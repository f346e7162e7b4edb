// The max-weight-clique solver's two device loops, for sm_90a:
//
//   greedy_start_kernel replaces the greedy start's fori_loop over V,
//     mcmtt_opticalflow_tpu/models/mwcp.py::_greedy_initial (:48-60),
//     vmapped over the replicas in solve_mwcp (:122-141);
//   bls_steps_kernel replaces the BLS while_loop (:286-324) and its body
//     one_replica_step (:177-273) with its record (:159-169), vmapped over
//     the replicas.
//
// Neither is a Pallas kernel: both are XLA loops inside the JAX package's
// jitted per-frame program.  Their plain versions are
// ops/mwcp_kernel.py::greedy_start_reference and bls_steps_reference.
// A third, clique_weight_kernel (a warp a row, all loads issued first; see
// its note), sums each start clique's weights in the
// BLS kernel's order (the JAX package takes one reduction for the start's
// score and the loop's, :143 and :185), so that a clique scores the same
// in the ring whether the start or an iteration recorded it: the record's
// duplicate test compares scores within 1e-5, less than 2 ulp at the
// bench's scores of ~250.
//
// greedy_start_kernel, one warp per replica and up to eight replicas a
// block.  It walks the replica's order (a permutation of the vertices,
// argsort outside the kernel) and admits the vertex at position i when
// i < bound, i < sum(valid), the vertex is valid with a weight >= 0 and
// every member of the clique so far is adjacent to it (adj[u][x] for the
// candidate u and each member x, as the plain version reads it).  The
// last two conditions are one bit set over the vertices, ok: the
// eligible vertices at first, ANDed with column x of the adjacency when
// x joins.  The columns come as bits, packed once a launch by
// pack_columns_kernel (exact for any adjacency, symmetric or not), so the
// update is ceil(V / 32) whole words, one a lane.  As ok only shrinks, a
// position found inadmissible stays so, and each round scans on from the
// last admitted position 32 positions at a time: each lane tests its
// position's vertex against ok, a ballot, the lowest lane; the window's
// vertices stay in registers while the scan stands there, and the next
// window's are loaded ahead.  Up to 1024 vertices lane k holds word k of
// ok and of the clique in a register: a test is one shuffle, an update
// one shared load.  The rounds are the clique's size plus one, not V, and
// need no block barrier.  The kernel is launched as the packing's
// programmatic dependent: its copies of the replicas' orders and its pass
// over the eligible vertices overlap the packing, and it waits for that
// grid (griddepcontrol.wait) before it copies the columns into shared
// memory.  It is integer logic only, so the result is bit-equal to the
// plain version's.  No vertex limit: the packed columns and the orders
// sit in shared memory where they fit (tier 0), the columns in device
// memory above that (tier 1), and the orders read where they lie where
// even a replica's do not fit (tier 2; `greedy_tiers`).
//
// bls_steps_kernel runs n iterations of every replica in one launch, one
// warp per replica and up to kMaxWarps replicas a block, which share the
// block's copy of the graph; after the graph's copy no block barrier is
// left.  The iteration number is read from the device (BlsState.it), the
// fields' rows it.. it+n-1 are read from device memory, and the state
// (membership, tabu stamps, best, previous optimum, counters, the ring of
// local optima) is written back in place; the caller advances `it` after
// the launch.  Rows at or past the fields' last are not run (the
// while_loop's condition).
//
// An iteration is a serial chain, so the design shortens the chain:
//   - neighbour state kept, not recounted: cnt[v] = |N(v) & C| and nx[v] =
//     the XOR of the members not adjacent to v, for every vertex, held as
//     bit planes (bit b of the integers of vertices 32k..32k+31; lane k
//     owns word k, whose planes lie together: four a 16-byte access).
//     Counted in full at the launch's start; a member that joins or
//     leaves C adds or subtracts its row's word k (bit b = adj[x][32k + b])
//     into the count planes with a ripple carry and XORs its complement
//     into the planes of its index's set bits (one pass for a move's
//     member in and member out).  PA = free & cnt == |C| and OM = free &
//     cnt == |C| - 1 are then a few word operations a plane, and nx[v] of
//     an OM vertex is its one non-adjacent member: no scan for the swap
//     partner.  A random move that drops more members than it keeps counts
//     anew;
//   - only what the iteration reads: the insert and swap gains while
//     searching (l_left <= 0), the tabu stamps' expiry and the directed
//     mask while perturbing, and in a random pick the neighbour sums of
//     only those live free vertices whose draw beats the best expired one;
//   - the sparse sets as lists: C's members ascending (rebuilt by the warp
//     from ballot counts and a prefix over lanes when C changes: fc is
//     summed over it once per change, the neighbour sums run over it),
//     and the PA/OM, tabu-live and live free vertices, spread over the
//     lanes four at a time;
//   - the fields: iteration it + 2's g_dir and g_rnd rows are copied into
//     shared memory while iteration it runs (three stages: one lane's
//     cp.async.bulk on the stage's mbarrier, or every lane's 4-byte
//     cp.async when the rows are not 16-byte aligned), and each lane
//     holds u_dir and u_ten for one of the next 32 iterations (the 32
//     after them loaded a chunk ahead): no device-memory load on the
//     chain;
//   - the argmaxes by torch's rule (`beats`) over the listed or set
//     vertices (the masked-out ones score NEG; the first of them stands
//     for all), then across the warp by two REDUX reductions of an
//     order-preserving key;
//   - the ring of local optima: its scores in shared memory, its masks
//     where they lie, read only when a score matches within 1e-5 and
//     written when a clique is recorded;
//   - no vertex limit: the layout (`layout`) puts the packed adjacency,
//     the replicas' state and the fields' stages in shared memory where
//     they fit (tier 0: V up to ~1200 at the bench's S), the adjacency in
//     device memory (L2) above that (tier 1), and the state too where one
//     replica's does not fit (tier 2: V above ~5000, the fields then read
//     where they lie).  The adjacency is packed by pack_columns_kernel
//     (the greedy start's packer) before each launch and brought into
//     shared memory by one bulk copy.
//
// Summation order, the one tolerance.  fc (the clique's weight) and
// nbr_w_in_c (each vertex's weight sum over adjacent members) are float32
// sums.  The kernel adds in ascending member order; the plain version
// takes torch.sum and a matrix product, whose order is the library's.  So
// the two can differ in the last bits, and a comparison that falls within
// that rounding (fc > fbest, |fc - score| < 1e-5 in the record,
// nbr_w_in_c >= alpha * fc) can send a replica another way.  The counts,
// masks, argmaxes, tabu stamps (truncation as .to(int32)), the select for
// the member weights (never a multiply: weights of -inf outside the graph)
// and exp (expf, not __expf; -fmad=false) are the plain version's.  The
// member weights are assumed finite (every member is a valid vertex).
// Every float operation is the one-block-per-replica kernel's before it,
// in its order; what changed is integer and bit logic, so the state after
// a launch is that kernel's bit for bit.
//
// What bounds it on this card.  The bytes are the fields' rows (2 x 4 B x
// V a replica and iteration) and the state, read once: ~47 MB and ~14 us
// for a bench solve of 150 iterations.  But an iteration depends on the
// one before, so the chain's latency is what counts.  On the bench's
// solves the sets it walks are not small (the PA/OM, tabu-live and random
// candidates hold hundreds of vertices while C is small), one warp walks
// them with little latency hidden, and each phase of the loop is a few
// hundred dependent instructions: ~11.8k cycles an iteration (PERF.md),
// against ~18.8k for the one-block-per-replica kernel before it.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e30f;             // models/mwcp.py's NEG
constexpr int kMaxWarps = 4;               // replicas a BLS block
constexpr int kStages = 3;                 // field rows in flight a replica
constexpr size_t kSmemMax = 232448;        // a block's shared memory
constexpr size_t kStaticSmem = 256;        // a kernel's own, at most
constexpr int kMaxDevices = 64;

// torch.argmax's order: NaN above everything, then value, then the lower
// index
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// An int whose signed order is `beats`' order of values: NaN above
// everything, then the value, -0 equal to +0 (the index breaks ties).
__device__ __forceinline__ int order_key(float f) {
  if (isnan(f)) return INT_MAX;
  if (f == 0.0f) return 0;
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return k == INT_MAX ? __int_as_float(0x7fffffff)
                      : __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// the warp's argmax by `beats`, with two reductions (REDUX): the largest
// key, then the lowest index holding it; v comes back as that key's value
// (a NaN for NaN, +0 for -0: equal in every comparison)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  const int key = order_key(v);
  const int top = __reduce_max_sync(kAll, key);
  i = (int)__reduce_min_sync(kAll, key == top ? (unsigned)i : 0xffffffffu);
  v = key_value(top);
}

// one count plane's bits under a +1 carry (cu) and a -1 borrow (cd) on
// disjoint vertices
__device__ __forceinline__ void ripple(uint32_t& plane, uint32_t& cu,
                                       uint32_t& cd) {
  const uint32_t t = plane;
  plane = t ^ cu ^ cd;
  cu &= t;
  cd &= ~t;
}

// bit b of x's two's complement, for any b >= 0 (the sign past 31)
__device__ __forceinline__ bool bit_of(int x, int b) {
  return ((unsigned)x >> (b < 31 ? b : 31)) & 1u;
}

__device__ __forceinline__ bool bit(const uint32_t* s, int v) {
  return (s[v >> 5] >> (v & 31)) & 1u;
}

// ---- Hopper's asynchronous copies (PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one thread: the arrival on `bar` that expects `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// one thread: the copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

long long round4(long long x) { return (x + 3) & ~3LL; }

// ---------------------------------------------------------------------------
// the greedy start
// ---------------------------------------------------------------------------

// P[k * as + x], bit b: adj[32k + b][x] (0 past V), column x of the
// adjacency as bits whatever its symmetry; one warp a 32 x 32 tile: lane b
// reads row 32k + b's 32 bytes of the tile, one ballot a column.
__global__ void pack_columns_kernel(const uint8_t* __restrict__ adj, int V,
                                    int as, int aligned16,
                                    uint32_t* __restrict__ P) {
  const int lane = threadIdx.x & 31;
  const int nk = (V + 31) >> 5;
  const long long tile =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // the greedy kernel may start now: it waits for this grid's writes
  // before it reads them (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (tile >= (long long)nk * nk) return;
  const int k = (int)(tile / nk), c0 = 32 * (int)(tile - (long long)k * nk);
  const int row = 32 * k + lane;
  uint32_t q[8] = {};        // the row's bytes at columns c0.., four a word
  if (row < V) {
    const uint8_t* src = adj + (size_t)row * V + c0;
    if (aligned16 && c0 + 32 <= V) {
      const uint4 lo = reinterpret_cast<const uint4*>(src)[0];
      const uint4 hi = reinterpret_cast<const uint4*>(src)[1];
      q[0] = lo.x; q[1] = lo.y; q[2] = lo.z; q[3] = lo.w;
      q[4] = hi.x; q[5] = hi.y; q[6] = hi.z; q[7] = hi.w;
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c0 + c < V) q[c >> 2] |= (uint32_t)(src[c] != 0) << (8 * (c & 3));
    }
  }
  uint32_t mine = 0;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const unsigned word =
        __ballot_sync(kAll, (q[c >> 2] >> (8 * (c & 3))) & 0xffu);
    if (lane == c) mine = word;
  }
  if (c0 + lane < V) P[(size_t)k * as + c0 + lane] = mine;
}

// Where the greedy start keeps what.  Offsets and sizes in 4-byte words.
struct GreedyLayout {
  int nk;             // words of a vertex bit set
  int as;             // words between the packed columns' rows k and k + 1
                      // (odd: lane k's word of a column in bank k)
  long long a_words;  // the packed columns [nk][as], a multiple of 4
  int elig;           // the block's eligible vertices [nk], rounded to 4
  int tier;           // 0: the packed columns and the replicas' orders in
                      // shared memory; 1: the columns in device memory;
                      // 2: the orders read where they lie too
  int wpb;            // replicas (one warp each) a block
  int rep;            // a replica's words: ok and members [nk] (past 1024
                      // vertices; in registers below), and its order [V]
                      // as int64 (tiers 0 and 1)
  size_t smem;        // dynamic shared memory a block, in bytes
};

constexpr int kGreedyWarps = 8;      // a greedy block's warps

GreedyLayout greedy_tiers(int V) {
  GreedyLayout G{};
  G.nk = (V + 31) >> 5;
  G.as = V | 1;
  G.a_words = round4((long long)G.nk * G.as);
  G.elig = (int)round4(G.nk);
  const long long bits = G.nk <= 32 ? 0 : 2LL * G.nk;
  const long long with_ord = round4(bits + 2LL * V);
  const long long avail = (long long)(kSmemMax - kStaticSmem) / 4;
  long long fixed = G.elig, rep = with_ord;
  if (G.a_words + G.elig + with_ord <= avail) {
    G.tier = 0;
    fixed += G.a_words;
  } else if (G.elig + with_ord <= avail) {
    G.tier = 1;
  } else {
    G.tier = 2;
    rep = round4(bits);
  }
  G.rep = (int)rep;
  G.wpb = (int)std::max<long long>(
      1, std::min<long long>(kGreedyWarps,
                             rep ? (avail - fixed) / rep : kGreedyWarps));
  G.smem = 4 * (size_t)(fixed + (long long)G.wpb * rep);
  return G;
}

struct GreedyArgs {
  const int64_t* orders;     // [R, V]
  const float* weights;      // [V]
  const uint8_t* valid;      // [V]
  const uint32_t* cols;      // the packed columns (pack_columns_kernel)
  uint8_t* in_c;             // [R, V]
  int R, V, bound;
  int out4;                  // in_c's rows start on 4 bytes
  GreedyLayout L;
};

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One warp per replica, wpb replicas a block of kGreedyWarps warps (the
// rest help with the copies); see the file's comment.  kReg (V <= 1024,
// tier 0): lane k holds word k of ok and of the clique in a register.
template <int kTier, bool kReg>
__global__ void __launch_bounds__(32 * kGreedyWarps)
    greedy_start_kernel(const GreedyArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int red[kGreedyWarps];
  const GreedyLayout& L = a.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = a.V, nk = L.nk;
  const int r = blockIdx.x * L.wpb + warp;
  const bool mine = warp < L.wpb && r < a.R;

  // ---- the block: each replica's order (tiers 0, 1) and, once the
  // packing grid is done, the packed columns (tier 0) copied by cp.async,
  // while every warp finds the eligible vertices (valid, weight >= 0) and
  // sum(valid); the kernel is launched as the packing's dependent, so the
  // orders' copy overlaps the packing
  uint32_t* sw = smem;
  const uint32_t* cols = a.cols;
  if (kTier == 0) sw += L.a_words;
  uint32_t* elig = sw;
  sw += L.elig;
  uint32_t* ok = sw + (size_t)warp * L.rep;      // by vertex (not kReg)
  uint32_t* mem = ok + nk;                       // the clique (not kReg)
  const int64_t* ord = a.orders + (size_t)r * V;
  if (kTier < 2) {
    int64_t* os = reinterpret_cast<int64_t*>(kReg ? ok : mem + nk);
    if (mine) {
      const uint32_t dst = smem_u32(os);
      for (int p = lane; p < V; p += 32) cp_async8(dst + 8 * p, ord + p);
    }
    ord = os;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (kTier == 0) {
    const uint32_t dst = smem_u32(smem);
    for (int q = tid; q < L.a_words / 4; q += 32 * kGreedyWarps)
      cp_async16(dst + 16 * q, a.cols + 4 * q);
    cols = smem;
  }
  cp_async_commit();
  int nv = 0;
  for (int k0 = warp; k0 < nk; k0 += 8 * kGreedyWarps) {
    bool va[8];
    float wt[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int v = 32 * (k0 + u * kGreedyWarps) + lane;
      const int vc = min(v, V - 1);
      va[u] = (v < V) & (a.valid[vc] != 0);
      wt[u] = a.weights[vc];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (k0 + u * kGreedyWarps >= nk) break;
      const unsigned e = __ballot_sync(kAll, va[u] && wt[u] >= 0.0f);
      nv += __popc(__ballot_sync(kAll, va[u]));
      if (lane == 0) elig[k0 + u * kGreedyWarps] = e;
    }
  }
  if (lane == 0) red[warp] = nv;
  cp_async_wait<0>();
  __syncthreads();
  if (!mine) return;                 // no block barrier after this
  nv = 0;
#pragma unroll
  for (int k = 0; k < kGreedyWarps; ++k) nv += red[k];
  const int lim = min(a.bound, nv);  // positions past either admit nothing

  // ---- the replica: ok starts as the eligible set (it only shrinks, and
  // eligibility is the admission's other condition on the vertex)
  uint32_t okw = 0, memw = 0;        // kReg: word `lane`
  if (kReg) {
    okw = lane < nk ? elig[lane] : 0u;
  } else {
    for (int k = lane; k < nk; k += 32) {
      ok[k] = elig[k];
      mem[k] = 0;
    }
    __syncwarp();
  }

  // ---- the rounds: the first position from the cursor on, below lim,
  // whose vertex is in ok; then ok &= the new member's column.  The scan
  // stands at window k (positions 32k ..), its vertices xc a lane (-1:
  // none) and the next window's loaded ahead.
  const int nkl = (lim + 31) >> 5;
  int64_t xn = -1;
  int xc = -1;
  if (lane < lim) {
    const int64_t x0 = ord[lane];
    xc = x0 >= 0 && x0 < V ? (int)x0 : -1;
  }
  if (32 + lane < lim) xn = ord[32 + lane];
  for (int k = 0, cursor = 0; k < nkl;) {
    const int okword = kReg ? (int)__shfl_sync(kAll, okw, max(xc, 0) >> 5)
                            : 0;
    bool hit = xc >= 0 && 32 * k + lane >= cursor;
    if (kReg)
      hit = hit && ((okword >> (xc & 31)) & 1);
    else
      hit = hit && bit(ok, xc);
    const unsigned hits = __ballot_sync(kAll, hit);
    if (!hits) {                     // on to the next window
      ++k;
      xc = xn >= 0 && xn < V ? (int)xn : -1;
      xn = -1;
      if (32 * (k + 1) + lane < lim) xn = ord[32 * (k + 1) + lane];
      continue;
    }
    const int l = __ffs(hits) - 1;
    const int xnew = __shfl_sync(kAll, xc, l);
    cursor = 32 * k + l + 1;
    if (kReg) {
      if (lane < nk) okw &= cols[(size_t)lane * L.as + xnew];
      if (lane == xnew >> 5) memw |= 1u << (xnew & 31);
    } else {
      if (lane == ((xnew >> 5) & 31)) mem[xnew >> 5] |= 1u << (xnew & 31);
      for (int q = lane; q < nk; q += 32)
        ok[q] &= cols[(size_t)q * L.as + xnew];
      __syncwarp();
    }
  }

  // ---- in_c's row from the members' bits, four bytes a store where the
  // row is aligned
  uint8_t* out = a.in_c + (size_t)r * V;
  if (kReg) {
    if (a.out4) {
      uint32_t* out4 = reinterpret_cast<uint32_t*>(out) + 8 * lane;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (32 * lane + 4 * q < V)
          out4[q] = (((memw >> (4 * q)) & 0xfu) * 0x00204081u) & 0x01010101u;
    } else {
      for (int b = 0; b < 32 && 32 * lane + b < V; ++b)
        out[32 * lane + b] = (memw >> b) & 1u;
    }
  } else {
    __syncwarp();
    if (a.out4) {
      uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
      for (int q = lane; q < V / 4; q += 32) {
        const uint32_t nib = (mem[q >> 3] >> (4 * (q & 7))) & 0xfu;
        out4[q] = (nib * 0x00204081u) & 0x01010101u;
      }
    } else {
      for (int v = lane; v < V; v += 32) out[v] = bit(mem, v);
    }
  }
}

// Each row's clique weight, one warp a row and a row a block (so that the
// rows spread over the SMs): the members' weights added in ascending order
// from 0, as bls_steps_kernel sums fc.  The row is taken kCliqueChunk
// columns at a time, 32 contiguous columns a lane.  Every load of a chunk
// is issued before any is used: a lane's 32 mask bytes as two 16-byte
// loads and its 32 weights as eight float4 loads whether the vertex is a
// member or not (kVec: V % 16 == 0 and 16-byte aligned rows; else a byte
// and a float at a time); the members are then bit tests in registers.
// The ascending chain runs once a chunk: the members' weights are
// compacted into shared memory in ascending order (each lane's place by a
// prefix of the lanes' member counts over five shuffles, each member's by
// the lane's members before it), and lane 0 adds them eight at a time from
// two 16-byte loads.  (Passing the partial sum lane to lane by shuffles,
// each lane adding its own members, makes the same additions in the same
// order but was slower on the H100: PERF.md, section 6.)
constexpr int kCliqueChunk = 1024;

template <bool kVec>
__global__ void __launch_bounds__(32)
    clique_weight_kernel(const uint8_t* __restrict__ masks,
                         const float* __restrict__ weights, int V,
                         float* __restrict__ out) {
  __shared__ __align__(16) float sw[kCliqueChunk];
  const int lane = threadIdx.x;
  const uint8_t* m = masks + (size_t)blockIdx.x * V;
  float s = 0.0f;
  for (int c0 = 0; c0 < V; c0 += kCliqueChunk) {
    const int col = c0 + 32 * lane;
    float w[32];
    unsigned bits = 0;
    if (kVec) {
      uint4 q[2];
      float4 f[8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        q[h] = col + 16 * h < V
                   ? __ldg(reinterpret_cast<const uint4*>(m + col + 16 * h))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        f[k] = col + 4 * k < V
                   ? __ldg(reinterpret_cast<const float4*>(weights + col) + k)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const unsigned words[8] = {q[0].x, q[0].y, q[0].z, q[0].w,
                                 q[1].x, q[1].y, q[1].z, q[1].w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const unsigned nz = __vcmpne4(words[k], 0u);   // 0xff a member byte
        bits |= ((nz & 1u) | ((nz >> 7) & 2u) | ((nz >> 14) & 4u) |
                 ((nz >> 21) & 8u)) << (4 * k);
        w[4 * k] = f[k].x;
        w[4 * k + 1] = f[k].y;
        w[4 * k + 2] = f[k].z;
        w[4 * k + 3] = f[k].w;
      }
    } else {
      uint8_t b[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        b[k] = col + k < V ? __ldg(m + col + k) : (uint8_t)0;
        w[k] = col + k < V ? __ldg(weights + col + k) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) bits |= (unsigned)(b[k] != 0) << k;
    }
    const int cnt = __popc(bits);
    int pos = cnt;                   // inclusive prefix over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kAll, pos, d);
      if (lane >= d) pos += t;
    }
    const int total = __shfl_sync(kAll, pos, 31);
    pos -= cnt;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if ((bits >> k) & 1u) sw[pos + __popc(bits & ((1u << k) - 1u))] = w[k];
    __syncwarp();
    if (lane == 0) {
      const float4* sw4 = reinterpret_cast<const float4*>(sw);
      for (int i = 0; i < total; i += 8) {
        const float4 a = sw4[i >> 2], b = sw4[(i >> 2) + 1];
        const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (i + j < total) s = __fadd_rn(s, x[j]);
      }
    }
    __syncwarp();
  }
  if (lane == 0) out[blockIdx.x] = s;
}
// ---------------------------------------------------------------------------
// the BLS iterations
// ---------------------------------------------------------------------------

// The packed adjacency A is pack_columns_kernel's: A[k * as + x], bit b,
// is adj[32k + b][x] (0 past V).  The kernel relies on the symmetry of
// the engine's compatibility matrix: A[k * as + x] is then also row x's
// word k, bit b adj[x][32k + b], and A[k * as + v] bit b of member 32k + b
// is adj[v][32k + b], the entry the plain version's matrix product reads.

// Where a launch keeps what.  Offsets and sizes in 4-byte words.
struct Layout {
  int nk;          // words of a vertex bit set, ceil(V / 32)
  int nb;          // bit planes of a neighbour count (0..V)
  int nxb;         // bit planes of a vertex index (0..V-1)
  int nbs, nxs;    // words between a word's count planes, index planes:
                   // nb, nxb rounded up to 4 mod 8 (a lane's 16-byte
                   // loads of its planes fall in distinct banks)
  int as;          // words between the packed adjacency's rows k and k + 1
  long long a_words;  // the packed adjacency [nk][as], a multiple of 4
  int w_words;     // the weights' shared copy (tiers 0 and 1)
  int tier;        // 0: adjacency, state and fields in shared memory;
                   // 1: state and fields there, adjacency in device memory;
                   // 2: all in device memory (the scratch)
  int wpb;         // replicas (one warp each) a block
  // a replica's region: bit sets of nk words, the ring's scores, the
  // count and index planes, the tabu stamps, the member list and a vertex
  // list (V each), the fields' stages (tiers 0 and 1); the ring's masks
  // stay in device memory
  int bars, valid, c, best, cp, pa, om, live, aux, ring_s, cnt, nx, tabu,
      mem, lst, stage;
  int rep;         // a replica's words, a multiple of 4
  size_t smem;     // dynamic shared memory a block, in bytes
};

int bits_for(long long x) {  // bits that hold 0..x
  int b = 0;
  while ((1LL << b) <= x) ++b;
  return b;
}

Layout layout(int V, int S) {
  Layout L{};
  L.nk = (V + 31) >> 5;
  L.nb = bits_for(V);
  L.nxb = bits_for(V - 1) > 0 ? bits_for(V - 1) : 1;
  L.as = V | 1;              // odd: lane k's word k of a row in bank k
  L.a_words = round4((long long)L.nk * L.as);
  L.w_words = (int)round4(V);
  int off = 0;
  auto take = [&off](int words) {
    const int o = off;
    off += words;
    return o;
  };
  L.bars = take(2 * kStages);   // the stages' mbarriers, 8-byte aligned
  L.valid = take(L.nk);
  L.c = take(L.nk);
  L.best = take(L.nk);
  L.cp = take(L.nk);
  L.pa = take(L.nk);
  L.om = take(L.nk);
  L.live = take(L.nk);
  L.aux = take(L.nk);
  L.ring_s = take(S);
  L.nbs = L.nb <= 4 ? 4 : 8 * ((L.nb - 4 + 7) / 8) + 4;
  L.nxs = L.nxb <= 4 ? 4 : 8 * ((L.nxb - 4 + 7) / 8) + 4;
  off = (int)round4(off);
  L.cnt = take(L.nbs * L.nk);      // word k's planes at [k * nbs, + nbs)
  L.nx = take(L.nxs * L.nk);
  L.tabu = take(V);
  L.mem = take(V);
  L.lst = take(V);
  L.stage = (int)round4(off);
  const long long staged = L.stage + (long long)kStages * 2 * 32 * L.nk;
  const long long avail = (long long)(kSmemMax - kStaticSmem) / 4;
  if (L.a_words + L.w_words + staged <= avail) {
    L.tier = 0;
    L.wpb = (int)std::min<long long>(
        kMaxWarps, (avail - L.a_words - L.w_words) / staged);
    L.rep = (int)staged;
    L.smem = 4 * (size_t)(L.a_words + L.w_words + (long long)L.wpb * L.rep);
  } else if (L.w_words + staged <= avail) {
    L.tier = 1;
    L.wpb = (int)std::min<long long>(kMaxWarps,
                                     (avail - L.w_words) / staged);
    L.rep = (int)staged;
    L.smem = 4 * (size_t)(L.w_words + (long long)L.wpb * L.rep);
  } else {
    L.tier = 2;
    L.wpb = kMaxWarps;
    L.rep = L.stage;
    L.smem = 0;
  }
  return L;
}

struct BlsArgs {
  const float* weights;      // [V]
  const uint8_t* valid;      // [V]
  uint32_t* scratch;         // packed adjacency, then tier 2's regions
  const float* l0;           // 0-dim
  const float* lmax;         // 0-dim
  uint8_t* in_c;             // [R, V]
  int32_t* tabu;             // [R, V]
  float* fbest;              // [R]
  uint8_t* best;             // [R, V]
  uint8_t* cp;               // [R, V]
  int32_t* wcnt;             // [R]
  float* l_left;             // [R]
  uint8_t* use_directed;     // [R]
  uint8_t* sol_masks;        // [R, S, V]
  float* sol_scores;         // [R, S]
  int64_t* sol_next;         // [R]
  const int32_t* it;         // [1]
  const float* u_dir;        // [I, R]
  const float* g_dir;        // [I, R, V]
  const float* u_ten;        // [I, R]
  const float* g_rnd;        // [I, R, V]
  int V, R, S, I, n;
  int t_nonimprove, phi;
  float p0, alpha_s, alpha_r;
  int aligned16;             // the fields' rows start on 16 bytes
  Layout L;
};

enum Move { kNone = 0, kLocal, kDirected, kRandom };

// whether bit sets x and y differ, by one warp
__device__ __forceinline__ bool differ(const uint32_t* x, const uint32_t* y,
                                       int nk, int lane) {
  bool d = false;
  for (int k = lane; k < nk; k += 32) d |= x[k] != y[k];
  return __any_sync(kAll, d);
}

__device__ __forceinline__ void copy_bits(uint32_t* dst, const uint32_t* src,
                                          int nk, int lane) {
  for (int k = lane; k < nk; k += 32) dst[k] = src[k];
}

// the lowest-index entry of `m`'s bits (vertices 32k + b) by the values
// g[v], folded into (bv, bi) by torch.argmax's rule; four loads in flight
__device__ __forceinline__ void argmax_bits(uint32_t m, int k, const float* g,
                                            float& bv, int& bi) {
  while (m) {
    int v4[4];
    float x4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v4[q] = m ? 32 * k + __ffs(m) - 1 : -1;
      m &= m - 1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) x4[q] = v4[q] >= 0 ? g[v4[q]] : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (v4[q] >= 0 && beats(x4[q], v4[q], bv, bi)) {
        bv = x4[q];
        bi = v4[q];
      }
  }
}

// the argmax over m's bits of word k with the values g[32k..32k+31] read
// as eight 16-byte loads (g 16-byte aligned), rotated by k so that the
// eight lanes of a quarter-warp read eight different banks
__device__ __forceinline__ void argmax_word16(uint32_t m, int k, const float* g,
                                              float& bv, int& bi) {
  const float4* g4 = reinterpret_cast<const float4*>(g + 32 * k);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = (i + k) & 7;
    const float4 x = g4[q];
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = 32 * k + 4 * q + e;
      if (((m >> (4 * q + e)) & 1u) && beats(xs[e], v, bv, bi)) {
        bv = xs[e];
        bi = v;
      }
    }
  }
}

// the bits of m (vertices 32k + b) whose values g[v] beat (bv, bi) by
// torch.argmax's rule; four loads in flight
__device__ __forceinline__ uint32_t beating_bits(uint32_t m, int k,
                                                 const float* g, float bv,
                                                 int bi) {
  uint32_t out = 0u;
  while (m) {
    int v4[4];
    float x4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v4[q] = m ? 32 * k + __ffs(m) - 1 : -1;
      m &= m - 1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) x4[q] = v4[q] >= 0 ? g[v4[q]] : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (v4[q] >= 0 && beats(x4[q], v4[q], bv, bi))
        out |= 1u << (v4[q] & 31);
  }
  return out;
}

// One warp per replica, wpb replicas a block; see the file's comment.
template <int kTier>
__global__ void __launch_bounds__(32 * kMaxWarps)
    bls_steps_kernel(const BlsArgs a) {
  constexpr bool kAdjS = kTier == 0, kStateS = kTier < 2;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(8) unsigned long long bar;
  const Layout& L = a.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = a.V, R = a.R, S = a.S, nk = L.nk, as = L.as;

  // ---- the block's graph: the packed adjacency by one bulk copy, the
  // weights by every thread
  const uint32_t* A = a.scratch;
  const float* w = a.weights;
  if (kStateS) {
    uint32_t* sw = smem;
    const uint32_t b = smem_u32(&bar);
    if (kAdjS) {
      if (tid == 0) mbar_init(b, 1);
      __syncthreads();
      if (tid == 0) {
        mbar_expect(b, (uint32_t)(4 * L.a_words));
        bulk_load(smem_u32(sw), a.scratch, (uint32_t)(4 * L.a_words), b);
      }
      A = sw;
      sw += L.a_words;
    }
    float* ws = reinterpret_cast<float*>(sw);
    for (int v = tid; v < V; v += blockDim.x) ws[v] = a.weights[v];
    w = ws;
    if (kAdjS) mbar_wait(b, 0);
    __syncthreads();
  }
  const int r = blockIdx.x * L.wpb + warp;
  if (r >= R) return;                // no block barrier after this
  uint32_t* base =
      kStateS ? smem + (kAdjS ? L.a_words : 0) + L.w_words +
                    (size_t)warp * L.rep
              : a.scratch + L.a_words + (size_t)r * L.rep;
  uint32_t* valid = base + L.valid;
  uint32_t* C = base + L.c;
  uint32_t* best = base + L.best;
  uint32_t* cp = base + L.cp;
  uint32_t* pa_s = base + L.pa;
  uint32_t* om_s = base + L.om;
  uint32_t* live = base + L.live;        // tabu stamp > it
  uint32_t* aux = base + L.aux;          // the random pick's strong bits
  float* ring_s = reinterpret_cast<float*>(base + L.ring_s);
  uint32_t* cntp = base + L.cnt;         // word k, plane b: [k * nbs + b]
  uint32_t* nxp = base + L.nx;
  const int nbs = L.nbs, nxs = L.nxs;
  int32_t* tabu = reinterpret_cast<int32_t*>(base + L.tabu);
  int32_t* mem = reinterpret_cast<int32_t*>(base + L.mem);
  int32_t* lst = reinterpret_cast<int32_t*>(base + L.lst);
  float* stage = reinterpret_cast<float*>(base + L.stage);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(base + L.bars);
  const int nk32 = 32 * nk;
  const size_t rv0 = (size_t)r * V;

  // ---- the replica's state
  const int it0 = *a.it;
  const int steps = max(0, min(a.n, a.I - it0));
  for (int k0 = 0; k0 < nk; k0 += 8) {  // eight words' loads in flight
    uint8_t xv[8], xc[8], xb[8], xp[8];
    int tb[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int v = 32 * (k0 + q) + lane;
      const bool in = k0 + q < nk && v < V;
      xv[q] = in ? a.valid[v] : 0;
      xc[q] = in ? a.in_c[rv0 + v] : 0;
      xb[q] = in ? a.best[rv0 + v] : 0;
      xp[q] = in ? a.cp[rv0 + v] : 0;
      tb[q] = in ? a.tabu[rv0 + v] : 0;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = k0 + q, v = 32 * k + lane;
      if (k >= nk) break;
      if (v < V) tabu[v] = tb[q];
      const unsigned bv = __ballot_sync(kAll, xv[q]);
      const unsigned bc = __ballot_sync(kAll, xc[q]);
      const unsigned bb = __ballot_sync(kAll, xb[q]);
      const unsigned bp = __ballot_sync(kAll, xp[q]);
      const unsigned bl = __ballot_sync(kAll, v < V && tb[q] > it0);
      if (lane == (k & 31)) {
        valid[k] = bv;
        C[k] = bc;
        best[k] = bb;
        cp[k] = bp;
        live[k] = bl;
      }
    }
  }
  for (int s = lane; s < S; s += 32)
    ring_s[s] = a.sol_scores[(size_t)r * S + s];
  float fbest = a.fbest[r], l_left = a.l_left[r];
  int wcnt = a.wcnt[r];
  bool use_dir = a.use_directed[r] != 0;
  long long sol_next = a.sol_next[r];
  const float l0 = *a.l0, lmax = *a.lmax;
  __syncwarp();

  // lanes own words k = lane, lane + 32, ...: the counts and index planes
  // of vertices 32k..32k+31 change by one adjacency word a member.  One
  // pass for a member x_in that joins and one x_out that leaves (-1:
  // none): +1 ripples up as a carry, -1 as a borrow, on disjoint vertices
  auto update_rows = [&](int x_in, int x_out) {
    for (int k = lane; k < nk; k += 32) {
      const uint32_t ra = x_in >= 0 ? A[(size_t)k * as + x_in] : 0u;
      const uint32_t rb = x_out >= 0 ? A[(size_t)k * as + x_out] : 0u;
      uint32_t cu = ra & ~rb, cd = rb & ~ra;
      uint4* cw = reinterpret_cast<uint4*>(cntp + (size_t)k * nbs);
      for (int c = 0; c < (nbs >> 2) && (cu | cd); ++c) {
        uint4 p = cw[c];                 // four planes a load
        ripple(p.x, cu, cd);
        ripple(p.y, cu, cd);
        ripple(p.z, cu, cd);
        ripple(p.w, cu, cd);
        cw[c] = p;
      }
      // the vertices not adjacent to x_in (x_out) take its bits into nx
      const uint32_t na = x_in >= 0 ? ~ra : 0u, nb_ = x_out >= 0 ? ~rb : 0u;
      const int xi = x_in >= 0 ? x_in : 0, xo = x_out >= 0 ? x_out : 0;
      uint4* xw = reinterpret_cast<uint4*>(nxp + (size_t)k * nxs);
      for (int c = 0; c < (nxs >> 2); ++c) {
        uint32_t f[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          f[q] = (bit_of(xi, 4 * c + q) ? na : 0u) ^
                 (bit_of(xo, 4 * c + q) ? nb_ : 0u);
        if (f[0] | f[1] | f[2] | f[3]) {
          uint4 x = xw[c];
          x.x ^= f[0];
          x.y ^= f[1];
          x.z ^= f[2];
          x.w ^= f[3];
          xw[c] = x;
        }
      }
    }
  };
  // the vertices of the words mask(k) ascending into out (ballot counts,
  // a prefix over lanes): a sparse set's work spread over the lanes
  auto compact = [&](auto mask, int32_t* out) {
    int total = 0;
    for (int k0 = 0; k0 < nk; k0 += 32) {
      const int k = k0 + lane;
      uint32_t word = k < nk ? mask(k) : 0u;
      const int c = __popc(word);
      int incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, off);
        if (lane >= off) incl += y;
      }
      int pos = total + incl - c;
      for (; word; word &= word - 1) out[pos++] = 32 * k + __ffs(word) - 1;
      total += __shfl_sync(kAll, incl, 31);
    }
    __syncwarp();
    return total;
  };
  // C's members ascending into mem, and fc, their weights added in that
  // order
  int csize = 0;
  float fc = 0.0f;
  auto rebuild = [&]() {
    const int total = compact([&](int k) { return C[k]; }, mem);
    float f = 0.0f;
    for (int j0 = 0; j0 < total; j0 += 32) {
      const int j = j0 + lane;
      const float wj = j < total ? w[mem[j]] : 0.0f;
      const int cnt = min(32, total - j0);
#pragma unroll 8
      for (int q = 0; q < cnt; ++q) f = __fadd_rn(f, __shfl_sync(kAll, wj, q));
    }
    csize = total;
    fc = f;
  };
  auto recount = [&]() {
    for (int k = lane; k < nk; k += 32) {
      for (int b = 0; b < nbs; ++b) cntp[(size_t)k * nbs + b] = 0u;
      for (int b = 0; b < nxs; ++b) nxp[(size_t)k * nxs + b] = 0u;
    }
    for (int j = 0; j < csize; ++j) update_rows(mem[j], -1);
  };
  // an OM vertex's one non-adjacent member: its index planes' bits
  auto partner = [&](int v) {
    const uint4* xw =
        reinterpret_cast<const uint4*>(nxp + (size_t)(v >> 5) * nxs);
    const int j = v & 31;
    int p = 0;
    for (int c = 0; c < (nxs >> 2); ++c) {
      const uint4 x = xw[c];
      p |= (int)((x.x >> j) & 1u) << (4 * c) |
           (int)((x.y >> j) & 1u) << (4 * c + 1) |
           (int)((x.z >> j) & 1u) << (4 * c + 2) |
           (int)((x.w >> j) & 1u) << (4 * c + 3);
    }
    return p;
  };
  // the vertices of word k outside a mask score NEG there: the first of
  // them stands for all in an argmax
  auto floor_cand = [&](uint32_t set, int k, float& bv, int& bi) {
    const int rem = V - 32 * k;
    const uint32_t z = ~set & (rem >= 32 ? kAll : (1u << rem) - 1u);
    if (z) {
      const int v = 32 * k + __ffs(z) - 1;
      if (beats(kNeg, v, bv, bi)) {
        bv = kNeg;
        bi = v;
      }
    }
  };
  rebuild();
  recount();
  // the stamps that have expired by iteration it leave `live` (a superset
  // of {v : tabu[v] > it} between calls): the live vertices listed, four
  // a lane in flight
  auto expire = [&](int it) {
    const int nl = compact([&](int k) { return live[k]; }, lst);
    for (int j0 = 0; j0 < nl; j0 += 128) {
      int v4[4], t4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + 32 * q + lane;
        v4[q] = j < nl ? lst[j] : -1;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) t4[q] = v4[q] >= 0 ? tabu[v4[q]] : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (v4[q] >= 0 && t4[q] <= it)
          atomicAnd(&live[v4[q] >> 5], ~(1u << (v4[q] & 31)));
    }
    __syncwarp();
  };

  // ---- the fields: rows it..it+kStages-2 in flight into the stages; the
  // perturbation draws 32 iterations to a register, the next 32 loaded
  // rows 16-byte aligned: one lane's two bulk copies a stage, on the
  // stage's mbarrier; else every lane's 4-byte cp.async, in groups
  const bool bulk = kStateS && a.aligned16;
  if (bulk && lane == 0)
    for (int q = 0; q < kStages; ++q) mbar_init(smem_u32(bars + q), 1);
  __syncwarp();
  auto prefetch = [&](int t) {
    if (t < steps) {
      const size_t row = ((size_t)(it0 + t) * R + r) * V;
      float* dst = stage + (size_t)(t % kStages) * 2 * nk32;
      const uint32_t d0 = smem_u32(dst), d1 = smem_u32(dst + nk32);
      if (bulk) {
        if (lane == 0) {
          const uint32_t b = smem_u32(bars + t % kStages);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_expect(b, 8u * V);
          bulk_load(d0, a.g_dir + row, 4u * V, b);
          bulk_load(d1, a.g_rnd + row, 4u * V, b);
        }
      } else {
        for (int v = lane; v < V; v += 32) {
          cp_async4(d0 + 4 * v, a.g_dir + row + v);
          cp_async4(d1 + 4 * v, a.g_rnd + row + v);
        }
      }
    }
    if (!bulk) cp_async_commit();
  };
  if (kStateS)
    for (int q = 0; q < kStages - 1; ++q) prefetch(q);
  auto u_at = [&](const float* u, int t) {
    return t < steps ? u[(size_t)(it0 + t) * R + r] : 0.0f;
  };
  float ud_c = u_at(a.u_dir, lane), ut_c = u_at(a.u_ten, lane);
  float ud_n = u_at(a.u_dir, 32 + lane), ut_n = u_at(a.u_ten, 32 + lane);

  for (int t = 0; t < steps; ++t) {
    const int it = it0 + t;
    const float* gd;
    const float* gr;
    if (kStateS) {
      if (bulk)
        mbar_wait(smem_u32(bars + t % kStages), (t / kStages) & 1);
      else
        cp_async_wait<kStages - 2>();
      __syncwarp();
      prefetch(t + kStages - 1);
      gd = stage + (size_t)(t % kStages) * 2 * nk32;
      gr = gd + nk32;
    } else {
      const size_t row = ((size_t)it * R + r) * V;
      gd = a.g_dir + row;
      gr = a.g_rnd + row;
    }
    const float ud = __shfl_sync(kAll, ud_c, t & 31);
    const float ut = __shfl_sync(kAll, ut_c, t & 31);
    if ((t & 31) == 31) {
      ud_c = ud_n;
      ut_c = ut_n;
      ud_n = u_at(a.u_dir, t + 33 + lane);
      ut_n = u_at(a.u_ten, t + 33 + lane);
    }
    // ---- PA = free & cnt == |C|, OM = free & cnt == |C| - 1, from the
    // count planes
    const bool searching = l_left <= 0.0f;
    float b0 = -INFINITY, b1 = -INFINITY;
    int i0 = INT_MAX, i1 = INT_MAX, omc = 0;
    const int cm1 = csize - 1;
    for (int k = lane; k < nk; k += 32) {
      // the planes past nb are 0, as are csize's and cm1's bits there
      // (cm1 = -1 only without members, when OM is empty)
      uint32_t eq = kAll, eq1 = kAll;
      const uint4* cw = reinterpret_cast<const uint4*>(cntp + (size_t)k * nbs);
      for (int c = 0; c < (nbs >> 2); ++c) {
        const uint4 p4 = cw[c];
        const uint32_t q4[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          eq &= bit_of(csize, 4 * c + q) ? q4[q] : ~q4[q];
          eq1 &= bit_of(cm1, 4 * c + q) ? q4[q] : ~q4[q];
        }
      }
      const uint32_t fr = valid[k] & ~C[k];
      const uint32_t pa = fr & eq, om = csize > 0 ? fr & eq1 : 0u;
      pa_s[k] = pa;
      om_s[k] = om;
      if (searching) {
        floor_cand(pa, k, b0, i0);
        floor_cand(om, k, b1, i1);
      }
      omc += __popc(om);
    }
    omc = __reduce_add_sync(kAll, omc);
    // the insert and swap gains, which only a local search reads: the PA
    // and OM vertices listed, four a lane
    if (searching) {
      const int ncand = compact(
          [&](int k) { return pa_s[k] | om_s[k]; }, lst);
      for (int j0 = 0; j0 < ncand; j0 += 128) {
        int v4[4], p4[4] = {0, 0, 0, 0};
        bool o4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 32 * q + lane;
          v4[q] = j < ncand ? lst[j] : -1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) o4[q] = v4[q] >= 0 && bit(om_s, v4[q]);
        for (int c = 0; c < (nxs >> 2); ++c) {  // OM partners: nx's bits
          uint4 x4[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            x4[q] = o4[q] ? reinterpret_cast<const uint4*>(
                                nxp + (size_t)(v4[q] >> 5) * nxs)[c]
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = v4[q] & 31;
            p4[q] |= (int)((x4[q].x >> j) & 1u) << (4 * c) |
                     (int)((x4[q].y >> j) & 1u) << (4 * c + 1) |
                     (int)((x4[q].z >> j) & 1u) << (4 * c + 2) |
                     (int)((x4[q].w >> j) & 1u) << (4 * c + 3);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int v = v4[q];
          if (v < 0) continue;
          if (o4[q]) {
            const float g = __fsub_rn(w[v], w[p4[q]]);
            if (beats(g, v, b1, i1)) {
              b1 = g;
              i1 = v;
            }
          } else if (beats(w[v], v, b0, i0)) {
            b0 = w[v];
            i0 = v;
          }
        }
      }
      warp_argmax(b0, i0);
      warp_argmax(b1, i1);
    }

    // ---- the decision, every lane alike
    const float gi = b0, gs = b1;
    const bool use_swap = gs > gi;
    // max(gi, gs) > 1e-9, NaN propagating as torch.maximum does
    const bool improving =
        !isnan(gi) && !isnan(gs) && (gi > 1e-9f || gs > 1e-9f);
    const bool do_ls = searching && improving;
    const bool at_opt = searching && !improving;
    const bool better = fc > fbest;
    const bool up = at_opt && better;
    int new_w = at_opt ? (better ? 0 : wcnt + 1) : wcnt;
    const bool esc = new_w > a.t_nonimprove;
    float l_new = 0.0f;
    if (at_opt) {
      const bool same_cp = !differ(C, cp, nk, lane);
      l_new = esc ? lmax : (same_cp ? __fadd_rn(l_left, 1.0f) : l0);
      // the record: a new local optimum, unless empty, not positive or
      // already in the ring (score within 1e-5 and the same mask)
      if (!same_cp && !esc && fc > 0.0f && csize > 0) {
        bool dup = false;
        for (int s0 = 0; s0 < S && !dup; s0 += 32) {
          const int s = s0 + lane;
          uint32_t near = __ballot_sync(
              kAll, s < S && fabsf(__fsub_rn(ring_s[s], fc)) < 1e-5f);
          while (near && !dup) {         // the slot's mask, where it lies
            const int q = s0 + __ffs(near) - 1;
            near &= near - 1;
            const uint8_t* row = a.sol_masks + ((size_t)r * S + q) * V;
            bool d = false;
            for (int v = lane; v < V; v += 32) d |= (row[v] != 0) != bit(C, v);
            dup = !__any_sync(kAll, d);
          }
        }
        if (!dup) {
          const int slot = (int)(sol_next % S);
          uint8_t* row = a.sol_masks + ((size_t)r * S + slot) * V;
          for (int v = lane; v < V; v += 32) row[v] = bit(C, v);
          if (lane == 0) ring_s[slot] = fc;
          ++sol_next;
        }
      }
      if (up) copy_bits(best, C, nk, lane);
      copy_bits(cp, C, nk, lane);
      if (esc) new_w = 0;
    }
    const float p =
        wcnt == 0 ? 0.0f
                  : fminf(expf(__fdiv_rn((float)(-wcnt),
                                         (float)a.t_nonimprove)),
                          a.p0);
    const bool directed = ud < p;
    const bool use_dir_now = at_opt ? directed : use_dir;
    const float new_l = at_opt ? l_new : l_left;
    const bool perturbing = l_left > 0.0f || at_opt;
    const int stamp = it + a.phi + (int)__fmul_rn(ut, (float)max(omc, 1));
    const float th = __fmul_rn(wcnt == 0 ? a.alpha_s : a.alpha_r, fc);
    int move = do_ls ? kLocal : kNone;
    if (perturbing) {
      // the stamps this iteration reads: tabu[v] <= it; the directed mask,
      // (PA or OM) with an expired stamp, or C, is empty only without C
      expire(it);
      bool dany = csize > 0;
      if (!dany) {
        bool d = false;
        for (int k = lane; k < nk; k += 32) d |= (pa_s[k] & ~live[k]) != 0u;
        dany = __any_sync(kAll, d);
      }
      move = use_dir_now && dany ? kDirected : kRandom;
    }
    fbest = up ? fc : fbest;
    wcnt = new_w;
    l_left = do_ls ? l_left : fmaxf(__fsub_rn(new_l, 1.0f), 0.0f);
    use_dir = at_opt ? directed : use_dir;
    __syncwarp();

    // ---- the move
    if (move == kLocal || move == kDirected) {
      int x, ins = -1, out = -1;
      if (move == kLocal) {              // insert x, or swap it in
        x = use_swap ? i1 : i0;
        ins = x;
        if (use_swap) out = partner(x);  // x is OM: gs > gi >= NEG
      } else {                           // directed: remove, insert, swap
        float bd = -INFINITY;
        int id = INT_MAX;
        for (int k = lane; k < nk; k += 32)
          floor_cand(((pa_s[k] | om_s[k]) & ~live[k]) | C[k], k, bd, id);
        const int nd = compact(
            [&](int k) { return (pa_s[k] | om_s[k]) & ~live[k]; }, lst);
        for (int j = lane; j < nd; j += 32) {
          const int v = lst[j];
          if (beats(gd[v], v, bd, id)) {
            bd = gd[v];
            id = v;
          }
        }
        for (int j = lane; j < csize; j += 32) {
          const int v = mem[j];
          if (beats(gd[v], v, bd, id)) {
            bd = gd[v];
            id = v;
          }
        }
        warp_argmax(bd, id);
        x = id;
        if (bit(C, x)) {
          out = x;
        } else {
          ins = x;
          if (bit(om_s, x)) out = partner(x);
        }
      }
      if (ins >= 0 && bit(C, ins)) ins = -1;
      if (out >= 0 && !bit(C, out)) out = -1;
      __syncwarp();
      if (lane == 0) {
        if (out >= 0) {
          C[out >> 5] &= ~(1u << (out & 31));
          tabu[out] = stamp;
          live[out >> 5] |= 1u << (out & 31);
        }
        if (ins >= 0) C[ins >> 5] |= 1u << (ins & 31);
      }
      update_rows(ins, out);
      __syncwarp();
      rebuild();
    } else if (move == kRandom) {
      // among free vertices whose stamp has expired or whose weight sum
      // over adjacent members (ascending) reaches alpha * fc.  The expired
      // ones first: a live one can only win by beating their best, so
      // only such live ones sum their neighbours' weights (all of them
      // when no expired free vertex scores above NEG)
      float bv = -INFINITY;
      int bi = INT_MAX;
      bool tany = false;
      for (int k = lane; k < nk; k += 32) {
        const uint32_t tk = valid[k] & ~C[k] & ~live[k];
        tany |= tk != 0u;
        if (kStateS)
          argmax_word16(tk, k, gr, bv, bi);
        else
          argmax_bits(tk, k, gr, bv, bi);
      }
      warp_argmax(bv, bi);
      tany = __any_sync(kAll, tany);
      const bool all = !(bv > kNeg) && !isnan(bv);
      for (int k = lane; k < nk; k += 32) {
        const uint32_t lf = valid[k] & ~C[k] & live[k];
        aux[k] = all ? lf : beating_bits(lf, k, gr, bv, bi);
      }
      const int nlive = compact([&](int k) { return aux[k]; }, lst);
      for (int k = lane; k < nk; k += 32) aux[k] = 0u;
      __syncwarp();
      for (int j0 = 0; j0 < nlive; j0 += 128) {   // four vertices a lane
        int v4[4];
        float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 32 * q + lane;
          v4[q] = j < nlive ? lst[j] : 0;
        }
#pragma unroll 2
        for (int qm = 0; qm < csize; ++qm) {    // members ascending
          const int m = mem[qm];
          const float wm = w[m];
          const uint32_t* am = A + (size_t)(m >> 5) * as;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if ((am[v4[q]] >> (m & 31)) & 1u) s4[q] = __fadd_rn(s4[q], wm);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + 32 * q + lane < nlive && s4[q] >= th)
            atomicOr(&aux[v4[q] >> 5], 1u << (v4[q] & 31));
      }
      __syncwarp();
      bool rany = tany;
      if (all) {                         // every live free vertex summed
        bv = -INFINITY;
        bi = INT_MAX;
        for (int k = lane; k < nk; k += 32) {
          const uint32_t pick = valid[k] & ~C[k] & (~live[k] | aux[k]);
          rany |= pick != 0u;
          argmax_bits(pick, k, gr, bv, bi);
          floor_cand(pick, k, bv, bi);
        }
        warp_argmax(bv, bi);
        rany = __any_sync(kAll, rany);
      } else {                           // the strong live ones that beat it
        float cv = -INFINITY;
        int ci = INT_MAX;
        for (int j = lane; j < nlive; j += 32) {
          const int v = lst[j];
          if (bit(aux, v) && beats(gr[v], v, cv, ci)) {
            cv = gr[v];
            ci = v;
          }
        }
        warp_argmax(cv, ci);
        if (beats(cv, ci, bv, bi)) {
          bv = cv;
          bi = ci;
        }
      }
      if (rany) {                        // (C & adj[bi]) | {bi}
        const bool was_in = bit(C, bi);
        __syncwarp();
        for (int k = lane; k < nk; k += 32) {
          const uint32_t c = C[k];
          uint32_t nxt = c & A[(size_t)k * as + bi];
          if (k == (bi >> 5)) nxt |= 1u << (bi & 31);
          const uint32_t gone = c & ~nxt;
          for (uint32_t x = gone; x; x &= x - 1)
            tabu[32 * k + __ffs(x) - 1] = stamp;
          live[k] |= gone;
          C[k] = nxt;
        }
        __syncwarp();
        int nout = 0;                    // the old members that left
        for (int j0 = 0; j0 < csize; j0 += 32) {
          const int j = j0 + lane;
          nout += __popc(
              __ballot_sync(kAll, j < csize && !bit(C, mem[j])));
        }
        const int nsize = csize - nout + !was_in;
        if (nout + !was_in > nsize + 1) {  // fewer rows to count anew
          rebuild();
          recount();
        } else {
          int x_in = was_in ? -1 : bi;   // paired with the first to leave
          for (int j0 = 0; j0 < csize; j0 += 32) {
            const int j = j0 + lane;
            uint32_t g = __ballot_sync(kAll, j < csize && !bit(C, mem[j]));
            for (; g; g &= g - 1) {
              update_rows(x_in, mem[j0 + __ffs(g) - 1]);
              x_in = -1;
            }
          }
          if (x_in >= 0) update_rows(x_in, -1);
          __syncwarp();
          rebuild();
        }
      }
    }
    __syncwarp();
  }
  if (kStateS) cp_async_wait<0>();
  __syncwarp();

  // ---- write the state back (the ring's masks were written in place)
  for (int v = lane; v < V; v += 32) {
    a.in_c[rv0 + v] = bit(C, v);
    a.best[rv0 + v] = bit(best, v);
    a.cp[rv0 + v] = bit(cp, v);
    a.tabu[rv0 + v] = tabu[v];
  }
  for (int s = lane; s < S; s += 32)
    a.sol_scores[(size_t)r * S + s] = ring_s[s];
  if (lane == 0) {
    a.fbest[r] = fbest;
    a.wcnt[r] = wcnt;
    a.l_left[r] = l_left;
    a.use_directed[r] = (uint8_t)use_dir;
    a.sol_next[r] = sol_next;
  }
}

// Allows `kernel` `bytes` of dynamic shared memory on the current device
// when that and the kernel's static shared memory (under kStaticSmem)
// pass 48 KB.  Each (kernel, device) is set once, to the most asked for:
// an eager call before a graph's capture sets it, and the capture makes
// no such call.  `allowed` is the kernel's per-device record.
cudaError_t allow_smem(const void* kernel, size_t bytes, size_t* allowed) {
  if (bytes + kStaticSmem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

template <int kTier>
cudaError_t launch_bls(const BlsArgs& a, cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(bls_steps_kernel<kTier>), a.L.smem,
      allowed);
  if (err != cudaSuccess) return err;
  const int blocks = (a.R + a.L.wpb - 1) / a.L.wpb;
  bls_steps_kernel<kTier><<<blocks, 32 * a.L.wpb, a.L.smem, stream>>>(a);
  return cudaGetLastError();
}

// Launched as the packing kernel's programmatic dependent: it may start
// before that grid ends, and waits for it where it reads the columns.
template <int kTier, bool kReg>
cudaError_t launch_greedy(const GreedyArgs& a, cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};
  const void* kernel =
      reinterpret_cast<const void*>(greedy_start_kernel<kTier, kReg>);
  const cudaError_t err = allow_smem(kernel, a.L.smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.R + a.L.wpb - 1) / a.L.wpb);
  cfg.blockDim = dim3(32 * kGreedyWarps);
  cfg.dynamicSmemBytes = a.L.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, greedy_start_kernel<kTier, kReg>, a);
}

}  // namespace

// Launches pack_columns_kernel into `scratch` and then greedy_start_kernel
// on `stream`: in_c [R, V] from orders [R, V] (int64 permutations), adj
// [V, V], valid [V] (bool), weights [V] float32.  `scratch` holds
// greedy_scratch_words(V) int32 words.
extern "C" int greedy_start_launch(const int64_t* orders, const uint8_t* adj,
                                   const uint8_t* valid, const float* weights,
                                   int R, int V, int bound, uint8_t* in_c,
                                   uint32_t* scratch, void* stream) {
  if (R <= 0 || V <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const GreedyLayout L = greedy_tiers(V);
  const long long tiles = (long long)L.nk * L.nk;
  const int aligned16 = V % 16 == 0 && (uintptr_t)adj % 16 == 0;
  pack_columns_kernel<<<(unsigned)((tiles + 7) / 8), 256, 0, st>>>(
      adj, V, L.as, aligned16, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int out4 = V % 4 == 0 && (uintptr_t)in_c % 4 == 0;
  const GreedyArgs a{orders, weights, valid, scratch, in_c, R, V, bound,
                     out4, L};
  // up to 1024 vertices the columns fit in shared memory: tier 0
  if (L.nk <= 32) err = launch_greedy<0, true>(a, st);
  else if (L.tier == 0) err = launch_greedy<0, false>(a, st);
  else if (L.tier == 1) err = launch_greedy<1, false>(a, st);
  else err = launch_greedy<2, false>(a, st);
  return (int)err;
}

// The int32 words of greedy_start_launch's `scratch` for a V-vertex graph:
// the packed columns.
extern "C" long long greedy_scratch_words(int V) {
  return greedy_tiers(V).a_words;
}

// The greedy start's layout for a V-vertex graph: out = {tier, replicas a
// block, dynamic shared memory bytes a block}.
extern "C" void greedy_layout(int V, long long* out) {
  const GreedyLayout L = greedy_tiers(V);
  out[0] = L.tier;
  out[1] = L.wpb;
  out[2] = (long long)L.smem;
}

// Launches clique_weight_kernel on `stream`: out [R] from masks [R, V]
// (bool) and weights [V] float32, a block a row.
extern "C" int clique_weight_launch(const uint8_t* masks, const float* weights,
                                    int R, int V, float* out, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  const bool vec = V % 16 == 0 && (uintptr_t)masks % 16 == 0 &&
                   (uintptr_t)weights % 16 == 0;
  auto* kernel = vec ? clique_weight_kernel<true> : clique_weight_kernel<false>;
  kernel<<<R, 32, 0, (cudaStream_t)stream>>>(masks, weights, V, out);
  return (int)cudaGetLastError();
}

// The int32 words of bls_steps_launch's `scratch` for R replicas of a
// V-vertex graph with S ring slots: the packed adjacency, and each
// replica's state where it does not fit in shared memory (tier 2).
extern "C" long long bls_scratch_words(int R, int V, int S) {
  const Layout L = layout(V, S);
  return L.a_words + (L.tier == 2 ? (long long)R * L.rep : 0);
}

// The layout of a V-vertex graph with S ring slots: out = {tier, replicas a
// block, dynamic shared memory bytes a block}.
extern "C" void bls_layout(int V, int S, long long* out) {
  const Layout L = layout(V, S);
  out[0] = L.tier;
  out[1] = L.wpb;
  out[2] = (long long)L.smem;
}

// Launches pack_columns_kernel into `scratch` and then bls_steps_kernel (n
// iterations, one warp per replica) on `stream`.  `scratch` holds
// bls_scratch_words(R, V, S) int32 words.
extern "C" int bls_steps_launch(
    const float* weights, const uint8_t* adj, const uint8_t* valid,
    const float* l0, const float* lmax, uint8_t* in_c, int32_t* tabu,
    float* fbest, uint8_t* best, uint8_t* cp, int32_t* wcnt, float* l_left,
    uint8_t* use_directed, uint8_t* sol_masks, float* sol_scores,
    int64_t* sol_next, const int32_t* it, const float* u_dir,
    const float* g_dir, const float* u_ten, const float* g_rnd,
    uint32_t* scratch, int R, int V, int S, int I, int n, int t_nonimprove,
    int phi, float p0, float alpha_s, float alpha_r, void* stream) {
  if (R <= 0 || V <= 0 || n <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout(V, S);
  const long long tiles = (long long)L.nk * L.nk;
  pack_columns_kernel<<<(unsigned)((tiles + 7) / 8), 256, 0, st>>>(
      adj, V, L.as, V % 16 == 0 && (uintptr_t)adj % 16 == 0, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int aligned16 = V % 4 == 0 && (uintptr_t)g_dir % 16 == 0 &&
                        (uintptr_t)g_rnd % 16 == 0;
  const BlsArgs a{weights, valid, scratch, l0, lmax, in_c, tabu, fbest,
                  best, cp, wcnt, l_left, use_directed, sol_masks,
                  sol_scores, sol_next, it, u_dir, g_dir, u_ten, g_rnd, V,
                  R, S, I, n, t_nonimprove, phi, p0, alpha_s, alpha_r,
                  aligned16, L};
  switch (L.tier) {
    case 0: err = launch_bls<0>(a, st); break;
    case 1: err = launch_bls<1>(a, st); break;
    default: err = launch_bls<2>(a, st); break;
  }
  return (int)err;
}
