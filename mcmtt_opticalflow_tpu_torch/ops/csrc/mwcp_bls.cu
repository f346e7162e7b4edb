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
// A third, clique_weight_kernel, sums each start clique's weights in the
// BLS kernel's order (the JAX package takes one reduction for the start's
// score and the loop's, :143 and :185), so that a clique scores the same
// in the ring whether the start or an iteration recorded it: the record's
// duplicate test compares scores within 1e-5, less than 2 ulp at the
// bench's scores of ~250.
//
// greedy_start_kernel, one block per replica.  It walks the replica's
// order (a permutation of the vertices, argsort outside the kernel) and
// admits the vertex at position i when i < bound, i < sum(valid), the
// vertex is valid with a weight >= 0 and every member of the clique so
// far is adjacent to it.  ok[u] holds the last condition for every vertex
// u: it starts true and is ANDed with adj[u][x] when x joins.  As ok only
// shrinks, a position found inadmissible stays so, and each round takes
// the first admissible position after the last admitted one with a
// block-wide min: the rounds are the clique's size plus one, not V.  It is
// integer logic only, so the result is bit-equal to the plain version's.
//
// bls_steps_kernel, one block per replica, runs n iterations in one
// launch.  The iteration number is read from the device (BlsState.it),
// the fields' rows it.. it+n-1 are read from device memory, and the state
// (membership, tabu stamps, best, previous optimum, counters, the ring of
// local optima) is written back in place; the caller advances `it` after
// the launch.  Rows at or past the fields' last are not run (the
// while_loop's condition).  Per iteration and replica:
//   - the adjacency is a bit matrix, A[k][v] bit b = adj[v][32k + b],
//     packed once per launch by pack_adj_kernel and copied to shared
//     memory when it fits (V up to about 1300; read from device memory
//     otherwise);
//   - membership, best, the previous optimum, the move sets and the ring
//     are bit sets in shared memory, the tabu stamps and weights arrays
//     there; each thread owns kPer vertices;
//   - cnt[v] = sum_k popc(A[k][v] & C[k]) gives the PA and OM sets
//     exactly; the swap partner weight of an OM vertex is the weight of
//     its single non-adjacent member (the product with ~adj sums it with
//     zeros, so it is exact in any order);
//   - the three argmaxes take torch.argmax's rule: NaN is the largest, the
//     first index wins a tie, index 0 for an empty mask (every masked
//     entry is NEG);
//   - one warp then decides the replica's move as the plain version does,
//     and only the random perturbation needs the neighbour weight sums,
//     computed then and only for free vertices whose tabu stamp is live.
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
//
// What bounds it on this card.  The bytes are the fields' rows (2 x 4 B x
// V a replica and iteration) and the state, read once: ~47 MB and ~14 us
// for a bench solve of 150 iterations.  But an iteration depends on the
// one before, so the chain's latency is what counts: a few block barriers
// and shared-memory passes an iteration.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e30f;             // models/mwcp.py's NEG
constexpr int kMaxThreads = 512;           // bls_steps_kernel's block
constexpr int kGreedyThreads = 256;
constexpr int kMaxV = 8 * kMaxThreads;     // kPer <= 8
constexpr size_t kSmemMax = 232448;        // a block's shared memory
constexpr size_t kStaticSmem = 2048;       // bls_steps_kernel's own
constexpr int kMaxDevices = 64;

// torch.argmax's order: NaN above everything, then value, then the lower
// index
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kAll, v, off);
    const int oi = __shfl_xor_sync(kAll, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ bool bit(const uint32_t* s, int v) {
  return (s[v >> 5] >> (v & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// the greedy start
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kGreedyThreads)
    greedy_start_kernel(const int64_t* __restrict__ orders,
                        const uint8_t* __restrict__ adj,
                        const uint8_t* __restrict__ valid,
                        const float* __restrict__ weights, int V, int bound,
                        uint8_t* __restrict__ in_c) {
  extern __shared__ int gsm[];
  int* ord = gsm;                                            // [V] by position
  uint8_t* adm = reinterpret_cast<uint8_t*>(ord + V);        // [V] by position
  uint8_t* ok = adm + V;                                     // [V] by vertex
  __shared__ int red[32];
  const int r = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int64_t* o = orders + (size_t)r * V;
  uint8_t* out = in_c + (size_t)r * V;

  int nv = 0;
  for (int v = tid; v < V; v += nt) nv += valid[v] != 0;
  for (int off = 16; off > 0; off >>= 1) nv += __shfl_xor_sync(kAll, nv, off);
  if (lane == 0) red[warp] = nv;
  __syncthreads();
  nv = 0;
  for (int k = 0; k < nw; ++k) nv += red[k];
  const int lim = min(bound, nv);      // positions past either admit nothing
  for (int i = tid; i < V; i += nt) {
    const int64_t x = o[i];
    const bool in_range = x >= 0 && x < V;
    ord[i] = in_range ? (int)x : 0;
    adm[i] = in_range && i < lim && valid[x] && weights[x] >= 0.0f;
    ok[i] = 1;
    out[i] = 0;
  }
  int cursor = 0;
  for (;;) {
    __syncthreads();
    int first = INT_MAX;
    for (int i = cursor + tid; i < lim; i += nt) {
      if (adm[i] && ok[ord[i]]) {
        first = i;
        break;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      first = min(first, __shfl_xor_sync(kAll, first, off));
    if (lane == 0) red[warp] = first;
    __syncthreads();
    first = INT_MAX;
    for (int k = 0; k < nw; ++k) first = min(first, red[k]);
    if (first == INT_MAX) break;
    const int x = ord[first];
    if (tid == 0) out[x] = 1;
    for (int u = tid; u < V; u += nt)
      if (ok[u] && !adj[(size_t)u * V + x]) ok[u] = 0;
    cursor = first + 1;
  }
}

// each row's clique weight, one warp a row: the members' weights added in
// ascending order from 0, as bls_steps_kernel sums fc
__global__ void clique_weight_kernel(const uint8_t* __restrict__ masks,
                                     const float* __restrict__ weights,
                                     int R, int V, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= R) return;
  const uint8_t* m = masks + (size_t)row * V;
  float s = 0.0f;
  for (int k = 0; k < V; k += 32) {
    const int c = k + lane;
    const bool in = c < V && m[c];
    const float wc = in ? weights[c] : 0.0f;
    for (unsigned bits = __ballot_sync(kAll, in); bits; bits &= bits - 1)
      s = __fadd_rn(s, __shfl_sync(kAll, wc, __ffs(bits) - 1));
  }
  if (lane == 0) out[row] = s;
}

// ---------------------------------------------------------------------------
// the BLS iterations
// ---------------------------------------------------------------------------

// A[k * V + v], bit b: adj[v][32k + b] (0 past V); one warp a row
__global__ void pack_adj_kernel(const uint8_t* __restrict__ adj, int V,
                                uint32_t* __restrict__ A) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (v >= V) return;
  const int nk = (V + 31) >> 5;
  const uint8_t* row = adj + (size_t)v * V;
  for (int k = 0; k < nk; ++k) {
    const int c = 32 * k + lane;
    const unsigned word = __ballot_sync(kAll, c < V && row[c]);
    if (lane == 0) A[(size_t)k * V + v] = word;
  }
}

struct BlsArgs {
  const float* weights;      // [V]
  const uint8_t* valid;      // [V]
  const uint32_t* A;         // [nk, V] packed adjacency (pack_adj_kernel)
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
};

// Dynamic shared memory, in bytes from its start.
struct Layout {
  size_t A, w, tabu, bits, ring, ring_s, total;
  int astride;               // words between A's rows k, k + 1
  bool a_in_smem;
};

constexpr int kBitSets = 7;  // valid, C, best, cp, PA, OM, the next C

__host__ __device__ inline Layout layout(int V, int S) {
  const int nk = (V + 31) >> 5;
  Layout L;
  L.astride = V | 1;         // odd: a row's words k, k + 1 in other banks
  const size_t a_bytes = (size_t)4 * nk * L.astride;
  const size_t rest = (size_t)8 * V + (size_t)4 * nk * (kBitSets + S) +
                      (size_t)4 * S + 64;
  L.a_in_smem = a_bytes + rest + kStaticSmem <= kSmemMax;
  size_t off = 0;
  L.A = off;
  if (L.a_in_smem) off += a_bytes;
  L.w = off;
  off += (size_t)4 * V;
  L.tabu = off;
  off += (size_t)4 * V;
  L.bits = off;
  off += (size_t)4 * nk * kBitSets;
  L.ring = off;
  off += (size_t)4 * nk * S;
  L.ring_s = off;
  off += (size_t)4 * S;
  L.total = off;
  if (!L.a_in_smem) L.astride = V;
  return L;
}

enum Move { kNone = 0, kLocal, kDirected, kRandom };

struct Scalars {
  float fc, fbest, l_left, th;
  int wcnt, csize, move, tenure, mv;
  int use_directed, use_swap;
  long long sol_next;
};

// first member of C not adjacent to v (its index, or 0 when there is
// none: argmax of an all-False mask), by one warp
__device__ __forceinline__ int first_nonadj(const uint32_t* C,
                                            const uint32_t* A, int astride,
                                            int v, int nk, int lane) {
  for (int k0 = 0; k0 < nk; k0 += 32) {
    const int k = k0 + lane;
    const unsigned m = k < nk ? C[k] & ~A[(size_t)k * astride + v] : 0u;
    const unsigned any = __ballot_sync(kAll, m != 0u);
    if (any) {
      const int src = __ffs(any) - 1;
      const unsigned mm = __shfl_sync(kAll, m, src);
      return 32 * (k0 + src) + __ffs(mm) - 1;
    }
  }
  return 0;
}

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

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
    bls_steps_kernel(const BlsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[3][32];
  __shared__ int red_i[3][32];
  __shared__ int red_n[32];
  __shared__ int red_a[32];
  __shared__ Scalars sc;
  const int r = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int V = a.V, R = a.R, S = a.S, nk = (V + 31) >> 5;
  const Layout L = layout(V, S);
  const int as = L.astride;
  uint32_t* A_s = reinterpret_cast<uint32_t*>(smem + L.A);
  const uint32_t* A = L.a_in_smem ? A_s : a.A;
  float* w = reinterpret_cast<float*>(smem + L.w);
  int32_t* tabu = reinterpret_cast<int32_t*>(smem + L.tabu);
  uint32_t* valid = reinterpret_cast<uint32_t*>(smem + L.bits);
  uint32_t* C = valid + nk;
  uint32_t* best = C + nk;
  uint32_t* cp = best + nk;
  uint32_t* pa_s = cp + nk;
  uint32_t* om_s = pa_s + nk;
  uint32_t* nxt = om_s + nk;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + L.ring);
  float* ring_s = reinterpret_cast<float*>(smem + L.ring_s);
  const size_t rv0 = (size_t)r * V;

  // ---- load the replica's state
  if (L.a_in_smem)
    for (int i = tid; i < nk * V; i += nt) {
      const int k = i / V, v = i - k * V;
      A_s[(size_t)k * as + v] = a.A[i];
    }
  for (int v = tid; v < V; v += nt) {
    w[v] = a.weights[v];
    tabu[v] = a.tabu[rv0 + v];
  }
  for (int base = warp * 32; base < nk * 32; base += nt) {
    const int v = base + lane, k = base >> 5;
    const bool in = v < V;
    const unsigned bv = __ballot_sync(kAll, in && a.valid[v]);
    const unsigned bc = __ballot_sync(kAll, in && a.in_c[rv0 + v]);
    const unsigned bb = __ballot_sync(kAll, in && a.best[rv0 + v]);
    const unsigned bp = __ballot_sync(kAll, in && a.cp[rv0 + v]);
    if (lane == 0) {
      valid[k] = bv;
      C[k] = bc;
      best[k] = bb;
      cp[k] = bp;
    }
    for (int s = 0; s < S; ++s) {
      const unsigned m = __ballot_sync(
          kAll, in && a.sol_masks[((size_t)r * S + s) * V + v]);
      if (lane == 0) ring[s * nk + k] = m;
    }
  }
  for (int s = tid; s < S; s += nt) ring_s[s] = a.sol_scores[(size_t)r * S + s];
  const int it0 = *a.it;
  const int steps = max(0, min(a.n, a.I - it0));
  if (tid == 0) {
    sc.fbest = a.fbest[r];
    sc.wcnt = a.wcnt[r];
    sc.l_left = a.l_left[r];
    sc.use_directed = a.use_directed[r] != 0;
    sc.sol_next = a.sol_next[r];
  }
  __syncthreads();
  if (warp == 0) {
    int c = 0;
    for (int k = lane; k < nk; k += 32) c += __popc(C[k]);
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kAll, c, off);
    if (lane == 0) sc.csize = c;
  }
  const float l0 = *a.l0, lmax = *a.lmax;
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int it = it0 + t;
    const size_t row = ((size_t)it * R + r) * V;
    float gd[kPer], gr[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int v = tid + j * nt;
      gd[j] = v < V ? __ldg(a.g_dir + row + v) : 0.0f;
      gr[j] = v < V ? __ldg(a.g_rnd + row + v) : 0.0f;
    }
    if (tid == 0) {                  // the clique's weight, members ascending
      float fc = 0.0f;
      for (int k = 0; k < nk; ++k)
        for (unsigned m = C[k]; m; m &= m - 1)
          fc = __fadd_rn(fc, w[32 * k + __ffs(m) - 1]);
      sc.fc = fc;
    }
    const int csize = sc.csize;

    // ---- phase A: the move sets and three argmaxes, vertex by vertex
    float bv[3] = {-INFINITY, -INFINITY, -INFINITY};
    int bi[3] = {INT_MAX, INT_MAX, INT_MAX};
    int omc = 0;
    bool dany = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int v = tid + j * nt;
      bool pa = false, om = false;
      if (v < V) {
        int cnt = 0;
        for (int k = 0; k < nk; ++k)
          cnt += __popc(A[(size_t)k * as + v] & C[k]);
        const bool in = bit(C, v);
        const bool fr = bit(valid, v) && !in;
        pa = fr && cnt == csize;
        om = fr && cnt == csize - 1 && csize > 0;
        const float wv = w[v];
        float gsw = kNeg;
        if (om) {                      // its one non-adjacent member
          for (int k = 0; k < nk; ++k) {
            const unsigned m = C[k] & ~A[(size_t)k * as + v];
            if (m) {
              gsw = __fsub_rn(wv, w[32 * k + __ffs(m) - 1]);
              break;
            }
          }
        }
        // the directed mask: PA or OM with an expired stamp, or in C
        const bool dm = ((pa || om) && tabu[v] <= it) || in;
        const float cand[3] = {pa ? wv : kNeg, gsw, dm ? gd[j] : kNeg};
#pragma unroll
        for (int q = 0; q < 3; ++q)
          if (beats(cand[q], v, bv[q], bi[q])) {
            bv[q] = cand[q];
            bi[q] = v;
          }
        omc += om;
        dany |= dm;
      }
      const unsigned bpa = __ballot_sync(kAll, pa);
      const unsigned bom = __ballot_sync(kAll, om);
      const int k = j * nw + warp;
      if (lane == 0 && k < nk) {
        pa_s[k] = bpa;
        om_s[k] = bom;
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) warp_argmax(bv[q], bi[q]);
    for (int off = 16; off > 0; off >>= 1)
      omc += __shfl_xor_sync(kAll, omc, off);
    dany = __any_sync(kAll, dany);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        red_v[q][warp] = bv[q];
        red_i[q][warp] = bi[q];
      }
      red_n[warp] = omc;
      red_a[warp] = dany;
    }
    __syncthreads();

    // ---- phase B: warp 0 decides the move, every lane alike
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        bv[q] = lane < nw ? red_v[q][lane] : -INFINITY;
        bi[q] = lane < nw ? red_i[q][lane] : INT_MAX;
        warp_argmax(bv[q], bi[q]);
      }
      omc = lane < nw ? red_n[lane] : 0;
      for (int off = 16; off > 0; off >>= 1)
        omc += __shfl_xor_sync(kAll, omc, off);
      dany = __any_sync(kAll, lane < nw && red_a[lane]);
      // an all-NEG row's argmax is index 0, as every entry ties
      const float gi = bv[0], gs = bv[1];
      const float fc = sc.fc, fbest = sc.fbest, l_left = sc.l_left;
      const int wcnt = sc.wcnt;
      const bool was_directed = sc.use_directed != 0;
      long long sol_next = sc.sol_next;
      const bool use_swap = gs > gi;
      // max(gi, gs) > 1e-9, NaN propagating as torch.maximum does
      const bool improving = !isnan(gi) && !isnan(gs) &&
                             (gi > 1e-9f || gs > 1e-9f);
      const bool searching = l_left <= 0.0f;
      const bool do_ls = searching && improving;
      const bool at_opt = searching && !improving;
      const bool better = fc > fbest;
      const bool up = at_opt && better;
      int new_w = at_opt ? (better ? 0 : wcnt + 1) : wcnt;
      const bool same_cp = !differ(C, cp, nk, lane);
      const bool esc = new_w > a.t_nonimprove;
      const float l_new =
          esc ? lmax : (same_cp ? __fadd_rn(l_left, 1.0f) : l0);
      if (at_opt && esc) new_w = 0;
      // the record: a new local optimum, unless empty, not positive or
      // already in the ring (score within 1e-5 and the same mask)
      if (at_opt && !same_cp && !esc && fc > 0.0f && csize > 0) {
        bool dup = false;
        for (int s = 0; s < S && !dup; ++s)
          dup = fabsf(__fsub_rn(ring_s[s], fc)) < 1e-5f &&
                !differ(ring + s * nk, C, nk, lane);
        if (!dup) {
          const int slot = (int)(sol_next % S);
          copy_bits(ring + slot * nk, C, nk, lane);
          if (lane == 0) ring_s[slot] = fc;
          ++sol_next;
        }
      }
      if (up) copy_bits(best, C, nk, lane);
      if (at_opt) copy_bits(cp, C, nk, lane);
      const float p =
          wcnt == 0 ? 0.0f
                    : fminf(expf(__fdiv_rn((float)(-wcnt),
                                           (float)a.t_nonimprove)),
                            a.p0);
      const bool directed = a.u_dir[(size_t)it * R + r] < p;
      const bool use_dir_now = at_opt ? directed : was_directed;
      const float new_l = at_opt ? l_new : l_left;
      const bool perturbing = l_left > 0.0f || at_opt;
      const int tenure =
          a.phi + (int)__fmul_rn(a.u_ten[(size_t)it * R + r],
                                 (float)max(omc, 1));
      const float alpha = wcnt == 0 ? a.alpha_s : a.alpha_r;
      int move = kNone;
      if (do_ls)
        move = kLocal;
      else if (perturbing)
        move = use_dir_now && dany ? kDirected : kRandom;
      __syncwarp();
      if (lane == 0) {
        sc.move = move;
        sc.mv = move == kLocal ? (use_swap ? bi[1] : bi[0]) : bi[2];
        sc.use_swap = use_swap;
        sc.tenure = tenure;
        sc.th = __fmul_rn(alpha, fc);
        sc.fbest = up ? fc : fbest;
        sc.wcnt = new_w;
        sc.l_left = do_ls ? l_left : fmaxf(__fsub_rn(new_l, 1.0f), 0.0f);
        sc.use_directed = at_opt ? directed : was_directed;
        sc.sol_next = sol_next;
      }
    }
    __syncthreads();
    const int move = sc.move;

    // ---- phase C: the random pick among free vertices whose stamp has
    // expired or whose weight sum over adjacent members reaches alpha * fc
    float rv = -INFINITY;
    int ri = INT_MAX;
    bool rany = false;
    if (move == kRandom) {
      const float th = sc.th;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int v = tid + j * nt;
        if (v < V) {
          bool pick = false;
          if (bit(valid, v) && !bit(C, v)) {
            pick = tabu[v] <= it;
            if (!pick) {                 // members ascending
              float s = 0.0f;
              for (int k = 0; k < nk; ++k)
                for (unsigned m = A[(size_t)k * as + v] & C[k]; m;
                     m &= m - 1)
                  s = __fadd_rn(s, w[32 * k + __ffs(m) - 1]);
              pick = s >= th;
            }
          }
          rany |= pick;
          const float val = pick ? gr[j] : kNeg;
          if (beats(val, v, rv, ri)) {
            rv = val;
            ri = v;
          }
        }
      }
      warp_argmax(rv, ri);
      rany = __any_sync(kAll, rany);
      if (lane == 0) {
        red_v[0][warp] = rv;
        red_i[0][warp] = ri;
        red_a[warp] = rany;
      }
      __syncthreads();
    }

    // ---- the move, by warp 0: the next C, then the stamps of the
    // vertices that left it
    if (warp == 0 && move != kNone) {
      bool changed = true;
      if (move == kRandom) {
        rv = lane < nw ? red_v[0][lane] : -INFINITY;
        ri = lane < nw ? red_i[0][lane] : INT_MAX;
        warp_argmax(rv, ri);
        changed = __any_sync(kAll, lane < nw && red_a[lane]);
        if (changed) {                   // (C & adj[ri]) | {ri}
          for (int k = lane; k < nk; k += 32)
            nxt[k] = C[k] & A[(size_t)k * as + ri];
          __syncwarp();
          if (lane == 0) nxt[ri >> 5] |= 1u << (ri & 31);
        }
      } else {
        const int x = sc.mv;
        const int partner = first_nonadj(C, A, as, x, nk, lane);
        copy_bits(nxt, C, nk, lane);
        __syncwarp();
        if (lane == 0) {
          if (move == kLocal) {          // insert x, or swap it in
            nxt[x >> 5] |= 1u << (x & 31);
            if (sc.use_swap) nxt[partner >> 5] &= ~(1u << (partner & 31));
          } else {                       // directed: remove, insert, swap
            const bool rem = bit(C, x);
            if (rem)
              nxt[x >> 5] &= ~(1u << (x & 31));
            else
              nxt[x >> 5] |= 1u << (x & 31);
            if (bit(om_s, x) && !rem)
              nxt[partner >> 5] &= ~(1u << (partner & 31));
          }
        }
      }
      if (changed) {
        __syncwarp();
        const int stamp = it + sc.tenure;
        int c = 0;
        for (int k = lane; k < nk; k += 32) {
          for (unsigned m = C[k] & ~nxt[k]; m; m &= m - 1)
            tabu[32 * k + __ffs(m) - 1] = stamp;
          C[k] = nxt[k];
          c += __popc(nxt[k]);
        }
        for (int off = 16; off > 0; off >>= 1)
          c += __shfl_xor_sync(kAll, c, off);
        if (lane == 0) sc.csize = c;
      }
    }
    __syncthreads();
  }

  // ---- write the state back
  for (int v = tid; v < V; v += nt) {
    a.in_c[rv0 + v] = bit(C, v);
    a.best[rv0 + v] = bit(best, v);
    a.cp[rv0 + v] = bit(cp, v);
    a.tabu[rv0 + v] = tabu[v];
  }
  for (int i = tid; i < S * V; i += nt) {
    const int s = i / V, v = i - s * V;
    a.sol_masks[(size_t)r * S * V + i] = bit(ring + s * nk, v);
  }
  for (int s = tid; s < S; s += nt) a.sol_scores[(size_t)r * S + s] = ring_s[s];
  if (tid == 0) {
    a.fbest[r] = sc.fbest;
    a.wcnt[r] = sc.wcnt;
    a.l_left[r] = sc.l_left;
    a.use_directed[r] = (uint8_t)sc.use_directed;
    a.sol_next[r] = sc.sol_next;
  }
}

int per_thread(int V) {
  return V <= kMaxThreads ? 1 : V <= 2 * kMaxThreads ? 2
                              : V <= 4 * kMaxThreads ? 4 : 8;
}

// Allows `kernel` `bytes` of dynamic shared memory on the current device
// when above 48 KB.  Each (kernel, device) is set once, to the most asked
// for: an eager call before a graph's capture sets it, and the capture
// makes no such call.  `allowed` is the kernel's per-device record.
cudaError_t allow_smem(const void* kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
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

template <int kPer>
cudaError_t launch_bls(const BlsArgs& a, cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};
  const Layout L = layout(a.V, a.S);
  const int threads = ((a.V + kPer - 1) / kPer + 31) / 32 * 32;
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(bls_steps_kernel<kPer>), L.total,
      allowed);
  if (err != cudaSuccess) return err;
  bls_steps_kernel<kPer><<<a.R, threads, L.total, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mwcp_max_vertices() { return kMaxV; }

// Launches greedy_start_kernel on `stream`: in_c [R, V] from orders [R, V]
// (int64 permutations), adj [V, V], valid [V] (bool), weights [V] float32.
extern "C" int greedy_start_launch(const int64_t* orders, const uint8_t* adj,
                                   const uint8_t* valid, const float* weights,
                                   int R, int V, int bound, uint8_t* in_c,
                                   void* stream) {
  if (R <= 0 || V <= 0) return (int)cudaSuccess;
  static size_t allowed[kMaxDevices] = {};
  const size_t smem = (size_t)6 * V;
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(greedy_start_kernel), smem, allowed);
  if (err != cudaSuccess) return (int)err;
  greedy_start_kernel<<<R, kGreedyThreads, smem, (cudaStream_t)stream>>>(
      orders, adj, valid, weights, V, bound, in_c);
  return (int)cudaGetLastError();
}

// Launches clique_weight_kernel on `stream`: out [R] from masks [R, V]
// (bool) and weights [V] float32.
extern "C" int clique_weight_launch(const uint8_t* masks, const float* weights,
                                    int R, int V, float* out, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  clique_weight_kernel<<<(R + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      masks, weights, R, V, out);
  return (int)cudaGetLastError();
}

// Launches pack_adj_kernel into `packed` ([ceil(V/32), V] words) and then
// bls_steps_kernel (n iterations, one block per replica) on `stream`.
extern "C" int bls_steps_launch(
    const float* weights, const uint8_t* adj, const uint8_t* valid,
    const float* l0, const float* lmax, uint8_t* in_c, int32_t* tabu,
    float* fbest, uint8_t* best, uint8_t* cp, int32_t* wcnt, float* l_left,
    uint8_t* use_directed, uint8_t* sol_masks, float* sol_scores,
    int64_t* sol_next, const int32_t* it, const float* u_dir,
    const float* g_dir, const float* u_ten, const float* g_rnd,
    uint32_t* packed, int R, int V, int S, int I, int n, int t_nonimprove,
    int phi, float p0, float alpha_s, float alpha_r, void* stream) {
  if (R <= 0 || V <= 0 || n <= 0) return (int)cudaSuccess;
  if (V > kMaxV) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  pack_adj_kernel<<<(V + 7) / 8, 256, 0, st>>>(adj, V, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const BlsArgs a{weights, valid, packed, l0, lmax, in_c, tabu, fbest, best,
                  cp, wcnt, l_left, use_directed, sol_masks, sol_scores,
                  sol_next, it, u_dir, g_dir, u_ten, g_rnd, V, R, S, I, n,
                  t_nonimprove, phi, p0, alpha_s, alpha_r};
  switch (per_thread(V)) {
    case 1: err = launch_bls<1>(a, st); break;
    case 2: err = launch_bls<2>(a, st); break;
    case 4: err = launch_bls<4>(a, st); break;
    default: err = launch_bls<8>(a, st); break;
  }
  return (int)err;
}
