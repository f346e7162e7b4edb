// Exact min-cost linear assignment (Jonker-Volgenant shortest augmenting
// paths with column potentials) of a batch of cost matrices, for sm_90a.
//
// Replaces the JAX package's device loops of
//   mcmtt_opticalflow_tpu/ops/hungarian.py::solve_assignment (:54-169),
//   vmapped over cameras as solve_assignment_batch (:172),
// which the 2D tracker runs inside its jitted step (models/tracker2d.py:
// 377-379).  Those loops are XLA while_loops, not a Pallas kernel.  The
// arithmetic is theirs, float32 in the same order, so the matching is
// bit-equal to the plain version (ops/hungarian.py::jv_assign_reference):
//   - forbidden entries (inf, masked row or column) become
//     big = ((maxfin + 100) - minfin) / span, the rest
//     (cost - minfin) / span with span = max(maxfin - minfin, 1); IEEE
//     division (nvcc's default -prec-div=true) and no multiply-add
//     contraction (-fmad=false; there are no products here anyway);
//   - rows are processed in order; a masked row changes nothing (the JAX
//     cond); each Dijkstra step takes the argmin of the reduced distances
//     with visited columns at 1e18, ties to the lowest index as
//     jnp.argmin, and relaxes through the column's owner with
//     nd = (dj + (w[i2] - v)) - (w[i2, j] - v[j]);
//   - the potentials of the scanned columns but the sink become
//     (v + dist) - dsink; the augmenting walk follows the parents back
//     from the sink;
//   - with more rows than columns the transposed problem is solved (the
//     JAX function's :75-88) and the matching read from the column side.
//
// What bounds it on this card.  The work is tiny (a bench frame's
// [4, 48, 64] matrices are 49 KB and a few hundred thousand operations: a
// bound well under a microsecond), and it is a serial chain: every
// Dijkstra step needs the argmin of the step before, and the walk chases
// pointers.  So the latency of one step is what counts, times the number
// of steps (the sum over rows of each row's Dijkstra steps, printed by
// chip_smoke.py).
//
// What this design does.  One block a camera: its eight warps normalise
// the matrix (the only pass over all of it; each thread's entries and
// their masks loaded at once, the divisions on safe operands so they
// overlap), then warp 0 alone runs the rows, with no block barrier left.
// Lane l owns the working columns l, l + 32, ... .  Where the columns
// number at most 256 (kN = 1, 2, 4 or 8 a lane) everything a step touches
// but the matrix lives in registers: each column's distance, potential,
// parent and owning row, each row's column (rows <= columns), and the
// visited columns as a bit mask.  A step is then, with selects and no
// branch but the sink's:
//   - each lane's best column by an order-preserving integer key (visited
//     columns at 1e18's key, the lower index first), carrying its value,
//     owner and potential along, and (off the chain) the base its owner's
//     row would give;
//   - one REDUX for the least key and a ballot of the lanes holding it; a
//     second REDUX for the least column among them only on a tie
//     (jnp.argmin's rule);
//   - four independent shuffles from that lane: the column, its
//     distance, its owner, the base;
//   - the relaxation through the owner's row: a shared load a column.
// The augmenting walk reads parents and row matches by shuffles too, and
// every lane follows it, so the matching stays in registers.  Only the
// normalised rows (and the rows' flags) stay in memory: in shared memory
// where they fit, else in device memory (the wrapper's scratch; L2).
// Past 256 columns the column state cannot stay in registers: kN = 0
// keeps it in shared memory (or the scratch where even that does not fit)
// and loops over it, a lane's columns at a time, with the same argmin.
// The host's `layout` picks the variant and the tiers from (rows,
// columns), so no size is refused.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;        // the block normalises; warp 0 solves
constexpr int kWarps = kThreads / kLanes;
constexpr float kVisited = 1e18f;    // hungarian.py's _INF
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kSmemMax = 232448;  // a block's shared memory
constexpr size_t kStaticSmem = 256;  // the kernel's own, at most
constexpr int kMaxDevices = 64;
constexpr int kBatch = 16;           // entries a thread loads at once

// Where a launch keeps what; sizes in 4-byte words, per camera.
struct Layout {
  int nr, nc;           // the working matrix, nr <= nc
  int transposed;       // its rows are the columns of `cost`
  int ncl;              // columns a lane holds in registers (1, 2, 4, 8);
                        // 0: the column state in memory
  int w_smem;           // the normalised rows in shared memory, else in
                        // the scratch
  int state_smem;       // (ncl == 0) the column state in shared memory,
                        // else in the scratch
  long long w_words;    // nr x nc
  long long state_words;  // ncl == 0: v, dist, par, x [nc], y [nr],
                          // then visited [nc] and the row flags [nr] as
                          // bytes; else the row flags alone
  long long scratch;    // the scratch's words a camera
  size_t smem;          // dynamic shared memory a block, bytes
};

Layout layout(int R, int T) {
  Layout L{};
  L.transposed = R > T;
  L.nr = L.transposed ? T : R;
  L.nc = L.transposed ? R : T;
  const int nc = L.nc;
  L.ncl = nc <= 32 ? 1 : nc <= 64 ? 2 : nc <= 128 ? 4 : nc <= 256 ? 8 : 0;
  L.w_words = (long long)L.nr * nc;
  L.state_words = L.ncl ? (L.nr + 3) / 4
                        : 4LL * nc + L.nr + (nc + L.nr + 3) / 4;
  const long long avail = (long long)(kSmemMax - kStaticSmem) / 4;
  // the register variants keep their row flags in shared memory always
  // (at most 64 words)
  L.w_smem = L.w_words + L.state_words <= avail;
  L.state_smem = L.w_smem || L.ncl || L.state_words <= avail;
  L.smem = 4 * (size_t)((L.w_smem ? L.w_words : 0) +
                        (L.state_smem ? L.state_words : 0));
  L.scratch = (L.w_smem ? 0 : L.w_words) +
              (L.state_smem ? 0 : L.state_words);
  return L;
}

// An int whose signed order is the order of the float values (finite or
// infinite), -0 equal to +0: the index breaks ties.
__device__ __forceinline__ int min_key(float f) {
  if (f == 0.0f) return 0;
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// a[k] for a register array and a k known only at run time, without
// putting the array in local memory
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&a)[N], int k) {
  T r = a[0];
#pragma unroll
  for (int t = 1; t < N; ++t) r = t == k ? a[t] : r;
  return r;
}

template <int N, typename T>
__device__ __forceinline__ void put(T (&a)[N], int k, T val, bool mine) {
#pragma unroll
  for (int t = 0; t < N; ++t)
    if (mine && t == k) a[t] = val;
}

// The least key across the warp and the least column holding it: the
// column jnp.argmin picks.
__device__ __forceinline__ int warp_argmin(int key, int col) {
  const int kmin = __reduce_min_sync(kAll, key);
  return (int)__reduce_min_sync(kAll,
                                key == kmin ? (unsigned)col : 0xffffffffu);
}

// One block per camera; see the file's comment.  kN > 0: the column state
// in registers, kN columns a lane, the rows in shared memory (kWS) or the
// scratch.  kN == 0: the column state in memory, as the layout says.
template <int kN, bool kWS>
__global__ void __launch_bounds__(kThreads)
    jv_assign_kernel(const float* __restrict__ cost,
                     const uint8_t* __restrict__ row_mask,
                     const uint8_t* __restrict__ col_mask, int R, int T,
                     const Layout L, float* __restrict__ scratch,
                     int32_t* __restrict__ col_of_row,
                     float* __restrict__ match_cost) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_mx[kWarps], red_mn[kWarps];
  const int cam = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & (kLanes - 1), warp = tid / kLanes;
  const float* c0 = cost + (size_t)cam * R * T;
  const uint8_t* rm = row_mask + (size_t)cam * R;
  const uint8_t* cm = col_mask + (size_t)cam * T;
  const int nr = L.nr, nc = L.nc;
  const bool tr = L.transposed;
  float* sc = scratch + (size_t)cam * L.scratch;
  const bool w_smem = kN ? kWS : L.w_smem;
  float* w = w_smem ? smem : sc;
  float* state = kN || L.state_smem ? smem + (w_smem ? L.w_words : 0)
                                    : sc + (w_smem ? 0 : L.w_words);
  // each working row's flag: the whole state of the register variants,
  // after visited in the other
  uint8_t* row_ok = reinterpret_cast<uint8_t*>(kN ? state
                                                  : state + 4 * nc + nr) +
                    (kN ? 0 : nc);

  // ---- the block: span normalisation over the finite, unmasked entries,
  // read in the cost's own order (coalesced), kBatch entries a thread with
  // their masks loaded at once (no load waits on another), written in the
  // working order
  const int RT = R * T;
  // entry e = r * T + t of a thread's batch advances by kThreads: r by
  // dq, t by dt (one division a batch, not one an entry)
  const int dq = T ? kThreads / T : 0, dt = kThreads - dq * T;
  float a[kBatch];
  bool f[kBatch];
  auto load = [&](int e0) {
    int e = e0 + tid, r = e / T, t = e - r * T;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      a[u] = c0[min(e, RT - 1)];
      f[u] = (e < RT) & (rm[min(r, R - 1)] != 0) & (cm[t] != 0);
      e += kThreads;
      r += dq;
      t += dt;
      if (t >= T) {
        t -= T;
        ++r;
      }
    }
  };
  float mx = -INFINITY, mn = INFINITY;
  for (int e0 = 0; e0 < RT; e0 += kThreads * kBatch) {
    load(e0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool use = f[u] && isfinite(a[u]);
      mx = use ? fmaxf(mx, a[u]) : mx;
      mn = use ? fminf(mn, a[u]) : mn;
    }
  }
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
    mn = fminf(mn, __shfl_xor_sync(kAll, mn, off));
  }
  if (lane == 0) {
    red_mx[warp] = mx;
    red_mn[warp] = mn;
  }
  __syncthreads();
  mx = red_mx[0];
  mn = red_mn[0];
  for (int k = 1; k < kWarps; ++k) {
    mx = fmaxf(mx, red_mx[k]);
    mn = fminf(mn, red_mn[k]);
  }
  const float maxfin = isfinite(mx) ? mx : 0.0f;
  const float minfin = isfinite(mn) ? mn : 0.0f;
  const float span = fmaxf(__fsub_rn(maxfin, minfin), 1.0f);
  const float big =
      __fdiv_rn(__fsub_rn(__fadd_rn(maxfin, 100.0f), minfin), span);
  // one batch (the tracker's shapes): its entries are still in registers
  const bool one = RT <= kThreads * kBatch;
  for (int e0 = 0; e0 < RT; e0 += kThreads * kBatch) {
    if (!one) load(e0);
    int e = e0 + tid, r = e / T, t = e - r * T;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // every entry divides, a forbidden one or a zero span / span: a
      // numerator that is not inf or 0 keeps the division off its slow
      // path (+-0 / span is +-0)
      const bool use = f[u] && isfinite(a[u]);
      const float num = __fsub_rn(a[u], minfin);
      const bool zero = num == 0.0f;
      const float q = __fdiv_rn(use && !zero ? num : span, span);
      if (e < RT)
        w[tr ? (size_t)t * nc + r : (size_t)r * nc + t] =
            use ? (zero ? num : q) : big;
      e += kThreads;
      r += dq;
      t += dt;
      if (t >= T) {
        t -= T;
        ++r;
      }
    }
  }
  for (int i = tid; i < nr; i += kThreads) row_ok[i] = tr ? cm[i] : rm[i];
  __syncthreads();
  if (warp != 0) return;             // no block barrier after this

  if constexpr (kN > 0) {
    // ---- warp 0, the column state in registers
    float v[kN], dist[kN];
    int par[kN], x[kN], y[kN];       // x: each column's row; y: each row's
    int pcol[kN];                    // the column matched to par (y[par])
    int jc[kN];                      // the lane's columns, clamped to nc
    uint32_t live = 0;               // the lane's columns below nc
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      v[t] = dist[t] = 0.0f;
      par[t] = 0;
      x[t] = y[t] = pcol[t] = -1;
      jc[t] = min(lane + kLanes * t, nc - 1);
      if (lane + kLanes * t < nc) live |= 1u << t;
    }
    const int vis_key = min_key(kVisited);
    for (int i = 0; i < nr; ++i) {
      if (!row_ok[i]) continue;      // a masked row changes nothing
      const float* wi = w + (size_t)i * nc;
      uint32_t vis = 0;
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        dist[t] = __fsub_rn(wi[jc[t]], v[t]);
        par[t] = i;
        pcol[t] = -1;
      }
      int sink;
      float dsink;
      for (;;) {
        // the lane's best column, its value, owner and potential, and
        // (while the warp reduces) the base its owner's row would give;
        // selects, no branches
        int lk = INT_MAX, lj = 0, lown = -1;
        float lval = 0.0f, lpot = 0.0f;
#pragma unroll
        for (int t = 0; t < kN; ++t) {
          const bool seen = (vis >> t) & 1;
          const float d = seen ? kVisited : dist[t];
          const int k = (live >> t) & 1 ? (seen ? vis_key : min_key(d))
                                        : INT_MAX;
          const bool better = k < lk;
          lk = better ? k : lk;
          lj = better ? lane + kLanes * t : lj;
          lval = better ? d : lval;
          lown = better ? x[t] : lown;
          lpot = better ? v[t] : lpot;
        }
        const float lbase =
            lown >= 0 ? __fsub_rn(w[(size_t)lown * nc + lj], lpot) : 0.0f;
        // the lane of the least key; where several hold it, of the least
        // column among them
        const int kmin = __reduce_min_sync(kAll, lk);
        const unsigned at = __ballot_sync(kAll, lk == kmin);
        const int src =
            at & (at - 1)
                ? (int)__reduce_min_sync(
                      kAll, lk == kmin ? (unsigned)lj : 0xffffffffu) &
                      (kLanes - 1)
                : __ffs(at) - 1;
        const int bj = __shfl_sync(kAll, lj, src);
        const float dj = __shfl_sync(kAll, lval, src);
        const int owner = __shfl_sync(kAll, lown, src);
        const float base = __shfl_sync(kAll, lbase, src);
        if (lane == src) vis |= 1u << (bj / kLanes);
        if (owner < 0) {               // a free column: the sink
          sink = bj;
          dsink = dj;
          break;
        }
        // relax through the owner's row (a lane's columns past nc read
        // the row's last entry and change nothing)
        const float* w2 = w + (size_t)owner * nc;
        const uint32_t open = live & ~vis;
#pragma unroll
        for (int t = 0; t < kN; ++t) {
          const float nd = __fsub_rn(
              __fadd_rn(dj, __fsub_rn(w2[jc[t]], v[t])), base);
          const bool upd = ((open >> t) & 1) && nd < dist[t];
          dist[t] = upd ? nd : dist[t];
          par[t] = upd ? owner : par[t];
          pcol[t] = upd ? bj : pcol[t];    // y[owner] until the walk
        }
      }
      // potentials of the scanned columns (keeps reduced costs >= 0)
#pragma unroll
      for (int t = 0; t < kN; ++t)
        if (((vis >> t) & 1) && lane + kLanes * t != sink)
          v[t] = __fsub_rn(__fadd_rn(v[t], dist[t]), dsink);
      // augment back from the sink, every lane on the same walk; a
      // parent's column is y[parent] (the walk visits a row once), so
      // both come by two independent shuffles
      for (int j = sink;;) {
        const int i2 =
            __shfl_sync(kAll, pick(par, j / kLanes), j & (kLanes - 1));
        const int pj =
            __shfl_sync(kAll, pick(pcol, j / kLanes), j & (kLanes - 1));
        put(y, i2 / kLanes, j, lane == (i2 & (kLanes - 1)));
        put(x, j / kLanes, i2, lane == (j & (kLanes - 1)));
        j = pj;
        if (i2 == i) break;
      }
    }
    // the matching of each row of `cost`: the working rows, or with the
    // transpose the working columns; a match on a forbidden entry is
    // reported unmatched
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      const int r = lane + kLanes * t;
      if (r >= R) continue;
      const int col = tr ? x[t] : y[t];
      float mc = INFINITY;
      bool ok = col >= 0;
      if (ok) {
        mc = c0[(size_t)r * T + col];
        ok = isfinite(mc) && rm[r] && cm[col];
      }
      col_of_row[(size_t)cam * R + r] = ok ? col : -1;
      match_cost[(size_t)cam * R + r] = ok ? mc : INFINITY;
    }
  } else {
    // ---- warp 0, the column state in memory, a lane's columns at a time
    float* v = state;
    float* dist = v + nc;
    int* par = reinterpret_cast<int*>(dist + nc);
    int* x = par + nc;               // working row owning each column
    int* y = x + nc;                 // working column of each row
    uint8_t* visited = reinterpret_cast<uint8_t*>(y + nr);  // row_ok after
    for (int j = lane; j < nc; j += kLanes) {
      v[j] = 0.0f;
      x[j] = -1;
    }
    for (int i = lane; i < nr; i += kLanes) y[i] = -1;
    __syncwarp();
    const int vis_key = min_key(kVisited);
    for (int i = 0; i < nr; ++i) {
      if (!row_ok[i]) continue;
      const float* wi = w + (size_t)i * nc;
      for (int j = lane; j < nc; j += kLanes) {
        dist[j] = __fsub_rn(wi[j], v[j]);
        par[j] = i;
        visited[j] = 0;
      }
      int sink;
      float dsink;
      for (;;) {
        int lk = INT_MAX, lj = 0;
        float lval = 0.0f;
#pragma unroll 4
        for (int j = lane; j < nc; j += kLanes) {
          const bool seen = visited[j];
          const float d = seen ? kVisited : dist[j];
          const int k = seen ? vis_key : min_key(d);
          if (k < lk) {
            lk = k;
            lj = j;
            lval = d;
          }
        }
        const int bj = warp_argmin(lk, lj);
        const float dj = __shfl_sync(kAll, lval, bj & (kLanes - 1));
        if (lane == (bj & (kLanes - 1))) visited[bj] = 1;
        const int owner = x[bj];
        if (owner < 0) {
          sink = bj;
          dsink = dj;
          break;
        }
        const float* w2 = w + (size_t)owner * nc;
        const float base = __fsub_rn(w2[bj], v[bj]);
#pragma unroll 4
        for (int j = lane; j < nc; j += kLanes) {
          if (!visited[j]) {
            const float nd =
                __fsub_rn(__fadd_rn(dj, __fsub_rn(w2[j], v[j])), base);
            if (nd < dist[j]) {
              dist[j] = nd;
              par[j] = owner;
            }
          }
        }
      }
      for (int j = lane; j < nc; j += kLanes)
        if (visited[j] && j != sink)
          v[j] = __fsub_rn(__fadd_rn(v[j], dist[j]), dsink);
      __syncwarp();
      if (lane == 0) {
        for (int j = sink;;) {
          const int i2 = par[j];
          const int pj = y[i2];
          y[i2] = j;
          x[j] = i2;
          j = pj;
          if (i2 == i) break;
        }
      }
      __syncwarp();
    }
    for (int r = lane; r < R; r += kLanes) {
      const int col = tr ? x[r] : y[r];
      float mc = INFINITY;
      bool ok = col >= 0;
      if (ok) {
        mc = c0[(size_t)r * T + col];
        ok = isfinite(mc) && rm[r] && cm[col];
      }
      col_of_row[(size_t)cam * R + r] = ok ? col : -1;
      match_cost[(size_t)cam * R + r] = ok ? mc : INFINITY;
    }
  }
}

// Allows `kernel` `bytes` of dynamic shared memory on the current device
// when that and its static shared memory pass 48 KB, once per (kernel,
// device) and size: an eager call before a graph's capture sets it.
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

template <int kN, bool kWS>
cudaError_t launch(const float* cost, const uint8_t* row_mask,
                   const uint8_t* col_mask, int C, int R, int T,
                   const Layout& L, float* scratch, int32_t* col_of_row,
                   float* match_cost, cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(jv_assign_kernel<kN, kWS>), L.smem,
      allowed);
  if (err != cudaSuccess) return err;
  jv_assign_kernel<kN, kWS><<<C, kThreads, L.smem, stream>>>(
      cost, row_mask, col_mask, R, T, L, scratch, col_of_row, match_cost);
  return cudaGetLastError();
}

}  // namespace

// The float32 words of jv_assign_launch's `scratch` a camera for [R, T]
// matrices: the normalised rows and the column state where they do not
// fit in shared memory (0 at the tracker's shapes).
extern "C" long long jv_scratch_words(int R, int T) {
  return layout(R, T).scratch;
}

// The layout of [R, T] matrices: out = {columns a lane in registers (0:
// the column state in memory), rows in shared memory, column state in
// shared memory, dynamic shared memory bytes a block}.
extern "C" void jv_layout(int R, int T, long long* out) {
  const Layout L = layout(R, T);
  out[0] = L.ncl;
  out[1] = L.w_smem;
  out[2] = L.state_smem;
  out[3] = (long long)L.smem;
}

// Launches on `stream`; `scratch` holds C x jv_scratch_words(R, T) words.
extern "C" int jv_assign_launch(const float* cost, const uint8_t* row_mask,
                                const uint8_t* col_mask, int C, int R, int T,
                                int32_t* col_of_row, float* match_cost,
                                float* scratch, void* stream) {
  if (C <= 0 || R <= 0) return (int)cudaSuccess;
  const Layout L = layout(R, T);
  const cudaStream_t st = (cudaStream_t)stream;
#define JV_LAUNCH(N, WS)                                                     \
  launch<N, WS>(cost, row_mask, col_mask, C, R, T, L, scratch, col_of_row, \
                match_cost, st)
  cudaError_t err;
  switch (L.ncl) {
    // up to 128 columns the rows always fit in shared memory (64 KB)
    case 1: err = JV_LAUNCH(1, true); break;
    case 2: err = JV_LAUNCH(2, true); break;
    case 4: err = JV_LAUNCH(4, true); break;
    case 8: err = L.w_smem ? JV_LAUNCH(8, true) : JV_LAUNCH(8, false); break;
    default: err = JV_LAUNCH(0, false); break;
  }
#undef JV_LAUNCH
  return (int)err;
}
