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
// What this design does.  One block of one warp per camera: a step is a
// pass of each lane over its columns (j = lane, lane + 32, ...) and a
// 5-round shuffle argmin, with no block barrier in the loop.  The
// normalised matrix, the potentials, distances, parents, visited flags
// and both sides of the matching live in shared memory (12.8 KB at the
// bench's [48, 64]).  Each lane owns its columns' distances, parents and
// visited flags, so a step needs no synchronisation beyond the shuffles;
// one __syncwarp orders the potentials and parents before lane 0 walks
// the augmenting path, and one more orders the matching before the next
// row.  The cameras run in parallel on separate SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr float kVisited = 1e18f;   // hungarian.py's _INF
constexpr unsigned kAll = 0xffffffffu;

// One camera's problem, seen as the working matrix with nr <= nc.
struct Problem {
  const float* cost;     // [R, T]
  const uint8_t* rm;     // [R]
  const uint8_t* cm;     // [T]
  int T;
  bool transposed;       // working rows are the columns of `cost`
  __device__ float at(int i, int j) const {
    return transposed ? cost[(size_t)j * T + i] : cost[(size_t)i * T + j];
  }
  __device__ bool row_ok(int i) const { return transposed ? cm[i] : rm[i]; }
  __device__ bool col_ok(int j) const { return transposed ? rm[j] : cm[j]; }
};

size_t smem_bytes(int nr, int nc) {
  // w [nr, nc], v, dist [nc] f32; par, x [nc], y [nr] int; visited [nc]
  return (size_t)nr * nc * 4 + (size_t)nc * 16 + (size_t)nr * 4 + nc;
}

__global__ void __launch_bounds__(kLanes)
    jv_assign_kernel(const float* __restrict__ cost,
                     const uint8_t* __restrict__ row_mask,
                     const uint8_t* __restrict__ col_mask, int R, int T,
                     int32_t* __restrict__ col_of_row,
                     float* __restrict__ match_cost) {
  const int cam = blockIdx.x;
  const int lane = threadIdx.x;
  const Problem p{cost + (size_t)cam * R * T, row_mask + (size_t)cam * R,
                  col_mask + (size_t)cam * T, T, R > T};
  const int nr = p.transposed ? T : R;
  const int nc = p.transposed ? R : T;

  extern __shared__ float smem[];
  float* w = smem;
  float* v = w + (size_t)nr * nc;
  float* dist = v + nc;
  int* par = reinterpret_cast<int*>(dist + nc);
  int* x = par + nc;         // working row owning each column, -1 free
  int* y = x + nc;           // working column of each row, -1 unmatched
  uint8_t* visited = reinterpret_cast<uint8_t*>(y + nr);

  // span normalisation over the finite, unmasked entries
  float mx = -INFINITY, mn = INFINITY;
  for (int k = lane; k < nr * nc; k += kLanes) {
    const int i = k / nc, j = k - i * nc;
    const float a = p.at(i, j);
    if (isfinite(a) && p.row_ok(i) && p.col_ok(j)) {
      mx = fmaxf(mx, a);
      mn = fminf(mn, a);
    }
  }
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
    mn = fminf(mn, __shfl_xor_sync(kAll, mn, off));
  }
  const float maxfin = isfinite(mx) ? mx : 0.0f;
  const float minfin = isfinite(mn) ? mn : 0.0f;
  const float span = fmaxf(__fsub_rn(maxfin, minfin), 1.0f);
  const float big =
      __fdiv_rn(__fsub_rn(__fadd_rn(maxfin, 100.0f), minfin), span);
  for (int k = lane; k < nr * nc; k += kLanes) {
    const int i = k / nc, j = k - i * nc;
    const float a = p.at(i, j);
    w[k] = (isfinite(a) && p.row_ok(i) && p.col_ok(j))
               ? __fdiv_rn(__fsub_rn(a, minfin), span)
               : big;
  }
  for (int j = lane; j < nc; j += kLanes) {
    v[j] = 0.0f;
    x[j] = -1;
  }
  for (int i = lane; i < nr; i += kLanes) y[i] = -1;
  __syncwarp();

  for (int i = 0; i < nr; ++i) {
    if (!p.row_ok(i)) continue;          // a masked row changes nothing
    const float* wi = w + (size_t)i * nc;
    for (int j = lane; j < nc; j += kLanes) {
      dist[j] = __fsub_rn(wi[j], v[j]);
      par[j] = i;
      visited[j] = 0;
    }
    int sink;
    float dsink;
    for (;;) {
      // argmin over the columns, visited ones at 1e18, lowest index on ties
      float bv = INFINITY;
      int bj = nc;
      for (int j = lane; j < nc; j += kLanes) {
        const float d = visited[j] ? kVisited : dist[j];
        if (d < bv) {
          bv = d;
          bj = j;
        }
      }
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kAll, bv, off);
        const int oj = __shfl_xor_sync(kAll, bj, off);
        if (ov < bv || (ov == bv && oj < bj)) {
          bv = ov;
          bj = oj;
        }
      }
      if (bj % kLanes == lane) visited[bj] = 1;
      const int owner = x[bj];
      if (owner < 0) {                   // a free column: the sink
        sink = bj;
        dsink = bv;
        break;
      }
      // relax through the owner's row
      const float* w2 = w + (size_t)owner * nc;
      const float base = __fsub_rn(w2[bj], v[bj]);
      for (int j = lane; j < nc; j += kLanes) {
        if (!visited[j]) {
          const float nd =
              __fsub_rn(__fadd_rn(bv, __fsub_rn(w2[j], v[j])), base);
          if (nd < dist[j]) {
            dist[j] = nd;
            par[j] = owner;
          }
        }
      }
    }
    // potentials of the scanned columns (keeps reduced costs >= 0)
    for (int j = lane; j < nc; j += kLanes) {
      if (visited[j] && j != sink)
        v[j] = __fsub_rn(__fadd_rn(v[j], dist[j]), dsink);
    }
    __syncwarp();
    if (lane == 0) {                     // augment back from the sink
      int j = sink;
      for (;;) {
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

  // the matching of each row of `cost`: rows are the working rows, or
  // with the transpose the working columns; a match on a forbidden entry
  // is reported unmatched
  const float* c0 = p.cost;
  for (int r = lane; r < R; r += kLanes) {
    const int col = p.transposed ? x[r] : y[r];
    float mc = INFINITY;
    bool ok = col >= 0;
    if (ok) {
      mc = c0[(size_t)r * T + col];
      ok = isfinite(mc) && p.rm[r] && p.cm[col];
    }
    col_of_row[(size_t)cam * R + r] = ok ? col : -1;
    match_cost[(size_t)cam * R + r] = ok ? mc : INFINITY;
  }
}

}  // namespace

// Launches on `stream`; a shape whose shared memory exceeds a block's
// (227 KB) makes cudaFuncSetAttribute fail, and its error is returned.
extern "C" int jv_assign_launch(const float* cost, const uint8_t* row_mask,
                                const uint8_t* col_mask, int C, int R, int T,
                                int32_t* col_of_row, float* match_cost,
                                void* stream) {
  if (C <= 0 || R <= 0) return (int)cudaSuccess;
  const size_t smem = R > T ? smem_bytes(T, R) : smem_bytes(R, T);
  // above 48 KB a block's dynamic shared memory must be allowed first, on
  // the current device (the attribute is per device: set it every time)
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jv_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  jv_assign_kernel<<<C, kLanes, smem, (cudaStream_t)stream>>>(
      cost, row_mask, col_mask, R, T, col_of_row, match_cost);
  return (int)cudaGetLastError();
}
