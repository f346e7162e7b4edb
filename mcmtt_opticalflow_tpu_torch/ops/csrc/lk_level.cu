// One pyramid level of iterative Lucas-Kanade for a flat batch of
// features over stacked [C, H, W] float32 images, for sm_90a: the two
// variants of the TPU Pallas kernel behind lk_level_pallas.
//
// lk_level_kernel<false> (batched) replaces
//   mcmtt_opticalflow_tpu/ops/lk_pallas.py::_make_kernel_batched
// together with the corner/offset wrapping of lk_level_pallas.  The
// arithmetic is the same: a bilinear (w+2)^2 template window with
// central-difference gradients, a 2x2 structure tensor gated on
// det > 1e-7, `iters` Newton steps on a w x w window of the next image
// with the estimate clamped to [1, ph-w-2] x [1, pw-w-2] inside a patch
// whose corner is tile-aligned exactly as the TPU kernel's DMA patch
// (rows to 8, lanes to 128), a per-feature freeze when |ux|+|uy| <= 0.03,
// then the mean absolute residual.  The clamps keep every tap inside that
// patch.  Bilinear taps interpolate rows first, then columns: the order
// of the TPU kernel's one-hot products (R @ patch) @ C.
//
// lk_level_kernel<true> (serial) replaces
//   mcmtt_opticalflow_tpu/ops/lk_pallas.py::_make_kernel
// (lk_level_pallas(variant="serial")).  The same level, except that the
// Newton steps run in a [32, 128] working subpatch whose top-left pixel
// sits ((32-w)/2, (128-w)/2) up and left of the clamped initial guess's
// floor: the estimate is clamped to that subpatch intersected with the
// patch, a result outside it is invalid, and the loop exits per feature
// at the freeze.  Taps blend with the four-term formula
// a(1-fy)(1-fx) + b(1-fy)fx + c fy(1-fx) + d fy fx.  The TPU kernel moves
// windows with dynamic rolls of the patch and the subpatch; its clamps
// keep every tap off the rows and columns a roll wraps, so here taps
// index the image (or a staged copy of it) directly.
//
// What bounds both on this card.  The work a launch needs is small (a
// few MB of image windows, tens of MFLOP: a bound of about 1 µs, set by
// the float32 operations), so neither HBM nor the FP32 units bind.  A
// feature is a chain of ~10 dependent rounds (template, then each Newton
// step, whose offset depends on the warp-wide sum of the step before),
// each a gather of 4 taps per window pixel, and 30-40% of the slots the
// tracker hands in are active, in runs of one box (36 features).  Measured on the H100
// (PERF.md): an all-inactive launch takes ~3 µs, the setup and
// template ~8 µs and the 8 Newton steps ~8 µs of a ~19 µs launch; the
// gathers mostly hit L1, which the 8 warps of a block share, since the
// features of one box overlap.
//
// What this design does:
// - No idle work on inactive slots.  A block takes 8 consecutive slots.
//   Each of its warps reads their `active` flags and ballots them; the
//   first warp writes every inactive slot's outputs in one coalesced
//   pass, and warp k takes the block's k-th active slot, one feature per
//   warp, or exits when there is none.  A block with no active slot is
//   done after that one pass.  The ballot needs no barrier: every warp
//   computes it, and loads, in the same round as the flags, the inputs of
//   the slot it takes when all slots before it are active (the common
//   case, since boxes are active or not as a whole).  Consecutive slots
//   keep a box's features in one block, where they share L1; slots
//   strided over the batch, or more slots than warps per block, measured
//   slower (features then queue behind one another in a warp).
// - Staged windows.  Per feature the warp copies the (w+3)^2 region of
//   `prev` its template taps read, and a (w+1+2m)^2 region of `next`
//   (m = kMargin px around the clamped initial estimate, moved inside
//   the patch) into its own shared memory with cp.async: 16-byte copies
//   from the 4-float-aligned column at or left of each region, lane l
//   taking vector l % 8 of every fourth row (a few copies per lane, no
//   index division), or 4-byte copies when image rows are not 16-byte
//   aligned.  TMA would need a tensor map per image
//   and launch for ~1-4 KB windows.  The `next` copy is started before
//   the template, gradients and structure tensor are computed and is
//   waited for only before the first Newton step.  A Newton step whose
//   window lies inside the staged region (a warp-uniform test: the
//   estimate is per warp) reads shared memory; one that leaves it reads
//   the same pixels from global memory.  m = 6 px, about the 99th
//   percentile of |final - initial estimate| on the bench's inputs: 4
//   and 5 px measured 1-2% slower (more steps leave the region), and a
//   larger region costs more copying than it saves.  The
//   staged row pitch is 48 floats (16 mod 32): lanes 0-15 read row r and
//   lanes 16-31 row r+1, so each tap load touches 32 distinct banks.
// - A kernel compiled for the tracker's window (w = 16) beside the
//   generic one: the window's loops unroll and each tap's four loads take
//   immediate offsets from one base register.  That cut the Newton step
//   to ~200 instructions a warp, and the launch by ~30%.
// - Three blocks per SM (registers capped at 80, ~70 KB of shared memory
//   per block): every active feature of a bench launch is in flight in
//   one wave.  At two blocks per SM the launch takes ~1.3x as long.
// - Same arithmetic as the earlier unstaged version: the same tap
//   formulas, clamps, lane-to-pixel mapping and warp sums, built with
//   -fmad=false, so the results are bit-identical to it.
//
// Measured on the main path's inputs (PERF.md): ~0.7x the device time of
// the earlier unstaged version, ~13 µs a launch against a bound of
// ~1 µs.  What remains: instruction throughput in the Newton steps (~21
// features per SM), and ~3 µs for a launch whose ~860 blocks are mostly
// inactive.  Staging alone, without the compiled window, measured ~1.1x
// the unstaged version: it adds copies that L1 hits did not cost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps per block = slots per block
constexpr int kMinBlocks = 3;        // blocks per SM the registers allow
constexpr int kMaxWin = 16;
constexpr int kMaxDevices = 64;      // per-device launch records
constexpr int kMargin = 6;           // staged next region margin, px
constexpr int kNextPitch = 48;       // floats: 16 mod 32, room for the shift
constexpr int kPerLane = (kMaxWin * kMaxWin + 31) / 32;  // 8
static_assert(kNextPitch % 32 == 16 &&
                  kNextPitch >= 3 + kMaxWin + 1 + 2 * kMargin + 3,
              "staged next pitch");
static_assert(3 + kMaxWin + 1 + 2 * kMargin <= 32,
              "a staged row is at most 8 16-byte vectors");

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Staged prev row pitch: the (w+3)-wide region plus a shift of up to 3
// floats, rounded to 16 bytes.
__host__ __device__ constexpr int prev_pitch(int w) { return round4(w + 6); }

// Shared floats one warp uses for window w, each part 16-byte aligned:
// the prev region, the template window and the next region.
__host__ __device__ constexpr int warp_floats(int w) {
  return prev_pitch(w) * (w + 3) + round4((w + 2) * (w + 2)) +
         (w + 1 + 2 * kMargin) * kNextPitch;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bilinear tap whose top-left pixel is p0, row pitch `pitch`, fractions
// (fy, fx).  Batched: rows first, then columns.  Serial: the four-term
// formula, evaluated left to right (lk_pallas.py:123-131).
template <bool kSerial>
__device__ __forceinline__ float tap(const float* p0, int pitch, float fy,
                                     float fx) {
  const float* p1 = p0 + pitch;
  if constexpr (kSerial) {
    return p0[0] * (1.f - fy) * (1.f - fx) + p0[1] * (1.f - fy) * fx +
           p1[0] * fy * (1.f - fx) + p1[1] * fy * fx;
  } else {
    const float a = (1.f - fy) * p0[0] + fy * p1[0];
    const float b = (1.f - fy) * p0[1] + fy * p1[1];
    return a * (1.f - fx) + b * fx;
  }
}

// Tile-aligned patch corner with the point inside (lk_pallas.py:482-489).
__device__ __forceinline__ int corner(float v, int half_extent, int add,
                                      int mask, int hi) {
  const int c = ((int)floorf(v) - half_extent + add) & mask;
  return min(max(c, 0), hi);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The warp starts copying rows x cols floats at src (row pitch spitch)
// into dst (row pitch dpitch, 16-byte aligned) and returns the shift:
// pixel (r, c) lands at dst[r * dpitch + shift + c].  With `vec` (rows
// 16-byte aligned, the image's end too) it copies 16-byte vectors from
// the aligned column at or left of src, shift = that distance; else
// single floats, shift 0.
__device__ __forceinline__ int stage(float* dst, int dpitch,
                                     const float* src, int spitch, int rows,
                                     int cols, bool vec, int lane) {
  if (vec) {
    // lane -> vector lane % 8 of rows lane / 8, + 4, + 8, ...: no division
    const int shift = (int)(((uintptr_t)src >> 2) & 3);
    const int v = lane & 7;
    if (4 * v < shift + cols) {
      const float* a = src - shift + 4 * v;
      for (int r = lane >> 3; r < rows; r += 4)
        cp_async16(dst + r * dpitch + 4 * v, a + (size_t)r * spitch);
    }
    return shift;
  }
  for (int e = lane; e < rows * cols; e += 32) {
    const int r = e / cols, c = e - r * cols;
    cp_async4(dst + r * dpitch + c, src + (size_t)r * spitch + c);
  }
  return 0;
}

// A slot's inputs: camera, point, guess.
struct Slot {
  int cam;
  float px, py, qx, qy;
};

__device__ __forceinline__ Slot load_slot(const int* __restrict__ cam,
                                          const float* __restrict__ pts,
                                          const float* __restrict__ guess,
                                          int i) {
  return {cam[i], pts[2 * i], pts[2 * i + 1], guess[2 * i], guess[2 * i + 1]};
}

// One active feature, slot i with inputs `sl`, tracked by one warp in its
// shared buffer.  The window is kW when kW > 0 (a compile-time window:
// offsets fold into immediates), else w_rt.
template <bool kSerial, int kW>
__device__ __forceinline__ void track(
    int i, Slot sl, int lane, float* buf, const float* __restrict__ prev,
    const float* __restrict__ next, float* __restrict__ tracked,
    uint8_t* __restrict__ valid, float* __restrict__ resid, int H, int W,
    int w_rt, int iters, int ph, int pw, bool vec) {
  const int w = kW > 0 ? kW : w_rt;
  const float px = sl.px, py = sl.py, qx = sl.qx, qy = sl.qy;
  const int hi_cy = max(H - ph, 0), hi_cx = max(W - pw, 0);
  const int y0n = corner(qy, ph / 2, 4, ~7, hi_cy);
  const int x0n = corner(qx, pw / 2, 64, ~127, hi_cx);
  const int y0p = corner(py, ph / 2, 4, ~7, hi_cy);
  const int x0p = corner(px, pw / 2, 64, ~127, hi_cx);

  const float half = 0.5f * (float)(w - 1);
  const float lo = 1.f;
  const float hiy = (float)(ph - w - 2), hix = (float)(pw - w - 2);
  const float sy = (py - (float)y0p) - half;
  const float sx = (px - (float)x0p) - half;
  const float gy0 = (qy - (float)y0n) - half;
  const float gx0 = (qx - (float)x0n) - half;
  const bool src_ok = sy >= lo && sy <= hiy && sx >= lo && sx <= hix;

  // Where the estimate lives: batched, patch coordinates clamped to the
  // patch; serial, the working subpatch (lk_pallas.py:103-108, 189-202)
  // whose top-left pixel sits at (base_y, base_x) of the patch, clamped
  // to the subpatch intersected with the patch.
  int base_y = 0, base_x = 0;
  float lo_y = lo, lo_x = lo, hi_y = hiy, hi_x = hix;
  if constexpr (kSerial) {
    const int subh = min(32, ph), subw = min(128, pw);
    base_y = (int)floorf(clampf(gy0, lo, hiy)) - (subh - w) / 2;
    base_x = (int)floorf(clampf(gx0, lo, hix)) - (subw - w) / 2;
    lo_y = fmaxf(lo, lo - (float)base_y);
    lo_x = fmaxf(lo, lo - (float)base_x);
    hi_y = fminf((float)(subh - w - 2), hiy - (float)base_y);
    hi_x = fminf((float)(subw - w - 2), hix - (float)base_x);
  }
  float dy = gy0 - (float)base_y, dx = gx0 - (float)base_x;

  const size_t plane = (size_t)H * W;
  const float* P = prev + (size_t)sl.cam * plane + (size_t)y0p * W + x0p;
  const float* Q = next + (size_t)sl.cam * plane + (size_t)y0n * W + x0n;

  // Shared buffer: prev region [(w+3) rows x pp], template window
  // [(w+2)^2], next region [(w+1+2m) rows x kNextPitch].
  const int wp = w + 3, we = w + 2, pp = prev_pitch(w);
  float* ps = buf;
  float* ext = ps + pp * wp;
  float* ns = ext + round4(we * we);

  // (w+2)^2 template window one pixel up and left of the clamped source.
  // Batched samples at (s_c - 1); serial at the integer origin
  // floor(s_c) - 1 with the fractions of s_c.  Its taps read the (w+3)^2
  // region of prev at (iy, ix).
  int iy, ix;
  float fy, fx;
  {
    const float cy = clampf(sy, lo, hiy), cx = clampf(sx, lo, hix);
    if constexpr (kSerial) {
      iy = (int)floorf(cy);
      ix = (int)floorf(cx);
      fy = cy - (float)iy;
      fx = cx - (float)ix;
      --iy;
      --ix;
    } else {
      const float oy = cy - 1.f, ox = cx - 1.f;
      iy = (int)floorf(oy);
      ix = (int)floorf(ox);
      fy = oy - (float)iy;
      fx = ox - (float)ix;
    }
  }
  const float* ps0 =
      ps + stage(ps, pp, P + (size_t)iy * W + ix, W, wp, wp, vec, lane);
  cp_async_commit();

  // next region: m px around the clamped initial estimate's window, moved
  // inside the patch.
  const int rn_y = min(w + 1 + 2 * kMargin, ph);
  const int rn_x = min(w + 1 + 2 * kMargin, pw);
  const int ry = min(max(base_y + (int)floorf(clampf(dy, lo_y, hi_y)) -
                             kMargin, 0), ph - rn_y);
  const int rx = min(max(base_x + (int)floorf(clampf(dx, lo_x, hi_x)) -
                             kMargin, 0), pw - rn_x);
  const float* ns0 = ns + stage(ns, kNextPitch, Q + (size_t)ry * W + rx, W,
                               rn_y, rn_x, vec, lane);
  cp_async_commit();

  cp_async_wait<1>();  // prev region in
  __syncwarp();
#pragma unroll
  for (int p = lane; p < we * we; p += 32) {
    const int r = p / we, s = p - r * we;
    ext[p] = tap<kSerial>(ps0 + r * pp + s, pp, fy, fx);
  }
  __syncwarp();

  const int np = w * w;
  float t[kPerLane], gxv[kPerLane], gyv[kPerLane];
  // window pixel offset in the staged next region; with 32 % w == 0 a
  // constant step from the lane's first, so loads take immediates
  int off[kPerLane];
  constexpr bool kRowsPerK = kW > 0 && 32 % kW == 0;
  const int off0 = (lane / w) * kNextPitch + lane % w;
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int p = lane + 32 * k;
    t[k] = gxv[k] = gyv[k] = 0.f;
    off[k] = 0;
    if (p < np) {
      const int r = p / w, s = p - r * w;
      off[k] = kRowsPerK ? off0 + k * (32 / (kRowsPerK ? kW : 1)) * kNextPitch
                         : r * kNextPitch + s;
      t[k] = ext[(r + 1) * we + s + 1];
      gxv[k] = 0.5f * (ext[(r + 1) * we + s + 2] - ext[(r + 1) * we + s]);
      gyv[k] = 0.5f * (ext[(r + 2) * we + s + 1] - ext[r * we + s + 1]);
      sxx += gxv[k] * gxv[k];
      sxy += gxv[k] * gyv[k];
      syy += gyv[k] * gyv[k];
    }
  }
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const bool ok_g = det > 1e-7f;
  const float inv_det = ok_g ? 1.f / det : 0.f;

  cp_async_wait<0>();  // next region in
  __syncwarp();

  // Sum over the window at the clamped estimate (dyc, dxc) of f(tap - t,
  // k), reading the staged region when the window lies inside it.
  auto window = [&](float dyc, float dxc, auto f) {
    const int wy = (int)floorf(dyc), wx = (int)floorf(dxc);
    const float vy = dyc - (float)wy, vx = dxc - (float)wx;
    const int oy = base_y + wy - ry, ox = base_x + wx - rx;
    if (oy >= 0 && oy < rn_y - w && ox >= 0 && ox < rn_x - w) {
      const float* S = ns0 + oy * kNextPitch + ox;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (lane + 32 * k < np)
          f(tap<kSerial>(S + off[k], kNextPitch, vy, vx) - t[k], k);
    } else {
      const float* G = Q + (size_t)(base_y + wy) * W + (base_x + wx);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (lane + 32 * k < np) {
          const int r = off[k] / kNextPitch, s = off[k] - r * kNextPitch;
          f(tap<kSerial>(G + (size_t)r * W + s, W, vy, vx) - t[k], k);
        }
    }
  };

  for (int it = 0; it < iters; ++it) {
    const float dyc = clampf(dy, lo_y, hi_y), dxc = clampf(dx, lo_x, hi_x);
    float bx = 0.f, by = 0.f;
    window(dyc, dxc, [&](float d, int k) {
      bx += d * gxv[k];
      by += d * gyv[k];
    });
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float ux = -(gyy * bx - gxy * by) * inv_det;
    const float uy = -(-gxy * bx + gxx * by) * inv_det;
    dy = dyc + uy;
    dx = dxc + ux;
    if (!(fabsf(ux) + fabsf(uy) > 0.03f)) break;  // frozen from here on
  }

  const float dyc = clampf(dy, lo_y, hi_y), dxc = clampf(dx, lo_x, hi_x);
  float ra = 0.f;
  window(dyc, dxc, [&](float d, int) { ra += fabsf(d); });
  ra = warp_sum(ra);

  if (lane == 0) {
    const bool in_range = dy >= lo_y && dy <= hi_y && dx >= lo_x && dx <= hi_x;
    tracked[2 * i] = ((dxc + (float)base_x) + half) + (float)x0n;
    tracked[2 * i + 1] = ((dyc + (float)base_y) + half) + (float)y0n;
    valid[i] = (ok_g && src_ok && in_range) ? 1 : 0;
    resid[i] = ra * (1.f / (float)np);
  }
}

template <bool kSerial, int kW>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                const int* __restrict__ cam, const float* __restrict__ pts,
                const float* __restrict__ guess,
                const uint8_t* __restrict__ active,
                float* __restrict__ tracked, uint8_t* __restrict__ valid,
                float* __restrict__ resid, int H, int W, int N, int w,
                int iters, int ph, int pw) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kWarps;

  // Every warp ballots the block's active flags and loads, in the same
  // round, the inputs of the slot it takes when every slot before it is
  // active (the common case: boxes are active or not as a whole).
  const int i_lane = base + lane;
  const bool in = lane < kWarps && i_lane < N;
  const bool a = in && active[i_lane];
  const int i_own = min(base + warp, N - 1);
  Slot own = load_slot(cam, pts, guess, i_own);
  const unsigned m = __ballot_sync(0xffffffffu, a);
  if (warp == 0 && in && !a) {
    // inactive slot: the patch corner, valid 0, residual 0
    tracked[2 * i_lane] = (float)corner(guess[2 * i_lane], pw / 2, 64, ~127,
                                        max(W - pw, 0));
    tracked[2 * i_lane + 1] = (float)corner(guess[2 * i_lane + 1], ph / 2,
                                            4, ~7, max(H - ph, 0));
    valid[i_lane] = 0;
    resid[i_lane] = 0.f;
  }
  if (warp >= __popc(m)) return;
  // this warp's feature: the warp-th active slot of the block
  unsigned rest = m;
  for (int k = 0; k < warp; ++k) rest &= rest - 1;
  const int i = base + __ffs(rest) - 1;
  if (i != i_own) own = load_slot(cam, pts, guess, i);
  // 16-byte staging needs every row, and the image's end, 16-byte aligned
  const bool vec = (W & 3) == 0 &&
                   (((uintptr_t)prev | (uintptr_t)next) & 15) == 0;
  track<kSerial, kW>(i, own, lane, smem + warp * warp_floats(w), prev, next,
                     tracked, valid, resid, H, W, w, iters, ph, pw, vec);
}

__global__ void noop_kernel() {}

template <bool kSerial, int kW>
int launch_w(const float* prev, const float* next, const int* cam,
             const float* pts, const float* guess, const uint8_t* active,
             float* tracked, uint8_t* valid, float* resid, int H, int W, int N,
             int window, int iters, int ph, int pw, void* stream) {
  // above 48 KB a block's dynamic shared memory must be allowed first,
  // on each device the kernel runs on (the attribute is per device)
  static int allowed[kMaxDevices] = {};
  const int smem = kWarps * warp_floats(window) * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    const int max_smem = kWarps * warp_floats(kMaxWin) * (int)sizeof(float);
    err = cudaFuncSetAttribute(lk_level_kernel<kSerial, kW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = max_smem;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  lk_level_kernel<kSerial, kW>
      <<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
          prev, next, cam, pts, guess, active, tracked, valid, resid, H, W, N,
          window, iters, ph, pw);
  return (int)cudaGetLastError();
}

// The largest window (the tracker's) runs a kernel compiled for it; any
// other window the generic one.
template <bool kSerial>
int launch(const float* prev, const float* next, const int* cam,
           const float* pts, const float* guess, const uint8_t* active,
           float* tracked, uint8_t* valid, float* resid, int H, int W, int N,
           int window, int iters, int ph, int pw, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const auto go = window == kMaxWin ? launch_w<kSerial, kMaxWin>
                                     : launch_w<kSerial, 0>;
  return go(prev, next, cam, pts, guess, active, tracked, valid, resid, H, W,
            N, window, iters, ph, pw, stream);
}

}  // namespace

extern "C" int lk_level_launch(const float* prev, const float* next,
                               const int* cam, const float* pts,
                               const float* guess, const uint8_t* active,
                               float* tracked, uint8_t* valid, float* resid,
                               int H, int W, int N, int window, int iters,
                               int ph, int pw, void* stream) {
  return launch<false>(prev, next, cam, pts, guess, active, tracked, valid,
                       resid, H, W, N, window, iters, ph, pw, stream);
}

extern "C" int lk_level_serial_launch(const float* prev, const float* next,
                                      const int* cam, const float* pts,
                                      const float* guess,
                                      const uint8_t* active, float* tracked,
                                      uint8_t* valid, float* resid, int H,
                                      int W, int N, int window, int iters,
                                      int ph, int pw, void* stream) {
  return launch<true>(prev, next, cam, pts, guess, active, tracked, valid,
                      resid, H, W, N, window, iters, ph, pw, stream);
}

// An empty one-block kernel: the launch-time floor that lk_level's times
// are read against.
extern "C" int lk_noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int lk_level_max_window() { return kMaxWin; }

extern "C" int lk_level_stage_margin() { return kMargin; }
