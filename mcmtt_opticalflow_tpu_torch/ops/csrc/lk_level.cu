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
// patch, so taps read the image directly; the patch itself is never
// copied.  Bilinear taps interpolate rows first, then columns: the order
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
// index the image directly and neither patch nor subpatch is copied.
//
// What bounds both on this card: dependent gathers.  Each Newton step
// samples 4 taps per window pixel at a data-dependent offset, and the
// next step's offset depends on a warp-wide sum of the previous one, so
// a feature is a chain of ~10 latency-bound gather rounds with little
// arithmetic between them.  Only 10-30% of the slots the tracker hands
// in are active.  The design: one warp per feature (8 per block) so a
// feature's reductions are register shuffles, no block-wide barriers,
// and inactive features retire at once; the (w+2)^2 template window is
// staged in shared memory once per feature; per-lane template and
// gradient values stay in registers across the Newton steps; occupancy
// (many warps in flight per SM) hides the gather latency.  Staging the
// patch with TMA or cp.async is left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                                // features per block
constexpr int kMaxWin = 16;
constexpr int kMaxExt = (kMaxWin + 2) * (kMaxWin + 2);   // 324
constexpr int kPerLane = (kMaxWin * kMaxWin + 31) / 32;  // 8

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bilinear tap at integer (y, x) of a row-major image with row pitch W,
// fractions (fy, fx).  Batched: rows first, then columns.  Serial: the
// four-term formula, evaluated left to right (lk_pallas.py:123-131).
template <bool kSerial>
__device__ __forceinline__ float tap(const float* __restrict__ img, int W,
                                     int y, int x, float fy, float fx) {
  const float* p0 = img + (size_t)y * W + x;
  const float* p1 = p0 + W;
  if constexpr (kSerial) {
    return __ldg(p0) * (1.f - fy) * (1.f - fx) +
           __ldg(p0 + 1) * (1.f - fy) * fx + __ldg(p1) * fy * (1.f - fx) +
           __ldg(p1 + 1) * fy * fx;
  } else {
    const float a = (1.f - fy) * __ldg(p0) + fy * __ldg(p1);
    const float b = (1.f - fy) * __ldg(p0 + 1) + fy * __ldg(p1 + 1);
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

template <bool kSerial>
__global__ void __launch_bounds__(kWarps * 32)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                const int* __restrict__ cam, const float* __restrict__ pts,
                const float* __restrict__ guess,
                const uint8_t* __restrict__ active,
                float* __restrict__ tracked, uint8_t* __restrict__ valid,
                float* __restrict__ resid, int H, int W, int N, int w,
                int iters, int ph, int pw) {
  __shared__ float ext_s[kWarps][kMaxExt];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= N) return;  // warp-uniform

  const float px = pts[2 * i], py = pts[2 * i + 1];
  const float qx = guess[2 * i], qy = guess[2 * i + 1];
  const int hi_cy = max(H - ph, 0), hi_cx = max(W - pw, 0);
  const int y0n = corner(qy, ph / 2, 4, ~7, hi_cy);
  const int x0n = corner(qx, pw / 2, 64, ~127, hi_cx);
  if (!active[i]) {
    // inactive slot: the patch corner, valid 0, residual 0
    if (lane == 0) {
      tracked[2 * i] = (float)x0n;
      tracked[2 * i + 1] = (float)y0n;
      valid[i] = 0;
      resid[i] = 0.f;
    }
    return;
  }
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
  const float* P = prev + (size_t)cam[i] * plane + (size_t)y0p * W + x0p;
  const float* Q = next + (size_t)cam[i] * plane + (size_t)y0n * W + x0n;

  // (w+2)^2 window one pixel up and left of the clamped source: template
  // + gradients.  Batched samples at (s_c - 1); serial at the integer
  // origin floor(s_c) - 1 with the fractions of s_c.
  const int we = w + 2;
  float* ext = ext_s[warp];
  {
    const float cy = clampf(sy, lo, hiy), cx = clampf(sx, lo, hix);
    int iy, ix;
    float fy, fx;
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
    for (int p = lane; p < we * we; p += 32) {
      const int r = p / we, s = p - r * we;
      ext[p] = tap<kSerial>(P, W, iy + r, ix + s, fy, fx);
    }
  }
  __syncwarp();

  const int np = w * w;
  float t[kPerLane], gxv[kPerLane], gyv[kPerLane];
  int off[kPerLane];
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int p = lane + 32 * k;
    t[k] = gxv[k] = gyv[k] = 0.f;
    off[k] = 0;
    if (p < np) {
      const int r = p / w, s = p - r * w;
      off[k] = r * W + s;
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

  for (int it = 0; it < iters; ++it) {
    const float dyc = clampf(dy, lo_y, hi_y), dxc = clampf(dx, lo_x, hi_x);
    const int iy = (int)floorf(dyc), ix = (int)floorf(dxc);
    const float fy = dyc - (float)iy, fx = dxc - (float)ix;
    const float* Qb = Q + (size_t)(base_y + iy) * W + (base_x + ix);
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (lane + 32 * k < np) {
        const float d = tap<kSerial>(Qb + off[k], W, 0, 0, fy, fx) - t[k];
        bx += d * gxv[k];
        by += d * gyv[k];
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float ux = -(gyy * bx - gxy * by) * inv_det;
    const float uy = -(-gxy * bx + gxx * by) * inv_det;
    dy = dyc + uy;
    dx = dxc + ux;
    if (!(fabsf(ux) + fabsf(uy) > 0.03f)) break;  // frozen from here on
  }

  const float dyc = clampf(dy, lo_y, hi_y), dxc = clampf(dx, lo_x, hi_x);
  const int iy = (int)floorf(dyc), ix = (int)floorf(dxc);
  const float fy = dyc - (float)iy, fx = dxc - (float)ix;
  const float* Qb = Q + (size_t)(base_y + iy) * W + (base_x + ix);
  float ra = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (lane + 32 * k < np)
      ra += fabsf(tap<kSerial>(Qb + off[k], W, 0, 0, fy, fx) - t[k]);
  }
  ra = warp_sum(ra);

  if (lane == 0) {
    const bool in_range = dy >= lo_y && dy <= hi_y && dx >= lo_x && dx <= hi_x;
    tracked[2 * i] = ((dxc + (float)base_x) + half) + (float)x0n;
    tracked[2 * i + 1] = ((dyc + (float)base_y) + half) + (float)y0n;
    valid[i] = (ok_g && src_ok && in_range) ? 1 : 0;
    resid[i] = ra * (1.f / (float)np);
  }
}

template <bool kSerial>
int launch(const float* prev, const float* next, const int* cam,
           const float* pts, const float* guess, const uint8_t* active,
           float* tracked, uint8_t* valid, float* resid, int H, int W, int N,
           int window, int iters, int ph, int pw, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const int blocks = (N + kWarps - 1) / kWarps;
  lk_level_kernel<kSerial><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      prev, next, cam, pts, guess, active, tracked, valid, resid, H, W, N,
      window, iters, ph, pw);
  return (int)cudaGetLastError();
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

extern "C" int lk_level_max_window() { return kMaxWin; }
