// The solver's random fields of one solve, drawn in one launch, for
// sm_90a: threefry_fields_kernel replaces the JAX package's draws
// mcmtt_opticalflow_tpu/models/mwcp.py:134-141 (`split(key, r + 1)`, each
// replica's greedy-order noise `uniform(keys[j], (v,))`) and :279-284
// (`split(keys[r], 4)`; `uniform` (ip, r), `gumbel` (ip, r, v), `uniform`
// (ip, r), `gumbel` (ip, r, v)), jax.random with
// `jax_threefry_partitionable` on.  It is not a Pallas kernel: XLA fuses
// those draws.  Its plain version is
// ops/threefry_kernel.py::threefry_fields_reference (utils/prng.py, one
// int64 tensor operation per add, rotate, mask and xor).
//
// What it computes, exactly as the plain version: element e of a field
// hashes the 64-bit counter e (high word, low word) under the field's key
// with the 20-round threefry2x32 and takes the two output words' xor; the
// top 23 bits are a mantissa in [1, 2), minus 1; a uniform on [lo, hi) is
// max(lo, f * (hi - lo) + lo) with the multiply and the add rounded
// separately (the plain version's two tensor operations), a gumbel
// -log(-log(u)) of the uniform on [FLT_MIN, 1).  A split key j is the hash
// of counter j, both words.  The integer part is exact by construction,
// the float part is __fmul_rn / __fadd_rn and logf (never __logf): the
// kernel is held to the plain version bit for bit on the card.
//
// Launch: one a draw, its key read from the device (a [2] int64, the
// words in the low halves), so a CUDA graph holds it with no host read.
// Each block derives keys[r] and its four subkeys into shared memory
// (four lanes of the first warp, two hashes each); a replica's noise key
// keys[j] is derived where its row is drawn (the noise is r * v numbers
// of the draw's ~2 * ip * r * v).  The grid strides over each field in
// turn, a thread drawing 4 consecutive counters (four independent hash
// chains) and writing them with one 16-byte store where the field allows
// (the tail and unaligned fields element by element).  Any size: the
// counters are 64-bit, their high word honoured.
//
// What bounds it on this card: operations.  ~72 integer operations a hash
// (20 rounds of add, rotate, xor; the key's first addition and 5
// injections), ~111 operations a
// gumbel with its two logs: ~1.3 G at the bench's draw, 19 us at 67 T/s,
// against 47 MB written, 14 us at 3.35 TB/s.  Hopper issues 32-bit
// integer operations at half the FP32 rate (64 a clock and SM), so
// ~60-80 us is the practical floor at the bench's shape.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kFields = 5;

// what a field holds: the replicas' noise (a key a row), a uniform or a
// gumbel under one of keys[r]'s four subkeys
enum Kind { kNoise = 0, kUniform = 1, kGumbel = 2 };

struct Field {
  float* out;
  unsigned long long n;        // numbers
  int vec;                     // out 16-byte aligned
};

struct Fields {
  Field f[kFields];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// threefry2x32, 20 rounds, of the counter words (hi, lo) under (k0, k1)
// (jax/_src/prng.py::_threefry2x32_lowering; utils/prng.py)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t hi, uint32_t lo,
                                         uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0, x1 = lo + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

#undef TF_ROUND

__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            unsigned long long e) {
  uint32_t o0, o1;
  threefry(k0, k1, (uint32_t)(e >> 32), (uint32_t)e, o0, o1);
  return o0 ^ o1;
}

// jax.random.uniform's float of 32 random bits on [lo, hi)
__device__ __forceinline__ float uniform(uint32_t bits, float lo, float hi) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(hi, lo)), lo));
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  return -logf(-logf(uniform(bits, FLT_MIN, 1.0f)));
}

// the groups of 4 numbers of field F from `tid` on, `stride` apart
template <int kKind>
__device__ __forceinline__ void draw(const Field& F, uint32_t k0, uint32_t k1,
                                     uint32_t s0, uint32_t s1, int v,
                                     unsigned long long tid,
                                     unsigned long long stride) {
  const unsigned long long groups = (F.n + 3) / 4;
  for (unsigned long long g = tid; g < groups; g += stride) {
    const unsigned long long e0 = 4 * g;
    float x[4];
    if (kKind == kNoise) {
      // element e of row j = e / v: counter e % v under keys[j]
      unsigned long long row = e0 / (unsigned)v;
      unsigned long long col = e0 - row * (unsigned)v;
      uint32_t a, b;
      threefry(k0, k1, (uint32_t)(row >> 32), (uint32_t)row, a, b);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q && col == (unsigned)v) {
          ++row;
          col = 0;
          threefry(k0, k1, (uint32_t)(row >> 32), (uint32_t)row, a, b);
        }
        x[q] = uniform(bits_at(a, b, col), 0.0f, 1.0f);
        ++col;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t bits = bits_at(s0, s1, e0 + q);
        x[q] = kKind == kGumbel ? gumbel(bits) : uniform(bits, 0.0f, 1.0f);
      }
    }
    if (F.vec && e0 + 4 <= F.n) {
      *reinterpret_cast<float4*>(F.out + e0) =
          make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (e0 + q < F.n) F.out[e0 + q] = x[q];
    }
  }
}

// fs.f: g_dir, g_rnd (gumbels under subkeys 1 and 3), noise, u_dir, u_ten
// (uniforms under subkeys 0 and 2)
__global__ void __launch_bounds__(kThreads)
    threefry_fields_kernel(const int64_t* __restrict__ key, int r, int v,
                           Fields fs) {
  __shared__ uint32_t sub[4][2];
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  if (threadIdx.x < 4) {
    uint32_t a, b;
    threefry(k0, k1, 0u, (uint32_t)r, a, b);       // keys[r]
    threefry(a, b, 0u, threadIdx.x, sub[threadIdx.x][0],
             sub[threadIdx.x][1]);
  }
  __syncthreads();
  const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
  const unsigned long long tid =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  draw<kGumbel>(fs.f[0], k0, k1, sub[1][0], sub[1][1], v, tid, stride);
  draw<kGumbel>(fs.f[1], k0, k1, sub[3][0], sub[3][1], v, tid, stride);
  draw<kNoise>(fs.f[2], k0, k1, 0u, 0u, v, tid, stride);
  draw<kUniform>(fs.f[3], k0, k1, sub[0][0], sub[0][1], v, tid, stride);
  draw<kUniform>(fs.f[4], k0, k1, sub[2][0], sub[2][1], v, tid, stride);
}

}  // namespace

// Launches threefry_fields_kernel on `stream`: the five fields of one
// solve (noise [r, v], u_dir [ip, r], g_dir [ip, r, v], u_ten [ip, r],
// g_rnd [ip, r, v], float32, contiguous) from `key` [2] int64 on the
// device.  Nothing is launched when every field is empty.
extern "C" int threefry_fields_launch(const int64_t* key, int r, int v,
                                      int ip, float* noise, float* u_dir,
                                      float* g_dir, float* u_ten,
                                      float* g_rnd, void* stream) {
  const unsigned long long R = r, V = v, I = ip;
  Fields fs;
  fs.f[0] = {g_dir, I * R * V, 0};
  fs.f[1] = {g_rnd, I * R * V, 0};
  fs.f[2] = {noise, R * V, 0};
  fs.f[3] = {u_dir, I * R, 0};
  fs.f[4] = {u_ten, I * R, 0};
  unsigned long long groups = 0;
  for (Field& f : fs.f) {
    f.vec = (uintptr_t)f.out % 16 == 0;
    groups = groups > (f.n + 3) / 4 ? groups : (f.n + 3) / 4;
  }
  if (groups == 0) return (int)cudaSuccess;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned long long want = (groups + kThreads - 1) / kThreads;
  const unsigned long long cap = (unsigned long long)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  threefry_fields_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key, r, v, fs);
  return (int)cudaGetLastError();
}
