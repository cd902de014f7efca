// Variance-preserving noise blend for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the two Pallas TPU kernels of ops/pallas/noise_kernel.py in the
// JAX package:
//   * fused_normalise_noise_blend (:128, body _kernel :98-106):
//       out = sqrt(1 - r) * (x - m255[c]) / s255[c] + sqrt(r) * eps,
//     uint8 NHWC in, fp32 out;
//   * fused_noise_blend (:171, body _kernel_f32 :109-115):
//       out = sqrt(1 - r) * x + sqrt(r) * eps,
//     fp32 NHWC in and out;
// with a per-sample ratio r and eps standard normal, drawn in the kernel so
// no noise tensor touches device memory.
//
// Noise: counter-based Philox4x32-10 (Salmon et al., SC'11), written out
// here. Key = the 64-bit seed as two words; counter = (group lo, group hi,
// offset lo, offset hi), where group = flat element index / 4 and offset is
// the step or stream number. One call gives 4 words, hence 4 uniforms
// u = (w >> 8) * 2^-24 + 2^-25 (never 0, as the TPU kernel's
// _uniform_from_bits), hence two Box-Muller pairs
// sqrt(-2 ln u0) * (cos 2 pi u1, sin 2 pi u1) and the same of (u2, u3):
// elements 4g .. 4g+3. The noise depends on (seed, offset, element index)
// alone, not on the launch geometry, so the plain PyTorch version
// (noise_kernel.py) reproduces it.
//
// Rounding: every fp32 operation rounds on its own (the __f*_rn intrinsics,
// and the file is built with -fmad=false), as PyTorch's elementwise ops do,
// and logf / sinf / cosf / sqrtf are CUDA's accurate versions (no fast math).
//
// Bound: memory. An element is read once (1 byte uint8, 4 bytes fp32) and
// written once (4 bytes); 36.1 MB at 448^2 x 12 uint8 (10.8 us at 3.35 TB/s)
// and 77.1 MB at 448^2 x 16 fp32 (23.0 us). The arithmetic, about 26 integer
// operations (Philox: 10 rounds of 4 multiplies, 4 xors and 2 key adds per 4
// elements) and about 12 fp32 operations an element, takes less. One thread
// owns one group of 4 elements: one 4-byte uchar4 or 16-byte float4 load
// and one float4 store when the pointers are aligned, scalar accesses at the
// tail of a batch whose size is not a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float TWO_POW_M24 = 5.9604644775390625e-08f;
constexpr float TWO_POW_M25 = 2.98023223876953125e-08f;
constexpr int THREADS = 256;
constexpr int MAX_C = 4;

enum Kind { KIND_F32 = 0, KIND_U8 = 2 };

struct BlendParams {
  long long n;            // elements
  long long per_sample;   // H * W * C
  int chans;
  int vec;                // pointers aligned for one vector access a group
  unsigned long long offset;
  uint32_t k0, k1;        // seed words
  const float* ratios;    // (B,)
  float mean255[MAX_C];
  float std255[MAX_C];
};

__device__ __forceinline__ uint4 philox4x32_10(unsigned long long group,
                                               unsigned long long offset,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c0 = (uint32_t)group, c1 = (uint32_t)(group >> 32);
  uint32_t c2 = (uint32_t)offset, c3 = (uint32_t)(offset >> 32);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t lo0 = PHILOX_M0 * c0, hi0 = __umulhi(PHILOX_M0, c0);
    const uint32_t lo1 = PHILOX_M1 * c2, hi1 = __umulhi(PHILOX_M1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float uniform(uint32_t w) {
  return __fadd_rn(__fmul_rn((float)(w >> 8), TWO_POW_M24), TWO_POW_M25);
}

// Four standard normals of group `group`: elements 4 group .. 4 group + 3.
__device__ __forceinline__ float4 normals4(unsigned long long group,
                                          const BlendParams& p) {
  const uint4 w = philox4x32_10(group, p.offset, p.k0, p.k1);
  const float r01 = __fsqrt_rn(__fmul_rn(-2.0f, logf(uniform(w.x))));
  const float t1 = __fmul_rn(TWO_PI, uniform(w.y));
  const float r23 = __fsqrt_rn(__fmul_rn(-2.0f, logf(uniform(w.z))));
  const float t3 = __fmul_rn(TWO_PI, uniform(w.w));
  return make_float4(__fmul_rn(r01, cosf(t1)), __fmul_rn(r01, sinf(t1)),
                     __fmul_rn(r23, cosf(t3)), __fmul_rn(r23, sinf(t3)));
}

// a[c] without indexing the parameter array at run time, which would copy
// it to local memory in every thread.
__device__ __forceinline__ float pick(const float (&a)[MAX_C], int c) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < MAX_C; ++j) v = c == j ? a[j] : v;
  return v;
}

__device__ __forceinline__ float blend(float x, float eps, float r) {
  return __fadd_rn(__fmul_rn(__fsqrt_rn(__fsub_rn(1.0f, r)), x),
                   __fmul_rn(__fsqrt_rn(r), eps));
}

template <bool NORM, typename In>
__device__ __forceinline__ void blend_group(const In* __restrict__ x,
                                            float* __restrict__ out,
                                            const BlendParams& p) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long i0 = 4 * g;
  if (i0 >= p.n) return;
  const float4 e4 = normals4((unsigned long long)g, p);
  const float eps[4] = {e4.x, e4.y, e4.z, e4.w};
  const bool full = i0 + 4 <= p.n;

  float v[4];
  if (p.vec && full) {
    if constexpr (NORM) {
      const uchar4 q = *reinterpret_cast<const uchar4*>(x + i0);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      const float4 q = *reinterpret_cast<const float4*>(x + i0);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < p.n ? (float)x[i0 + k] : 0.f;
  }

  // Sample and channel of the first element; the next three follow on.
  long long b = i0 / p.per_sample;
  long long rem = i0 - b * p.per_sample;
  int c = (int)(rem % p.chans);
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (NORM)
      v[k] = __fdiv_rn(__fsub_rn(v[k], pick(p.mean255, c)),
                     pick(p.std255, c));
    r[k] = i0 + k < p.n ? p.ratios[b] : 0.f;
    if (++c == p.chans) c = 0;
    if (++rem == p.per_sample) {
      rem = 0;
      ++b;
    }
  }
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = blend(v[k], eps[k], r[k]);

  if (p.vec && full) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < p.n) out[i0 + k] = o[k];
  }
}

__global__ void __launch_bounds__(THREADS)
normalise_noise_blend_u8_kernel(const uint8_t* __restrict__ x,
                                float* __restrict__ out, BlendParams p) {
  blend_group<true>(x, out, p);
}

__global__ void __launch_bounds__(THREADS)
noise_blend_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                       BlendParams p) {
  blend_group<false>(x, out, p);
}

// Debug entry: the raw Philox words of groups 0 .. groups - 1.
__global__ void __launch_bounds__(THREADS)
philox_words_kernel(uint4* __restrict__ out, long long groups,
                    unsigned long long offset, uint32_t k0, uint32_t k1) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g < groups) out[g] = philox4x32_10((unsigned long long)g, offset, k0, k1);
}

unsigned grid_for(long long groups) {
  return (unsigned)((groups + THREADS - 1) / THREADS);
}

}  // namespace

// One blend over a contiguous (B, H, W, C) batch of n = B * per_sample
// elements. in_kind 2 (uint8) needs `norm`, a host array of 2 * chans
// floats (mean*255 then std*255); in_kind 0 (fp32) takes NULL. `ratios` is
// a device array of B floats. Returns 0 or the CUDA error of the launch.
extern "C" int d3f_noise_blend(int in_kind, const void* x, float* out,
                               long long n, long long per_sample, int chans,
                               const float* ratios, const float* norm,
                               unsigned long long seed,
                               unsigned long long offset, void* stream) {
  if (n <= 0 || per_sample <= 0 || n % per_sample || chans <= 0 ||
      per_sample % chans || chans > MAX_C)
    return (int)cudaErrorInvalidValue;
  if ((in_kind == KIND_U8) != (norm != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long groups = (n + 3) / 4;
  if (groups > (long long)THREADS * 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  BlendParams p;
  p.n = n;
  p.per_sample = per_sample;
  p.chans = chans;
  const size_t in_align = in_kind == KIND_U8 ? 4 : 16;
  p.vec = (uintptr_t)x % in_align == 0 && (uintptr_t)out % 16 == 0;
  p.offset = offset;
  p.k0 = (uint32_t)seed;
  p.k1 = (uint32_t)(seed >> 32);
  p.ratios = ratios;
  for (int c = 0; c < MAX_C; ++c) {
    p.mean255[c] = (norm && c < chans) ? norm[c] : 0.0f;
    p.std255[c] = (norm && c < chans) ? norm[chans + c] : 1.0f;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == KIND_U8)
    normalise_noise_blend_u8_kernel<<<grid_for(groups), THREADS, 0, s>>>(
        static_cast<const uint8_t*>(x), out, p);
  else if (in_kind == KIND_F32)
    noise_blend_f32_kernel<<<grid_for(groups), THREADS, 0, s>>>(
        static_cast<const float*>(x), out, p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The Philox words of groups 0 .. groups - 1 into `out` (4 * groups uint32).
extern "C" int d3f_philox_words(uint32_t* out, long long groups,
                                unsigned long long seed,
                                unsigned long long offset, void* stream) {
  if (groups <= 0 || groups > (long long)THREADS * 0x7FFFFFFFLL ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  philox_words_kernel<<<grid_for(groups), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<uint4*>(out), groups, offset, (uint32_t)seed,
      (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}
