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
// The element index is global: a launch takes `element_base`, the flat
// index of its first element in a larger batch (a data-parallel rank's
// rows start at rank * lb * H * W * C), so a rank draws the noise its rows
// get in the one-process step. A thread owns one global group; where the
// base is not a multiple of 4, the launch's first group is shared with the
// rows before it, and its lanes below the base are skipped (so are the
// vector accesses: the pointers are then off a group's alignment). At
// base 0 every launch is what it was without one.
//
// The row window: a spatial rank holds rows s*H/S .. (s+1)*H/S - 1 of each
// of its images, so its elements are not one run of the global batch but
// B runs of run_len = (H/S) * W * C elements, one every run_stride = H * W
// * C. Run j (blockIdx.y) starts at global element element_base + j *
// run_stride and at local element j * run_len, with its own first group
// and shift: W * C need not be a multiple of 4, so a run may start inside
// a Philox group. A launch of one run (run_len = n) is the contiguous
// launch above, bit for bit.
//
// Rounding: every fp32 operation rounds on its own (the __f*_rn intrinsics,
// and the file is built with -fmad=false), as PyTorch's elementwise ops do,
// and logf / sincosf / sqrtf are CUDA's accurate versions (no fast math).
// sincosf reduces the angle once for both results; on every input checked
// on the H100 it gives sinf's and cosf's values bit for bit (PERF.md).
//
// Bound: memory. An element is read once (1 byte uint8, 4 bytes fp32) and
// written once (4 bytes); 36.1 MB at 448^2 x 12 uint8 (10.8 us at 3.35 TB/s)
// and 77.1 MB at 448^2 x 16 fp32 (23.0 us). The arithmetic, about 26 integer
// operations (Philox: 10 rounds of 4 multiplies, 4 xors and 2 key adds per 4
// elements) and about 12 fp32 operations an element, takes less on paper,
// but the accurate logf and sincosf the rounding fixes cost tens of
// instructions each, so what the kernels issue, not the bytes, sets their
// pace.
//
// The fp32 kernel: one thread owns one group of 4 elements: one 16-byte
// float4 load and one float4 store when the pointers are aligned, scalar
// accesses at the tail of a batch whose size is not a multiple of 4.
//
// The uint8 kernel spends its instructions on the noise alone:
//   * the normalisation is a look-up: each block stages a [C][256] table of
//     (v - m255[c]) / s255[c] in shared memory (the same expression, so
//     bit-equal), and an element is one byte and one shared load (on the
//     H100, uniform noise and smooth images read it equally fast);
//   * a block owns U8_GROUPS * U8_THREADS consecutive groups, thread t the
//     groups t, t + U8_THREADS, ... (each warp's accesses stay contiguous),
//     so the table and the per-sample factors sqrt(1 - r) and sqrt(r) are
//     computed once for U8_GROUPS groups; only a block that straddles two
//     samples computes them per element, out of line;
//   * indices are 32-bit (the host refuses 2^31 elements or more) and the
//     channel count C is a template parameter, so i % C is a multiply-high.
//     The Philox counter stays 64-bit: offsets above 2^32 (the balancer's
//     scoring stream) keep their high word.
//
// The offset comes by value (d3f_noise_blend: scoring, DDIM) or is read by
// every thread from a device int64 (d3f_noise_blend_at: the train steps, whose
// offsets sit in a per-step table a CUDA graph replays from). The two forms
// are one template apart (AT) and draw the same Philox words from the same
// offset; the by-value form's code is unchanged by the other.

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
// The uint8 kernel's geometry (picked on the H100, PERF.md).
constexpr int U8_THREADS = 512;
constexpr int U8_GROUPS = 3;
constexpr long long U8_MAX_N = 0x7FFFFFFFLL;

enum Kind { KIND_F32 = 0, KIND_U8 = 2 };

struct BlendParams {
  long long per_sample;   // H * W * C
  int vec;                // pointers aligned for one vector access a group
  unsigned long long offset;
  const long long* offset_at;  // the offset on the device (AT kernels)
  unsigned long long base;     // element_base: run 0's first global element
  long long run_len;           // elements of a run (n for one run)
  long long run_stride;        // global elements from one run to the next
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

// The stream offset of a launch: by value, or read from the device.
template <bool AT>
__device__ __forceinline__ unsigned long long stream_offset(
    const BlendParams& p) {
  return AT ? (unsigned long long)*p.offset_at : p.offset;
}

// Four standard normals of group `group`: elements 4 group .. 4 group + 3.
__device__ __forceinline__ float4 normals4(unsigned long long group,
                                          unsigned long long offset,
                                          const BlendParams& p) {
  const uint4 w = philox4x32_10(group, offset, p.k0, p.k1);
  const float r01 = __fsqrt_rn(__fmul_rn(-2.0f, logf(uniform(w.x))));
  const float t1 = __fmul_rn(TWO_PI, uniform(w.y));
  const float r23 = __fsqrt_rn(__fmul_rn(-2.0f, logf(uniform(w.z))));
  const float t3 = __fmul_rn(TWO_PI, uniform(w.w));
  float s1, c1, s3, c3;
  sincosf(t1, &s1, &c1);
  sincosf(t3, &s3, &c3);
  return make_float4(__fmul_rn(r01, c1), __fmul_rn(r01, s1),
                     __fmul_rn(r23, c3), __fmul_rn(r23, s3));
}

__device__ __forceinline__ float blend(float x, float eps, float r) {
  return __fadd_rn(__fmul_rn(__fsqrt_rn(__fsub_rn(1.0f, r)), x),
                   __fmul_rn(__fsqrt_rn(r), eps));
}

// Run blockIdx.y of a launch: its first global group, the lanes of that
// group below the run (shift), and its first local element.
struct Run {
  unsigned long long gbase;
  long long local0;
  int shift;
};

__device__ __forceinline__ Run this_run(const BlendParams& p) {
  const long long j = blockIdx.y;
  const unsigned long long start =
      p.base + (unsigned long long)j * (unsigned long long)p.run_stride;
  return {start >> 2, j * p.run_len, (int)(start & 3)};
}

template <bool AT>
__global__ void __launch_bounds__(THREADS)
noise_blend_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                       BlendParams p) {
  const Run run = this_run(p);
  const long long n = p.run_len;
  x += run.local0;
  out += run.local0;
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  // Index in the run of the group's lane 0: below 0 for the lanes of a
  // shared first group that belong to the rows before the run's.
  const long long i0 = 4 * g - run.shift;
  if (i0 >= n) return;
  const float4 e4 = normals4(run.gbase + (unsigned long long)g,
                             stream_offset<AT>(p), p);
  const float eps[4] = {e4.x, e4.y, e4.z, e4.w};
  const bool full = i0 >= 0 && i0 + 4 <= n;
  const bool vec = p.vec && run.shift == 0;

  float v[4];
  if (vec && full) {
    const float4 q = *reinterpret_cast<const float4*>(x + i0);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = i0 + k >= 0 && i0 + k < n ? x[i0 + k] : 0.f;
  }

  // Sample of the first element in the launch; the next follow on.
  const long long first = run.local0 + (i0 < 0 ? 0 : i0);
  long long b = first / p.per_sample;
  long long rem = first - b * p.per_sample;
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool ok = i0 + k >= 0 && i0 + k < n;
    r[k] = ok ? p.ratios[b] : 0.f;
    if (ok && ++rem == p.per_sample) {
      rem = 0;
      ++b;
    }
  }
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = blend(v[k], eps[k], r[k]);

  if (vec && full) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k >= 0 && i0 + k < n) out[i0 + k] = o[k];
  }
}

// sqrt(1 - r) and sqrt(r) for the sample of element i of a run that starts
// at local element local0, in the blocks whose elements straddle samples;
// out of line, since no other block calls it.
__device__ __noinline__ float2 sample_factors(const float* ratios, uint32_t i,
                                              uint32_t n, uint32_t local0,
                                              uint32_t per_sample) {
  const float r = i < n ? ratios[(local0 + i) / per_sample] : 0.f;
  return make_float2(__fsqrt_rn(__fsub_rn(1.0f, r)), __fsqrt_rn(r));
}

// out = sqrt(1 - r[b]) * table[c][x] + sqrt(r[b]) * eps over a uint8 batch
// of C channels; n < 2^31 (the host checks it). Group g of a run is global
// group gbase + g, whose lane 0 is element 4 g - shift of the run: in
// 32-bit arithmetic the skipped lanes of group 0 wrap to 2^32 - 3 or above,
// past any n, so the one test `i < n` skips them.
template <int C, bool AT>
__global__ void __launch_bounds__(U8_THREADS, 65536 / (64 * U8_THREADS))
normalise_noise_blend_u8_kernel(const uint8_t* __restrict__ x,
                                float* __restrict__ out, BlendParams p) {
  __shared__ float table[C][256];
  const Run run = this_run(p);
  const uint32_t n = (uint32_t)p.run_len, per_sample = (uint32_t)p.per_sample;
  const uint32_t local0 = (uint32_t)run.local0;
  x += local0;
  out += local0;
  const uint32_t shift = (uint32_t)run.shift;
  const bool vec = p.vec && shift == 0;
  const uint32_t first = blockIdx.x * (U8_GROUPS * U8_THREADS);
  const uint32_t g0 = first + threadIdx.x;

  // The bytes first, so that their latency overlaps the table's staging.
  uint32_t bytes[U8_GROUPS];
#pragma unroll
  for (int j = 0; j < U8_GROUPS; ++j) {
    const uint32_t i0 = 4 * (g0 + j * U8_THREADS) - shift;
    if (vec && i0 + 4 <= n) {
      bytes[j] = *reinterpret_cast<const uint32_t*>(x + i0);
    } else {
      bytes[j] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < n) bytes[j] |= (uint32_t)x[i0 + k] << (8 * k);
    }
  }
  // One ratio for the block unless its elements straddle samples (a block
  // of a window's run past the run's end takes its last element's).
  const uint32_t lo = min(first == 0 ? 0 : 4 * first - shift, n - 1);
  const uint32_t hi = min(n, 4 * (first + U8_GROUPS * U8_THREADS) - shift) - 1;
  const uint32_t b = (local0 + lo) / per_sample;
  const bool one_sample = local0 + hi - b * per_sample < per_sample;
  const float r = p.ratios[b];

#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int v = threadIdx.x; v < 256; v += U8_THREADS)
      table[c][v] = __fdiv_rn(__fsub_rn((float)v, p.mean255[c]),
                              p.std255[c]);
  __syncthreads();

  const float keep = __fsqrt_rn(__fsub_rn(1.0f, r)), mix = __fsqrt_rn(r);
  const unsigned long long offset = stream_offset<AT>(p);
#pragma unroll
  for (int j = 0; j < U8_GROUPS; ++j) {
    const uint32_t g = g0 + j * U8_THREADS;
    const uint32_t i0 = 4 * g - shift;
    if (4 * g >= n + shift) break;
    const float4 e4 = normals4(run.gbase + g, offset, p);
    const float eps[4] = {e4.x, e4.y, e4.z, e4.w};
    // i0 + 4C wraps a skipped lane 0 back to its channel below the launch.
    const int c0 = (int)((i0 + 4u * C) % C);
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = table[(c0 + k) % C][(bytes[j] >> (8 * k)) & 0xFF];
      float2 f = make_float2(keep, mix);
      if (!one_sample)
        f = sample_factors(p.ratios, i0 + k, n, local0, per_sample);
      o[k] = __fadd_rn(__fmul_rn(f.x, v), __fmul_rn(f.y, eps[k]));
    }
    if (vec && i0 + 4 <= n) {
      *reinterpret_cast<float4*>(out + i0) =
          make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < n) out[i0 + k] = o[k];
    }
  }
}

template <int C, bool AT>
void launch_u8(long long groups, unsigned runs, const uint8_t* x, float* out,
               const BlendParams& p, cudaStream_t s) {
  const long long span = (long long)U8_GROUPS * U8_THREADS;
  const dim3 grid((unsigned)((groups + span - 1) / span), runs);
  normalise_noise_blend_u8_kernel<C, AT><<<grid, U8_THREADS, 0, s>>>(x, out,
                                                                     p);
}

// Debug entry: the raw Philox words of groups group_base .. group_base +
// groups - 1, the offset by value or (AT) from the device.
template <bool AT>
__global__ void __launch_bounds__(THREADS)
philox_words_kernel(uint4* __restrict__ out, long long groups,
                    unsigned long long group_base, unsigned long long offset,
                    const long long* offset_at, uint32_t k0, uint32_t k1) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const unsigned long long o =
      AT ? (unsigned long long)*offset_at : offset;
  if (g < groups)
    out[g] = philox4x32_10(group_base + (unsigned long long)g, o, k0, k1);
}

unsigned grid_for(long long groups) {
  return (unsigned)((groups + THREADS - 1) / THREADS);
}

// `groups`: the Philox groups of the longest run; `runs`: blockIdx.y.
template <bool AT>
void launch_blend(int in_kind, int chans, long long groups, unsigned runs,
                  const void* x, float* out, const BlendParams& p,
                  cudaStream_t s) {
  const uint8_t* x8 = static_cast<const uint8_t*>(x);
  if (in_kind == KIND_U8) {
    switch (chans) {
      case 1: launch_u8<1, AT>(groups, runs, x8, out, p, s); break;
      case 2: launch_u8<2, AT>(groups, runs, x8, out, p, s); break;
      case 3: launch_u8<3, AT>(groups, runs, x8, out, p, s); break;
      default: launch_u8<4, AT>(groups, runs, x8, out, p, s); break;
    }
  } else {
    noise_blend_f32_kernel<AT><<<dim3(grid_for(groups), runs), THREADS, 0,
                                 s>>>(static_cast<const float*>(x), out, p);
  }
}

// The checks and launch both entries share; offset_at NULL: by value.
int noise_blend(int in_kind, const void* x, float* out, long long n,
                long long per_sample, int chans, const float* ratios,
                const float* norm, unsigned long long seed,
                unsigned long long offset, const long long* offset_at,
                unsigned long long element_base, long long run_len,
                long long run_stride, void* stream) {
  if (n <= 0 || per_sample <= 0 || n % per_sample || chans <= 0 ||
      per_sample % chans || chans > MAX_C)
    return (int)cudaErrorInvalidValue;
  if ((in_kind == KIND_U8) != (norm != nullptr))
    return (int)cudaErrorInvalidValue;
  if (in_kind != KIND_U8 && in_kind != KIND_F32)
    return (int)cudaErrorInvalidValue;
  if (run_len <= 0 || n % run_len || run_len % chans || run_stride < 0 ||
      (run_len < n && run_stride < run_len) || n / run_len > 65535)
    return (int)cudaErrorInvalidValue;
  const unsigned runs = (unsigned)(n / run_len);
  // One run: its own shift; several: any shift when the stride moves it.
  const int shift = (int)(element_base & 3);
  const long long groups =
      runs == 1 || run_stride % 4 == 0 ? (run_len + shift + 3) / 4
                                       : (run_len + 6) / 4;
  if (groups > (long long)THREADS * 0x7FFFFFFFLL ||
      (in_kind == KIND_U8 && n > U8_MAX_N))
    return (int)cudaErrorInvalidValue;
  if (offset_at && (uintptr_t)offset_at % 8)
    return (int)cudaErrorInvalidValue;
  BlendParams p;
  p.per_sample = per_sample;
  const size_t in_align = in_kind == KIND_U8 ? 4 : 16;
  p.vec = (uintptr_t)x % in_align == 0 && (uintptr_t)out % 16 == 0 &&
          (runs == 1 || run_len % 4 == 0);
  p.offset = offset;
  p.offset_at = offset_at;
  p.base = element_base;
  p.run_len = run_len;
  p.run_stride = run_stride;
  p.k0 = (uint32_t)seed;
  p.k1 = (uint32_t)(seed >> 32);
  p.ratios = ratios;
  for (int c = 0; c < MAX_C; ++c) {
    p.mean255[c] = (norm && c < chans) ? norm[c] : 0.0f;
    p.std255[c] = (norm && c < chans) ? norm[chans + c] : 1.0f;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (offset_at)
    launch_blend<true>(in_kind, chans, groups, runs, x, out, p, s);
  else
    launch_blend<false>(in_kind, chans, groups, runs, x, out, p, s);
  return (int)cudaGetLastError();
}

int philox_words(uint32_t* out, long long groups, unsigned long long seed,
                 unsigned long long offset, const long long* offset_at,
                 unsigned long long group_base, void* stream) {
  if (groups <= 0 || groups > (long long)THREADS * 0x7FFFFFFFLL ||
      (uintptr_t)out % 16 || (offset_at && (uintptr_t)offset_at % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* o = reinterpret_cast<uint4*>(out);
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  if (offset_at)
    philox_words_kernel<true><<<grid_for(groups), THREADS, 0, s>>>(
        o, groups, group_base, 0, offset_at, k0, k1);
  else
    philox_words_kernel<false><<<grid_for(groups), THREADS, 0, s>>>(
        o, groups, group_base, offset, nullptr, k0, k1);
  return (int)cudaGetLastError();
}

}  // namespace

// One blend over a contiguous (B, H, W, C) batch of n = B * per_sample
// elements in runs of run_len (run_len = n: one run), run j's first
// element being element `element_base + j * run_stride` of the stream.
// in_kind 2 (uint8) needs `norm`, a host array of 2 * chans floats
// (mean*255 then std*255), and n < 2^31; in_kind 0 (fp32) takes NULL.
// `ratios` is a device array of B floats. Returns 0 or the CUDA error of
// the launch; refuses before any launch what the kernels cannot take.
extern "C" int d3f_noise_blend(int in_kind, const void* x, float* out,
                               long long n, long long per_sample, int chans,
                               const float* ratios, const float* norm,
                               unsigned long long seed,
                               unsigned long long offset,
                               unsigned long long element_base,
                               long long run_len, long long run_stride,
                               void* stream) {
  return noise_blend(in_kind, x, out, n, per_sample, chans, ratios, norm,
                     seed, offset, nullptr, element_base, run_len,
                     run_stride, stream);
}

// The same blend with the offset read by the kernel from `offset_at`, an
// 8-byte-aligned device int64 (its bits taken as unsigned): a CUDA graph
// replays the launch with whatever the table holds then.
extern "C" int d3f_noise_blend_at(int in_kind, const void* x, float* out,
                                  long long n, long long per_sample,
                                  int chans, const float* ratios,
                                  const float* norm, unsigned long long seed,
                                  const long long* offset_at,
                                  unsigned long long element_base,
                                  long long run_len, long long run_stride,
                                  void* stream) {
  if (!offset_at) return (int)cudaErrorInvalidValue;
  return noise_blend(in_kind, x, out, n, per_sample, chans, ratios, norm,
                     seed, 0, offset_at, element_base, run_len, run_stride,
                     stream);
}

// The Philox words of groups group_base .. group_base + groups - 1 into
// `out` (4 * groups uint32).
extern "C" int d3f_philox_words(uint32_t* out, long long groups,
                                unsigned long long seed,
                                unsigned long long offset,
                                unsigned long long group_base,
                                void* stream) {
  return philox_words(out, groups, seed, offset, nullptr, group_base,
                      stream);
}

// The same with the offset read from the device int64 `offset_at`.
extern "C" int d3f_philox_words_at(uint32_t* out, long long groups,
                                   unsigned long long seed,
                                   const long long* offset_at,
                                   unsigned long long group_base,
                                   void* stream) {
  if (!offset_at) return (int)cudaErrorInvalidValue;
  return philox_words(out, groups, seed, 0, offset_at, group_base, stream);
}
