// Affine-warp kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * warp_axis_pass_pallas    (ops/pallas/warp_kernel.py:126, body :99-123)
//                              -> warp_pass_kernel, entry d3f_warp_pass
//   * affine_warp_pallas_fused (ops/pallas/warp_fused.py:140, body :54-137)
//                              -> warp_fused_kernel, entry d3f_warp_fused
//
// Both compute the same 1-D resample pass, once along x and once along y of
// an LDU shear factorisation of the inverse affine map:
//
//   G(o)     = sum_i bf16(x[i]) * bf16(hat(src(o) - i)),
//   src(o)   = alpha * ((o - K + base) - c) + c,      c = n / 2,
//   out[t]   = sum_m hat(resid - m) * G(t + m + K),  m in [-K, K],
//
// with `base` the per-(sample, 32-line block) integer shift and `resid` the
// per-line residual displacement (pass_scalars in warp_kernel.py). The TPU
// kernel evaluates G as a dense banded bf16 matmul on the MXU and the second
// sum as a 25-tap MAC. Each column of the band matrix and each row of the
// residual weights has at most two nonzero taps, so here both sums are
// 2-tap gathers (`band_column` and `resid_taps` find the taps, `band_sum`
// and `combine` sum them). The bf16 products are exact in fp32 and every
// other term of the TPU's sums is an exact zero, so the gather reproduces
// the matmul's result bit for bit, provided every fp32 operation rounds
// where the reference's does: the source is built with -fmad=false and the
// rounding intrinsics spell out each step, with the one fused multiply-add
// the reference has (the residual MAC's accumulation).
//
// warp_pass_kernel, one pass over fp32 views of any strides (the two-pass
// warp): a block owns LB = 16 lines of one sample (half of a 32-line block,
// so all its lines share one `base`), stages them in bf16 in shared memory
// and writes every output position of those lines. Bound: memory, 4 + 4
// bytes an element (77.1 MB at 448^2 x 16, 23.0 us at 3.35 TB/s).
//
// warp_fused_kernel, both passes in one launch with no scratch in device
// memory. A 448^2 sample in bf16 (1.2 MB) does not fit in the 227 KB of
// shared memory a block may use, so the TPU's whole-sample residency does
// not carry over; instead a block of 512 threads owns S = 32 output columns
// of one sample (one 32-column group, so they share one `base`) over its
// full height. The y-pass of those columns needs the x-pass result of the
// same columns only (it resamples along y), and the x-pass of a row reads
// that source row only, so no halo is needed:
//   * phase 1, x-pass: a thread takes P = 2 consecutive strip columns of a
//     row, reads the C channels straight from the NHWC source (a row's span
//     is about alpha * S + 3 pixels, so neighbouring strips hit in L1/L2)
//     and writes a bf16 strip T[H][PITCH] in shared memory (C values a
//     column; 88 KB at 448^2, two blocks an SM);
//   * phase 2, y-pass: a thread takes P consecutive rows of one strip
//     column, reads T and writes fp32 NHWC: a warp stores a whole row of
//     the strip, S * C * 4 = 384 contiguous bytes at C = 3.
// The tap geometry is what costs instructions, so it is shared as far as
// the math allows: a line's residual taps are found once for all its
// outputs; output t and t + 1 share a band column, so a run of P outputs
// needs P + 1 columns, not 2P; and each column is found once for all C
// channels. uint8 input is staged through a per-channel 256-entry table of
// bf16(normalise(u)), built once a block: the same division and rounding as
// the reference's, outside the inner loop. The strip's row pitch is an odd
// number of 32-bit words (49 at C = 3), so rows fall on rotating banks: the
// 32 lanes of a phase-2 load read 32 values spread over 48 words of about
// one row, two wavefronts, where a row pitch that is a multiple of 32 words
// would put every row a warp touches on the same banks. C is a template
// parameter (1 to 4) and every index is 32-bit within a sample. P, S and
// the thread count were chosen by tune_warp_fused.py. Bound: memory, 1 byte
// in and 4 out an element (48.2 MB at 448^2 x 16, 14.4 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int K = 12;      // residual half-width (warp_kernel.py:41)
constexpr int ROWS = 32;   // lines per block-quantisation group (:43)
constexpr int LB = 16;     // lines per CUDA block of the pass kernel
constexpr int THREADS = 256;  // threads per block of the pass kernel
constexpr int S = 32;      // output columns per block of the fused kernel
constexpr int P = 2;       // consecutive outputs a thread of it computes
constexpr int FUSED_THREADS = 512;
constexpr int MAX_C = 4;
static_assert(ROWS % LB == 0 && ROWS % S == 0 && S % P == 0 &&
                  FUSED_THREADS % S == 0,
              "tiling");

// Row pitch of the fused kernel's strip, in bf16: S * C values rounded up
// to an odd number of 32-bit words.
__host__ __device__ constexpr int strip_pitch(int c) {
  return 2 * (((S * c + 1) / 2) | 1);
}

// clip(1 - |x|, 0, 1), the hat weight of warp_kernel.py:66 and :94.
__device__ __forceinline__ float hat(float x) {
  return fminf(fmaxf(__fsub_rn(1.0f, fabsf(x)), 0.0f), 1.0f);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The residual taps of a line: m0 = floor(resid) and m0 + 1, each valid
// when |m| <= K, with their hat weights. They depend on the line alone.
struct Resid {
  float hr[2];
  bool ok[2];
  int m0;
};

__device__ __forceinline__ Resid resid_taps(float r) {
  Resid q;
  const float m0 = floorf(r);
  q.m0 = (int)m0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float mf = __fadd_rn(m0, (float)k);
    const int m = (int)mf;
    q.ok[k] = m >= -K && m <= K;
    q.hr[k] = hat(__fsub_rn(r, mf));
  }
  return q;
}

// Band column o = t + m + K of a line, given as j = o - K + base = t + m +
// base: src(o) = alpha * (j - c) + c, its two source taps i, i + 1 (valid
// inside [0, n)) and their bf16 hat weights. It depends on the column, not
// on the channel or on which output uses it.
struct Band {
  float w0, w1;
  int i;
  bool ok0, ok1;
};

__device__ __forceinline__ Band band_column(int j, float alpha, float center,
                                            int n) {
  Band g;
  const float x = __fsub_rn((float)j, center);
  const float src = __fadd_rn(__fmul_rn(alpha, x), center);
  const float i0f = floorf(src);
  g.i = (int)i0f;
  g.ok0 = g.i >= 0 && g.i < n;
  g.ok1 = g.i + 1 >= 0 && g.i + 1 < n;
  g.w0 = round_bf16(hat(__fsub_rn(src, i0f)));
  g.w1 = round_bf16(hat(__fsub_rn(src, __fadd_rn(i0f, 1.0f))));
  return g;
}

// G(o) of one channel; `at(i)` is the staged (bf16-valued) input at i.
template <typename At>
__device__ __forceinline__ float band_sum(const Band& g, At at) {
  float s = 0.0f;
  if (g.ok0) s = __fadd_rn(s, __fmul_rn(at(g.i), g.w0));
  if (g.ok1) s = __fadd_rn(s, __fmul_rn(at(g.i + 1), g.w1));
  return s;
}

// out[t] from G at the columns of its two residual taps. One rounding per
// tap: the reference evaluates `acc + w * g` as a fused multiply-add (XLA
// contracts it; residual_mac in warp_kernel.py:69-75).
__device__ __forceinline__ float combine(const Resid& q, float g0, float g1) {
  float acc = 0.0f;
  if (q.ok[0]) acc = __fmaf_rn(q.hr[0], g0, acc);
  if (q.ok[1]) acc = __fmaf_rn(q.hr[1], g1, acc);
  return acc;
}

// ---------------------------------------------------------------- pass --

// Iteration order over a (line, pos, chan) tile, outermost to innermost.
// Code = outer * 9 + middle * 3 + inner with line = 0, pos = 1, chan = 2.
enum Order { LIC = 5, LCI = 7, ILC = 11, ICL = 15, CLI = 19, CIL = 21 };

struct PassParams {
  int lines, chans, n, nblocks;
  long long s_b, s_l, s_c, s_i;  // source strides, elements
  long long d_b, d_l, d_c, d_t;  // destination strides, elements
  int load_order, store_order;
  const float* alpha;  // (B,)
  const int* base;     // (B, lines / ROWS)
  const float* resid;  // (B, lines)
  float center;        // n / 2
};

__device__ __forceinline__ void split(int f, int order, int nl, int ni, int nc,
                                      int& l, int& i, int& c) {
  switch (order) {
    case LIC: c = f % nc; f /= nc; i = f % ni; l = f / ni; break;
    case LCI: i = f % ni; f /= ni; c = f % nc; l = f / nc; break;
    case ILC: c = f % nc; f /= nc; l = f % nl; i = f / nl; break;
    case ICL: l = f % nl; f /= nl; c = f % nc; i = f / nc; break;
    case CLI: i = f % ni; f /= ni; l = f % nl; c = f / nl; break;
    default:  l = f % nl; f /= nl; i = f % ni; c = f / ni; break;  // CIL
  }
}

__global__ void __launch_bounds__(THREADS)
warp_pass_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 PassParams p) {
  extern __shared__ __nv_bfloat16 tile[];  // [LB][chans][n]
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * LB;
  const int total = LB * p.chans * p.n;

  const float* s = src + b * p.s_b + l0 * p.s_l;
  for (int f = threadIdx.x; f < total; f += THREADS) {
    int l, i, c;
    split(f, p.load_order, LB, p.n, p.chans, l, i, c);
    tile[(l * p.chans + c) * p.n + i] =
        __float2bfloat16_rn(s[l * p.s_l + c * p.s_c + i * p.s_i]);
  }
  __syncthreads();

  const float alpha = p.alpha[b];
  const int base = p.base[b * p.nblocks + l0 / ROWS];
  const float* resid = p.resid + b * p.lines + l0;
  float* d = dst + b * p.d_b + l0 * p.d_l;
  for (int f = threadIdx.x; f < total; f += THREADS) {
    int l, t, c;
    split(f, p.store_order, LB, p.n, p.chans, l, t, c);
    const __nv_bfloat16* row = tile + (l * p.chans + c) * p.n;
    auto at = [&](int i) { return __bfloat162float(row[i]); };
    const Resid q = resid_taps(resid[l]);
    const int j = t + q.m0 + base;
    d[l * p.d_l + c * p.d_c + t * p.d_t] = combine(
        q, q.ok[0] ? band_sum(band_column(j, alpha, p.center, p.n), at) : 0.f,
        q.ok[1] ? band_sum(band_column(j + 1, alpha, p.center, p.n), at)
                : 0.f);
  }
}

int order_of(long long sl, long long si, long long sc) {
  // Roles sorted by stride, largest (outermost) first; ties keep role order.
  long long s[3] = {sl, si, sc};
  int r[3] = {0, 1, 2};
  for (int a = 0; a < 3; ++a)
    for (int b = a + 1; b < 3; ++b)
      if (s[r[b]] > s[r[a]]) { int t = r[a]; r[a] = r[b]; r[b] = t; }
  return r[0] * 9 + r[1] * 3 + r[2];
}

// --------------------------------------------------------------- fused --

struct FusedParams {
  int h, w;
  const float* alpha_x;  // (B,)
  const int* base_x;     // (B, H / ROWS)
  const float* resid_x;  // (B, H)
  const float* alpha_y;  // (B,)
  const int* base_y;     // (B, W / ROWS)
  const float* resid_y;  // (B, W)
  int norm;
  float mean255[MAX_C];
  float std255[MAX_C];
};

// A parameter-struct array indexed without a run-time index, so it stays in
// registers (a run-time index copies the struct to local memory).
__device__ __forceinline__ float pick(const float (&a)[MAX_C], int c) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < MAX_C; ++j) v = c == j ? a[j] : v;
  return v;
}

// A true division, as normalise_batch and warp_fused.py:93 do.
__device__ __forceinline__ float normalise(float v, float m255, float s255) {
  return __fdiv_rn(__fsub_rn(v, m255), s255);
}

// P consecutive outputs of one line, all C channels. Output t uses the band
// columns j = t + m0 + base and j + 1, so the run needs P + 1 columns, each
// found once and summed once a channel (`at(i, c)` is the staged input).
template <int C, typename At>
__device__ __forceinline__ void resample_run(const Resid& q, int j0,
                                             float alpha, float center, int n,
                                             At at, float (&out)[P][C]) {
  float g[P + 1][C];
#pragma unroll
  for (int k = 0; k <= P; ++k) {
    const Band band = band_column(j0 + k, alpha, center, n);
#pragma unroll
    for (int c = 0; c < C; ++c)
      g[k][c] = band_sum(band, [&](int i) { return at(i, c); });
  }
#pragma unroll
  for (int t = 0; t < P; ++t)
#pragma unroll
    for (int c = 0; c < C; ++c) out[t][c] = combine(q, g[t][c], g[t + 1][c]);
}

template <typename Tin, int C>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
warp_fused_kernel(const Tin* __restrict__ src, float* __restrict__ dst,
                  FusedParams p) {
  constexpr bool kU8 = sizeof(Tin) == 1;
  constexpr int PITCH = strip_pitch(C);
  constexpr int RUNS = S / P;  // threads a row of the strip in phase 1
  extern __shared__ float smem[];
  float* lut = smem;  // [C][256] staged values of a uint8 channel
  __nv_bfloat16* strip =
      reinterpret_cast<__nv_bfloat16*>(smem + (kU8 ? C * 256 : 0));
  const int h = p.h, w = p.w;
  const int b = blockIdx.y;
  const int x0 = blockIdx.x * S;

  if (kU8) {
    for (int f = threadIdx.x; f < C * 256; f += FUSED_THREADS) {
      const int c = f >> 8;
      const float u = (float)(f & 255);
      lut[f] = round_bf16(
          p.norm ? normalise(u, pick(p.mean255, c), pick(p.std255, c)) : u);
    }
    __syncthreads();
  }

  // Phase 1: x-pass of the strip's columns, every row, into T; a thread
  // takes P consecutive columns of a row.
  const Tin* s = src + (size_t)b * h * w * C;
  const float ax = p.alpha_x[b];
  const float cx = (float)w / 2.0f;
  const bool norm = p.norm;
  float m255[C], s255[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    m255[c] = p.mean255[c];
    s255[c] = p.std255[c];
  }
  const int t1 = (threadIdx.x % RUNS) * P;
  for (int v = threadIdx.x / RUNS; v < h; v += FUSED_THREADS / RUNS) {
    const Resid q = resid_taps(p.resid_x[b * h + v]);
    const int j0 = x0 + t1 + q.m0 + p.base_x[b * (h / ROWS) + v / ROWS];
    const Tin* row = s + v * w * C;
    float o[P][C];
    resample_run<C>(q, j0, ax, cx, w, [&](int i, int c) {
      if constexpr (kU8) {
        return lut[c * 256 + row[i * C + c]];
      } else {
        const float x = row[i * C + c];
        return round_bf16(norm ? normalise(x, m255[c], s255[c]) : x);
      }
    }, o);
    __nv_bfloat16* t = strip + v * PITCH + t1 * C;
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) t[k * C + c] = __float2bfloat16_rn(o[k][c]);
  }
  __syncthreads();

  // Phase 2: y-pass out of T into fp32 NHWC; a thread takes P consecutive
  // rows of one column, whose residual taps are the column's.
  const int xs = threadIdx.x % S;
  const Resid q = resid_taps(p.resid_y[b * w + x0 + xs]);
  const int j0 = q.m0 + p.base_y[b * (w / ROWS) + x0 / ROWS];
  const float ay = p.alpha_y[b];
  const float cy = (float)h / 2.0f;
  const __nv_bfloat16* col = strip + xs * C;
  float* d = dst + (size_t)b * h * w * C + (x0 + xs) * C;
  for (int y0 = threadIdx.x / S * P; y0 < h;
       y0 += FUSED_THREADS / S * P) {
    float o[P][C];
    resample_run<C>(q, y0 + j0, ay, cy, h, [&](int i, int c) {
      return __bfloat162float(col[i * PITCH + c]);
    }, o);
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) d[(y0 + k) * w * C + c] = o[k][c];
  }
}

template <typename Tin, int C>
int launch_fused(const void* src, float* dst, const FusedParams& p,
                 int batch, cudaStream_t stream) {
  const size_t smem = (sizeof(Tin) == 1 ? C * 256 * sizeof(float) : 0) +
                      (size_t)p.h * strip_pitch(C) * sizeof(__nv_bfloat16);
  auto kernel = warp_fused_kernel<Tin, C>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(p.w / S, batch);
  kernel<<<grid, FUSED_THREADS, smem, stream>>>(
      static_cast<const Tin*>(src), dst, p);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch_fused_c(int chans, const void* src, float* dst,
                   const FusedParams& p, int batch, cudaStream_t stream) {
  switch (chans) {
    case 1: return launch_fused<Tin, 1>(src, dst, p, batch, stream);
    case 2: return launch_fused<Tin, 2>(src, dst, p, batch, stream);
    case 3: return launch_fused<Tin, 3>(src, dst, p, batch, stream);
    case 4: return launch_fused<Tin, 4>(src, dst, p, batch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One resample pass over a (B, lines, chans, n) fp32 view of `src` into a
// view of the same shape of `dst`, each given by its element strides
// (b, l, c, i). Returns 0 or the CUDA error code of the launch.
extern "C" int d3f_warp_pass(const float* src, float* dst, int batch,
                             int lines, int chans, int n,
                             const long long* src_strides,
                             const long long* dst_strides, const float* alpha,
                             const int* base, const float* resid,
                             void* stream) {
  if (batch <= 0 || lines <= 0 || lines % ROWS || chans <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  PassParams p;
  p.lines = lines;
  p.chans = chans;
  p.n = n;
  p.nblocks = lines / ROWS;
  p.s_b = src_strides[0]; p.s_l = src_strides[1];
  p.s_c = src_strides[2]; p.s_i = src_strides[3];
  p.d_b = dst_strides[0]; p.d_l = dst_strides[1];
  p.d_c = dst_strides[2]; p.d_t = dst_strides[3];
  p.load_order = order_of(p.s_l, p.s_i, p.s_c);
  p.store_order = order_of(p.d_l, p.d_t, p.d_c);
  p.alpha = alpha;
  p.base = base;
  p.resid = resid;
  p.center = (float)n / 2.0f;
  const size_t smem = (size_t)LB * chans * n * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        warp_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(lines / LB, batch);
  warp_pass_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      src, dst, p);
  return (int)cudaGetLastError();
}

// The fused warp of a contiguous NHWC batch (uint8 when `in_u8`, else fp32)
// into a contiguous fp32 NHWC `dst`, from the two passes' scalars. `norm` is
// NULL or a host array of 2 * chans floats: mean*255 then std*255. Returns 0
// or the CUDA error code of the launch.
extern "C" int d3f_warp_fused(int in_u8, const void* src, float* dst,
                              int batch, int h, int w, int chans,
                              const float* alpha_x, const int* base_x,
                              const float* resid_x, const float* alpha_y,
                              const int* base_y, const float* resid_y,
                              const float* norm, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || h % ROWS || w % ROWS || chans <= 0 ||
      chans > MAX_C)
    return (int)cudaErrorInvalidValue;
  FusedParams p;
  p.h = h;
  p.w = w;
  p.alpha_x = alpha_x; p.base_x = base_x; p.resid_x = resid_x;
  p.alpha_y = alpha_y; p.base_y = base_y; p.resid_y = resid_y;
  p.norm = norm != nullptr;
  for (int c = 0; c < MAX_C; ++c) {
    p.mean255[c] = (norm && c < chans) ? norm[c] : 0.0f;
    p.std255[c] = (norm && c < chans) ? norm[chans + c] : 1.0f;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_u8 ? launch_fused_c<uint8_t>(chans, src, dst, p, batch, s)
               : launch_fused_c<float>(chans, src, dst, p, batch, s);
}
