// Affine-warp kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * warp_axis_pass_pallas    (ops/pallas/warp_kernel.py:126, body :99-123)
//                              -> warp_rows_kernel and warp_cols_kernel,
//                                 entry d3f_warp_pass
//   * affine_warp_pallas_fused (ops/pallas/warp_fused.py:140, body :54-137)
//                              -> warp_fused_kernel, entry d3f_warp_fused
//
// All compute the same 1-D resample pass, once along x and once along y of
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
// The tap geometry is what costs instructions, so every kernel shares it as
// far as the math allows (`resample_run`): a line's residual taps are found
// once for all its outputs; output t and t + 1 share a band column, so a run
// of P outputs needs P + 1 columns, not 2P; and each column is found once
// for all C channels. C is a template parameter (1 to 4; the pass entry runs
// more channels in groups of 4) and every index is 32-bit within a sample.
//
// One pass over fp32 (B, L, C, N) views of any strides (the two-pass warp,
// the 640^2 route). Bound: memory, 4 + 4 bytes an element: 77.1 MB and 23.0
// us at 448^2 x 16, 39.3 MB and 11.7 us at 640^2 x 4, on 3.35 TB/s. Two
// kernels, each specialised to one layout, with no run-time iteration order
// and no division per element; both are correct for every layout, and the
// entry takes the choice (warp_kernel.py picks it from the strides):
//   * warp_rows_kernel, where positions lie closer together in memory than
//     lines (the x-pass from NHWC, the (B, H, C, W) public layout). A warp
//     takes 32 * ROW_P consecutive outputs of one line, a thread ROW_P = 2
//     of them, all C channels; it reads the fp32 source through the
//     read-only path (a line's span is about alpha * 64 positions, so the
//     C * 2 * 3 tap loads of a thread hit in L1) and writes fp32, a warp
//     storing 64 consecutive positions a channel. No shared memory. Grid
//     (ceil(N / 64), L / 8, B) of 256 threads, one line a warp: 7 x 56 x 16
//     = 6,272 blocks at 448^2 x 16, 10 x 80 x 4 = 3,200 at 640^2 x 4 (8
//     blocks an SM are resident: 6 and 3 waves).
//   * warp_cols_kernel, where lines lie closer together than positions (the
//     y-pass, whose lines are image columns). A block of 512 threads owns
//     COL_S = 32 lines (one 32-line group, so they share one `base`) and a
//     segment of `seg` outputs of them. It stages, as bf16,
//     only the source rows the segment's outputs reach: the window follows
//     from `base`, alpha and |m| <= K through the same float operations as
//     `band_column`, and the strip has room for the window of |alpha| <=
//     1.5 (a wider one reads the source directly, so the kernel is right
//     for any alpha). The staging loads coalesce along the lines' unit
//     stride (32 lines of the planar intermediate are 128 contiguous
//     bytes); a thread then takes COL_P = 2 consecutive outputs of one
//     line, and a warp stores one row of 32 lines x C channels, 384
//     contiguous bytes in NHWC at C = 3. Segments of at most 224 outputs,
//     the line cut evenly (warp_kernel.py column_segment): grid (L / 32, 2,
//     16) = 448 blocks at 448^2 x 16 (224 outputs, a 376-row strip of 73.7
//     KB) and (20, 3, 4) = 240 at 640^2 x 4 (214 outputs, 361 rows, 70.8
//     KB); 3 blocks an SM fit by shared memory, so 1.1 waves and 0.6 of
//     one. Measured by tune_warp_pass.py on NVIDIA H100 80GB HBM3, 700 W:
//     0.0348 ms at 448^2 x 16 and 0.0137 ms at 640^2 x 4, against 0.0357
//     and 0.0145 ms for 16 lines and 256 threads; a full-height strip (80
//     blocks at 640^2 x 4) 0.0190 ms, segments of at most 160 0.0178 ms.
//   Banks of the column kernel (counted from the layout): the strip row
//   pitch is an odd number of 32-bit words (49 at C = 3: 96 values, padded
//   to 98), so rows fall on rotating banks. A staging store writes one
//   (row, channel) pair of 32 lines: bf16 values 3 apart over 48 words, two
//   wavefronts. A compute-phase load reads one value of each of 32 lines
//   in one or two rows (a line's `m0` differs from its neighbours' by at
//   most one): 48 words of a row, the next row's rotated by 49 words, so
//   two or three wavefronts. The old kernel's [16][C][n] tile had rows n / 2
//   words apart (a multiple of 32 at n = 448 and 640), so a warp's 32
//   stores or tap reads fell on one or two banks.
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
// uint8 input is staged through a per-channel 256-entry table of
// bf16(normalise(u)), built once a block: the same division and rounding as
// the reference's, outside the inner loop. The strip's row pitch is an odd
// number of 32-bit words (49 at C = 3), so rows fall on rotating banks: the
// 32 lanes of a phase-2 load read 32 values spread over 48 words of about
// one row, two wavefronts, where a row pitch that is a multiple of 32 words
// would put every row a warp touches on the same banks. P, S and the
// thread count were chosen by tune_warp_fused.py. Bound: memory, 1 byte in
// and 4 out an element (48.2 MB at 448^2 x 16, 14.4 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int K = 12;      // residual half-width (warp_kernel.py:41)
constexpr int ROWS = 32;   // lines per block-quantisation group (:43)
constexpr int S = 32;      // output columns per block of the fused kernel
constexpr int P = 2;       // consecutive outputs a thread of it computes
constexpr int FUSED_THREADS = 512;
constexpr int MAX_C = 4;
// Pass kernels; chosen by tune_warp_pass.py. A block of either has at most
// 1024 / threads * 256 threads' worth of registers: 64 a thread.
constexpr int ROW_P = 2;       // consecutive outputs a row-kernel thread
constexpr int ROW_WARPS = 8;   // lines a row-kernel block, one a warp
constexpr int COL_S = 32;      // lines a column-kernel block stages
constexpr int COL_P = 2;       // consecutive outputs a column-kernel thread
constexpr int COL_THREADS = 512;
static_assert(ROWS % S == 0 && S % P == 0 && FUSED_THREADS % S == 0 &&
                  ROWS % ROW_WARPS == 0 && ROWS % COL_S == 0 &&
                  COL_THREADS % COL_S == 0 && COL_THREADS / COL_S >= MAX_C,
              "tiling");

// Row pitch of a bf16 strip of `lines` lines of C values, in bf16: rounded
// up to an odd number of 32-bit words, so consecutive rows start on
// rotating banks.
__host__ __device__ constexpr int strip_pitch(int lines, int c) {
  return 2 * (((lines * c + 1) / 2) | 1);
}

// Source rows the column kernel's strip holds for segments of `seg` of `n`
// outputs: the whole line for one segment, else the window of |alpha| <=
// 1.5. The band columns of a segment span seg - 1 + 2K, so their taps span
// at most |alpha| * (seg - 1 + 2K) + 3 rows.
__host__ __device__ constexpr int window_rows(int seg) {
  return 3 * (seg + 2 * K) / 2 + 4;
}

__host__ __device__ constexpr int strip_rows(int n, int seg) {
  return seg >= n || window_rows(seg) >= n ? n : window_rows(seg);
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
// inside [lo, hi), which is [0, n) or a staged window that holds every tap
// in [0, n) of the columns the outputs use) and their bf16 hat weights. It
// depends on the column, not on the channel or on which output uses it.
struct Band {
  float w0, w1;
  int i;
  bool ok0, ok1;
};

__device__ __forceinline__ Band band_column(int j, float alpha, float center,
                                            int lo, int hi) {
  Band g;
  const float x = __fsub_rn((float)j, center);
  const float src = __fadd_rn(__fmul_rn(alpha, x), center);
  const float i0f = floorf(src);
  g.i = (int)i0f;
  g.ok0 = g.i >= lo && g.i < hi;
  g.ok1 = g.i + 1 >= lo && g.i + 1 < hi;
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

// RUN consecutive outputs of one line, all C channels. Output t uses the
// band columns j = t + m0 + base and j + 1, so the run needs RUN + 1
// columns, each found once and summed once a channel (`at(i, c)` is the
// staged input, read only at taps inside [lo, hi)).
template <int C, int RUN, typename At>
__device__ __forceinline__ void resample_run(const Resid& q, int j0,
                                             float alpha, float center,
                                             int lo, int hi, At at,
                                             float (&out)[RUN][C]) {
  float g[RUN + 1][C];
#pragma unroll
  for (int k = 0; k <= RUN; ++k) {
    const Band band = band_column(j0 + k, alpha, center, lo, hi);
#pragma unroll
    for (int c = 0; c < C; ++c)
      g[k][c] = band_sum(band, [&](int i) { return at(i, c); });
  }
#pragma unroll
  for (int t = 0; t < RUN; ++t)
#pragma unroll
    for (int c = 0; c < C; ++c) out[t][c] = combine(q, g[t][c], g[t + 1][c]);
}

// ---------------------------------------------------------------- pass --

struct PassParams {
  int lines, n, nblocks;
  int s_l, s_c, s_i;    // source strides within a sample, elements
  int d_l, d_c, d_t;    // destination strides within a sample, elements
  long long s_b, d_b;   // sample strides, elements
  int seg, rows_cap;    // column kernel: outputs a block, strip rows
  const float* alpha;   // (B,)
  const int* base;      // (B, lines / ROWS)
  const float* resid;   // (B, lines)
  float center;         // n / 2
};

template <int C>
__global__ void __launch_bounds__(32 * ROW_WARPS, 1024 / (32 * ROW_WARPS))
warp_rows_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 PassParams p) {
  const int b = blockIdx.z;
  const int l = blockIdx.y * ROW_WARPS + threadIdx.x / 32;
  const int t0 = (blockIdx.x * 32 + threadIdx.x % 32) * ROW_P;
  if (t0 >= p.n) return;
  const float* s = src + b * p.s_b + l * p.s_l;
  const Resid q = resid_taps(p.resid[b * p.lines + l]);
  const int j0 = t0 + q.m0 + p.base[b * p.nblocks + l / ROWS];
  float o[ROW_P][C];
  resample_run<C, ROW_P>(q, j0, p.alpha[b], p.center, 0, p.n,
                         [&](int i, int c) {
                           return round_bf16(__ldg(s + c * p.s_c +
                                                   i * p.s_i));
                         }, o);
  float* d = dst + b * p.d_b + l * p.d_l + t0 * p.d_t;
#pragma unroll
  for (int k = 0; k < ROW_P; ++k)
    if (t0 + k < p.n)
#pragma unroll
      for (int c = 0; c < C; ++c) d[k * p.d_t + c * p.d_c] = o[k][c];
}

template <int C>
__global__ void __launch_bounds__(COL_THREADS, 1024 / COL_THREADS)
warp_cols_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 PassParams p) {
  constexpr int PITCH = strip_pitch(COL_S, C);
  constexpr int STEP = COL_THREADS / COL_S;  // threads a line
  extern __shared__ __nv_bfloat16 strip[];   // [rows_cap][PITCH]
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * COL_S;
  const int t_begin = blockIdx.y * p.seg;
  const int t_end = min(t_begin + p.seg, p.n);
  const float alpha = p.alpha[b];
  const int base = p.base[b * p.nblocks + l0 / ROWS];
  const int sl = threadIdx.x % COL_S;
  const float* line = src + b * p.s_b + (l0 + sl) * p.s_l;

  // The window [lo, hi) of source rows the segment reaches: its outputs
  // use band columns j = t + m + base, |m| <= K, and src(j) is monotone.
  const Band first =
      band_column(t_begin - K + base, alpha, p.center, 0, p.n);
  const Band last = band_column(t_end - 1 + K + base, alpha, p.center, 0, p.n);
  const int lo = max(min(first.i, last.i), 0);
  const int hi = min(max(first.i, last.i) + 2, p.n);
  const bool staged = hi - lo <= p.rows_cap;  // uniform over the block
  // Staging: thread (sl, c, r0) loads channel c of rows r0, r0 + RSTEP, ...
  // of line sl; the 32 lines of a (row, channel) pair are one warp's lanes.
  // STEP % C threads a line stay idle here (1 of 16 at C = 3).
  constexpr int RSTEP = STEP / C;
  const int c_own = threadIdx.x / COL_S % C;
  const int r_own = threadIdx.x / COL_S / C;
  if (staged && r_own < RSTEP) {
    const float* from = line + c_own * p.s_c;
    __nv_bfloat16* to = strip + sl * C + c_own;
    for (int r = lo + r_own; r < hi; r += RSTEP)
      to[(r - lo) * PITCH] = __float2bfloat16_rn(__ldg(from + r * p.s_i));
  }
  __syncthreads();

  const int l = l0 + sl;
  const Resid q = resid_taps(p.resid[b * p.lines + l]);
  const int jq = q.m0 + base;
  float* d = dst + b * p.d_b + l * p.d_l;
  auto run = [&](int tap_lo, int tap_hi, auto at) {
    for (int t = t_begin + threadIdx.x / COL_S * COL_P; t < t_end;
         t += STEP * COL_P) {
      float o[COL_P][C];
      resample_run<C, COL_P>(q, t + jq, alpha, p.center, tap_lo, tap_hi, at,
                             o);
#pragma unroll
      for (int k = 0; k < COL_P; ++k)
        if (t + k < t_end)
#pragma unroll
          for (int c = 0; c < C; ++c)
            d[(t + k) * p.d_t + c * p.d_c] = o[k][c];
    }
  };
  if (staged) {
    const int off = sl * C - lo * PITCH;  // row i of the window at i * PITCH
    run(lo, hi, [&](int i, int c) {
      return __bfloat162float(strip[off + i * PITCH + c]);
    });
  } else {
    run(0, p.n, [&](int i, int c) {
      return round_bf16(__ldg(line + c * p.s_c + i * p.s_i));
    });
  }
}

template <int C>
int launch_pass(int kernel, const float* src, float* dst, const PassParams& p,
                int batch, cudaStream_t stream) {
  if (kernel == 0) {
    dim3 grid((p.n + 32 * ROW_P - 1) / (32 * ROW_P), p.lines / ROW_WARPS,
              batch);
    warp_rows_kernel<C><<<grid, 32 * ROW_WARPS, 0, stream>>>(src, dst, p);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)p.rows_cap * strip_pitch(COL_S, C) * sizeof(__nv_bfloat16);
  auto fn = warp_cols_kernel<C>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(p.lines / COL_S, (p.n + p.seg - 1) / p.seg, batch);
  fn<<<grid, COL_THREADS, smem, stream>>>(src, dst, p);
  return (int)cudaGetLastError();
}

bool fits_int(long long v) { return v >= 0 && v <= 0x7fffffffLL; }

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

template <typename Tin, int C>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
warp_fused_kernel(const Tin* __restrict__ src, float* __restrict__ dst,
                  FusedParams p) {
  constexpr bool kU8 = sizeof(Tin) == 1;
  constexpr int PITCH = strip_pitch(S, C);
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
    resample_run<C, P>(q, j0, ax, cx, 0, w, [&](int i, int c) {
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
    resample_run<C, P>(q, y0 + j0, ay, cy, 0, h, [&](int i, int c) {
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
                      (size_t)p.h * strip_pitch(S, C) * sizeof(__nv_bfloat16);
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
// (b, l, c, i); the l, c and i strides must fit 32 bits. `kernel` is 0 for
// warp_rows_kernel, 1 for warp_cols_kernel; `seg` is the outputs a block of
// the column kernel covers (n or more: the whole line). More than 4
// channels run as launches of up to 4. Returns 0 or the CUDA error code of
// the first launch that failed.
extern "C" int d3f_warp_pass(const float* src, float* dst, int batch,
                             int lines, int chans, int n,
                             const long long* src_strides,
                             const long long* dst_strides, const float* alpha,
                             const int* base, const float* resid, int kernel,
                             int seg, void* stream) {
  if (batch <= 0 || batch > 65535 || lines <= 0 || lines % ROWS ||
      chans <= 0 || n <= 0 || (kernel != 0 && kernel != 1) || seg <= 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 1; k < 4; ++k)
    if (!fits_int(src_strides[k]) || !fits_int(dst_strides[k]))
      return (int)cudaErrorInvalidValue;
  PassParams p;
  p.lines = lines;
  p.n = n;
  p.nblocks = lines / ROWS;
  p.s_b = src_strides[0]; p.s_l = (int)src_strides[1];
  p.s_c = (int)src_strides[2]; p.s_i = (int)src_strides[3];
  p.d_b = dst_strides[0]; p.d_l = (int)dst_strides[1];
  p.d_c = (int)dst_strides[2]; p.d_t = (int)dst_strides[3];
  p.seg = seg < n ? seg : n;
  p.rows_cap = strip_rows(n, p.seg);
  p.alpha = alpha;
  p.base = base;
  p.resid = resid;
  p.center = (float)n / 2.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < chans; c0 += MAX_C) {
    const float* gs = src + (size_t)c0 * p.s_c;
    float* gd = dst + (size_t)c0 * p.d_c;
    int err = (int)cudaErrorInvalidValue;
    switch (chans - c0 < MAX_C ? chans - c0 : MAX_C) {
      case 1: err = launch_pass<1>(kernel, gs, gd, p, batch, s); break;
      case 2: err = launch_pass<2>(kernel, gs, gd, p, batch, s); break;
      case 3: err = launch_pass<3>(kernel, gs, gd, p, batch, s); break;
      case 4: err = launch_pass<4>(kernel, gs, gd, p, batch, s); break;
    }
    if (err) return err;
  }
  return 0;
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
