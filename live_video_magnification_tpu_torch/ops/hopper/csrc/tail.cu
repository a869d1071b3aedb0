// Per-level temporal tail of the Riesz phase pipeline, for sm_90a.
//
// Three kernels for the four tail kernels of the reference package. They
// compute WHAT those compute, not how: the TPU kernels stream whole-width
// row strips through VMEM and run the 13-tap blurs as banded matmuls on the
// MXU; here a block stages a haloed tile in shared memory, mirroring the
// reflect-101 border by index as it loads (no padded copy in device memory),
// and the blurs are shifted multiply-adds from that tile.
//
//   lvmt_phase_df2  <- ops/pallas/riesz_phase_fused.py::riesz_phase_df2_fused
//                      phase_df2_kernel: rebuild selection, quaternion phase
//                      difference, amplitude, lo and hi DF-II, wc/ws.
//                      Element-wise: 18 planes in, 15 out.
//   lvmt_amplify13  <- ops/pallas/riesz_amplify.py::riesz_amplify_fused and
//                      ops/pallas/riesz_amplify_mxu.py::riesz_amplify_mxu
//                      amplify13_kernel<PREWEIGHTED, TB, TE, BF16>: the two
//                      TPU kernels compute one function (the MXU form exists
//                      only for the TPU's matrix unit), so one kernel serves
//                      both. ab = g13(amp), n = g13(w)/ab with w = change*amp
//                      (or the preweighted planes), then the phase rotation.
//                      6 planes in, 1 out. riesz_amplify_mxu's fast arms:
//                      amp/change planes of type TB and lowpass/Riesz planes
//                      of type TE (float or __nv_bfloat16, read as f32), and
//                      BF16, the bf16 blur operands of its default vertical
//                      matmul: the strip values (amp, w) and the taps rounded
//                      to bf16, the vertical (H-axis) pass first, its f32
//                      sums rounded to bf16 for the horizontal pass.
//   lvmt_level_tail <- ops/pallas/riesz_level_mxu.py::riesz_level_mxu
//                      level_tail_kernel: the phase front and the shared-
//                      accumulator DF-II recomputed on the tile plus a 6-px
//                      halo (the front is pointwise, so mirroring the inputs
//                      equals mirroring its products), then the blurs and the
//                      rotation of amplify13. 16 planes in, 11 out.
//
// Bounds on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32), at the 2160x3840 level
// (33.2 MB a plane): phase_df2 moves 33 planes, 1.095 GB, 0.327 ms;
// amplify13 7 planes, 0.069 ms (~200 operations a pixel: ~0.025 ms);
// level_tail 27 planes, 0.267 ms. All are bound by bytes. What the design
// does about it: every input plane is read from device memory once per
// block and every output written once; the blur intermediates (amp, wc, ws
// and their row passes) never leave shared memory. The halo rows and columns
// are read again by the neighbouring blocks, from L2.
//
// Blur tile: 32 x 64 outputs per block of 256 threads; the haloed tile is
// 44 x 76 for each of the three planes (40,128 bytes, under the 48 KB of
// static shared memory). The W-axis pass is written back in place (each
// thread holds its 11 sums in registers across a barrier), then the H-axis
// pass and the element-wise rotation run per output.
//
// Arithmetic: every product, sum, quotient and square root is rounded to f32
// on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no
// contraction into FMAs), in the order of the plain PyTorch versions
// (ops/hopper/tail.py): W-axis taps first, then H-axis taps, in tap order
// (H-axis first in the BF16 arm, as the reference kernel).
// The arccos of the phase is the reference kernels' polynomial (Abramowitz &
// Stegun 4.4.45), not acosf. sinf and cosf are the library's; they are the
// only operations that may round otherwise than the plain version on the CPU.
//
// C interface: plane pointers as a host array of void* (inputs, then
// outputs), sizes as int, scalars as float, coefficients and taps as host
// pointers copied into by-value kernel parameters, the stream as void*. Each
// function returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int HALO = 6;            // 13-tap reach
constexpr int TW = 64;             // outputs per block along W
constexpr int TH = 32;             // outputs per block along H
constexpr int SW = TW + 2 * HALO;  // haloed tile width
constexpr int SH = TH + 2 * HALO;  // haloed tile height
constexpr int NT = 256;            // threads per block (blur kernels)
constexpr int EW_THREADS = 256;    // threads per block (phase_df2)
constexpr float PI_F = 3.14159265358979323846f;  // float32(pi)

struct Taps13 {
  float k[13];
};

// b_lo[0..2], a_lo[1..2], b_hi[0..2], a_hi[1..2]: a[0] == 1 is assumed.
struct Coeffs {
  float b_lo[3];
  float a_lo[2];
  float b_hi[3];
  float a_hi[2];
};

struct PhasePlanes {
  // cur lp/r/i, old lp/r/i, lo (phase_c, phase_s, r0_c, r0_s, r1_c, r1_s), hi (...)
  const float* in[18];
  // amplitude, wc, ws, lo' (6), hi' (6)
  float* out[15];
};

// amp, cc, cs of the kernel's TB, lp, rr, ri of its TE
struct AmplifyPlanes {
  const void* amp;
  const void* cc;
  const void* cs;
  const void* lp;
  const void* rr;
  const void* ri;
  float* out;
};

struct LevelPlanes {
  // cur lp/r/i, old lp/r/i, acc c/s, lo r0_c/r0_s/r1_c/r1_s, hi (...)
  const float* in[16];
  // amplified lowpass, acc' c/s, lo' (4), hi' (4)
  float* out[11];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float madd(float acc, float v, float k) { return add(acc, mul(v, k)); }
__device__ __forceinline__ float nan_to_zero(float x) { return isnan(x) ? 0.f : x; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Reflect-101 for any p, periodic with period 2(n-1) as the plain version's
// index rule (ops/conv.py::reflect_index), so narrow sides agree with it.
__device__ __forceinline__ int reflect101(int p, int n) {
  if (p >= 0 && p < n) return p;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  p %= period;
  p = p < 0 ? p + period : p;
  return p >= n ? period - p : p;
}

// arccos for |x| <= 1 as the reference kernels compute it (A&S 4.4.45):
// sqrt(1-|x|) * poly(|x|), mirrored for x < 0. NaN stays NaN.
__device__ __forceinline__ float acos_poly(float x) {
  const float ax = fabsf(x);
  float p = mul(-0.0012624911f, ax);
  p = add(p, 0.0066700901f);
  p = sub(mul(p, ax), 0.0170881256f);
  p = add(mul(p, ax), 0.0308918810f);
  p = sub(mul(p, ax), 0.0501743046f);
  p = add(mul(p, ax), 0.0889789874f);
  p = sub(mul(p, ax), 0.2145988016f);
  p = add(mul(p, ax), 1.5707963050f);
  float t = sub(1.f, ax);
  t = t < 0.f ? 0.f : t;  // max(t, 0) that keeps a NaN
  const float r = mul(__fsqrt_rn(t), p);
  return x < 0.f ? sub(PI_F, r) : r;
}

// The quaternion phase difference cur * conj(old) (RieszPyramid.cpp:81-111)
// with the clamped-arccos quirk: out-of-range ratios map to +-1.0.
struct Front {
  float pd_c;
  float pd_s;
  float amp;
};

__device__ __forceinline__ Front phase_front(float c_lp, float c_r, float c_i, float o_lp,
                                             float o_r, float o_i) {
  const float q_real = add(add(mul(c_lp, o_lp), mul(c_r, o_r)), mul(c_i, o_i));
  const float qx = add(mul(o_r, -c_lp), mul(c_r, o_lp));
  const float qy = add(mul(o_i, -c_lp), mul(c_i, o_lp));
  const float xy_sq = add(mul(qx, qx), mul(qy, qy));
  const float q_amp = __fsqrt_rn(add(mul(q_real, q_real), xy_sq));
  const float ratio = quo(q_real, q_amp);
  const float clipped = ratio < -1.f ? -1.f : (ratio > 1.f ? 1.f : ratio);
  const float safe = acos_poly(clipped);
  const float phi = ratio < -1.f ? -1.f : (ratio > 1.f ? 1.f : safe);
  const float xyn = __fsqrt_rn(xy_sq);
  Front f;
  f.pd_c = nan_to_zero(mul(quo(qx, xyn), phi));
  f.pd_s = nan_to_zero(mul(quo(qy, xyn), phi));
  f.amp = __fsqrt_rn(q_amp);
  return f;
}

// One DF-II step on an accumulated phase (TemporalFilter.cpp:340-351):
// res = ph*b0 + r0; r0' = ph*b1 + r1 - res*a1; r1' = ph*b2 - res*a2.
__device__ __forceinline__ float df2(float ph, float& r0, float& r1, const float* b,
                                     const float* a) {
  const float res = add(mul(ph, b[0]), r0);
  const float n0 = sub(add(mul(ph, b[1]), r1), mul(res, a[0]));
  const float n1 = sub(mul(ph, b[2]), mul(res, a[1]));
  r0 = n0;
  r1 = n1;
  return res;
}

__global__ void __launch_bounds__(EW_THREADS)
phase_df2_kernel(PhasePlanes p, long long n, Coeffs k, int rebuild) {
  const long long stride = (long long)gridDim.x * EW_THREADS;
  for (long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x; i < n; i += stride) {
    const float c_lp = p.in[0][i], c_r = p.in[1][i], c_i = p.in[2][i];
    // rebuild: the prior pyramid is the current one and the filters restart
    // from zero (a selection, not a blend: inf state must not become NaN)
    float o_lp = c_lp, o_r = c_r, o_i = c_i;
    float st[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) st[j] = 0.f;
    if (!rebuild) {
      o_lp = p.in[3][i];
      o_r = p.in[4][i];
      o_i = p.in[5][i];
#pragma unroll
      for (int j = 0; j < 12; ++j) st[j] = p.in[6 + j][i];
    }
    const Front f = phase_front(c_lp, c_r, c_i, o_lp, o_r, o_i);

    const float lo_pc = add(st[0], f.pd_c), lo_ps = add(st[1], f.pd_s);
    const float lo_res_c = df2(lo_pc, st[2], st[4], k.b_lo, k.a_lo);
    const float lo_res_s = df2(lo_ps, st[3], st[5], k.b_lo, k.a_lo);
    const float hi_pc = add(st[6], f.pd_c), hi_ps = add(st[7], f.pd_s);
    const float hi_res_c = df2(hi_pc, st[8], st[10], k.b_hi, k.a_hi);
    const float hi_res_s = df2(hi_ps, st[9], st[11], k.b_hi, k.a_hi);

    p.out[0][i] = f.amp;
    p.out[1][i] = mul(sub(hi_res_c, lo_res_c), f.amp);
    p.out[2][i] = mul(sub(hi_res_s, lo_res_s), f.amp);
    p.out[3][i] = lo_pc;
    p.out[4][i] = lo_ps;
    p.out[5][i] = st[2];
    p.out[6][i] = st[3];
    p.out[7][i] = st[4];
    p.out[8][i] = st[5];
    p.out[9][i] = hi_pc;
    p.out[10][i] = hi_ps;
    p.out[11][i] = st[8];
    p.out[12][i] = st[9];
    p.out[13][i] = st[10];
    p.out[14][i] = st[11];
  }
}

// The three haloed planes (amp, wc, ws) of one tile, in shared memory.
using Tile3 = float[3][SH][SW];

// The first 13-tap pass of all three planes, written back in place. W-axis
// (VERT false): row r of each plane ends up holding, in its first TW
// columns, the row sums of the tile's TW output columns. H-axis (VERT, the
// bf16 arm): rows 0..TH-1 hold the column sums of the tile's TH output rows
// for every haloed column, each rounded to bf16.
template <bool VERT>
__device__ __forceinline__ void first_pass_in_place(Tile3& buf, const Taps13& g) {
  constexpr int ROWS = VERT ? TH : SH;
  constexpr int COLS = VERT ? SW : TW;
  constexpr int N = ROWS * COLS;
  constexpr int PER = (N + NT - 1) / NT;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    float v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      if (idx < N) {
        const int r = idx / COLS;
        const int c = idx - r * COLS;
        float acc = mul(buf[k][r][c], g.k[0]);
#pragma unroll
        for (int t = 1; t < 13; ++t) {
          acc = madd(acc, VERT ? buf[k][r + t][c] : buf[k][r][c + t], g.k[t]);
        }
        v[j] = VERT ? round_bf16(acc) : acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      if (idx < N) {
        const int r = idx / COLS;
        buf[k][r][idx - r * COLS] = v[j];
      }
    }
    __syncthreads();
  }
}

// The second pass of the first pass's sums (H-axis, or W-axis after a
// VERT_FIRST pass) and the amplify rotation (RieszPyramid.cpp:114-144) for
// every output of the tile; one plane is written.
template <bool VERT_FIRST, typename TE>
__device__ __forceinline__ void second_pass_and_amplify(const Tile3& buf, const Taps13& g,
                                                        int y0, int x0, int h, int w,
                                                        const TE* lp, const TE* rr,
                                                        const TE* ri, float alpha,
                                                        float threshold, float* out) {
  for (int idx = threadIdx.x; idx < TH * TW; idx += NT) {
    const int r = idx / TW;
    const int c = idx - r * TW;
    const int y = y0 + r;
    const int x = x0 + c;
    if (y >= h || x >= w) continue;
    float ab = mul(buf[0][r][c], g.k[0]);
    float bc = mul(buf[1][r][c], g.k[0]);
    float bs = mul(buf[2][r][c], g.k[0]);
#pragma unroll
    for (int t = 1; t < 13; ++t) {
      const int rt = VERT_FIRST ? r : r + t;
      const int ct = VERT_FIRST ? c + t : c;
      ab = madd(ab, buf[0][rt][ct], g.k[t]);
      bc = madd(bc, buf[1][rt][ct], g.k[t]);
      bs = madd(bs, buf[2][rt][ct], g.k[t]);
    }
    const float nc = quo(bc, ab);
    const float ns = quo(bs, ab);
    const float mag = __fsqrt_rn(add(mul(nc, nc), mul(ns, ns)));
    float mag2 = mul(mag, alpha);
    mag2 = mag2 > threshold ? threshold : mag2;  // THRESH_TRUNC, NaN kept
    const size_t o = (size_t)y * w + x;
    const float pair = nan_to_zero(quo(add(mul(load(rr, o), nc), mul(load(ri, o), ns)), mag));
    out[o] = sub(mul(load(lp, o), cosf(mag2)), mul(pair, sinf(mag2)));
  }
}

template <bool PREWEIGHTED, typename TB, typename TE, bool BF16>
__global__ void __launch_bounds__(NT)
amplify13_kernel(AmplifyPlanes p, int h, int w, float alpha, float threshold, Taps13 g) {
  __shared__ Tile3 buf;
  const TB* amp = static_cast<const TB*>(p.amp);
  const TB* ccp = static_cast<const TB*>(p.cc);
  const TB* csp = static_cast<const TB*>(p.cs);
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  for (int idx = threadIdx.x; idx < SH * SW; idx += NT) {
    const int r = idx / SW;
    const int c = idx - r * SW;
    const size_t s = (size_t)reflect101(y0 - HALO + r, h) * w + reflect101(x0 - HALO + c, w);
    const float a = load(amp, s);
    float cc = load(ccp, s);
    float cs = load(csp, s);
    if (!PREWEIGHTED) {
      cc = mul(cc, a);
      cs = mul(cs, a);
    }
    buf[0][r][c] = BF16 ? round_bf16(a) : a;
    buf[1][r][c] = BF16 ? round_bf16(cc) : cc;
    buf[2][r][c] = BF16 ? round_bf16(cs) : cs;
  }
  __syncthreads();
  first_pass_in_place<BF16>(buf, g);
  second_pass_and_amplify<BF16>(buf, g, y0, x0, h, w, static_cast<const TE*>(p.lp),
                                static_cast<const TE*>(p.rr), static_cast<const TE*>(p.ri),
                                alpha, threshold, p.out);
}

__global__ void __launch_bounds__(NT)
level_tail_kernel(LevelPlanes p, int h, int w, Coeffs k, int rebuild, float alpha,
                  float threshold, Taps13 g) {
  __shared__ Tile3 buf;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  for (int idx = threadIdx.x; idx < SH * SW; idx += NT) {
    const int r = idx / SW;
    const int c = idx - r * SW;
    const int yy = y0 - HALO + r;
    const int xx = x0 - HALO + c;
    const size_t s = (size_t)reflect101(yy, h) * w + reflect101(xx, w);
    const float c_lp = p.in[0][s], c_r = p.in[1][s], c_i = p.in[2][s];
    float o_lp = c_lp, o_r = c_r, o_i = c_i;
    float st[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) st[j] = 0.f;
    if (!rebuild) {
      o_lp = p.in[3][s];
      o_r = p.in[4][s];
      o_i = p.in[5][s];
#pragma unroll
      for (int j = 0; j < 10; ++j) st[j] = p.in[6 + j][s];
    }
    const Front f = phase_front(c_lp, c_r, c_i, o_lp, o_r, o_i);
    // both filters advance on the one shared accumulator
    const float acc_c = add(st[0], f.pd_c), acc_s = add(st[1], f.pd_s);
    const float lo_res_c = df2(acc_c, st[2], st[4], k.b_lo, k.a_lo);
    const float lo_res_s = df2(acc_s, st[3], st[5], k.b_lo, k.a_lo);
    const float hi_res_c = df2(acc_c, st[6], st[8], k.b_hi, k.a_hi);
    const float hi_res_s = df2(acc_s, st[7], st[9], k.b_hi, k.a_hi);
    buf[0][r][c] = f.amp;
    buf[1][r][c] = mul(sub(hi_res_c, lo_res_c), f.amp);
    buf[2][r][c] = mul(sub(hi_res_s, lo_res_s), f.amp);
    // the tile's own pixels also write the carried state, once
    if (r >= HALO && r < HALO + TH && c >= HALO && c < HALO + TW && yy < h && xx < w) {
      p.out[1][s] = acc_c;
      p.out[2][s] = acc_s;
#pragma unroll
      for (int j = 0; j < 8; ++j) p.out[3 + j][s] = st[2 + j];
    }
  }
  __syncthreads();
  first_pass_in_place<false>(buf, g);
  second_pass_and_amplify<false>(buf, g, y0, x0, h, w, p.in[0], p.in[1], p.in[2], alpha,
                                 threshold, p.out[0]);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

Coeffs coeffs(const float* c) {
  Coeffs k;
  std::memcpy(k.b_lo, c, sizeof k.b_lo);
  std::memcpy(k.a_lo, c + 3, sizeof k.a_lo);
  std::memcpy(k.b_hi, c + 5, sizeof k.b_hi);
  std::memcpy(k.a_hi, c + 8, sizeof k.a_hi);
  return k;
}

Taps13 taps13(const float* t) {
  Taps13 g;
  std::memcpy(g.k, t, sizeof g.k);
  return g;
}

// The sixteen amplify13 instantiations, picked from the runtime flags.
struct AmplifyLaunch {
  dim3 grid;
  cudaStream_t stream;
  AmplifyPlanes p;
  int h, w;
  float alpha, threshold;
  Taps13 g;
};

template <bool PW, typename TB, typename TE, bool BF16>
void amplify_go(const AmplifyLaunch& L) {
  amplify13_kernel<PW, TB, TE, BF16><<<L.grid, NT, 0, L.stream>>>(L.p, L.h, L.w, L.alpha,
                                                                 L.threshold, L.g);
}

template <bool PW, typename TB, typename TE>
void amplify_bf16(const AmplifyLaunch& L, bool bf16) {
  if (bf16) amplify_go<PW, TB, TE, true>(L);
  else amplify_go<PW, TB, TE, false>(L);
}

template <bool PW, typename TB>
void amplify_te(const AmplifyLaunch& L, bool ew_bf16, bool bf16) {
  if (ew_bf16) amplify_bf16<PW, TB, __nv_bfloat16>(L, bf16);
  else amplify_bf16<PW, TB, float>(L, bf16);
}

template <bool PW>
void amplify_tb(const AmplifyLaunch& L, bool blur_bf16, bool ew_bf16, bool bf16) {
  if (blur_bf16) amplify_te<PW, __nv_bfloat16>(L, ew_bf16, bf16);
  else amplify_te<PW, float>(L, ew_bf16, bf16);
}

}  // namespace

extern "C" {

// planes: 18 inputs then 15 outputs, each n floats; coeffs: 10 floats.
int lvmt_phase_df2(const void* const* planes, long long n, const float* coeff, int rebuild,
                   void* stream) {
  PhasePlanes p;
  for (int j = 0; j < 18; ++j) p.in[j] = static_cast<const float*>(planes[j]);
  for (int j = 0; j < 15; ++j) p.out[j] = static_cast<float*>(const_cast<void*>(planes[18 + j]));
  long long blocks = (n + EW_THREADS - 1) / EW_THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks an SM
  if (blocks < 1) blocks = 1;
  phase_df2_kernel<<<(unsigned)blocks, EW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, n, coeffs(coeff), rebuild);
  return static_cast<int>(cudaGetLastError());
}

// planes: amp, cc, cs (bf16 when blur_bf16, else float), lp, rr, ri (bf16
// when ew_bf16), out (float), each h x w; taps: 13 floats (bf16-rounded
// under bf16, the bf16 operand arm).
int lvmt_amplify13(const void* const* planes, int h, int w, float alpha, float threshold,
                   int preweighted, int blur_bf16, int ew_bf16, int bf16, const float* taps,
                   void* stream) {
  AmplifyLaunch L;
  L.p.amp = planes[0];
  L.p.cc = planes[1];
  L.p.cs = planes[2];
  L.p.lp = planes[3];
  L.p.rr = planes[4];
  L.p.ri = planes[5];
  L.p.out = static_cast<float*>(const_cast<void*>(planes[6]));
  L.grid = dim3(ceil_div(w, TW), ceil_div(h, TH));
  L.stream = static_cast<cudaStream_t>(stream);
  L.h = h;
  L.w = w;
  L.alpha = alpha;
  L.threshold = threshold;
  L.g = taps13(taps);
  if (preweighted) amplify_tb<true>(L, blur_bf16, ew_bf16, bf16);
  else amplify_tb<false>(L, blur_bf16, ew_bf16, bf16);
  return static_cast<int>(cudaGetLastError());
}

// planes: 16 inputs then 11 outputs, each h x w floats; coeffs: 10 floats;
// taps: 13 floats.
int lvmt_level_tail(const void* const* planes, int h, int w, const float* coeff, int rebuild,
                    float alpha, float threshold, const float* taps, void* stream) {
  LevelPlanes p;
  for (int j = 0; j < 16; ++j) p.in[j] = static_cast<const float*>(planes[j]);
  for (int j = 0; j < 11; ++j) p.out[j] = static_cast<float*>(const_cast<void*>(planes[16 + j]));
  const dim3 grid(ceil_div(w, TW), ceil_div(h, TH));
  level_tail_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      p, h, w, coeffs(coeff), rebuild, alpha, threshold, taps13(taps));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
