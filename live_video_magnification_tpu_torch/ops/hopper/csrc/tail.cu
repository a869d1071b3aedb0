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
// amplify13 7 planes, 0.069 ms (the fast arm's bf16 planes 0.040 ms);
// level_tail 27 planes, 0.267 ms. Every product and sum rounded on its own
// (below) costs one instruction at least: amplify13's ~171 f32 operations an
// output (150 of them the three separable 13-tap blurs) take 0.042 ms at one
// a lane a cycle (132 SMs x 128 lanes x 1.98 GHz); the BF16 arm's exact
// products let a blur tap be one instruction, ~99 an output, 0.025 ms, under
// its bytes bound. The blurs' intermediates never leave shared memory;
// every input plane is read from device memory once a block and every
// output written once (the halo rows and columns again from L2).
//
// amplify13_kernel: a 32 x 64 output tile a block of 256 threads.
//   - Staging: the three planes (amp, and cc/cs weighted by amp) as 44 rows
//     of 80 columns from x0 - 8, so 16-byte chunks start 16-byte aligned: a
//     chunk inside the image is one load a plane, one across a border is
//     mirrored element by element (reflect-101, periodic for narrow sides),
//     rows are mirrored once a chunk; a thread issues the loads of all its
//     chunks (four at most) before it weighs and stores any. Widths that are
//     no multiple of a chunk (4 f32, 8 bf16) stage element by element. Rows
//     are 84 floats apart, which puts the two rows a quarter-warp reads in
//     the W-axis passes on disjoint banks.
//   - f32 arms, W-axis pass: a lane sums 8 outputs of a staged row from six
//     16-byte reads (13 scalar reads an output before) and writes them back
//     in place; a warp owns its rows, so a warp barrier, not a block
//     barrier, parts a row's reads from its writes.
//   - f32 arms, H-axis pass and rotation: a thread sums a column quad for 2
//     rows from 14 16-byte reads a plane, then rotates those 8 outputs; it
//     issues their lp/rr/ri loads before the sums (16 bytes at a time where
//     rows allow, as it writes out).
//   - BF16 arm: the H-axis pass first over the 80 staged columns, column
//     quads by 4 rows of the three planes, about two a thread, in place (a
//     block barrier between all reads and all writes), then a lane's W-axis
//     sums of 8 outputs and their rotation, lp/rr/ri loaded before the sums;
//     each blur tap one fused multiply-add (below).
//   - sincosf: one range reduction for the rotation's sine and cosine; its
//     results equal sinf's and cosf's bit for bit on the card.
//   - Two block barriers a tile in the f32 arms, three in the BF16 arm (seven
//     before); 44 KB of static shared memory a block, three blocks an SM
//     (the f32 arms take 72-74 registers; a cap for three blocks, 80, or
//     for four, 64, measured slower).
// level_tail_kernel keeps the earlier scheme: 32 x 64 outputs, a 44 x 76
// haloed tile a plane (40,128 bytes), the W-axis pass written back in place
// (each thread holds its 11 sums in registers across a barrier), then the
// H-axis pass and the rotation an output at a time.
//
// Arithmetic: every product, sum, quotient and square root is rounded to f32
// on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no
// contraction into FMAs), in the order of the plain PyTorch versions
// (ops/hopper/tail.py): W-axis taps first, then H-axis taps, in tap order
// (H-axis first in the BF16 arm, as the reference kernel). In the BF16 arm
// both factors of every blur product are bf16 values: an integer below 2^8
// times 2^e with e >= -133 (subnormals too), and a tap of magnitude 2^-7 or
// more and 1 at most (e >= -14; the host refuses other taps). Their product,
// an integer below 2^16 times 2^(>= -147) and no larger in magnitude than the
// value, is exact in f32 and cannot overflow, so a
// fused multiply-add (__fmaf_rn) rounds only the sum and gives the bits of
// __fmul_rn then __fadd_rn in half the instructions.
// The arccos of the phase is the reference kernels' polynomial (Abramowitz &
// Stegun 4.4.45), not acosf. The sine and cosine are the library's; they are
// the only operations that may round otherwise than the plain version on the
// CPU.
//
// C interface: plane pointers as a host array of void* (inputs, then
// outputs), sizes as int, scalars as float, coefficients and taps as host
// pointers copied into by-value kernel parameters, the stream as void*. Each
// function returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

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

// The three haloed planes (amp, wc, ws) of one tile of level_tail_kernel,
// in shared memory.
using Tile3 = float[3][SH][SW];

// The W-axis 13-tap pass of all three planes, written back in place: row r
// of each plane ends up holding, in its first TW columns, the row sums of
// the tile's TW output columns.
__device__ __forceinline__ void first_pass_in_place(Tile3& buf, const Taps13& g) {
  constexpr int N = SH * TW;
  constexpr int PER = (N + NT - 1) / NT;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    float v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      if (idx < N) {
        const int r = idx / TW;
        const int c = idx - r * TW;
        float acc = mul(buf[k][r][c], g.k[0]);
#pragma unroll
        for (int t = 1; t < 13; ++t) acc = madd(acc, buf[k][r][c + t], g.k[t]);
        v[j] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = threadIdx.x + j * NT;
      if (idx < N) {
        const int r = idx / TW;
        buf[k][r][idx - r * TW] = v[j];
      }
    }
    __syncthreads();
  }
}

// The H-axis pass of the row sums and the amplify rotation
// (RieszPyramid.cpp:114-144) for every output of the tile; one plane is
// written.
__device__ __forceinline__ void second_pass_and_amplify(const Tile3& buf, const Taps13& g,
                                                        int y0, int x0, int h, int w,
                                                        const float* lp, const float* rr,
                                                        const float* ri, float alpha,
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
      ab = madd(ab, buf[0][r + t][c], g.k[t]);
      bc = madd(bc, buf[1][r + t][c], g.k[t]);
      bs = madd(bs, buf[2][r + t][c], g.k[t]);
    }
    const float nc = quo(bc, ab);
    const float ns = quo(bs, ab);
    const float mag = __fsqrt_rn(add(mul(nc, nc), mul(ns, ns)));
    float mag2 = mul(mag, alpha);
    mag2 = mag2 > threshold ? threshold : mag2;  // THRESH_TRUNC, NaN kept
    const size_t o = (size_t)y * w + x;
    const float pair = nan_to_zero(quo(add(mul(rr[o], nc), mul(ri[o], ns)), mag));
    out[o] = sub(mul(lp[o], cosf(mag2)), mul(pair, sinf(mag2)));
  }
}

// ---------------------------------------------------------------- amplify13

// f(Int<I>()) for I = B..E-1, unrolled by construction (the compiler may
// leave a #pragma unroll loop rolled when its body is large).
template <int V>
struct Int {
  static constexpr int value = V;
};

template <int B, int E, typename F>
__device__ __forceinline__ void unrolled(const F& f) {
  if constexpr (B < E) {
    f(Int<B>());
    unrolled<B + 1, E>(f);
  }
}

// Four consecutive values as floats; the caller checks the alignment.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// 16 bytes of a plane as floats (bf16 widens exactly).
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(u[k] << 16);
    v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The amplify rotation of one output (RieszPyramid.cpp:114-144) from its
// three blurred planes: n = (bc, bs) / ab, then the truncated phase rotation.
__device__ __forceinline__ float rotate(float ab, float bc, float bs, float lp, float rr, float ri,
                                       float alpha, float threshold) {
  const float nc = quo(bc, ab);
  const float ns = quo(bs, ab);
  const float mag = __fsqrt_rn(add(mul(nc, nc), mul(ns, ns)));
  float mag2 = mul(mag, alpha);
  mag2 = mag2 > threshold ? threshold : mag2;  // THRESH_TRUNC, NaN kept
  const float pair = nan_to_zero(quo(add(mul(rr, nc), mul(ri, ns)), mag));
  float sn, cs;
  sincosf(mag2, &sn, &cs);
  return sub(mul(lp, cs), mul(pair, sn));
}

// Block tile of amplify13_kernel: AMP_TH x AMP_TW outputs, AMP_NT threads.
// The staged tile holds AMP_SH rows (the 6-row halo above and below) of
// AMP_SC columns from x0 - AMP_LEAD (a 16-byte aligned start; columns
// AMP_SKIP .. AMP_SKIP + AMP_TW + 11 are read), rows AMP_SW floats apart:
// 84 = 80 + 4 puts the two rows a quarter-warp reads in the W-axis passes on
// disjoint banks.
constexpr int AMP_TH = 32;
constexpr int AMP_TW = 64;
constexpr int AMP_NT = 256;
constexpr int AMP_RY = AMP_TH / 16;  // H-axis outputs of a thread (16 row groups)
constexpr int AMP_RX = 8;            // W-axis outputs of a lane (8 lanes a row)
constexpr int AMP_LEAD = 8;
constexpr int AMP_SKIP = AMP_LEAD - HALO;
constexpr int AMP_SC = AMP_TW + 2 * AMP_LEAD;
constexpr int AMP_SW = AMP_SC + 4;
constexpr int AMP_SH = AMP_TH + 2 * HALO;
constexpr int AMP_PLANE = AMP_SH * AMP_SW;  // floats of one staged plane
static_assert(AMP_TH % 16 == 0 && AMP_TW == 8 * AMP_RX && AMP_NT == 16 * (AMP_TW / 4),
              "16 row groups of 16 column quads; 8 lanes a row");
static_assert((3 * AMP_SH) % 4 == 0 && AMP_SW % 4 == 0, "whole warp steps; 16-byte rows");

// Launch flags of amplify13_kernel.
constexpr int AMP_VEC_BLUR = 1;  // amp/cc/cs rows 16-byte aligned: staged in 16-byte chunks
constexpr int AMP_VEC_EW = 2;    // lp/rr/ri and out rows aligned for 4-wide loads and stores

// Stages the three planes of the tile at (y0, x0): amp, and cc/cs weighted
// by amp unless PW, each rounded to bf16 under BF16; reflect-101 by index.
// VEC: 16-byte chunks, one load each inside the image, mirrored element by
// element outside it (the left and right borders only), rows mirrored by
// index once a chunk; a thread issues the loads of all its chunks (four at
// most) before it weighs and stores any. Otherwise one element at a time.
template <bool PW, bool BF16, typename TB>
__device__ __forceinline__ void amp_stage(float* s, const TB* amp, const TB* ccp, const TB* csp,
                                          int y0, int x0, int h, int w, bool vec) {
  auto weigh = [](float a, float& c, float& d) {
    if (!PW) {
      c = mul(c, a);
      d = mul(d, a);
    }
  };
  // bf16 rounding under BF16; a value read from a bf16 plane is one already
  constexpr bool ROUND_READ = BF16 && !std::is_same<TB, __nv_bfloat16>::value;
  auto narrow = [](float v) { return BF16 ? round_bf16(v) : v; };
  auto narrow_read = [](float v) { return ROUND_READ ? round_bf16(v) : v; };
  if (vec) {
    constexpr int V = 16 / (int)sizeof(TB);     // elements of a chunk
    constexpr int Q = AMP_SC / V;                // chunks of a staged row
    constexpr int N = AMP_SH * Q;
    constexpr int CHUNKS = (N + AMP_NT - 1) / AMP_NT;  // of a thread
    float a[CHUNKS][V], c[CHUNKS][V], d[CHUNKS][V];
    unrolled<0, CHUNKS>([&](auto uu) {
      constexpr int U = decltype(uu)::value;
      const int i = threadIdx.x + U * AMP_NT;
      if ((U + 1) * AMP_NT <= N || i < N) {
        const int r = i / Q;
        const int gx = x0 - AMP_LEAD + (i - r * Q) * V;
        const size_t row = (size_t)reflect101(y0 - HALO + r, h) * w;
        if (gx >= 0 && gx + V <= w) {
          load16(amp + row + gx, a[U]);
          load16(ccp + row + gx, c[U]);
          load16(csp + row + gx, d[U]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const size_t j = row + reflect101(gx + e, w);
            a[U][e] = load(amp, j);
            c[U][e] = load(ccp, j);
            d[U][e] = load(csp, j);
          }
        }
      }
    });
    unrolled<0, CHUNKS>([&](auto uu) {
      constexpr int U = decltype(uu)::value;
      const int i = threadIdx.x + U * AMP_NT;
      if ((U + 1) * AMP_NT <= N || i < N) {
        const int r = i / Q;
        float* at = s + r * AMP_SW + (i - r * Q) * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          weigh(a[U][e], c[U][e], d[U][e]);
          a[U][e] = narrow_read(a[U][e]);
          c[U][e] = PW ? narrow_read(c[U][e]) : narrow(c[U][e]);
          d[U][e] = PW ? narrow_read(d[U][e]) : narrow(d[U][e]);
        }
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          store4(at + e, a[U] + e);
          store4(at + AMP_PLANE + e, c[U] + e);
          store4(at + 2 * AMP_PLANE + e, d[U] + e);
        }
      }
    });
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < AMP_SH * AMP_SC; i += AMP_NT) {
      const int r = i / AMP_SC;
      const int k = i - r * AMP_SC;
      const size_t j =
          (size_t)reflect101(y0 - HALO + r, h) * w + reflect101(x0 - AMP_LEAD + k, w);
      const float a = load(amp, j);
      float c = load(ccp, j);
      float d = load(csp, j);
      weigh(a, c, d);
      float* at = s + r * AMP_SW + k;
      at[0] = narrow_read(a);
      at[AMP_PLANE] = PW ? narrow_read(c) : narrow(c);
      at[2 * AMP_PLANE] = PW ? narrow_read(d) : narrow(d);
    }
  }
}

// acc + v * k, the product and the sum each rounded alone. EXACT: the
// product of v and k is exact in f32, so one fused multiply-add rounds the
// same sum once, bit for bit (the BF16 arm: both are bf16 values, see the top
// of this file); otherwise the two operations stay apart.
template <bool EXACT>
__device__ __forceinline__ float tap(float acc, float v, float k) {
  return EXACT ? __fmaf_rn(v, k, acc) : madd(acc, v, k);
}

// Sums 13 taps along H down a column quad of the staged tile for RY output
// rows: tile row T feeds output row J as tap T - J, so each output takes its
// taps in order, starting from the product of tap 0.
template <int RY, bool EXACT>
__device__ __forceinline__ void col_taps(const float* col, const Taps13& g, float (&b)[RY][4]) {
  unrolled<0, RY + 12>([&](auto tt) {
    constexpr int T = decltype(tt)::value;
    const float4 t4 = *reinterpret_cast<const float4*>(col + T * AMP_SW);
    const float v[4] = {t4.x, t4.y, t4.z, t4.w};
    unrolled<0, RY>([&](auto jj) {
      constexpr int J = decltype(jj)::value;
      constexpr int A = T - J;
      if constexpr (A >= 0 && A <= 12) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (A == 0) {
            b[J][i] = mul(v[i], g.k[0]);
          } else {
            b[J][i] = tap<EXACT>(b[J][i], v[i], g.k[A]);
          }
        }
      }
    });
  });
}

// Sums 13 taps along W for AMP_RX outputs of a staged row, from six 16-byte
// reads; output i takes staged columns i + AMP_SKIP .. i + AMP_SKIP + 12.
template <bool EXACT>
__device__ __forceinline__ void row_taps(const float* row, const Taps13& g, float* o) {
  float v[AMP_RX + 16];
#pragma unroll
  for (int c = 0; c < AMP_RX + 16; c += 4) load4(row + c, v + c);
#pragma unroll
  for (int i = 0; i < AMP_RX; ++i) {
    float acc = mul(v[i + AMP_SKIP], g.k[0]);
#pragma unroll
    for (int t = 1; t < 13; ++t) acc = tap<EXACT>(acc, v[i + AMP_SKIP + t], g.k[t]);
    o[i] = acc;
  }
}

// The staged row and the output column group of a lane in the W-axis
// passes: a warp takes four rows, a quarter-warp two rows of four lanes, so
// its 16-byte reads fall on disjoint banks.
struct RowLane {
  int row;  // of the warp's four
  int col;  // first of the lane's AMP_RX outputs
};

__device__ __forceinline__ RowLane row_lane() {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;
  return {2 * (q >> 1) + ((lane >> 2) & 1), AMP_RX * ((lane & 3) + 4 * (q & 1))};
}

// lp, rr and ri of up to four outputs at o (n of them inside the image),
// loaded ahead of the sums that their rotation waits for.
struct Ew4 {
  float lp[4], rr[4], ri[4];
  int n;  // outputs inside the image (4 at most)
};

template <typename TE>
__device__ __forceinline__ Ew4 load_ew4(const TE* lp, const TE* rr, const TE* ri, size_t o, int n,
                                        bool vec) {
  Ew4 e;
  e.n = n < 4 ? n : 4;
  if (vec && e.n == 4) {
    load4(lp + o, e.lp);
    load4(rr + o, e.rr);
    load4(ri + o, e.ri);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      e.lp[k] = k < e.n ? load(lp, o + k) : 0.f;
      e.rr[k] = k < e.n ? load(rr, o + k) : 0.f;
      e.ri[k] = k < e.n ? load(ri, o + k) : 0.f;
    }
  }
  return e;
}

// The rotation of the outputs of e at o from their blurred planes.
__device__ __forceinline__ void rotate4(const float* ab, const float* bc, const float* bs,
                                        const Ew4& e, float* out, size_t o, bool vec,
                                        float alpha, float threshold) {
  if (e.n <= 0) return;
  float y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    y[k] = rotate(ab[k], bc[k], bs[k], e.lp[k], e.rr[k], e.ri[k], alpha, threshold);
  }
  if (vec && e.n == 4) {
    store4(out + o, y);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < e.n) out[o + k] = y[k];
    }
  }
}

// f32 arm, first pass: the W-axis sums of every staged row of the three
// planes, written back in place (columns 0 .. AMP_TW-1). A warp owns its
// rows, so the reads of a row end before its writes at a warp barrier.
__device__ __forceinline__ void amp_rows_in_place(float* s, const Taps13& g) {
  const RowLane me = row_lane();
  float* base = s + me.row * AMP_SW + me.col;
#pragma unroll 1
  for (int r0 = (threadIdx.x >> 5) * 4; r0 < 3 * AMP_SH; r0 += (AMP_NT / 32) * 4) {
    float* row = base + r0 * AMP_SW;  // the planes' rows follow one another
    float o[AMP_RX];
    row_taps<false>(row, g, o);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < AMP_RX; i += 4) store4(row + i, o + i);
  }
}

// f32 arm, second pass: the H-axis sums of the row sums (a column quad by
// AMP_RY rows a thread) and the rotation of those outputs.
template <typename TE>
__device__ __forceinline__ void amp_cols_rotate(const float* s, const Taps13& g, int y0, int x0,
                                                int h, int w, const TE* lp, const TE* rr,
                                                const TE* ri, float* out, float alpha,
                                                float threshold, bool vec) {
  const int cq = threadIdx.x % (AMP_TW / 4);
  const int rg = threadIdx.x / (AMP_TW / 4);
  const int x = x0 + 4 * cq;
  const int y = y0 + rg * AMP_RY;
  Ew4 e[AMP_RY];
#pragma unroll
  for (int j = 0; j < AMP_RY; ++j) {
    e[j] = load_ew4(lp, rr, ri, (size_t)(y + j) * w + x, y + j < h ? w - x : 0, vec);
  }
  float b[3][AMP_RY][4];
  unrolled<0, 3>([&](auto pp) {
    constexpr int P = decltype(pp)::value;
    col_taps<AMP_RY, false>(s + P * AMP_PLANE + rg * AMP_RY * AMP_SW + 4 * cq, g, b[P]);
  });
#pragma unroll
  for (int j = 0; j < AMP_RY; ++j) {
    rotate4(b[0][j], b[1][j], b[2][j], e[j], out, (size_t)(y + j) * w + x, vec, alpha,
            threshold);
  }
}

// BF16 arm, first pass: the H-axis sums of every staged column for the
// tile's AMP_TH output rows, rounded to bf16 and written back in place: the
// three planes' column quads by 4 rows as one list of items, about two a
// thread, every read before a block barrier, then the writes.
__device__ __forceinline__ void amp_cols_in_place_bf16(float* s, const Taps13& g) {
  constexpr int RY = 4;
  constexpr int Q = AMP_SC / 4;                     // column quads
  constexpr int PLANE_ITEMS = (AMP_TH / RY) * Q;    // of a plane
  constexpr int ITEMS = 3 * PLANE_ITEMS;
  constexpr int PER = (ITEMS + AMP_NT - 1) / AMP_NT;
  static_assert(AMP_TH % RY == 0, "whole row groups");
  float hold[PER][RY][4];
  auto at = [&](int item) {
    const int p = item / PLANE_ITEMS;
    const int k = item - p * PLANE_ITEMS;
    const int rg = k / Q;
    return s + p * AMP_PLANE + rg * RY * AMP_SW + 4 * (k - rg * Q);
  };
  unrolled<0, PER>([&](auto uu) {
    constexpr int U = decltype(uu)::value;
    const int item = threadIdx.x + U * AMP_NT;
    if ((U + 1) * AMP_NT <= ITEMS || item < ITEMS) col_taps<RY, true>(at(item), g, hold[U]);
  });
  __syncthreads();
  unrolled<0, PER>([&](auto uu) {
    constexpr int U = decltype(uu)::value;
    const int item = threadIdx.x + U * AMP_NT;
    if ((U + 1) * AMP_NT <= ITEMS || item < ITEMS) {
      float* col = at(item);
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = round_bf16(hold[U][j][i]);
        store4(col + j * AMP_SW, v);
      }
    }
  });
  __syncthreads();
}

// BF16 arm, second pass: the W-axis sums of the rounded column sums (AMP_RX
// outputs a lane) and the rotation of those outputs.
template <typename TE>
__device__ __forceinline__ void amp_rows_rotate_bf16(const float* s, const Taps13& g, int y0,
                                                     int x0, int h, int w, const TE* lp,
                                                     const TE* rr, const TE* ri, float* out,
                                                     float alpha, float threshold, bool vec) {
  const RowLane me = row_lane();
  const int x = x0 + me.col;
  if (x >= w) return;
#pragma unroll 1
  for (int r = (threadIdx.x >> 5) * 4 + me.row; r < AMP_TH; r += (AMP_NT / 32) * 4) {
    const int y = y0 + r;
    if (y >= h) break;
    const size_t o = (size_t)y * w + x;
    Ew4 e[AMP_RX / 4];
#pragma unroll
    for (int i = 0; i < AMP_RX; i += 4) e[i / 4] = load_ew4(lp, rr, ri, o + i, w - x - i, vec);
    float b[3][AMP_RX];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      row_taps<true>(s + p * AMP_PLANE + r * AMP_SW + me.col, g, b[p]);
    }
#pragma unroll
    for (int i = 0; i < AMP_RX; i += 4) {
      rotate4(b[0] + i, b[1] + i, b[2] + i, e[i / 4], out, o + i, vec, alpha, threshold);
    }
  }
}

// ab = g13(amp), n = g13(w) / ab with w = change * amp (or the preweighted
// planes), then the rotation, for one AMP_TH x AMP_TW tile a block. TB: the
// type of amp/cc/cs, TE: of lp/rr/ri. BF16: the blurs on bf16 operands, the
// H-axis pass first (see the top of this file).
template <bool PREWEIGHTED, typename TB, typename TE, bool BF16>
__global__ void __launch_bounds__(AMP_NT)
amplify13_kernel(AmplifyPlanes p, int h, int w, float alpha, float threshold, int flags,
                 const __grid_constant__ Taps13 g) {  // taps read in place, from the constant bank
  __shared__ __align__(16) float s[3 * AMP_PLANE];
  const int x0 = blockIdx.x * AMP_TW;
  const int y0 = blockIdx.y * AMP_TH;
  const bool vec_ew = flags & AMP_VEC_EW;
  amp_stage<PREWEIGHTED, BF16>(s, static_cast<const TB*>(p.amp), static_cast<const TB*>(p.cc),
                               static_cast<const TB*>(p.cs), y0, x0, h, w,
                               flags & AMP_VEC_BLUR);
  __syncthreads();
  const TE* lp = static_cast<const TE*>(p.lp);
  const TE* rr = static_cast<const TE*>(p.rr);
  const TE* ri = static_cast<const TE*>(p.ri);
  if constexpr (BF16) {
    amp_cols_in_place_bf16(s, g);
    amp_rows_rotate_bf16(s, g, y0, x0, h, w, lp, rr, ri, p.out, alpha, threshold, vec_ew);
  } else {
    amp_rows_in_place(s, g);
    __syncthreads();
    amp_cols_rotate(s, g, y0, x0, h, w, lp, rr, ri, p.out, alpha, threshold, vec_ew);
  }
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
  first_pass_in_place(buf, g);
  second_pass_and_amplify(buf, g, y0, x0, h, w, p.in[0], p.in[1], p.in[2], alpha, threshold,
                          p.out[0]);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// True when every tap is a bf16 value of magnitude 2^-7 to 1, or zero: then
// its product with any bf16 value is exact and finite in f32 (the BF16 arm's
// premise).
bool exact_bf16_taps(const float* t) {
  for (int j = 0; j < 13; ++j) {
    unsigned u;
    std::memcpy(&u, &t[j], sizeof u);
    const float a = t[j] < 0.f ? -t[j] : t[j];
    if ((u & 0xffffu) != 0 || (a != 0.f && (a < 0.0078125f || a > 1.f))) return false;
  }
  return true;
}

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

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The sixteen amplify13 instantiations, picked from the runtime flags.
struct AmplifyLaunch {
  dim3 grid;
  cudaStream_t stream;
  AmplifyPlanes p;
  int h, w;
  float alpha, threshold;
  int flags;
  Taps13 g;
};

template <bool PW, typename TB, typename TE, bool BF16>
void amplify_go(const AmplifyLaunch& L) {
  amplify13_kernel<PW, TB, TE, BF16><<<L.grid, AMP_NT, 0, L.stream>>>(
      L.p, L.h, L.w, L.alpha, L.threshold, L.flags, L.g);
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
// when ew_bf16), out (float), each h x w; taps: 13 floats (under bf16, the
// bf16 operand arm, bf16 values of magnitude 2^-7 to 1, or zero; others are
// refused with cudaErrorInvalidValue).
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
  L.grid = dim3(ceil_div(w, AMP_TW), ceil_div(h, AMP_TH));
  L.stream = static_cast<cudaStream_t>(stream);
  L.h = h;
  L.w = w;
  L.alpha = alpha;
  L.threshold = threshold;
  if (bf16 && !exact_bf16_taps(taps)) return static_cast<int>(cudaErrorInvalidValue);
  L.g = taps13(taps);
  const int tb = blur_bf16 ? 2 : 4;
  const int te = ew_bf16 ? 2 : 4;
  L.flags = 0;
  if (w % (16 / tb) == 0 && aligned(planes[0], 16) && aligned(planes[1], 16) &&
      aligned(planes[2], 16)) {
    L.flags |= AMP_VEC_BLUR;
  }
  if (w % 4 == 0 && aligned(planes[3], 4 * te) && aligned(planes[4], 4 * te) &&
      aligned(planes[5], 4 * te) && aligned(planes[6], 16)) {
    L.flags |= AMP_VEC_EW;
  }
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
