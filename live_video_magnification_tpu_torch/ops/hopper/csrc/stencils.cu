// Reflect-101 pyramid stencils of the Riesz phase pipeline, for sm_90a.
//
// Five kernels, one per TPU kernel of the reference package's
// ops/pallas/conv9_mxu.py and ops/pallas/riesz_build.py. They compute WHAT
// those compute, not how: the TPU kernels are banded matmuls shaped for the
// MXU's 128x128 tiles (and, for the fused build, VMEM strips of a padded
// copy); here each block stages a halo tile in shared memory, mirroring the
// reflect-101 border by index as the tile is loaded (no padded copy in
// device memory), and each thread sums its taps from the tile.
//
//   lvmt_conv9        <- conv9_mxu (_run_dense / _run_dense_svd)
//                        out = x (*) k9, [H,W] -> [H,W]
//   lvmt_band5        <- band5_mxu (_run_band)
//                        r = hp (*) t5 along W, i = hp (*) t5 along H, one pass
//   lvmt_lp9_decimate <- lp9_decimate_mxu (_run_dec / _run_dec_svd)
//                        (x (*) k9)[::2, ::2], only the kept sites
//   lvmt_lp9_inject   <- lp9_inject_mxu (_run_inject)
//                        zero_inject(small, out_hw) (*) k9, without the
//                        injected array; odd and even targets alike
//   lvmt_riesz_build_level <- riesz_build.py::riesz_build_level_fused
//                        hp = x (*) HP9 on the tile plus a mirrored 2-px
//                        apron in shared memory, the band pair from it, and
//                        (x (*) 2LP9) at the kept even sites: one read of
//                        the octave for what conv9, band5 and lp9_decimate
//                        read three times
//
// The bf16 operand arm (the reference's LVMT_MXU_DTYPE=bf16: dot of bf16
// operands, f32 accumulation) is a template flag ROUND: each pixel is
// rounded to bf16 as it is used, the taps arrive rounded from the host, and
// the exact products are summed in f32. band5's vertical taps are summed in
// f32 and only the sum is rounded (the TPU kernel's VPU pass, then a matmul
// by an identity shift). Outputs (TOut) and band5's input (TIn) are float or
// __nv_bfloat16; a bf16 store rounds the f32 sum to nearest even.
//
// Arithmetic: every product and every sum is rounded to f32 on its own
// (__fmul_rn / __fadd_rn, which the compiler never contracts into an FMA),
// rows summed in order, taps left to right, zero taps skipped. That is the
// order of the plain PyTorch version (ops/conv.py), so the kernels agree with
// it bit for bit (up to the sign of a zero).
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 counting an FMA as two
// operations), at the 2160x3840 level: conv9 moves 66 MB and does 1.3 G
// operations (~20 us either way: on the edge); band5 moves 100 MB, decimate
// and inject 41 MB each (memory-bound, ~30 / 12 / 12 us); the fused build
// moves 33 + 100 + 8 MB and does 2.0 G operations (~42 us, bytes). What the
// design does about it: one read of the input tile per block through shared
// memory, each output written once, and a thread computing RY outputs down a
// column so a row of 9 tile values loaded into registers serves up to RY
// outputs (conv9: 108 shared loads per 4 outputs instead of 324). Keeping
// products and sums apart costs conv9 up to 2x in issue slots against FMAs;
// exact agreement with the plain version is worth it in a first kernel. The
// fused build recomputes hp on its 2-px apron (36x36 values for a 32x32
// tile, +27%) rather than exchange it between blocks.
//
// C interface: pointers and the stream as void*, sizes as int, taps as a host
// pointer copied into a by-value kernel parameter. Each function returns
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int BX = 32;  // threads per block along W
constexpr int BY = 8;   // threads per block along H

struct Taps81 {
  float k[81];
};

struct Taps5 {
  float k[5];
};

// Reflect-101 (gfedcb|abcdefgh|gfedcba) for p in [-(n-1), 2n-2]; clamped
// beyond that, which only tile entries that no valid output reads can reach.
__device__ __forceinline__ int reflect101(int p, int n) {
  p = p < 0 ? -p : p;
  p = p >= n ? 2 * n - 2 - p : p;
  return min(max(p, 0), n - 1);
}

__device__ __forceinline__ float madd(float acc, float v, float k) {
  return __fadd_rn(acc, __fmul_rn(v, k));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Dense 9x9 correlation, sampled with stride S (S=1: conv9, S=2: decimate).
// Block: BX x BY threads, each computing RY outputs down one column, so the
// block covers BX x (BY*RY) outputs from a tile of input rows/cols
// S*(T-1)+9 starting at S*origin-4. ROUND: bf16 operands (the tile holds
// the rounded pixels).
template <int S, int RY, typename TOut, bool ROUND>
__global__ void __launch_bounds__(BX * BY)
stencil9_kernel(const float* __restrict__ x, TOut* __restrict__ out, int h, int w,
                int oh, int ow, Taps81 taps) {
  constexpr int TX = BX;
  constexpr int TY = BY * RY;
  constexpr int IN_H = S * (TY - 1) + 9;
  constexpr int IN_W = S * (TX - 1) + 9;
  __shared__ float tile[IN_H][IN_W];

  const int ox0 = blockIdx.x * TX;
  const int oy0 = blockIdx.y * TY;
  const int iy0 = S * oy0 - 4;
  const int ix0 = S * ox0 - 4;
  for (int idx = threadIdx.y * BX + threadIdx.x; idx < IN_H * IN_W; idx += BX * BY) {
    const int r = idx / IN_W;
    const int c = idx - r * IN_W;
    const float v = x[(size_t)reflect101(iy0 + r, h) * w + reflect101(ix0 + c, w)];
    tile[r][c] = ROUND ? round_bf16(v) : v;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int ty0 = threadIdx.y * RY;
  float acc[RY];
#pragma unroll
  for (int j = 0; j < RY; ++j) acc[j] = 0.f;

  // Tile rows S*ty0 + r; output j takes tap row a = r - S*j.
#pragma unroll
  for (int r = 0; r < S * (RY - 1) + 9; ++r) {
    float v[9];
#pragma unroll
    for (int b = 0; b < 9; ++b) v[b] = tile[S * ty0 + r][S * tx + b];
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      const int a = r - S * j;
      if (a >= 0 && a < 9) {
        float row = 0.f;
#pragma unroll
        for (int b = 0; b < 9; ++b) {
          const float k = taps.k[a * 9 + b];
          if (k != 0.f) row = madd(row, v[b], k);
        }
        acc[j] = __fadd_rn(acc[j], row);
      }
    }
  }

  const int ox = ox0 + tx;
#pragma unroll
  for (int j = 0; j < RY; ++j) {
    const int oy = oy0 + ty0 + j;
    if (oy < oh && ox < ow) store(out, (size_t)oy * ow + ox, acc[j]);
  }
}

// Riesz band pair on the high-pass band: r along W, i along H, both from one
// tile with a 2-px halo. tr are r's taps (bf16-rounded under ROUND), ti i's.
template <int RY, typename TIn, typename TOut, bool ROUND>
__global__ void __launch_bounds__(BX * BY)
band5_kernel(const TIn* __restrict__ hp, TOut* __restrict__ r_out,
             TOut* __restrict__ i_out, int h, int w, Taps5 tr, Taps5 ti) {
  constexpr int TX = BX;
  constexpr int TY = BY * RY;
  constexpr int IN_H = TY + 4;
  constexpr int IN_W = TX + 4;
  __shared__ float tile[IN_H][IN_W];

  const int ox0 = blockIdx.x * TX;
  const int oy0 = blockIdx.y * TY;
  for (int idx = threadIdx.y * BX + threadIdx.x; idx < IN_H * IN_W; idx += BX * BY) {
    const int r = idx / IN_W;
    const int c = idx - r * IN_W;
    tile[r][c] = load(hp, (size_t)reflect101(oy0 - 2 + r, h) * w + reflect101(ox0 - 2 + c, w));
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int ox = ox0 + tx;
#pragma unroll
  for (int j = 0; j < RY; ++j) {
    const int ty = threadIdx.y * RY + j;
    float rr = 0.f;
    float ii = 0.f;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      if (tr.k[b] != 0.f) {
        const float v = tile[ty + 2][tx + b];
        rr = madd(rr, ROUND ? round_bf16(v) : v, tr.k[b]);
      }
      if (ti.k[b] != 0.f) ii = madd(ii, tile[ty + b][tx + 2], ti.k[b]);
    }
    if (ROUND) ii = round_bf16(ii);
    const int oy = oy0 + ty;
    if (oy < h && ox < w) {
      store(r_out, (size_t)oy * w + ox, rr);
      store(i_out, (size_t)oy * w + ox, ii);
    }
  }
}

// Collapse upsample: out = Z (*) k9 with Z the zero-injected small image at
// the output size (h, w): Z[p][q] = small[p/2][q/2] at even (p, q), else 0,
// reflect-101 on Z's own size. Reflect-101 keeps the parity of a coordinate
// (-p and 2n-2-p have p's parity), so output (y, x) meets nonzero Z only for
// taps with (y+a) and (x+b) even, and the tile can hold just the even sites:
// S[i][j] = Z[Y0+2i][X0+2j] = small[refl(Y0+2i)/2][refl(X0+2j)/2].
// Each thread computes a 2-wide x RY-tall patch (both column parities, so a
// warp never diverges on parity); the skipped taps add exact zeros in the
// plain version. ROUND: bf16 operands (the tile holds the rounded pixels).
template <int RY, bool ROUND>
__global__ void __launch_bounds__(BX * BY)
inject9_kernel(const float* __restrict__ small, float* __restrict__ out, int sh,
               int sw, int h, int w, Taps81 taps) {
  constexpr int TX = 2 * BX;
  constexpr int TY = BY * RY;
  constexpr int S_H = (TY + 8) / 2;
  constexpr int S_W = (TX + 8) / 2;
  static_assert(RY % 2 == 0, "thread row origin must stay even");
  __shared__ float tile[S_H][S_W];

  const int ox0 = blockIdx.x * TX;  // even
  const int oy0 = blockIdx.y * TY;  // even
  for (int idx = threadIdx.y * BX + threadIdx.x; idx < S_H * S_W; idx += BX * BY) {
    const int i = idx / S_W;
    const int j = idx - i * S_W;
    const int p = reflect101(oy0 - 4 + 2 * i, h) >> 1;
    const int q = reflect101(ox0 - 4 + 2 * j, w) >> 1;
    const float v = small[(size_t)min(p, sh - 1) * sw + min(q, sw - 1)];
    tile[i][j] = ROUND ? round_bf16(v) : v;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int ty0 = threadIdx.y * RY;  // even
#pragma unroll
  for (int dy = 0; dy < RY; ++dy) {
    const int oy = oy0 + ty0 + dy;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int ox = ox0 + 2 * tx + dx;
      float acc = 0.f;
#pragma unroll
      for (int a = (dy & 1); a < 9; a += 2) {
        const int i = (ty0 + dy + a) >> 1;
        float row = 0.f;
#pragma unroll
        for (int b = dx; b < 9; b += 2) {
          const float k = taps.k[a * 9 + b];
          if (k != 0.f) row = madd(row, tile[i][tx + ((dx + b) >> 1)], k);
        }
        acc = __fadd_rn(acc, row);
      }
      if (oy < h && ox < w) out[(size_t)oy * w + ox] = acc;
    }
  }
}

// One band level of the pyramid in one pass (the fused build). Block: BX x
// BY threads over a BX x (BY*BUILD_RY) output tile. The octave tile carries a
// 6-px halo (the 9x9 reach plus the band pair's 2), loaded once with
// reflect-101 by index. hp is computed for the tile plus a 2-px apron into
// shared memory; an apron position outside the image holds hp at the
// mirrored index (reflect-101 of hp, as band5 reads it), computed from the
// octave tile, which covers the 9x9 window of every mirrored position a
// valid output needs (the window start is clamped only for positions no
// valid output reads). Then each thread writes hp, r and i for its outputs
// and one decimated 2LP9 value at a kept (even, even) site. Every sum runs
// in conv9's, band5's and lp9_decimate's order, so the outputs equal theirs.
template <typename TOut>
__global__ void __launch_bounds__(BX * BY)
build_level_kernel(const float* __restrict__ x, TOut* __restrict__ hp_out,
                   TOut* __restrict__ r_out, TOut* __restrict__ i_out,
                   float* __restrict__ sub_out, int h, int w, Taps81 hp9, Taps5 t5,
                   Taps81 lp9) {
  constexpr int RY = 4;
  constexpr int TX = BX;
  constexpr int TY = BY * RY;
  constexpr int IN_H = TY + 12;
  constexpr int IN_W = TX + 12;
  constexpr int HP_H = TY + 4;
  constexpr int HP_W = TX + 4;
  static_assert(TX % 2 == 0 && TY % 2 == 0, "tile origins must stay even");
  static_assert((TX / 2) * (TY / 2) == BX * BY, "one kept site a thread");
  __shared__ float tile[IN_H][IN_W];
  __shared__ float hpx[HP_H][HP_W];

  const int ox0 = blockIdx.x * TX;
  const int oy0 = blockIdx.y * TY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  for (int idx = tid; idx < IN_H * IN_W; idx += BX * BY) {
    const int r = idx / IN_W;
    const int c = idx - r * IN_W;
    tile[r][c] = x[(size_t)reflect101(oy0 - 6 + r, h) * w + reflect101(ox0 - 6 + c, w)];
  }
  __syncthreads();

  for (int idx = tid; idx < HP_H * HP_W; idx += BX * BY) {
    const int a = idx / HP_W;
    const int b = idx - a * HP_W;
    // the 9x9 window of hp at the mirrored position starts at tile row
    // (ry - 4) - (oy0 - 6)
    const int sy = min(max(reflect101(oy0 - 2 + a, h) - oy0 + 2, 0), IN_H - 9);
    const int sx = min(max(reflect101(ox0 - 2 + b, w) - ox0 + 2, 0), IN_W - 9);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      float row = 0.f;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const float k = hp9.k[i * 9 + j];
        if (k != 0.f) row = madd(row, tile[sy + i][sx + j], k);
      }
      acc = __fadd_rn(acc, row);
    }
    hpx[a][b] = acc;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int ox = ox0 + tx;
#pragma unroll
  for (int j = 0; j < RY; ++j) {
    const int ty = threadIdx.y * RY + j;
    const int oy = oy0 + ty;
    float rr = 0.f;
    float ii = 0.f;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const float k = t5.k[b];
      if (k != 0.f) {
        rr = madd(rr, hpx[ty + 2][tx + b], k);
        ii = madd(ii, hpx[ty + b][tx + 2], k);
      }
    }
    if (oy < h && ox < w) {
      const size_t o = (size_t)oy * w + ox;
      store(hp_out, o, hpx[ty + 2][tx + 2]);
      store(r_out, o, rr);
      store(i_out, o, ii);
    }
  }

  // the kept site (2*dy, 2*dx) of the tile; its window starts at tile row
  // (y - 4) - (oy0 - 6) = 2*dy + 2
  const int dy = tid / (TX / 2);
  const int dx = tid - dy * (TX / 2);
  const int y = oy0 + 2 * dy;
  const int xx = ox0 + 2 * dx;
  if (y < h && xx < w) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 9; ++a) {
      float row = 0.f;
#pragma unroll
      for (int b = 0; b < 9; ++b) {
        const float k = lp9.k[a * 9 + b];
        if (k != 0.f) row = madd(row, tile[2 * dy + 2 + a][2 * dx + 2 + b], k);
      }
      acc = __fadd_rn(acc, row);
    }
    sub_out[(size_t)(y / 2) * ((w + 1) / 2) + xx / 2] = acc;
  }
}

constexpr int CONV9_RY = 4;
constexpr int DEC_RY = 2;
constexpr int BAND_RY = 4;
constexpr int INJECT_RY = 4;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

Taps81 taps81(const void* k) {
  Taps81 t;
  std::memcpy(t.k, k, sizeof t.k);
  return t;
}

Taps5 taps5(const void* k) {
  Taps5 t;
  std::memcpy(t.k, k, sizeof t.k);
  return t;
}

template <typename TOut, bool ROUND>
void conv9_launch(const void* x, void* out, int h, int w, const void* taps,
                  cudaStream_t s) {
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(w, BX), ceil_div(h, BY * CONV9_RY));
  stencil9_kernel<1, CONV9_RY, TOut, ROUND><<<grid, block, 0, s>>>(
      static_cast<const float*>(x), static_cast<TOut*>(out), h, w, h, w, taps81(taps));
}

template <bool ROUND>
void decimate_launch(const void* x, void* out, int h, int w, const void* taps,
                     cudaStream_t s) {
  const int oh = (h + 1) / 2;
  const int ow = (w + 1) / 2;
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(ow, BX), ceil_div(oh, BY * DEC_RY));
  stencil9_kernel<2, DEC_RY, float, ROUND><<<grid, block, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, oh, ow, taps81(taps));
}

template <typename TIn, typename TOut, bool ROUND>
void band5_launch(const void* hp, void* r, void* i, int h, int w, const void* r_taps,
                  const void* i_taps, cudaStream_t s) {
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(w, BX), ceil_div(h, BY * BAND_RY));
  band5_kernel<BAND_RY, TIn, TOut, ROUND><<<grid, block, 0, s>>>(
      static_cast<const TIn*>(hp), static_cast<TOut*>(r), static_cast<TOut*>(i), h, w,
      taps5(r_taps), taps5(i_taps));
}

template <typename TIn, typename TOut>
void band5_round(bool round, const void* hp, void* r, void* i, int h, int w,
                 const void* r_taps, const void* i_taps, cudaStream_t s) {
  if (round) {
    band5_launch<TIn, TOut, true>(hp, r, i, h, w, r_taps, i_taps, s);
  } else {
    band5_launch<TIn, TOut, false>(hp, r, i, h, w, r_taps, i_taps, s);
  }
}

template <typename TIn>
void band5_out(bool out_bf16, bool round, const void* hp, void* r, void* i, int h, int w,
               const void* r_taps, const void* i_taps, cudaStream_t s) {
  if (out_bf16) {
    band5_round<TIn, __nv_bfloat16>(round, hp, r, i, h, w, r_taps, i_taps, s);
  } else {
    band5_round<TIn, float>(round, hp, r, i, h, w, r_taps, i_taps, s);
  }
}

template <bool ROUND>
void inject_launch(const void* small, void* out, int sh, int sw, int h, int w,
                   const void* taps, cudaStream_t s) {
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(w, 2 * BX), ceil_div(h, BY * INJECT_RY));
  inject9_kernel<INJECT_RY, ROUND><<<grid, block, 0, s>>>(
      static_cast<const float*>(small), static_cast<float*>(out), sh, sw, h, w, taps81(taps));
}

template <typename TOut>
void build_launch(const void* x, void* hp, void* r, void* i, void* sub, int h, int w,
                  const void* hp9, const void* t5, const void* lp9, cudaStream_t s) {
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(w, BX), ceil_div(h, BY * 4));
  build_level_kernel<TOut><<<grid, block, 0, s>>>(
      static_cast<const float*>(x), static_cast<TOut*>(hp), static_cast<TOut*>(r),
      static_cast<TOut*>(i), static_cast<float*>(sub), h, w, taps81(hp9), taps5(t5),
      taps81(lp9));
}

}  // namespace

extern "C" {

// bf16: bf16 operands (taps arrive rounded); out_bf16: a bf16 output plane.
int lvmt_conv9(const void* x, void* out, int h, int w, const void* taps, int bf16,
               int out_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    if (bf16) conv9_launch<__nv_bfloat16, true>(x, out, h, w, taps, s);
    else conv9_launch<__nv_bfloat16, false>(x, out, h, w, taps, s);
  } else {
    if (bf16) conv9_launch<float, true>(x, out, h, w, taps, s);
    else conv9_launch<float, false>(x, out, h, w, taps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int lvmt_lp9_decimate(const void* x, void* out, int h, int w, const void* taps, int bf16,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) decimate_launch<true>(x, out, h, w, taps, s);
  else decimate_launch<false>(x, out, h, w, taps, s);
  return static_cast<int>(cudaGetLastError());
}

// r_taps: r's taps (bf16-rounded under bf16); i_taps: i's, as given.
// in_bf16 / out_bf16: bf16 input / output planes.
int lvmt_band5(const void* hp, void* r, void* i, int h, int w, const void* r_taps,
               const void* i_taps, int in_bf16, int out_bf16, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    band5_out<__nv_bfloat16>(out_bf16, bf16, hp, r, i, h, w, r_taps, i_taps, s);
  } else {
    band5_out<float>(out_bf16, bf16, hp, r, i, h, w, r_taps, i_taps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int lvmt_lp9_inject(const void* small, void* out, int sh, int sw, int h, int w,
                    const void* taps, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) inject_launch<true>(small, out, sh, sw, h, w, taps, s);
  else inject_launch<false>(small, out, sh, sw, h, w, taps, s);
  return static_cast<int>(cudaGetLastError());
}

// hp, r, i: h x w (bf16 when out_bf16); sub: ceil(h/2) x ceil(w/2) floats.
int lvmt_riesz_build_level(const void* x, void* hp, void* r, void* i, void* sub, int h,
                           int w, const void* hp9, const void* t5, const void* lp9,
                           int out_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) build_launch<__nv_bfloat16>(x, hp, r, i, sub, h, w, hp9, t5, lp9, s);
  else build_launch<float>(x, hp, r, i, sub, h, w, hp9, t5, lp9, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
