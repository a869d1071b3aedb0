// Reflect-101 pyramid stencils of the Riesz phase pipeline, for sm_90a.
//
// Four kernels, one per TPU kernel of the reference package's
// ops/pallas/conv9_mxu.py. They compute WHAT those compute, not how: the TPU
// kernels are banded matmuls shaped for the MXU's 128x128 tiles; here each
// block stages a halo tile in shared memory, mirroring the reflect-101 border
// by index as the tile is loaded (no padded copy in device memory), and each
// thread sums its taps from the tile.
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
// and inject 41 MB each (memory-bound, ~30 / 12 / 12 us). What the design does
// about it: one read of the input tile per block through shared memory, each
// output written once, and a thread computing RY outputs down a column so a
// row of 9 tile values loaded into registers serves up to RY outputs
// (conv9: 108 shared loads per 4 outputs instead of 324). Keeping products
// and sums apart costs conv9 up to 2x in issue slots against FMAs; exact
// agreement with the plain version is worth it in a first kernel.
//
// C interface: pointers and the stream as void*, sizes as int, taps as a host
// pointer copied into a by-value kernel parameter. Each function returns
// cudaGetLastError() of its launch.

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

// Dense 9x9 correlation, sampled with stride S (S=1: conv9, S=2: decimate).
// Block: BX x BY threads, each computing RY outputs down one column, so the
// block covers BX x (BY*RY) outputs from a tile of input rows/cols
// S*(T-1)+9 starting at S*origin-4.
template <int S, int RY>
__global__ void __launch_bounds__(BX * BY)
stencil9_kernel(const float* __restrict__ x, float* __restrict__ out, int h, int w,
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
    tile[r][c] = x[(size_t)reflect101(iy0 + r, h) * w + reflect101(ix0 + c, w)];
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
    if (oy < oh && ox < ow) out[(size_t)oy * ow + ox] = acc[j];
  }
}

// Riesz band pair on the high-pass band: r along W, i along H, both from one
// tile with a 2-px halo.
template <int RY>
__global__ void __launch_bounds__(BX * BY)
band5_kernel(const float* __restrict__ hp, float* __restrict__ r_out,
             float* __restrict__ i_out, int h, int w, Taps5 taps) {
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
    tile[r][c] = hp[(size_t)reflect101(oy0 - 2 + r, h) * w + reflect101(ox0 - 2 + c, w)];
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
      const float k = taps.k[b];
      if (k != 0.f) {
        rr = madd(rr, tile[ty + 2][tx + b], k);
        ii = madd(ii, tile[ty + b][tx + 2], k);
      }
    }
    const int oy = oy0 + ty;
    if (oy < h && ox < w) {
      r_out[(size_t)oy * w + ox] = rr;
      i_out[(size_t)oy * w + ox] = ii;
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
// plain version.
template <int RY>
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
    tile[i][j] = small[(size_t)min(p, sh - 1) * sw + min(q, sw - 1)];
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

constexpr int CONV9_RY = 4;
constexpr int DEC_RY = 2;
constexpr int BAND_RY = 4;
constexpr int INJECT_RY = 4;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

Taps81 taps81(const float* k) {
  Taps81 t;
  std::memcpy(t.k, k, sizeof t.k);
  return t;
}

}  // namespace

extern "C" {

int lvmt_conv9(const void* x, void* out, int h, int w, const void* taps, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(w, BX), ceil_div(h, BY * CONV9_RY));
  stencil9_kernel<1, CONV9_RY><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, h, w,
      taps81(static_cast<const float*>(taps)));
  return static_cast<int>(cudaGetLastError());
}

int lvmt_lp9_decimate(const void* x, void* out, int h, int w, const void* taps,
                      void* stream) {
  const int oh = (h + 1) / 2;
  const int ow = (w + 1) / 2;
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(ow, BX), ceil_div(oh, BY * DEC_RY));
  stencil9_kernel<2, DEC_RY><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, oh, ow,
      taps81(static_cast<const float*>(taps)));
  return static_cast<int>(cudaGetLastError());
}

int lvmt_band5(const void* hp, void* r, void* i, int h, int w, const void* taps,
               void* stream) {
  Taps5 t;
  std::memcpy(t.k, taps, sizeof t.k);
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(w, BX), ceil_div(h, BY * BAND_RY));
  band5_kernel<BAND_RY><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hp), static_cast<float*>(r), static_cast<float*>(i), h, w, t);
  return static_cast<int>(cudaGetLastError());
}

int lvmt_lp9_inject(const void* small, void* out, int sh, int sw, int h, int w,
                    const void* taps, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid(ceil_div(w, 2 * BX), ceil_div(h, BY * INJECT_RY));
  inject9_kernel<INJECT_RY><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(small), static_cast<float*>(out), sh, sw, h, w,
      taps81(static_cast<const float*>(taps)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
