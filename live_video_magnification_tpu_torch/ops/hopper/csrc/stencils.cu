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
// operands, f32 accumulation) is a template flag ROUND (in stencil9_kernel
// a launch flag: it changes only how the tile is staged): each pixel is
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
// it bit for bit (up to the sign of a zero; conv9 and lp9_decimate start each
// row sum from its first product and the total from its first row, as the
// plain version does, so there the sign of a zero matches too).
//
// The exactness floor: rounding each product and sum alone costs two issue
// slots per used tap where an FMA would take one, at most 128 f32
// instructions a cycle on each of 132 SMs (3.35e13 a second at 1.98 GHz).
// conv9 with the high-pass's 77 used taps is 153 instructions an output: at
// 2160x3840, 1.27 G instructions, ~38 us, above both its bytes bound (66 MB,
// ~20 us at 3.35 TB/s) and its FMA-counted f32 bound (~19 us at 67 TFLOP/s).
// So conv9 is bound by instruction issue, and cannot pass about half of its
// table bound while it stays bit-equal to its plain version. lp9_decimate
// (81 taps at a quarter of the sites, ~10 us of instructions) and inject are
// bound by bytes (41 MB each, ~12 us), band5 too (100 MB, ~30 us); the fused
// build moves 33 + 100 + 8 MB and does 2.0 G operations (~42 us, bytes).
//
// conv9 and lp9_decimate (stencil9_kernel) spend their issue slots on those
// products and sums and little else:
//   - the zero pattern of the main path's bank is a template parameter
//     (conv9's high-pass: all but the four corners; decimate's 2*LP9: all
//     81), so no tap is tested or multiplied in vain; any other bank takes
//     an instantiation that tests each tap as it runs; the tap values stay
//     kernel parameters, which FMUL reads from the constant bank;
//   - each thread computes 4 outputs along W by RY down H and reads each
//     tile row it needs once, with 16-byte shared loads, for all the outputs
//     that use it;
//   - where rows are 16-byte aligned (w % 4 == 0), the tile is staged in
//     4-column chunks: a chunk inside the image is one 16-byte global load,
//     one outside it (only at the left and right borders) four loads
//     mirrored by index (reflect-101); rows are mirrored by index, once a
//     chunk; other widths stage one element at a time, mirrored by index;
//   - lp9_decimate stages its tile split by column parity (even columns, then
//     odd), so a thread's stride-2 reads are unit-stride and free of bank
//     conflicts, and computes only the kept sites;
//   - the host launches as many blocks as fit on the card at once, and each
//     walks tiles; with 16-byte rows a block issues the next tile's global
//     loads into registers before it sums the current one, so they are in
//     flight while it computes (decimate is bound by bytes and instructions
//     about equally: without this, its loads and its sums took turns);
//   - the host takes a taller tile (RY 4 for conv9, 2 for decimate) where
//     that still gives two blocks an SM, and RY = 1 on smaller levels
//     (decimate there with half-width tiles, so its few tiles spread over
//     the SMs); any other bank always takes RY = 1.
// No tensor cores: their sums take another order, which would break the
// agreement with the plain versions, K5's with K1+K2+K3, and the sharded
// step's 0 LSB.
//
// The other kernels stage one input tile per block through shared memory
// and write each output once; band5, inject and the fused build compute RY
// outputs down a column from a row of tile values loaded into registers. The
// fused build recomputes hp on its 2-px apron (36x36 values for a 32x32
// tile, +27%) rather than exchange it between blocks.
//
// C interface: pointers and the stream as void*, sizes as int, taps as a host
// pointer copied into a by-value kernel parameter. Each function returns
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
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

// Four outputs to consecutive addresses; the caller checks the alignment.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Which taps of a 9x9 bank are used (non-zero): known at compile time for
// the main path's banks, all of them (decimate's 2*LP9) or all but the four
// corners (conv9's HP9); any other bank's, tested at run time.
constexpr int TAPS_ANY = 0;
constexpr int TAPS_DENSE = 1;
constexpr int TAPS_NO_CORNERS = 2;

__host__ __device__ constexpr bool corner(int a, int b) {
  return (a == 0 || a == 8) && (b == 0 || b == 8);
}

// Launch flags of stencil9_kernel.
constexpr int FLAG_VEC_IN = 1;   // input rows 16-byte aligned (w % 4 == 0)
constexpr int FLAG_VEC_OUT = 2;  // output rows aligned for 4-wide stores
constexpr int FLAG_ROUND = 4;    // bf16 operands: the tile holds rounded pixels

constexpr int STENCIL_RX = 4;   // outputs a thread computes along W
constexpr int STAGE_BATCH = 8;  // loads a thread keeps in flight, element by element

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

// The values of one tile row that a thread reads: NV columns from t in each
// of the S planes (PS floats apart).
template <int S, int NV, int PS>
__device__ __forceinline__ void read_row(const float* t, float (&v)[S][NV]) {
#pragma unroll
  for (int p = 0; p < S; ++p) {
#pragma unroll
    for (int q = 0; q < NV; q += 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(t + p * PS + q);
      v[p][q] = t4.x;
      v[p][q + 1] = t4.y;
      v[p][q + 2] = t4.z;
      v[p][q + 3] = t4.w;
    }
  }
}

// Adds tile row r (of the thread's window rows) to the outputs that use it:
// output row j takes tap row a = r - S*j, output i tap b from plane b % S
// at i + b / S. The row sum starts from its first used product (a row with
// none adds +0, as in the plain version), the total from tap row 0.
template <int S, int PAT, int NV, int RY, int RX>
__device__ __forceinline__ void add_row(int r, const float (&v)[S][NV], const Taps81& taps,
                                        float (&acc)[RY][RX]) {
#pragma unroll
  for (int j = 0; j < RY; ++j) {
    const int a = r - S * j;
    if (a < 0 || a > 8) continue;
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      float row = 0.f;
      bool first = true;
#pragma unroll
      for (int b = 0; b < 9; ++b) {
        const float k = taps.k[a * 9 + b];
        const bool used = PAT == TAPS_DENSE || (PAT == TAPS_NO_CORNERS && !corner(a, b)) ||
                          (PAT == TAPS_ANY && k != 0.f);
        if (used) {
          const float prod = __fmul_rn(v[b % S][i + b / S], k);
          row = first ? prod : __fadd_rn(row, prod);
          first = false;
        }
      }
      acc[j][i] = a == 0 ? row : __fadd_rn(acc[j][i], row);
    }
  }
}

// 9x9 correlation sampled with stride S (S=1: conv9, S=2: decimate), taps
// of zero pattern PAT. A block of WX x BY threads walks output tiles
// TX x TY = (WX*4) x (BY*RY), tile t at (t % tiles_x, t / tiles_x), from
// blockIdx.x in steps of gridDim.x (the host launches as many blocks as fit
// on the card at once). Each tile stages S*(TY-1)+9 input rows from S*oy0-4
// in shared memory as S planes of input columns: for S=2 the even columns,
// then the odd ones (column c of the tile in plane c % S at c / S), so
// output i of a thread reads plane b % S at i + b / S for tap b. With 16-byte
// rows the next tile's loads are issued into registers before this tile's
// sums, so they are in flight while the block computes. A thread computes 4
// outputs along W by RY along H. Every output sums its rows a = 0..8 in
// order, each row its used taps left to right, the row sum starting from
// its first product and the total from its first row, every product and sum
// rounded alone.
template <int S, int WX, int RY, int PAT, typename TOut>
__global__ void __launch_bounds__(WX * BY)
stencil9_kernel(const float* __restrict__ x, TOut* __restrict__ out, int h, int w,
                int oh, int ow, int tiles_x, int tiles, int flags,
                const __grid_constant__ Taps81 taps) {  // read in place, from the constant bank
  constexpr int NT = WX * BY;
  constexpr int RX = STENCIL_RX;
  constexpr int TX = WX * RX;
  constexpr int TY = BY * RY;
  constexpr int IN_H = S * (TY - 1) + 9;
  constexpr int LOAD_W = S * TX + 8;  // input columns staged (S*(TX-1)+9, rounded up to 4)
  constexpr int PW = LOAD_W / S;      // columns of a plane
  constexpr int NV = RX + 8 / S;      // values of a plane a thread reads from a tile row
  constexpr int Q = LOAD_W / 4;       // 4-column chunks of a tile row
  constexpr int CHUNKS = (IN_H * Q + NT - 1) / NT;  // of a thread
  static_assert(LOAD_W % 4 == 0 && PW % 4 == 0 && NV % 4 == 0, "16-byte rows and reads");
  __shared__ __align__(16) float tile[S][IN_H][PW];

  const int tid = threadIdx.y * WX + threadIdx.x;
  const bool vec_in = flags & FLAG_VEC_IN;
  const bool to_bf16 = flags & FLAG_ROUND;
  const int c0 = threadIdx.x * RX;      // the thread's first column in each plane
  const int r0 = S * threadIdx.y * RY;  // the tile row its first output's window starts at

  // 16-byte rows: chunk i of a tile, one 16-byte load inside the image, four
  // loads mirrored by index outside it (only at the left and right borders);
  // rows mirrored by index
  float4 buf[CHUNKS];
  auto fetch = [&](int t) {
    const int ty = t / tiles_x;
    const int iy0 = S * ty * TY - 4;
    const int ix0 = S * (t - ty * tiles_x) * TX - 4;  // a multiple of 4
    unrolled<0, CHUNKS>([&](auto u) {
      constexpr int U = decltype(u)::value;
      const int i = U * NT + tid;
      if (U < CHUNKS - 1 || i < IN_H * Q) {
        const int r = i / Q;
        const int c = ix0 + 4 * (i - r * Q);
        const float* row = x + (size_t)reflect101(iy0 + r, h) * w;
        if (c >= 0 && c < w) {
          buf[U] = *reinterpret_cast<const float4*>(row + c);
        } else {
          buf[U] = make_float4(row[reflect101(c, w)], row[reflect101(c + 1, w)],
                               row[reflect101(c + 2, w)], row[reflect101(c + 3, w)]);
        }
      }
    });
  };
  auto put = [&]() {
    unrolled<0, CHUNKS>([&](auto u) {
      constexpr int U = decltype(u)::value;
      const int i = U * NT + tid;
      if (U < CHUNKS - 1 || i < IN_H * Q) {
        const int r = i / Q;
        const int q = i - r * Q;
        float4 v = buf[U];
        if (to_bf16) {
          v.x = round_bf16(v.x);
          v.y = round_bf16(v.y);
          v.z = round_bf16(v.z);
          v.w = round_bf16(v.w);
        }
        if constexpr (S == 1) {
          *reinterpret_cast<float4*>(&tile[0][r][4 * q]) = v;
        } else {
          *reinterpret_cast<float2*>(&tile[0][r][2 * q]) = make_float2(v.x, v.z);
          *reinterpret_cast<float2*>(&tile[1][r][2 * q]) = make_float2(v.y, v.w);
        }
      }
    });
  };

  const int first_tile = blockIdx.x;
  const int stride = gridDim.x;
  if (vec_in && first_tile < tiles) fetch(first_tile);
  for (int t = first_tile; t < tiles; t += stride) {
    const int oy0 = t / tiles_x * TY;
    const int ox0 = (t - t / tiles_x * tiles_x) * TX;
    __syncthreads();  // every thread is done reading the previous tile
    if (vec_in) {
      put();
      __syncthreads();
      if (t + stride < tiles) fetch(t + stride);  // in flight during the sums below
    } else {
      // rows not aligned (w % 4 != 0): one element at a time, mirrored by index
      const int iy0 = S * oy0 - 4;
      const int ix0 = S * ox0 - 4;
      constexpr int N = IN_H * LOAD_W;
      constexpr int ITERS = (N + NT - 1) / NT;
#pragma unroll 1
      for (int base = 0; base < ITERS; base += STAGE_BATCH) {
        float e[STAGE_BATCH];
        unrolled<0, STAGE_BATCH>([&](auto u) {
          const int i = (base + decltype(u)::value) * NT + tid;
          if (i < N) {
            const int r = i / LOAD_W;
            e[decltype(u)::value] =
                x[(size_t)reflect101(iy0 + r, h) * w + reflect101(ix0 + i - r * LOAD_W, w)];
          }
        });
        unrolled<0, STAGE_BATCH>([&](auto u) {
          const int i = (base + decltype(u)::value) * NT + tid;
          if (i < N) {
            const int r = i / LOAD_W;
            const int c = i - r * LOAD_W;
            const float v = e[decltype(u)::value];
            tile[c % S][r][c / S] = to_bf16 ? round_bf16(v) : v;
          }
        });
      }
      __syncthreads();
    }

    float acc[RY][RX] = {};
    const float* row0 = &tile[0][r0][c0];
    if constexpr (PAT == TAPS_ANY) {
      // any other bank (off the main path): the tile rows in a loop, which
      // keeps this instantiation's code small
#pragma unroll 1
      for (int r = 0; r < S * (RY - 1) + 9; ++r) {
        float v[S][NV];
        read_row<S, NV, IN_H * PW>(row0 + r * PW, v);
        add_row<S, PAT>(r, v, taps, acc);
      }
    } else {
      // the tile rows unrolled by construction, so every tap index is a
      // constant and the pattern's zeros drop out at compile time
      unrolled<0, S * (RY - 1) + 9>([&](auto rr) {
        constexpr int R = decltype(rr)::value;
        float v[S][NV];
        read_row<S, NV, IN_H * PW>(row0 + R * PW, v);
        add_row<S, PAT>(R, v, taps, acc);
      });
    }

    const int ox = ox0 + c0;
    const bool vec_out = (flags & FLAG_VEC_OUT) && ox + RX <= ow;
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      const int oy = oy0 + threadIdx.y * RY + j;
      if (oy >= oh) break;
      const size_t o = (size_t)oy * ow + ox;
      if (vec_out) {
        store4(out + o, acc[j]);
      } else {
#pragma unroll
        for (int i = 0; i < RX; ++i) {
          if (ox + i < ow) store(out, o + i, acc[j][i]);
        }
      }
    }
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

// At least this many tall tiles keep two blocks on each of an H100's 132
// SMs; smaller outputs take RY = 1, and decimate also half-width tiles
// (16 threads along W), so that its few tiles still spread over the SMs.
constexpr int TALL_GRID_MIN = 2 * 132;

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Blocks of the kernel that fit on the current device at once (its SMs times
// the blocks an SM holds), asked once per kernel.
template <typename K>
int resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return per_sm * sms > 0 ? per_sm * sms : 1;
}

template <int S, int WX, int RY, int PAT, typename TOut>
void stencil9_go(const void* x, void* out, int h, int w, int oh, int ow, int flags,
                 const Taps81& taps, cudaStream_t s) {
  static const int resident = resident_blocks(stencil9_kernel<S, WX, RY, PAT, TOut>, WX * BY);
  const int tiles_x = ceil_div(ow, WX * STENCIL_RX);
  const int tiles = tiles_x * ceil_div(oh, BY * RY);
  stencil9_kernel<S, WX, RY, PAT, TOut><<<tiles < resident ? tiles : resident, dim3(WX, BY), 0, s>>>(
      static_cast<const float*>(x), static_cast<TOut*>(out), h, w, oh, ow, tiles_x, tiles,
      flags, taps);
}

// conv9 (S=1) or lp9_decimate (S=2). main_taps: the taps have the zero
// pattern of the bank each runs on the main path (conv9 HP9, no corners;
// decimate 2*LP9, dense), which has its own instantiations, a tall tile and
// RY = 1 by the output's size; any other bank takes TAPS_ANY.
template <int S, typename TOut>
void stencil9_launch(const void* x, void* out, int h, int w, const void* taps, bool round,
                     bool main_taps, cudaStream_t s) {
  constexpr int TALL_RY = S == 1 ? 4 : 2;
  constexpr int MAIN_PAT = S == 1 ? TAPS_NO_CORNERS : TAPS_DENSE;
  constexpr int SMALL_WX = S == 1 ? BX : BX / 2;
  const int oh = S == 1 ? h : (h + 1) / 2;
  const int ow = S == 1 ? w : (w + 1) / 2;
  int flags = round ? FLAG_ROUND : 0;
  if (w % 4 == 0 && aligned(x, 16)) flags |= FLAG_VEC_IN;
  if (ow % 4 == 0 && aligned(out, 4 * sizeof(TOut))) flags |= FLAG_VEC_OUT;
  const Taps81 t = taps81(taps);
  if (!main_taps) {
    stencil9_go<S, SMALL_WX, 1, TAPS_ANY, TOut>(x, out, h, w, oh, ow, flags, t, s);
  } else if (ceil_div(ow, BX * STENCIL_RX) * ceil_div(oh, BY * TALL_RY) >= TALL_GRID_MIN) {
    stencil9_go<S, BX, TALL_RY, MAIN_PAT, TOut>(x, out, h, w, oh, ow, flags, t, s);
  } else {
    stencil9_go<S, SMALL_WX, 1, MAIN_PAT, TOut>(x, out, h, w, oh, ow, flags, t, s);
  }
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

// bf16: bf16 operands (taps arrive rounded); out_bf16: a bf16 output plane;
// main_taps: the host found the taps it passes to have the zero pattern of
// the main path's bank (conv9: all but the four corners used; lp9_decimate:
// all 81).
int lvmt_conv9(const void* x, void* out, int h, int w, const void* taps, int bf16,
               int out_bf16, int main_taps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) stencil9_launch<1, __nv_bfloat16>(x, out, h, w, taps, bf16, main_taps, s);
  else stencil9_launch<1, float>(x, out, h, w, taps, bf16, main_taps, s);
  return static_cast<int>(cudaGetLastError());
}

int lvmt_lp9_decimate(const void* x, void* out, int h, int w, const void* taps, int bf16,
                      int main_taps, void* stream) {
  stencil9_launch<2, float>(x, out, h, w, taps, bf16, main_taps,
                            static_cast<cudaStream_t>(stream));
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
