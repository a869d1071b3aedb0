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
//                        hp = x (*) HP9 on the tile plus a 2-px apron in
//                        shared memory (mirrored outside the image), the band
//                        pair from it, and (x (*) 2LP9) at the kept even
//                        sites: one read of the octave for what conv9, band5
//                        and lp9_decimate read three times
//   lvmt_blur13       <- no TPU kernel: the plain tail's GaussianBlur(13x13,
//                        sigma=3) of the amplitudes (ops/riesz.py::
//                        amplitude_blur), which the reference package leaves
//                        to jnp and XLA fuses. In plain PyTorch it was 62
//                        launches and ~4.3 GB of elementwise traffic a 4K
//                        level-0 blur (reflect pads, 13 shifted products and
//                        12 sums an axis), 15 blurs a 4K frame. blur13_kernel
//                        stages a haloed tile as amplify13_kernel does
//                        (tail.cu), keeps both passes in shared memory and
//                        reads and writes each plane once: 66 MB at
//                        2160x3840, a bound of 0.0198 ms (bytes); its ~60
//                        rounded operations an output (the W-axis pass on
//                        the halo rows too) take ~0.015 ms at one a lane a
//                        cycle. It reads 0.0367 ms there by CUDA graph on an
//                        H100 SXM at 700 W, half its bound: the staging, the
//                        two passes and the store of a tile take turns, and
//                        a 64-row tile (1.19 staged rows an output row) with
//                        four blocks an SM was the fastest of the tiles and
//                        register caps tried; under 1,056 such tiles the
//                        32-row tile, whose shorter chain a block waits on
//                        less. [..., H, W] planes, any sides (reflect-101
//                        periodic under 7 px, as the plain version).
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
// it bit for bit. Every kernel starts each row sum from its first product
// and the total from its first row, as the plain version does, so the sign
// of a zero matches too (inject adds +0 where the plain version's zero-site
// products would; see inject9_kernel). Where both factors of a product are
// bf16 values and the taps lie in 2^-7..1 (band5's r in the bf16 arm,
// checked on the host), the product is exact in f32, so a fused multiply-add
// rounds only the sum and gives the same bits.
//
// The exactness floor: rounding each product and sum alone costs two issue
// slots per used tap where an FMA would take one, at most 128 f32
// instructions a cycle on each of 132 SMs (3.35e13 a second at 1.98 GHz).
// conv9 with the high-pass's 77 used taps is 153 instructions an output: at
// 2160x3840, 1.27 G instructions, ~38 us, above both its bytes bound (66 MB,
// ~20 us at 3.35 TB/s) and its FMA-counted f32 bound (~19 us at 67 TFLOP/s).
// So conv9 is bound by instruction issue, and cannot pass about half of its
// table bound while it stays bit-equal to its plain version. lp9_decimate
// (81 taps at a quarter of the sites, ~10 us of instructions) and inject
// (each output meets the taps of its parity class, 81/4 on average: ~40
// instructions an output, ~10 us) are bound by bytes and issue about
// equally (41 MB each, ~12 us); band5 by bytes (100 MB, ~30 us). The fused
// build moves 33 + 100 + 8 MB (~42 us) but issues ~210 instructions an
// output at the least (hp 153, the band pair 16, a quarter of a decimate
// sum's 161), ~52 us: bound by issue, as conv9 is.
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
// The fused build (build_level_kernel), the inject (inject9_kernel) and the
// band pair (band5_kernel) use the same machinery: compile-time tap patterns
// (HP9 without corners and 2*LP9 dense, the band taps' zero centre; inject's
// dense bank), register blocks of 4 outputs along W fed by 16-byte (8-byte
// for inject) shared reads, 16-byte staging with reflect-101 only outside
// the image, blocks that walk tiles and prefetch, a tall tile and a small
// one by the same size rule.
// The fused build computes hp on its tile plus a 2-px apron (64x32 outputs,
// hp on 72x36: 1.27x) and copies the apron outside the image from its
// mirror; its band pair and decimate read the shared tiles. The inject
// stages only the even sites of the injected array and sums only the taps
// that meet them.
// band5 moves 12 bytes a pixel (6 in the bf16 arm) and issues ~15
// instructions an output: it is bound by bytes. A thread's 4 x RY outputs
// read each tile row of its columns once (16 bytes) for the i sums of every
// output row that uses it, and 16 bytes left and right of an output row for
// r; bf16 input is staged 8 elements a chunk and widened in shared memory.
// No tensor cores: their sums take another order, which would break the
// agreement with the plain versions, K5's with K1+K2+K3, and the sharded
// step's 0 LSB.
//
// C interface: pointers and the stream as void*, sizes as int, taps as a host
// pointer copied into a by-value kernel parameter. Each function returns
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
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

// Sixteen bytes of a row at columns c .. c+3 (f32) or c .. c+7 (bf16),
// each mirrored by index (reflect-101): a chunk outside the image.
__device__ __forceinline__ float4 gather16(const float* row, int c, int w) {
  return make_float4(row[reflect101(c, w)], row[reflect101(c + 1, w)],
                     row[reflect101(c + 2, w)], row[reflect101(c + 3, w)]);
}
__device__ __forceinline__ uint4 gather16(const __nv_bfloat16* row, int c, int w) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(row);
  auto pair = [&](int k) {
    return static_cast<unsigned>(u[reflect101(c + k, w)]) |
           (static_cast<unsigned>(u[reflect101(c + k + 1, w)]) << 16);
  };
  return make_uint4(pair(0), pair(2), pair(4), pair(6));
}

// The register type of a 16-byte chunk of T: four f32, or eight bf16 kept
// as raw bits until they are widened into shared memory.
template <typename T>
struct Chunk16 {
  using type = float4;
};
template <>
struct Chunk16<__nv_bfloat16> {
  using type = uint4;
};

// A chunk written to shared memory as f32 (bf16 widened exactly: its bits
// are the high half of the f32's).
__device__ __forceinline__ void put16(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void put16(float* dst, uint4 v) {
  auto lo = [](unsigned u) { return __uint_as_float(u << 16); };
  auto hi = [](unsigned u) { return __uint_as_float(u & 0xffff0000u); };
  *reinterpret_cast<float4*>(dst) = make_float4(lo(v.x), hi(v.x), lo(v.y), hi(v.y));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(lo(v.z), hi(v.z), lo(v.w), hi(v.w));
}

// Loads chunk U*NT + tid of a tile's N_CHUNKS 16-byte chunks (Q to a row;
// rows from iy0, columns from ix0, a multiple of the 4 f32 or 8 bf16
// elements of a chunk) of x into buf[U]: one 16-byte load inside the image,
// one load an element mirrored by index (reflect-101) outside it, only at
// the left and right borders; rows mirrored by index, once a chunk. w is a
// multiple of a chunk's elements.
template <int NT, int Q, int N_CHUNKS, int CHUNKS, typename B, typename T>
__device__ __forceinline__ void fetch16(B (&buf)[CHUNKS], const T* __restrict__ x, int h, int w,
                                        int iy0, int ix0, int tid) {
  constexpr int CE = 16 / sizeof(T);
  unrolled<0, CHUNKS>([&](auto u) {
    constexpr int U = decltype(u)::value;
    const int i = U * NT + tid;
    if (U < CHUNKS - 1 || i < N_CHUNKS) {
      const int r = i / Q;
      const int c = ix0 + CE * (i - r * Q);
      const T* row = x + (size_t)reflect101(iy0 + r, h) * w;
      if (c >= 0 && c < w) {
        buf[U] = *reinterpret_cast<const B*>(row + c);
      } else {
        buf[U] = gather16(row, c, w);
      }
    }
  });
}

// Stages a tile of N elements, LOAD_W to a row, from rows iy0 and columns
// ix0 of x one element at a time, each mirrored by index, STAGE_BATCH loads
// in flight a thread; put(r, c, v) stores one (as f32). For rows that are
// not 16-byte aligned.
template <int NT, int N, int LOAD_W, typename T, typename Put>
__device__ __forceinline__ void stage_elements(const T* __restrict__ x, int h, int w,
                                               int iy0, int ix0, int tid, const Put& put) {
  constexpr int ITERS = (N + NT - 1) / NT;
#pragma unroll 1
  for (int base = 0; base < ITERS; base += STAGE_BATCH) {
    float e[STAGE_BATCH];
    unrolled<0, STAGE_BATCH>([&](auto u) {
      const int i = (base + decltype(u)::value) * NT + tid;
      if (i < N) {
        const int r = i / LOAD_W;
        e[decltype(u)::value] =
            load(x, (size_t)reflect101(iy0 + r, h) * w + reflect101(ix0 + i - r * LOAD_W, w));
      }
    });
    unrolled<0, STAGE_BATCH>([&](auto u) {
      const int i = (base + decltype(u)::value) * NT + tid;
      if (i < N) {
        const int r = i / LOAD_W;
        put(r, i - r * LOAD_W, e[decltype(u)::value]);
      }
    });
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

  float4 buf[CHUNKS];  // 16-byte rows: the chunks of the next tile
  auto fetch = [&](int t) {
    const int ty = t / tiles_x;
    fetch16<NT, Q, IN_H * Q>(buf, x, h, w, S * ty * TY - 4,
                             S * (t - ty * tiles_x) * TX - 4, tid);
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
      stage_elements<NT, IN_H * LOAD_W, LOAD_W>(
          x, h, w, S * oy0 - 4, S * ox0 - 4, tid, [&](int r, int c, float v) {
            tile[c % S][r][c / S] = to_bf16 ? round_bf16(v) : v;
          });
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

// Four outputs of row oy from column ox: one 16- or 8-byte store where the
// row allows (vec), else those inside the image one by one.
template <typename TOut>
__device__ __forceinline__ void store_row(TOut* out, int oy, int ox, int h, int w, bool vec,
                                          const float (&v)[4]) {
  if (oy >= h) return;
  const size_t o = (size_t)oy * w + ox;
  if (vec) {
    store4(out + o, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ox + i < w) store(out, o + i, v[i]);
    }
  }
}

// Which taps of a 5-tap band bank are used: the main path's
// (RIESZ_BAND_KERNEL, all but the zero centre) at compile time; any other
// bank's (TAPS_ANY) tested at run time.
constexpr int TAPS_ZERO_CENTRE = 3;

// Adds tap B of a band bank to a sum: the first used tap (B = 0 of the zero
// centre) starts it, the centre is skipped at compile time; any other bank
// tests the tap as it runs (its sums start from -0, which adds nothing, or
// +0 for a bank with no used tap). FMA: the product is exact (bf16 factors,
// host-checked taps), so the fused multiply-add gives the bits of the
// product rounded and then added.
template <int PAT, bool FMA, int B>
__device__ __forceinline__ void band_tap(float& acc, float v, const Taps5& t) {
  const float k = t.k[B];
  if constexpr (PAT == TAPS_ANY) {
    if (k != 0.f) acc = __fadd_rn(acc, __fmul_rn(v, k));
  } else if constexpr (B == 0) {
    acc = __fmul_rn(v, k);
  } else if constexpr (B != 2) {
    acc = FMA ? __fmaf_rn(v, k, acc) : __fadd_rn(acc, __fmul_rn(v, k));
  }
}

// The start of a sum over bank t with run-time taps: -0, or +0 (what the
// plain version gives) when no tap is used.
__device__ __forceinline__ float band_start(const Taps5& t) {
  bool used = false;
#pragma unroll
  for (int b = 0; b < 5; ++b) used = used || t.k[b] != 0.f;
  return used ? -0.f : 0.f;
}

// Blocks of band5_kernel an SM holds at least: 32 warps (64 registers a
// thread) where a thread has up to 4 output rows, 16 warps (128 registers)
// where it has more (8 rows a thread stage 10 chunks of the next tile).
__host__ __device__ constexpr int band5_min_blocks(int tx, int ty, int nt) {
  return (ty * (tx / 4) / nt > 4 ? 512 : 1024) / nt;
}

// Riesz band pair on the high-pass band: r along W (taps tr, bf16-rounded
// under ROUND), i along H (taps ti, as given). A block of NT threads walks
// output tiles TX x TY as stencil9_kernel does, staging TY+4 rows from oy0-2
// and TX+2*CE columns from ox0-CE (CE elements to 16 bytes of TIn: 4 f32 or
// 8 bf16) in 16-byte chunks, reflect-101 by index only for chunks outside
// the image, bf16 widened to f32 in shared memory, and prefetching the next
// tile's chunks into registers while it sums this one; other widths or
// pointers stage one element at a time. A thread computes 4 outputs along W
// by RY rows: it reads the tile rows of its columns top to bottom, once
// each (16 bytes), and a row adds its taps to the i sums of every output row
// that uses it (a window of sums sliding down the column); an output row
// also reads its neighbours left and right (two more 16-byte reads) for r.
// Each sum runs over its used taps in order from its first product, as the
// plain version (ops/conv.py) does, so both outputs equal it bit for bit,
// the sign of a zero included. ROUND (bf16 operands): r's pixels are
// rounded to bf16 (already so when TIn is bf16) and its products, exact,
// fused into the sums (PAT != TAPS_ANY; the host sends other banks to the
// run-time instantiation); i is the f32 sum rounded to bf16. Outputs go out
// 16 (f32) or 8 (bf16) bytes at a time where the rows allow.
template <int TX, int TY, int NT, int PAT, typename TIn, typename TOut, bool ROUND>
__global__ void __launch_bounds__(NT, band5_min_blocks(TX, TY, NT))
band5_kernel(const TIn* __restrict__ hp, TOut* __restrict__ r_out, TOut* __restrict__ i_out,
             int h, int w, int tiles_x, int tiles, int flags,
             const __grid_constant__ Taps5 tr, const __grid_constant__ Taps5 ti) {
  constexpr int CE = 16 / sizeof(TIn);  // elements of a 16-byte chunk
  constexpr int IN_H = TY + 4;          // rows from oy0 - 2
  constexpr int LOAD_W = TX + 2 * CE;   // columns from ox0 - CE
  constexpr int Q = LOAD_W / CE;        // chunks of a staged row
  constexpr int CHUNKS = (IN_H * Q + NT - 1) / NT;
  constexpr int WX = TX / 4;            // threads along W
  constexpr int RY = TY * WX / NT;      // output rows of a thread
  constexpr bool FMA = ROUND && PAT != TAPS_ANY;
  constexpr bool ROUND_R = ROUND && sizeof(TIn) == 4;  // bf16 pixels are rounded already
  static_assert(TX % 16 == 0 && RY * NT == TY * WX && NT % WX == 0, "tile shape");
  __shared__ __align__(16) float tile[IN_H][LOAD_W];

  const int tid = threadIdx.x;
  const bool vec_in = flags & FLAG_VEC_IN;
  const bool vec_out_rows = flags & FLAG_VEC_OUT;
  const int bq = tid % WX;
  const int y0 = tid / WX * RY;  // tile rows y0 .. y0+RY-1 of the thread's outputs
  float r_start = 0.f, i_start = 0.f;
  if constexpr (PAT == TAPS_ANY) {
    r_start = band_start(tr);
    i_start = band_start(ti);
  }

  typename Chunk16<TIn>::type buf[CHUNKS];  // 16-byte rows: the chunks of the next tile
  auto fetch = [&](int t) {
    const int ty = t / tiles_x;
    fetch16<NT, Q, IN_H * Q>(buf, hp, h, w, ty * TY - 2, (t - ty * tiles_x) * TX - CE, tid);
  };
  auto put = [&]() {
    unrolled<0, CHUNKS>([&](auto u) {
      constexpr int U = decltype(u)::value;
      const int i = U * NT + tid;
      if (U < CHUNKS - 1 || i < IN_H * Q) {
        const int r = i / Q;
        put16(&tile[r][CE * (i - r * Q)], buf[U]);
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
      // rows or pointer not 16-byte aligned: the columns the outputs read,
      // one element at a time, mirrored by index
      stage_elements<NT, IN_H * (TX + 4), TX + 4>(
          hp, h, w, oy0 - 2, ox0 - 2, tid, [&](int r, int c, float v) { tile[r][c + CE - 2] = v; });
      __syncthreads();
    }

    const int ox = ox0 + 4 * bq;
    const bool vec_out = vec_out_rows && ox + 4 <= w;
    const float* col = &tile[y0][CE + 4 * bq];  // the thread's columns in its first row
    float isum[RY][4];
#pragma unroll
    for (int j = 0; j < RY; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) isum[j][i] = i_start;
    }
    // tile row y0 + J (image row oy0 + y0 + J - 2) is tap J - T of output
    // row T's i sum, and the centre of output row J - 2's r sums
    unrolled<0, RY + 4>([&](auto jj) {
      constexpr int J = decltype(jj)::value;
      const float4 m = *reinterpret_cast<const float4*>(col + J * LOAD_W);
      const float mv[4] = {m.x, m.y, m.z, m.w};
      unrolled<0, 5>([&](auto bb) {
        constexpr int B = decltype(bb)::value;
        if constexpr (J - B >= 0 && J - B < RY) {
#pragma unroll
          for (int i = 0; i < 4; ++i) band_tap<PAT, false, B>(isum[J - B][i], mv[i], ti);
        }
      });
      if constexpr (J >= 2 && J < RY + 2) {
        const float4 lo = *reinterpret_cast<const float4*>(col + J * LOAD_W - 4);
        const float4 hi = *reinterpret_cast<const float4*>(col + J * LOAD_W + 4);
        float v[8] = {lo.z, lo.w, m.x, m.y, m.z, m.w, hi.x, hi.y};
        if constexpr (ROUND_R) {
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = round_bf16(v[q]);
        }
        float rv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rv[i] = r_start;
          unrolled<0, 5>([&](auto bb) {
            constexpr int B = decltype(bb)::value;
            band_tap<PAT, FMA, B>(rv[i], v[i + B], tr);
          });
        }
        store_row(r_out, oy0 + y0 + J - 2, ox, h, w, vec_out, rv);
      }
      if constexpr (J >= 4) {  // output row J - 4 has all its i taps
        float iv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a bf16 store rounds the sum itself
          iv[i] = ROUND && sizeof(TOut) == 4 ? round_bf16(isum[J - 4][i]) : isum[J - 4][i];
        }
        store_row(i_out, oy0 + y0 + J - 4, ox, h, w, vec_out, iv);
      }
    });
  }
}

// The small-image index of the injected array's even site 2s on an axis of
// n (ns = (n+1)/2 even sites): reflect-101 keeps the parity of a coordinate,
// so 2s < 0 mirrors to -2s and 2s >= n to 2n-2-2s; clamped where no valid
// output reads.
__device__ __forceinline__ int mirror_even(int s, int n, int ns) {
  s = s < 0 ? -s : s;
  s = s >= ns ? n - 1 - s : s;
  return min(max(s, 0), ns - 1);
}

// Collapse upsample: out = Z (*) k9 with Z the zero-injected small image at
// the output size (h, w): Z[p][q] = small[p/2][q/2] at even (p, q), else 0,
// reflect-101 on Z's own size. Reflect-101 keeps the parity of a coordinate,
// so output (y, x) meets nonzero Z only at taps with (y+a) and (x+b) even,
// and the tile holds just the even sites: S[i][j] = Z[oy0-4+2i][ox0-4+2j],
// small at mirror_even of (oy0/2-2+i, ox0/2-2+j). A block of WX x BY threads
// walks output tiles 4WX x BY*RY as stencil9_kernel does; with 16-byte small
// rows it stages 4-column chunks of small from column ox0/2-4 (one 16-byte
// load inside the used part of small, four mirrored loads outside it) into S
// as two 8-byte halves, and prefetches the next tile's chunks into registers.
// A thread computes 4 adjacent outputs along W (both column parities) by RY
// rows from 8-byte reads of S, each read feeding every output that uses it;
// only the taps that meet even sites are summed, rows in order, taps left to
// right, each row sum from its first product (the zero pattern at compile
// time for a dense bank; any other bank tests each tap as it runs, its sums
// starting from -0, which adds nothing). The plain version also adds the
// products at zero sites, 0 * k: exact zeros, which change only the sign of
// a zero total. negz (from the host, bit 2*(y&1) + (x&1)) says for each
// output parity class whether all of them are -0 (and every tap row used);
// where not, the kernel adds +0 to its total, so the sign of a zero matches
// the plain version too. ROUND: bf16 operands (S holds the rounded pixels;
// products and sums stay unfused, so no product's rounding can differ).
template <int WX, int RY, int PAT, bool ROUND>
__global__ void __launch_bounds__(WX * BY)
inject9_kernel(const float* __restrict__ small, float* __restrict__ out, int sw, int h,
               int w, int tiles_x, int tiles, int flags, int negz,
               const __grid_constant__ Taps81 taps) {
  constexpr int NT = WX * BY;
  constexpr int TX = 4 * WX;
  constexpr int TY = BY * RY;
  constexpr int S_H = TY / 2 + 4;  // even-site rows from Z row oy0 - 4
  constexpr int S_W = TX / 2 + 4;  // even-site columns from Z column ox0 - 4
  constexpr int Q = TX / 8 + 2;    // 4-column chunks of small a row, from column ox0/2 - 4
  constexpr int CHUNKS = (S_H * Q + NT - 1) / NT;
  static_assert(RY % 2 == 0 && TX % 64 == 0, "even origins; chunks from a multiple of 4");
  __shared__ __align__(16) float tile[S_H][S_W];

  const int tid = threadIdx.y * WX + threadIdx.x;
  const bool vec_in = flags & FLAG_VEC_IN;
  const int hs = (h + 1) / 2;  // even sites of Z down H (the small rows it uses)
  const int ws = (w + 1) / 2;
  const int m = threadIdx.x;              // the thread's outputs 4m .. 4m+3 of a tile row
  const int n0 = threadIdx.y * (RY / 2);  // S row of its first output row's first tap row

  float4 buf[CHUNKS];
  auto fetch = [&](int t) {
    const int ty = t / tiles_x;
    const int sy0 = ty * (TY / 2) - 2;
    const int sx0 = (t - ty * tiles_x) * (TX / 2) - 4;  // a multiple of 4
    unrolled<0, CHUNKS>([&](auto u) {
      constexpr int U = decltype(u)::value;
      const int i = U * NT + tid;
      if (U < CHUNKS - 1 || i < S_H * Q) {
        const int r = i / Q;
        const int c = sx0 + 4 * (i - r * Q);
        const float* row = small + (size_t)mirror_even(sy0 + r, h, hs) * sw;
        if (c >= 0 && c + 3 < ws) {
          buf[U] = *reinterpret_cast<const float4*>(row + c);
        } else {
          buf[U] = make_float4(row[mirror_even(c, w, ws)], row[mirror_even(c + 1, w, ws)],
                               row[mirror_even(c + 2, w, ws)], row[mirror_even(c + 3, w, ws)]);
        }
      }
    });
  };
  auto put = [&]() {
    unrolled<0, CHUNKS>([&](auto u) {
      constexpr int U = decltype(u)::value;
      const int i = U * NT + tid;
      if (U < CHUNKS - 1 || i < S_H * Q) {
        const int r = i / Q;
        const int q = i - r * Q;
        float4 v = buf[U];
        if (ROUND) {
          v.x = round_bf16(v.x);
          v.y = round_bf16(v.y);
          v.z = round_bf16(v.z);
          v.w = round_bf16(v.w);
        }
        // the chunk starts at S column 4q - 2
        if (q > 0) *reinterpret_cast<float2*>(&tile[r][4 * q - 2]) = make_float2(v.x, v.y);
        if (q < Q - 1) *reinterpret_cast<float2*>(&tile[r][4 * q]) = make_float2(v.z, v.w);
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
      // small's rows not 16-byte aligned: one element at a time, mirrored by index
      const int sy0 = oy0 / 2 - 2;
      const int sx0 = ox0 / 2 - 2;
      constexpr int N = S_H * S_W;
      constexpr int ITERS = (N + NT - 1) / NT;
#pragma unroll 1
      for (int base = 0; base < ITERS; base += STAGE_BATCH) {
        float e[STAGE_BATCH];
        unrolled<0, STAGE_BATCH>([&](auto u) {
          const int i = (base + decltype(u)::value) * NT + tid;
          if (i < N) {
            const int r = i / S_W;
            e[decltype(u)::value] = small[(size_t)mirror_even(sy0 + r, h, hs) * sw +
                                          mirror_even(sx0 + i - r * S_W, w, ws)];
          }
        });
        unrolled<0, STAGE_BATCH>([&](auto u) {
          const int i = (base + decltype(u)::value) * NT + tid;
          if (i < N) {
            const int r = i / S_W;
            const float v = e[decltype(u)::value];
            tile[r][i - r * S_W] = ROUND ? round_bf16(v) : v;
          }
        });
      }
      __syncthreads();
    }

    // S row n0 + K meets output row E (0 .. RY-1) of the thread at tap row
    // 2K - E, and output T (0 .. 3) at tap b on S column 2m + (T + b) / 2
    float acc[RY][4] = {};
    unrolled<0, RY / 2 + 4>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const float2* p = reinterpret_cast<const float2*>(&tile[n0 + K][2 * m]);
      const float2 p0 = p[0], p1 = p[1], p2 = p[2];
      const float u6[6] = {p0.x, p0.y, p1.x, p1.y, p2.x, p2.y};
      unrolled<0, RY>([&](auto ee) {
        constexpr int E = decltype(ee)::value;
        constexpr int A = 2 * K - E;
        if constexpr (A >= 0 && A <= 8) {
          unrolled<0, 4>([&](auto tt) {
            constexpr int T = decltype(tt)::value;
            float row = -0.f;
            unrolled<0, 5>([&](auto bb) {
              constexpr int B = (T & 1) + 2 * decltype(bb)::value;
              if constexpr (B <= 8) {
                const float k = taps.k[A * 9 + B];
                if constexpr (PAT == TAPS_DENSE) {
                  const float prod = __fmul_rn(u6[(T + B) / 2], k);
                  row = B == (T & 1) ? prod : __fadd_rn(row, prod);
                } else if (k != 0.f) {
                  row = __fadd_rn(row, __fmul_rn(u6[(T + B) / 2], k));
                }
              }
            });
            acc[E][T] = A == (E & 1) ? row : __fadd_rn(acc[E][T], row);
          });
        }
      });
    });

    const int ox = ox0 + 4 * m;
    const bool vec_out = (flags & FLAG_VEC_OUT) && ox + 4 <= w;
    unrolled<0, RY>([&](auto ee) {
      constexpr int E = decltype(ee)::value;
      const int oy = oy0 + 2 * n0 + E;
      float v[4];
#pragma unroll
      for (int T = 0; T < 4; ++T) {
        const bool neg = (negz >> (2 * (E & 1) + (T & 1))) & 1;
        v[T] = neg ? acc[E][T] : __fadd_rn(acc[E][T], 0.f);
      }
      if (oy < h) {
        const size_t o = (size_t)oy * w + ox;
        if (vec_out) {
          store4(out + o, v);
        } else {
#pragma unroll
          for (int T = 0; T < 4; ++T) {
            if (ox + T < w) out[o + T] = v[T];
          }
        }
      }
    });
  }
}

// One band level of the pyramid in one pass (the fused build): hp = x (*)
// HP9, its band pair, and (x (*) 2LP9) at the kept even sites. A block of NT
// threads walks output tiles TX x TY as stencil9_kernel does, staging TY+12
// octave rows from oy0-6 and TX+16 columns from ox0-8 in 16-byte chunks
// (reflect-101 by index, only for chunks outside the image) and prefetching
// the next tile's chunks into registers; other widths stage one element at
// a time. Then, for each tile:
//   1. hp on the tile plus its apron, positions [oy0-2, oy0+TY+2) x
//      [ox0-4, ox0+TX+4), into shared memory, by items of 4 columns x R rows
//      that add_row sums from 16-byte reads of the staged rows (HP9's corners
//      skipped at compile time). An apron position outside the image is then
//      copied from its mirrored position (reflect-101 of hp's own index, as
//      band5 reads hp), so the apron holds exactly what conv9 would write.
//   2. A thread's 4 x RB outputs: hp, r along W and i along H from 16-byte
//      reads of the hp tile (the band taps' zero centre skipped at compile
//      time), stored 16 (f32) or 8 (bf16) bytes at a time where rows allow;
//      and a pair of kept sites of the decimated octave from the staged rows
//      (add_row with S = 2 on registers split by column parity).
// Each sum runs in conv9's, band5's and lp9_decimate's order, every product
// and sum rounded alone, starting from its first product (the totals of hp
// and the octave from their first row), as the plain versions do: the
// outputs equal them, and K1+K2+K3's, bit for bit, the sign of a zero
// included.
// The host checks that the three banks have the zero patterns compiled in.
template <int TX, int TY, int NT, int R, int MIN_BLOCKS, typename TOut>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
build_level_kernel(const float* __restrict__ x, TOut* __restrict__ hp_out,
                   TOut* __restrict__ r_out, TOut* __restrict__ i_out,
                   float* __restrict__ sub_out, int h, int w, int tiles_x, int tiles,
                   int flags, const __grid_constant__ Taps81 hp9,
                   const __grid_constant__ Taps5 t5, const __grid_constant__ Taps81 lp9) {
  constexpr int IN_H = TY + 12;    // octave rows from oy0 - 6
  constexpr int LOAD_W = TX + 16;  // octave columns from ox0 - 8
  constexpr int Q = LOAD_W / 4;    // 4-column chunks of a staged row
  constexpr int CHUNKS = (IN_H * Q + NT - 1) / NT;
  constexpr int HP_H = TY + 4;     // hp rows from oy0 - 2
  constexpr int HP_W = TX + 8;     // hp columns from ox0 - 4
  constexpr int HP_Q = HP_W / 4;
  constexpr int HP_ITEMS = HP_Q * (HP_H / R);
  constexpr int BQ = TX / 4;              // 4-column groups of a tile row
  constexpr int RB = TY * BQ / NT;        // tile rows of a thread's outputs
  constexpr int DEC_ITEMS = TY / 2 * BQ;  // pairs of kept sites (TX / 2 a kept row)
  static_assert(TX % 32 == 0 && TY % 2 == 0 && HP_H % R == 0 && RB * NT == TY * BQ,
                "tile shape");
  __shared__ __align__(16) float tile[IN_H][LOAD_W];
  __shared__ __align__(16) float hpx[HP_H][HP_W];

  const int tid = threadIdx.x;
  const bool vec_in = flags & FLAG_VEC_IN;
  const bool vec_out_rows = flags & FLAG_VEC_OUT;
  const int sub_w = (w + 1) / 2;

  float4 buf[CHUNKS];  // 16-byte rows: the chunks of the next tile
  auto fetch = [&](int t) {
    const int ty = t / tiles_x;
    fetch16<NT, Q, IN_H * Q>(buf, x, h, w, ty * TY - 6, (t - ty * tiles_x) * TX - 8, tid);
  };
  auto put = [&]() {
    unrolled<0, CHUNKS>([&](auto u) {
      constexpr int U = decltype(u)::value;
      const int i = U * NT + tid;
      if (U < CHUNKS - 1 || i < IN_H * Q) {
        const int r = i / Q;
        *reinterpret_cast<float4*>(&tile[r][4 * (i - r * Q)]) = buf[U];
      }
    });
  };
  auto band = [&](float p0, float p1, float p3, float p4) {
    float s = __fmul_rn(p0, t5.k[0]);
    s = __fadd_rn(s, __fmul_rn(p1, t5.k[1]));
    s = __fadd_rn(s, __fmul_rn(p3, t5.k[3]));
    return __fadd_rn(s, __fmul_rn(p4, t5.k[4]));
  };

  const int first_tile = blockIdx.x;
  const int stride = gridDim.x;
  if (vec_in && first_tile < tiles) fetch(first_tile);
  for (int t = first_tile; t < tiles; t += stride) {
    const int oy0 = t / tiles_x * TY;
    const int ox0 = (t - t / tiles_x * tiles_x) * TX;
    __syncthreads();  // every thread is done with the previous tile
    if (vec_in) {
      put();
      __syncthreads();
      if (t + stride < tiles) fetch(t + stride);  // in flight during the sums below
    } else {
      // rows not aligned (w % 4 != 0): one element at a time, mirrored by index
      stage_elements<NT, IN_H * LOAD_W, LOAD_W>(x, h, w, oy0 - 6, ox0 - 8, tid,
                                                [&](int r, int c, float v) { tile[r][c] = v; });
      __syncthreads();
    }

    // 1. hp at hp-tile (g*R + j, 4k + i): its window starts at staged row
    // g*R + j, column 4k + i
#pragma unroll 1
    for (int it = tid; it < HP_ITEMS; it += NT) {
      const int g = it / HP_Q;
      const int k = it - g * HP_Q;
      float acc[R][4] = {};
      const float* row0 = &tile[g * R][4 * k];
      unrolled<0, R + 8>([&](auto rr) {
        constexpr int RR = decltype(rr)::value;
        float v[1][12];
        read_row<1, 12, 0>(row0 + RR * LOAD_W, v);
        add_row<1, TAPS_NO_CORNERS>(RR, v, hp9, acc);
      });
#pragma unroll
      for (int j = 0; j < R; ++j) {
        *reinterpret_cast<float4*>(&hpx[g * R + j][4 * k]) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();
    if (oy0 == 0 || ox0 == 0 || oy0 + TY + 2 > h || ox0 + TX + 4 > w) {
      // the apron positions -2, -1, n, n+1 of each axis that the band pair
      // reads (rows for columns inside the image, columns for rows inside
      // it) take hp at their mirrored position, which lies inside the image
      // and inside the hp tile; no entry written here is read here
      for (int e = tid; e < 4 * (HP_W + HP_H); e += NT) {
        if (e < 4 * HP_W) {
          const int s = e / HP_W;
          const int c = e - s * HP_W;
          const int p = s < 2 ? s - 2 : h + s - 2;
          const int a = p - oy0 + 2;
          const int q = ox0 - 4 + c;
          if (a >= 0 && a < HP_H && q >= 0 && q < w) {
            hpx[a][c] = hpx[reflect101(p, h) - oy0 + 2][c];
          }
        } else {
          const int s = (e - 4 * HP_W) / HP_H;
          const int a = e - 4 * HP_W - s * HP_H;
          const int p = s < 2 ? s - 2 : w + s - 2;
          const int c = p - ox0 + 4;
          const int y = oy0 - 2 + a;
          if (c >= 0 && c < HP_W && y >= 0 && y < h) {
            hpx[a][c] = hpx[a][reflect101(p, w) - ox0 + 4];
          }
        }
      }
      __syncthreads();
    }

    // 2. the thread's outputs: tile rows y0 .. y0+RB-1, columns 4bq .. 4bq+3,
    // at hp-tile rows + 2, columns + 4
    const int bq = tid % BQ;
    const int y0 = tid / BQ * RB;
    const int ox = ox0 + 4 * bq;
    const bool vec_out = vec_out_rows && ox + 4 <= w;
    float col[RB + 4][4];  // hp-tile rows y0 .. y0+RB+3 at the thread's columns
    unrolled<0, RB + 4>([&](auto jj) {
      constexpr int J = decltype(jj)::value;
      const float4 c = *reinterpret_cast<const float4*>(&hpx[y0 + J][4 * bq + 4]);
      col[J][0] = c.x;
      col[J][1] = c.y;
      col[J][2] = c.z;
      col[J][3] = c.w;
    });
    unrolled<0, RB>([&](auto jj) {
      constexpr int J = decltype(jj)::value;
      const float4 lo = *reinterpret_cast<const float4*>(&hpx[y0 + J + 2][4 * bq]);
      const float4 hi = *reinterpret_cast<const float4*>(&hpx[y0 + J + 2][4 * bq + 8]);
      const float v[12] = {lo.x, lo.y, lo.z, lo.w, col[J + 2][0], col[J + 2][1],
                           col[J + 2][2], col[J + 2][3], hi.x, hi.y, hi.z, hi.w};
      float hv[4], rv[4], iv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hv[i] = v[i + 4];
        rv[i] = band(v[i + 2], v[i + 3], v[i + 5], v[i + 6]);
        iv[i] = band(col[J][i], col[J + 1][i], col[J + 3][i], col[J + 4][i]);
      }
      const int oy = oy0 + y0 + J;
      if (oy < h) {
        const size_t o = (size_t)oy * w + ox;
        if (vec_out) {
          store4(hp_out + o, hv);
          store4(r_out + o, rv);
          store4(i_out + o, iv);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (ox + i < w) {
              store(hp_out, o + i, hv[i]);
              store(r_out, o + i, rv[i]);
              store(i_out, o + i, iv[i]);
            }
          }
        }
      }
    });

    // kept sites (2dr, 4dc) and (2dr, 4dc + 2) of the tile: their windows
    // start at staged row 2dr + 2, columns 4dc + 4 and 4dc + 6
#pragma unroll 1
    for (int d = tid; d < DEC_ITEMS; d += NT) {
      const int dr = d / BQ;
      const int dc = d - dr * BQ;
      float acc[1][2] = {};
      const float* row0 = &tile[2 * dr + 2][4 * dc + 4];
      unrolled<0, 9>([&](auto aa) {
        constexpr int A = decltype(aa)::value;
        float v[1][12];
        read_row<1, 12, 0>(row0 + A * LOAD_W, v);
        float planes[2][6];
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          planes[0][q] = v[0][2 * q];
          planes[1][q] = v[0][2 * q + 1];
        }
        add_row<2, TAPS_DENSE>(A, planes, lp9, acc);
      });
      const int sy = oy0 / 2 + dr;
      const int sx = ox0 / 2 + 2 * dc;
      if (2 * sy < h) {
        const size_t o = (size_t)sy * sub_w + sx;
        if (2 * sx < w) sub_out[o] = acc[0][0];
        if (2 * sx + 2 < w) sub_out[o + 1] = acc[0][1];
      }
    }
  }
}

// ---------------------------------------------------------------- blur13

struct Taps13 {
  float k[13];
};

// Reflect-101 for any p: periodic with period 2(n-1), as the plain version's
// index rule (ops/conv.py::reflect_index), so sides under the blur's 6-px
// reach agree with it.
__device__ __forceinline__ int reflect101_any(int p, int n) {
  if (p >= 0 && p < n) return p;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  p %= period;
  p = p < 0 ? p + period : p;
  return p >= n ? period - p : p;
}

// Block tile of blur13_kernel: TH x BLUR_TW outputs (TH is BLUR_TALL_TH or
// BLUR_SMALL_TH, picked on the host), BLUR_NT threads, BLUR_MIN_BLOCKS
// resident an SM (a register cap: the kernel waits on its loads, and more
// blocks hide them). The staged tile holds TH + 12 rows (the 6-row halo
// above and below) of BLUR_SC columns from x0 - BLUR_LEAD, a 16-byte aligned
// start (columns BLUR_SKIP .. BLUR_SKIP + BLUR_TW + 11 are read), rows
// BLUR_SW floats apart: 84 = 80 + 4 puts the two rows a quarter-warp reads
// in the W-axis pass on disjoint banks.
constexpr int BLUR_HALO = 6;
constexpr int BLUR_TALL_TH = 64;
constexpr int BLUR_SMALL_TH = 32;
constexpr int BLUR_TW = 64;
constexpr int BLUR_NT = 256;
constexpr int BLUR_MIN_BLOCKS = 4;
constexpr int BLUR_RX = 8;                   // W-axis outputs of a lane (8 lanes a row)
constexpr int BLUR_QX = BLUR_TW / 4;         // column quads of a tile row
constexpr int BLUR_RG = BLUR_NT / BLUR_QX;   // row groups of the H-axis pass
constexpr int BLUR_LEAD = 8;
constexpr int BLUR_SKIP = BLUR_LEAD - BLUR_HALO;
constexpr int BLUR_SC = BLUR_TW + 2 * BLUR_LEAD;
constexpr int BLUR_SW = BLUR_SC + 4;
static_assert(BLUR_TW == 8 * BLUR_RX && BLUR_NT % 32 == 0 && BLUR_NT % BLUR_QX == 0,
              "8 lanes a row; whole warps; row groups of whole column quads");
static_assert(BLUR_SW % 4 == 0, "16-byte rows");

// The rows of a tile TH outputs tall: staged (SH), and summed down a column
// quad by one thread in the H-axis pass (RY).
template <int TH>
struct BlurRows {
  static constexpr int SH = TH + 2 * BLUR_HALO;
  static constexpr int RY = TH / BLUR_RG;
  static_assert(TH % BLUR_RG == 0 && SH % 4 == 0, "whole row groups; whole warp steps");
};

// Launch flags of blur13_kernel.
constexpr int BLUR_VEC_IN = 1;   // input rows 16-byte aligned: staged in 16-byte chunks
constexpr int BLUR_VEC_OUT = 2;  // output rows aligned for 4-wide stores

// Stages the SH rows of the tile at (y0, x0) of plane x, reflect-101 by
// index. VEC: 16-byte chunks, one load each inside the image, mirrored
// element by element outside it (the left and right borders only), rows
// mirrored by index once a chunk; a thread issues the loads of all its
// chunks (six at most) before it stores any. Otherwise one element at a time.
template <int SH>
__device__ __forceinline__ void blur_stage(float* s, const float* __restrict__ x, int y0, int x0,
                                           int h, int w, bool vec) {
  if (vec) {
    constexpr int Q = BLUR_SC / 4;  // chunks of a staged row
    constexpr int N = SH * Q;
    constexpr int CHUNKS = (N + BLUR_NT - 1) / BLUR_NT;
    float4 v[CHUNKS];
    unrolled<0, CHUNKS>([&](auto uu) {
      constexpr int U = decltype(uu)::value;
      const int i = threadIdx.x + U * BLUR_NT;
      if ((U + 1) * BLUR_NT <= N || i < N) {
        const int r = i / Q;
        const int gx = x0 - BLUR_LEAD + (i - r * Q) * 4;
        const float* row = x + (size_t)reflect101_any(y0 - BLUR_HALO + r, h) * w;
        if (gx >= 0 && gx + 4 <= w) {
          v[U] = *reinterpret_cast<const float4*>(row + gx);
        } else {
          v[U] = make_float4(row[reflect101_any(gx, w)], row[reflect101_any(gx + 1, w)],
                             row[reflect101_any(gx + 2, w)], row[reflect101_any(gx + 3, w)]);
        }
      }
    });
    unrolled<0, CHUNKS>([&](auto uu) {
      constexpr int U = decltype(uu)::value;
      const int i = threadIdx.x + U * BLUR_NT;
      if ((U + 1) * BLUR_NT <= N || i < N) {
        const int r = i / Q;
        *reinterpret_cast<float4*>(s + r * BLUR_SW + (i - r * Q) * 4) = v[U];
      }
    });
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < SH * BLUR_SC; i += BLUR_NT) {
      const int r = i / BLUR_SC;
      const int k = i - r * BLUR_SC;
      s[r * BLUR_SW + k] = x[(size_t)reflect101_any(y0 - BLUR_HALO + r, h) * w +
                             reflect101_any(x0 - BLUR_LEAD + k, w)];
    }
  }
}

// W-axis pass: the 13-tap sums of every staged row, written back in place
// (columns 0 .. BLUR_TW-1). A lane sums BLUR_RX outputs of a row from six
// 16-byte reads; a warp takes four rows, a quarter-warp two rows of four
// lanes, so its reads fall on disjoint banks. A warp owns its rows, so the
// reads of a row end before its writes at a warp barrier.
template <int SH>
__device__ __forceinline__ void blur_rows_in_place(float* s, const Taps13& g) {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;
  const int row = 2 * (q >> 1) + ((lane >> 2) & 1);
  const int col = BLUR_RX * ((lane & 3) + 4 * (q & 1));
#pragma unroll 1
  for (int r0 = (threadIdx.x >> 5) * 4; r0 < SH; r0 += (BLUR_NT / 32) * 4) {
    float* at = s + (r0 + row) * BLUR_SW + col;
    float v[BLUR_RX + 16];
#pragma unroll
    for (int c = 0; c < BLUR_RX + 16; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(at + c);
      v[c] = t.x;
      v[c + 1] = t.y;
      v[c + 2] = t.z;
      v[c + 3] = t.w;
    }
    float o[BLUR_RX];
#pragma unroll
    for (int i = 0; i < BLUR_RX; ++i) {
      float acc = __fmul_rn(v[i + BLUR_SKIP], g.k[0]);
#pragma unroll
      for (int t = 1; t < 13; ++t) acc = madd(acc, v[i + BLUR_SKIP + t], g.k[t]);
      o[i] = acc;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < BLUR_RX; i += 4) {
      *reinterpret_cast<float4*>(at + i) = make_float4(o[i], o[i + 1], o[i + 2], o[i + 3]);
    }
  }
}

// GaussianBlur(13x13) with reflect-101 borders of each h x w plane, as
// ops/conv.py::sep_correlate2d computes it: the W-axis pass first, its sums
// rounded to f32, then the H-axis pass, each output of a pass starting from
// the product of tap 0 and adding taps 1..12 in order, every product and sum
// rounded alone. One TH x BLUR_TW tile of one plane a block: staged with its
// halo, the W-axis pass in place, then a thread sums a column quad for RY
// rows down the staged row sums (RY + 12 16-byte reads) and writes them
// out. Planes from blockIdx.z in steps of gridDim.z.
template <int TH>
__global__ void __launch_bounds__(BLUR_NT, BLUR_MIN_BLOCKS)
blur13_kernel(const float* __restrict__ x, float* __restrict__ out, int planes, int h, int w,
              int flags, const __grid_constant__ Taps13 g) {
  using R = BlurRows<TH>;
  __shared__ __align__(16) float s[R::SH * BLUR_SW];
  const int x0 = blockIdx.x * BLUR_TW;
  const int y0 = blockIdx.y * TH;
  const int cq = threadIdx.x % BLUR_QX;
  const int rg = threadIdx.x / BLUR_QX;
  const int ox = x0 + 4 * cq;
  const int oy = y0 + rg * R::RY;
  const bool vec_out = (flags & BLUR_VEC_OUT) && ox + 4 <= w;
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    const size_t plane = (size_t)p * h * w;
    blur_stage<R::SH>(s, x + plane, y0, x0, h, w, flags & BLUR_VEC_IN);
    __syncthreads();
    blur_rows_in_place<R::SH>(s, g);
    __syncthreads();
    float b[R::RY][4];
    const float* col = s + rg * R::RY * BLUR_SW + 4 * cq;
    unrolled<0, R::RY + 12>([&](auto tt) {
      constexpr int T = decltype(tt)::value;
      const float4 t4 = *reinterpret_cast<const float4*>(col + T * BLUR_SW);
      const float v[4] = {t4.x, t4.y, t4.z, t4.w};
      unrolled<0, R::RY>([&](auto jj) {
        constexpr int J = decltype(jj)::value;
        constexpr int A = T - J;  // staged row T feeds output row J as tap T - J
        if constexpr (A >= 0 && A <= 12) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (A == 0) {
              b[J][i] = __fmul_rn(v[i], g.k[0]);
            } else {
              b[J][i] = madd(b[J][i], v[i], g.k[A]);
            }
          }
        }
      });
    });
#pragma unroll
    for (int j = 0; j < R::RY; ++j) {
      if (oy + j >= h) break;
      float* o = out + plane + (size_t)(oy + j) * w + ox;
      if (vec_out) {
        *reinterpret_cast<float4*>(o) = make_float4(b[j][0], b[j][1], b[j][2], b[j][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (ox + i < w) o[i] = b[j][i];
        }
      }
    }
    __syncthreads();  // the next plane's staging overwrites the tile
  }
}

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
// The fused build and the inject take their small tiles by the same rule.
constexpr int TALL_GRID_MIN = 2 * 132;

// Output tiles (along W x along H) of the fused build, the inject and band5.
constexpr int BUILD_TALL_TX = 64;
constexpr int BUILD_TALL_TY = 32;
constexpr int BUILD_SMALL_TX = 32;
constexpr int BUILD_SMALL_TY = 16;
constexpr int INJECT_TALL_TX = 128;
constexpr int INJECT_TALL_TY = 32;
constexpr int INJECT_SMALL_TX = 64;
constexpr int INJECT_SMALL_TY = 16;
constexpr int BAND_TALL_TX = 128;
constexpr int BAND_TALL_TY = 32;
constexpr int BAND_SMALL_TX = 64;
constexpr int BAND_SMALL_TY = 8;
constexpr int BAND_TALL_F32_TX = 128;  // band5 with f32 in and out (12 bytes a pixel)
constexpr int BAND_TALL_F32_TY = 64;
constexpr int BAND_TALL_NT = 256;   // threads of a block: 4 x 4 outputs each (f32: 4 x 8)
constexpr int BAND_SMALL_NT = 128;  // 4 x 1 outputs each

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

template <int TX, int TY, int NT, int PAT, typename TIn, typename TOut, bool ROUND>
void band5_go(const void* hp, void* r, void* i, int h, int w, int flags, const Taps5& tr,
              const Taps5& ti, cudaStream_t s) {
  static const int resident =
      resident_blocks(band5_kernel<TX, TY, NT, PAT, TIn, TOut, ROUND>, NT);
  const int tiles_x = ceil_div(w, TX);
  const int tiles = tiles_x * ceil_div(h, TY);
  band5_kernel<TX, TY, NT, PAT, TIn, TOut, ROUND><<<tiles < resident ? tiles : resident, NT, 0,
                                                    s>>>(
      static_cast<const TIn*>(hp), static_cast<TOut*>(r), static_cast<TOut*>(i), h, w, tiles_x,
      tiles, flags, tr, ti);
}

// True when every tap is a bf16 value of magnitude 2^-7 to 1, or zero: then
// its product with any bf16 value is exact and finite in f32 (the premise of
// band5's fused bf16 arm; tail.cu's exact_bf16_taps, for 5 taps).
bool exact_bf16_taps5(const Taps5& t) {
  for (float k : t.k) {
    unsigned u;
    std::memcpy(&u, &k, sizeof u);
    const float a = k < 0.f ? -k : k;
    if ((u & 0xffffu) != 0 || (a != 0.f && (a < 0.0078125f || a > 1.f))) return false;
  }
  return true;
}

// The zero pattern band5_kernel compiles in (RIESZ_BAND_KERNEL's: all but
// the centre) in both banks, and under bf16 operands r's taps exact.
bool band5_main_taps(const Taps5& tr, const Taps5& ti, bool round) {
  for (int b = 0; b < 5; ++b) {
    if ((tr.k[b] == 0.f) != (b == 2) || (ti.k[b] == 0.f) != (b == 2)) return false;
  }
  return !round || exact_bf16_taps5(tr);
}

// The main bank: tall tiles where they give at least TALL_GRID_MIN tiles
// (with f32 in and out 128x64, where they do, else 128x32), small ones
// below; any other bank: the small tiles, taps tested at run time, never
// fused. By graph replay on an H100 (tools/kernel_ab.py against copies
// with other tiles; PERF.md) the f32 pair, the most bytes a pixel, ran
// faster on the taller tile and the other arms slower, and on small levels
// every arm ran faster on 64x8 tiles than on 64x16.
template <typename TIn, typename TOut, bool ROUND>
void band5_launch(const void* hp, void* r, void* i, int h, int w, const void* r_taps,
                  const void* i_taps, cudaStream_t s) {
  const Taps5 tr = taps5(r_taps), ti = taps5(i_taps);
  int flags = 0;
  if (w % (16 / sizeof(TIn)) == 0 && aligned(hp, 16)) flags |= FLAG_VEC_IN;
  constexpr size_t OUT4 = 4 * sizeof(TOut);
  if (w % 4 == 0 && aligned(r, OUT4) && aligned(i, OUT4)) flags |= FLAG_VEC_OUT;
  constexpr int TT = BAND_TALL_TX, TH = BAND_TALL_TY, TN = BAND_TALL_NT;
  constexpr int ST = BAND_SMALL_TX, SH = BAND_SMALL_TY, SN = BAND_SMALL_NT;
  constexpr int FT = BAND_TALL_F32_TX, FH = BAND_TALL_F32_TY;
  if (!band5_main_taps(tr, ti, ROUND)) {
    band5_go<ST, SH, SN, TAPS_ANY, TIn, TOut, ROUND>(hp, r, i, h, w, flags, tr, ti, s);
    return;
  }
  if constexpr (sizeof(TIn) == 4 && sizeof(TOut) == 4) {
    if (ceil_div(w, FT) * ceil_div(h, FH) >= TALL_GRID_MIN) {
      band5_go<FT, FH, TN, TAPS_ZERO_CENTRE, TIn, TOut, ROUND>(hp, r, i, h, w, flags, tr, ti, s);
      return;
    }
  }
  if (ceil_div(w, TT) * ceil_div(h, TH) >= TALL_GRID_MIN) {
    band5_go<TT, TH, TN, TAPS_ZERO_CENTRE, TIn, TOut, ROUND>(hp, r, i, h, w, flags, tr, ti, s);
  } else {
    band5_go<ST, SH, SN, TAPS_ZERO_CENTRE, TIn, TOut, ROUND>(hp, r, i, h, w, flags, tr, ti, s);
  }
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

template <int WX, int RY, int PAT, bool ROUND>
void inject_go(const void* small, void* out, int sw, int h, int w, int flags, int negz,
               const Taps81& taps, cudaStream_t s) {
  static const int resident = resident_blocks(inject9_kernel<WX, RY, PAT, ROUND>, WX * BY);
  const int tiles_x = ceil_div(w, 4 * WX);
  const int tiles = tiles_x * ceil_div(h, BY * RY);
  inject9_kernel<WX, RY, PAT, ROUND><<<tiles < resident ? tiles : resident, dim3(WX, BY), 0, s>>>(
      static_cast<const float*>(small), static_cast<float*>(out), sw, h, w, tiles_x, tiles,
      flags, negz, taps);
}

// negz of inject9_kernel: bit 2*py + px is set when every product the plain
// version adds at a zero site of an output of row parity py and column
// parity px is -0 (its tap negative) and every tap row has a used tap, i.e.
// when those products leave a -0 total as it is.
int inject_negz(const Taps81& t) {
  int negz = 0;
  for (int py = 0; py < 2; ++py) {
    for (int px = 0; px < 2; ++px) {
      bool neg = true;
      for (int a = 0; a < 9; ++a) {
        bool used = false;
        for (int b = 0; b < 9; ++b) {
          const float k = t.k[a * 9 + b];
          if (k == 0.f) continue;
          used = true;
          if (((py + a) | (px + b)) & 1) neg = neg && k < 0.f;
        }
        neg = neg && used;
      }
      if (neg) negz |= 1 << (2 * py + px);
    }
  }
  return negz;
}

// main_taps: the taps have no zero (the dense 2*LP9 of the collapse), which
// has its own instantiations, a tall tile and a small one by the output's
// size; any other bank takes TAPS_ANY. Taps must be finite: the kernel skips
// the zero sites, where the plain version's 0 * k would be NaN for k = inf.
template <bool ROUND>
int inject_launch(const void* small, void* out, int sw, int h, int w, const void* taps,
                  bool main_taps, cudaStream_t s) {
  const Taps81 t = taps81(taps);
  for (float k : t.k) {
    if (!std::isfinite(k)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int negz = inject_negz(t);
  int flags = 0;
  if (sw % 4 == 0 && aligned(small, 16)) flags |= FLAG_VEC_IN;
  if (w % 4 == 0 && aligned(out, 16)) flags |= FLAG_VEC_OUT;
  constexpr int TALL_WX = INJECT_TALL_TX / 4, TALL_RY = INJECT_TALL_TY / BY;
  constexpr int SMALL_WX = INJECT_SMALL_TX / 4, SMALL_RY = INJECT_SMALL_TY / BY;
  if (!main_taps) {
    inject_go<SMALL_WX, SMALL_RY, TAPS_ANY, ROUND>(small, out, sw, h, w, flags, negz, t, s);
  } else if (ceil_div(w, INJECT_TALL_TX) * ceil_div(h, INJECT_TALL_TY) >= TALL_GRID_MIN) {
    inject_go<TALL_WX, TALL_RY, TAPS_DENSE, ROUND>(small, out, sw, h, w, flags, negz, t, s);
  } else {
    inject_go<SMALL_WX, SMALL_RY, TAPS_DENSE, ROUND>(small, out, sw, h, w, flags, negz, t, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int TX, int TY, int NT, int R, int MIN_BLOCKS, typename TOut>
void build_go(const void* x, void* hp, void* r, void* i, void* sub, int h, int w, int flags,
              const Taps81& hp9, const Taps5& t5, const Taps81& lp9, cudaStream_t s) {
  static const int resident =
      resident_blocks(build_level_kernel<TX, TY, NT, R, MIN_BLOCKS, TOut>, NT);
  const int tiles_x = ceil_div(w, TX);
  const int tiles = tiles_x * ceil_div(h, TY);
  build_level_kernel<TX, TY, NT, R, MIN_BLOCKS, TOut><<<tiles < resident ? tiles : resident, NT,
                                                         0, s>>>(
      static_cast<const float*>(x), static_cast<TOut*>(hp), static_cast<TOut*>(r),
      static_cast<TOut*>(i), static_cast<float*>(sub), h, w, tiles_x, tiles, flags, hp9, t5,
      lp9);
}

// The zero patterns build_level_kernel compiles in: HP9 all but the four
// corners, the band taps all but the centre, 2*LP9 all 81.
bool build_taps_ok(const Taps81& hp9, const Taps5& t5, const Taps81& lp9) {
  for (int a = 0; a < 9; ++a) {
    for (int b = 0; b < 9; ++b) {
      if ((hp9.k[a * 9 + b] == 0.f) != corner(a, b) || lp9.k[a * 9 + b] == 0.f) return false;
    }
  }
  for (int b = 0; b < 5; ++b) {
    if ((t5.k[b] == 0.f) != (b == 2)) return false;
  }
  return true;
}

// Tall tiles (256 threads, hp items of 3 rows) where they give at least
// TALL_GRID_MIN tiles, small ones (128 threads, items of 2 rows) below. The
// tall instantiation is held to 3 blocks an SM (80 registers, no spill):
// left alone, ptxas takes 100 and fits 2 (4-5% slower at 2160x3840 in the
// bf16 arm); 4 blocks spill. The small one fits in 64 registers.
template <typename TOut>
int build_launch(const void* x, void* hp, void* r, void* i, void* sub, int h, int w,
                 const void* hp9_taps, const void* t5_taps, const void* lp9_taps,
                 cudaStream_t s) {
  const Taps81 hp9 = taps81(hp9_taps), lp9 = taps81(lp9_taps);
  const Taps5 t5 = taps5(t5_taps);
  if (!build_taps_ok(hp9, t5, lp9)) return static_cast<int>(cudaErrorInvalidValue);
  int flags = 0;
  if (w % 4 == 0 && aligned(x, 16)) flags |= FLAG_VEC_IN;
  constexpr size_t OUT4 = 4 * sizeof(TOut);
  if (w % 4 == 0 && aligned(hp, OUT4) && aligned(r, OUT4) && aligned(i, OUT4)) {
    flags |= FLAG_VEC_OUT;
  }
  if (ceil_div(w, BUILD_TALL_TX) * ceil_div(h, BUILD_TALL_TY) >= TALL_GRID_MIN) {
    build_go<BUILD_TALL_TX, BUILD_TALL_TY, 256, 3, 3, TOut>(x, hp, r, i, sub, h, w, flags, hp9,
                                                            t5, lp9, s);
  } else {
    build_go<BUILD_SMALL_TX, BUILD_SMALL_TY, 128, 2, 8, TOut>(x, hp, r, i, sub, h, w, flags,
                                                              hp9, t5, lp9, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// At least this many tall tiles (BLUR_TALL_TH rows) make two rounds of the
// blocks an H100 holds at once (BLUR_MIN_BLOCKS an SM); fewer take the small
// tiles, whose shorter chain of load, passes and store a lone block waits on
// less.
constexpr int BLUR_TALL_MIN = 2 * BLUR_MIN_BLOCKS * 132;

// The 13 taps of blur13_kernel, or false where one is zero: the plain
// version skips zero taps, which the kernel does not.
bool taps13(const void* k, Taps13& t) {
  std::memcpy(t.k, k, sizeof t.k);
  for (float v : t.k) {
    if (v == 0.f) return false;
  }
  return true;
}

int blur13_launch(const void* x, void* out, int planes, int h, int w, const void* taps,
                  cudaStream_t s) {
  Taps13 t;
  if (planes < 1 || h < 1 || w < 1 || !taps13(taps, t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int flags = 0;
  if (w % 4 == 0 && aligned(x, 16)) flags |= BLUR_VEC_IN;
  if (w % 4 == 0 && aligned(out, 16)) flags |= BLUR_VEC_OUT;
  const dim3 block(BLUR_NT);
  const int z = planes < 65535 ? planes : 65535;
  const auto* in = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  if ((long long)ceil_div(w, BLUR_TW) * ceil_div(h, BLUR_TALL_TH) * planes >= BLUR_TALL_MIN) {
    const dim3 grid(ceil_div(w, BLUR_TW), ceil_div(h, BLUR_TALL_TH), z);
    blur13_kernel<BLUR_TALL_TH><<<grid, block, 0, s>>>(in, o, planes, h, w, flags, t);
  } else {
    const dim3 grid(ceil_div(w, BLUR_TW), ceil_div(h, BLUR_SMALL_TH), z);
    blur13_kernel<BLUR_SMALL_TH><<<grid, block, 0, s>>>(in, o, planes, h, w, flags, t);
  }
  return static_cast<int>(cudaGetLastError());
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

// sh: small's rows (at least ceil(h/2); the kernel reads no more than
// those); main_taps: the taps have no zero (the collapse's 2*LP9).
int lvmt_lp9_inject(const void* small, void* out, int sh, int sw, int h, int w,
                    const void* taps, int bf16, int main_taps, void* stream) {
  (void)sh;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? inject_launch<true>(small, out, sw, h, w, taps, main_taps, s)
              : inject_launch<false>(small, out, sw, h, w, taps, main_taps, s);
}

// hp, r, i: h x w (bf16 when out_bf16); sub: ceil(h/2) x ceil(w/2) floats.
// hp9, t5, lp9 must have the zero patterns of HP9, the band taps and 2*LP9
// (cudaErrorInvalidValue otherwise, nothing launched).
int lvmt_riesz_build_level(const void* x, void* hp, void* r, void* i, void* sub, int h,
                           int w, const void* hp9, const void* t5, const void* lp9,
                           int out_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? build_launch<__nv_bfloat16>(x, hp, r, i, sub, h, w, hp9, t5, lp9, s)
                  : build_launch<float>(x, hp, r, i, sub, h, w, hp9, t5, lp9, s);
}

// x, out: planes x h x w floats, any sides of at least 1; taps: 13 non-zero
// floats (cudaErrorInvalidValue otherwise, nothing launched).
int lvmt_blur13(const void* x, void* out, int planes, int h, int w, const void* taps,
                void* stream) {
  return blur13_launch(x, out, planes, h, w, taps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
