// Column halo exchange between lane shards, for sm_90a.
//
//   lvmt_halo_cols <- parallel/halo.py::halo_exchange_cols_rdma
//                     halo_cols_kernel: every shard of a W-sharded array
//                     gets its haloed strip [rows, w_l + 2h] in one pass.
//
// What it computes: shard k's strip holds, column by column,
//   [0, h)          the left neighbour's last h columns, or on the global
//                   first shard reflect-101: column h - c of its own;
//   [h, h + w_l)    its own columns;
//   [h + w_l, ...)  the right neighbour's first h columns, or on the global
//                   last shard reflect-101 (own column w_l - 2 - j) or, in
//                   the symmetric mode of the zero-injection quirk, the
//                   symmetric pad (own column w_l - 1 - j), j = c - h - w_l.
// That is the value the reference returns: its TPU kernel RDMAs only the two
// edge strips into the neighbours' VMEM behind a barrier semaphore, and jnp
// does the flips, the edge selects and the concatenation afterwards. Here
// all of it is one pass, and the direction is reversed: each shard's threads
// PULL the neighbour's edge columns through its device pointer and write
// only their own shard's output. A neighbour on the same card is plain
// device memory; on a peer card it is read over NVLink, which needs peer
// access (enabled by lvmt_enable_peer_access) and nothing else: no remote
// semaphores, since the wrapper orders the launch after the neighbours'
// streams with events, the role of the reference's barrier.
//
// One launch covers every shard a device holds (up to MAX_SHARDS = 8, the
// largest mesh of the reference's tests): the pointer table (own, left,
// right, out for each shard) travels by value as a kernel parameter, and
// blockIdx.z picks the shard. With n virtual shards on one card an exchange
// is one launch, not n.
//
// Bound on an H100 SXM (3.35 TB/s): each shard reads rows * (w_l + 2h)
// values and writes as many. At a 2160x3840 frame on a 4-way mesh (2160 x
// 960 a shard), halo 6: 16.8 MB a shard, 67 MB for four, 0.020 ms; the
// 6-plane stack of the kernel tail, 0.120 ms. Only 2 * rows * h values a
// shard cross between cards. Bound by bytes; the design keeps the accesses
// coalesced: threads run along a row of the strip, each thread resolves its
// column's source (pointer and column) once and then copies that column for
// ROWS rows at a time, ROWS loads in flight. No shared memory, no TMA: it is
// a copy.
//
// C interface: the pointer table as host arrays of void* (own, left, right,
// out; a null left / right marks the global first / last shard), sizes as
// int, the stream as void*. lvmt_halo_cols returns cudaGetLastError() of its
// launch; lvmt_enable_peer_access returns the cudaError of enabling access
// from `device` to `peer`, 0 when it was enabled already.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SHARDS = 8;
constexpr int THREADS = 256;  // along a row of the strip
constexpr int ROWS = 8;       // rows a thread copies

struct Shard {
  const float* own;
  const float* left;   // nullptr on the global first shard
  const float* right;  // nullptr on the global last shard
  float* out;
};

struct ShardTable {
  Shard s[MAX_SHARDS];
};

__global__ void __launch_bounds__(THREADS)
halo_cols_kernel(const ShardTable table, const int rows, const int wl, const int halo,
                 const int symmetric) {
  const Shard sh = table.s[blockIdx.z];
  const int w2 = wl + 2 * halo;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= w2) return;
  // the source of output column c: a plane and a column of it
  const float* src;
  int sc;
  if (c < halo) {
    if (sh.left != nullptr) {
      src = sh.left;
      sc = wl - halo + c;
    } else {
      src = sh.own;
      sc = halo - c;
    }
  } else if (c < halo + wl) {
    src = sh.own;
    sc = c - halo;
  } else {
    const int j = c - halo - wl;
    if (sh.right != nullptr) {
      src = sh.right;
      sc = j;
    } else {
      src = sh.own;
      sc = symmetric ? wl - 1 - j : wl - 2 - j;
    }
  }
  const long long blocks = (rows + ROWS - 1) / ROWS;
  for (long long b = blockIdx.y; b < blocks; b += gridDim.y) {
    const long long r0 = b * ROWS;
    const int n = rows - r0 < ROWS ? static_cast<int>(rows - r0) : ROWS;
    const float* in = src + r0 * wl + sc;
    float* out = sh.out + r0 * w2 + c;
    if (n == ROWS) {
      float v[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) v[r] = in[static_cast<long long>(r) * wl];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) out[static_cast<long long>(r) * w2] = v[r];
    } else {
      for (int r = 0; r < n; ++r)
        out[static_cast<long long>(r) * w2] = in[static_cast<long long>(r) * wl];
    }
  }
}

}  // namespace

extern "C" {

// count shards (1..8), each [rows, wl] f32 in, [rows, wl + 2 halo] f32 out;
// 0 < halo < wl. symmetric: the global last shard pads symmetric.
int lvmt_halo_cols(const void* const* own, const void* const* left, const void* const* right,
                   void* const* out, int count, int rows, int wl, int halo, int symmetric,
                   void* stream) {
  if (count < 1 || count > MAX_SHARDS || rows < 1 || halo < 1 || wl <= halo)
    return static_cast<int>(cudaErrorInvalidValue);
  ShardTable table{};
  for (int k = 0; k < count; ++k) {
    table.s[k].own = static_cast<const float*>(own[k]);
    table.s[k].left = static_cast<const float*>(left[k]);
    table.s[k].right = static_cast<const float*>(right[k]);
    table.s[k].out = static_cast<float*>(out[k]);
  }
  const int w2 = wl + 2 * halo;
  const int row_blocks = (rows + ROWS - 1) / ROWS;
  const dim3 grid((w2 + THREADS - 1) / THREADS, row_blocks < 65535 ? row_blocks : 65535, count);
  halo_cols_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, rows, wl, halo, symmetric);
  return static_cast<int>(cudaGetLastError());
}

int lvmt_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it, so that no later cudaGetLastError reports it
      err = cudaSuccess;
    }
  }
  const cudaError_t restore = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}

}  // extern "C"
