// Row-wise gather for Hopper (sm_90a): stages 2 and 3 of the stream tier's
// static routing network.
//
// Replaces: bmsparse_tpu/ops/pallas/shuffle_kernel.py, rowwise_gather
// (kernel body _rowwise_kernel).
//
// Computes out (R, G, 128) float32:
//     out[r, g, l] = x[r, idx[r, g, l]]   where 0 <= idx[r, g, l] < W,
//                    0                    elsewhere (the planner's sentinel
//                                         is W).
// x (R, W) float32, idx (R, G, 128) int32.
//
// What bounds it on the H100: device-memory bytes. Each output reads one
// index (4 bytes) and writes one float (4 bytes); each row of x is read
// once. There is no arithmetic to speak of.
//
// Design: one thread block per tile of rows. The block copies its rows of
// x (one contiguous run of tile * W floats, about 16 KB) into shared memory
// with coalesced loads, then each thread reads four neighbouring indices
// as one 16-byte load, looks the four values up in shared memory and
// writes them as one 16-byte store. Rows wider than 12,288 floats (48 KB)
// are read from global memory in place of the staging, where L1 and L2
// serve the repeated reads of one row.
//
// On the TPU each output vreg was resolved by W / 128 lane shuffles and
// selects (a quarter-select chain), because the TPU has no gather; a GPU
// thread reads any shared-memory word directly, so the chain has no
// counterpart here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kStageBytes = 16 * 1024;   // x staged per block (target)
constexpr int64_t kMaxStagedW = 12288;       // 48 KB: no opt-in needed

__device__ __forceinline__ float pick(const float* row, int c, int w) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(w) ? row[c] : 0.f;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    rowwise_gather_kernel(const float* __restrict__ x,
                          const int* __restrict__ idx, int64_t rows, int w,
                          int per_row, int tile_rows,
                          float* __restrict__ out) {
  extern __shared__ float xs[];   // [tile_rows * w] when staged
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int nr = static_cast<int>(
      rows - r0 < tile_rows ? rows - r0 : static_cast<int64_t>(tile_rows));
  const float* xt = x + r0 * w;
  if (kStaged) {
    const int nx = nr * w;
    for (int i = threadIdx.x; i < nx; i += kThreads) xs[i] = __ldg(xt + i);
    __syncthreads();
  }
  const float* src = kStaged ? xs : xt;
  const int64_t base = r0 * per_row;
  const int4* i4 = reinterpret_cast<const int4*>(idx + base);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  const int per_row4 = per_row / 4;
  const int n4 = nr * per_row4;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    // per_row is a multiple of 128, so four neighbours share a row
    const float* row = src + static_cast<int64_t>(i / per_row4) * w;
    const int4 c = __ldg(i4 + i);
    float4 o;
    o.x = pick(row, c.x, w);
    o.y = pick(row, c.y, w);
    o.z = pick(row, c.z, w);
    o.w = pick(row, c.w, w);
    o4[i] = o;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
// x, idx and out must be 16-byte aligned.
extern "C" int bmsp_rowwise_gather(const void* x, const void* idx,
                                   int64_t rows, int64_t w, int64_t g_out,
                                   void* out, void* stream) {
  if (rows < 0 || w < 1 || w > (1 << 26) || g_out < 1 || g_out > 4096) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return cudaSuccess;
  const int64_t per_row = g_out * 128;
  int64_t tile = kStageBytes / (w * static_cast<int64_t>(sizeof(float)));
  tile = tile < 1 ? 1 : (tile > 32 ? 32 : tile);
  if (tile * per_row > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t blocks = (rows + tile - 1) / tile;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* ii = static_cast<const int*>(idx);
  auto* of = static_cast<float*>(out);
  if (w <= kMaxStagedW) {
    const size_t smem = static_cast<size_t>(tile * w) * sizeof(float);
    rowwise_gather_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, s>>>(
        xf, ii, rows, static_cast<int>(w), static_cast<int>(per_row),
        static_cast<int>(tile), of);
  } else {
    rowwise_gather_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                    0, s>>>(
        xf, ii, rows, static_cast<int>(w), static_cast<int>(per_row),
        static_cast<int>(tile), of);
  }
  return cudaGetLastError();
}
