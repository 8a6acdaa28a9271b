// Segment compress for Hopper (sm_90a): one sigma class's packed C rows
// summed into the SpGEMM output rows.
//
// Replaces: bmsparse_tpu/ops/pallas/compress_kernel.py,
// segment_compress_class (kernel body _compress_kernel, step list
// _window_steps).
//
// Computes out (t_pad, 128) float32:
//     out[q] = sum of w[r] over the rows r with b_row[r] == q,
// w (R, 128) float32 and b_row (R,) int32 non-decreasing. Rows whose
// b_row lies outside [0, t_pad) (the planner pads with 2**30) drop out.
//
// What bounds it on the H100: device-memory bytes. Every input row is read
// once (512 bytes) and every output row written once, with one add per
// input float.
//
// Design: a segmented row sum over the sorted b_row, with no atomics. Each
// warp owns 32 consecutive output rows. Its lanes find, by binary search
// over b_row, where the contributor runs of those rows begin (one search
// per lane, all in flight together; the runs are contiguous because b_row
// is sorted). Then the warp walks its rows in order: for each row it adds
// the run's rows in input order, each lane holding 4 of the 128 columns,
// and writes the row once, zeros included. One search serves 32 rows, so
// the searches' dependent loads stay a small part of the time; the reads
// of w and the writes of the output are coalesced 512-byte rows. The order
// of the sum is fixed, so the result is the same on every run.
//
// On the TPU the same scatter was a one-hot matrix product per 512-row
// output window on the MXU, driven by a prefetched (window, chunk) step
// list: the TPU's scatter engine, with no counterpart here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 32;                 // one search per lane
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

// first r in [0, n) with b_row[r] >= q (n if none)
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ b_row,
                                               int64_t n, int64_t q) {
  int64_t lo = 0;
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(b_row + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    segment_compress_kernel(const float* __restrict__ w,
                            const int* __restrict__ b_row, int64_t n_in,
                            int64_t t_pad, float* __restrict__ out) {
  __shared__ int64_t run_start[kWarps][kRowsPerWarp + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                     static_cast<int64_t>(warp) * kRowsPerWarp;
  if (q0 >= t_pad) return;                       // uniform over the warp
  int64_t* starts = run_start[warp];
  starts[lane] = lower_bound(b_row, n_in, q0 + lane);
  if (lane == 0) {
    starts[kRowsPerWarp] = lower_bound(b_row, n_in, q0 + kRowsPerWarp);
  }
  __syncwarp();
  const int64_t left = t_pad - q0;
  const int nq = left < kRowsPerWarp ? static_cast<int>(left) : kRowsPerWarp;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4* o4 = reinterpret_cast<float4*>(out + q0 * 128);
  for (int j = 0; j < nq; ++j) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const int64_t end = starts[j + 1];
    for (int64_t r = starts[j]; r < end; ++r) {
      const float4 v = __ldg(w4 + r * 32 + lane);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    o4[j * 32 + lane] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
// w and out must be 16-byte aligned.
extern "C" int bmsp_segment_compress(const void* w, const void* b_row,
                                     int64_t n_in, int64_t t_pad, void* out,
                                     void* stream) {
  if (n_in < 0 || t_pad < 0 || t_pad >= (int64_t{1} << 30)) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = (t_pad + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  segment_compress_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int*>(b_row), n_in,
      t_pad, static_cast<float*>(out));
  return cudaGetLastError();
}
