// The SELL tiers' gathered groups for Hopper (sm_90a), from the tier's pack.
//
// Replaces no TPU kernel: the JAX package computes the SELL groups without
// a window plan, and the overflow mini-SELL, with XLA over dense slabs
// (bmsparse_tpu/ops/spmv.py, sell_apply), which hold cw * 8 coefficients
// per slot, 98.8% zeros at Graph500 scale 20 (8.11 GB for 101 MB of
// values). This kernel reads the tier's GatherPack
// (ops/cuda/sell_gather_kernel.py), built once per matrix: each nonzero
// once, its value (float32, or bfloat16 converted to float32 in registers)
// and its global scalar column (int32), sorted by (pack row, column), the
// rows cut into segments of at most SEG_LEN entries. It computes
//     out[rows[r]] = sum over the entries e of pack row r:
//                    vals[e] * v[cols[e] - col_off]
// with v read as 0 outside [0, n), for every pack row r, empty rows
// included. col_off is where v starts in the whole vector: 0 on one device,
// a shard's window start in the multi-device halo mode.
//
// What bounds it on the H100: the pack's bytes in device memory (8 bytes
// per entry in float32, 6 in bfloat16) and the gathers of v, one 32-byte
// L2 sector per entry at worst. v is read through __ldg: Graph500 scale 20
// has 2.6 MB of it, resident in the 50 MB L2. One FMA per entry.
//
// Design: two kernels, no atomics, so that two calls give the same bits.
// 1. One warp per segment, 8 warps per block. Lane t reads entries
//    [4 * t, 4 * t + 4) of each 128-entry step with one vector load of
//    values and one of columns (the step starts at the segment's first
//    entry rounded down to a multiple of 4; entries outside the segment
//    count 0), accumulates in float32 and the warp sums its lanes with
//    shuffles in a fixed tree; lane 0 writes the segment's sum.
// 2. One thread per pack row: it adds its segments' sums in segment order
//    (none for an empty row) and writes its row of out once.
// Work is balanced by entries, not by rows: a hub row of 45,830 entries
// is 45 warps of 1,024 entries, not one thread's walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kVec = 4;                  // entries per lane per step
constexpr int kStep = kWarp * kVec;      // entries per warp per step
constexpr int kWarps = 8;                // segments per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kRowThreads = 256;

__device__ __forceinline__ float2 bf2(unsigned u) {
  __nv_bfloat162 b;
  b.x = __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu));
  b.y = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
  return __bfloat1622float2(b);
}

__device__ __forceinline__ void load4(const float* __restrict__ vals,
                                      int64_t e, float (&a)[kVec]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(vals + e));
  a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ vals,
                                      int64_t e, float (&a)[kVec]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(vals + e));
  const float2 lo = bf2(x.x), hi = bf2(x.y);
  a[0] = lo.x, a[1] = lo.y, a[2] = hi.x, a[3] = hi.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sell_gather_segments_kernel(const T* __restrict__ vals,
                                const int* __restrict__ cols,
                                const int64_t* __restrict__ seg_off,
                                const float* __restrict__ v, int64_t nseg,
                                int64_t n, int64_t col_off,
                                float* __restrict__ partial) {
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (s >= nseg) return;
  const int lane = threadIdx.x % kWarp;
  const int64_t lo = __ldg(seg_off + s);
  const int64_t hi = __ldg(seg_off + s + 1);
  float acc = 0.f;
#pragma unroll 2
  for (int64_t e = (lo & ~int64_t{kVec - 1}) + lane * kVec; e < hi;
       e += kStep) {
    const int4 c = __ldg(reinterpret_cast<const int4*>(cols + e));
    float a[kVec];
    load4(vals, e, a);
    const int64_t col[kVec] = {c.x - col_off, c.y - col_off, c.z - col_off,
                               c.w - col_off};
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      const bool in =
          e + m >= lo && e + m < hi && col[m] >= 0 && col[m] < n;
      const float x = in ? __ldg(v + col[m]) : 0.f;
      acc = fmaf(in ? a[m] : 0.f, x, acc);
    }
  }
#pragma unroll
  for (int d = kWarp / 2; d > 0; d /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, d);
  }
  if (lane == 0) partial[s] = acc;
}

__global__ void __launch_bounds__(kRowThreads)
    sell_gather_rows_kernel(const int64_t* __restrict__ row_seg,
                            const int* __restrict__ rows,
                            const float* __restrict__ partial, int64_t nrows,
                            int64_t out_len, float* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowThreads +
                    threadIdx.x;
  if (r >= nrows) return;
  const int64_t a = __ldg(row_seg + r), b = __ldg(row_seg + r + 1);
  float acc = 0.f;
  for (int64_t s = a; s < b; ++s) acc += __ldg(partial + s);
  const int64_t o = __ldg(rows + r);
  if (o >= 0 && o < out_len) out[o] = acc;
}

template <typename T>
cudaError_t launch(const void* vals, const int* cols, const int64_t* seg_off,
                   int64_t nseg, const int64_t* row_seg, const int* rows,
                   int64_t nrows, const float* v, int64_t n,
                   int64_t col_off, float* partial, float* out,
                   int64_t out_len, cudaStream_t s) {
  if (nseg > 0) {
    const int64_t blocks = (nseg + kWarps - 1) / kWarps;
    sell_gather_segments_kernel<T>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            static_cast<const T*>(vals), cols, seg_off, v, nseg, n, col_off,
            partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (nrows > 0) {
    const int64_t blocks = (nrows + kRowThreads - 1) / kRowThreads;
    sell_gather_rows_kernel<<<static_cast<unsigned>(blocks), kRowThreads, 0,
                              s>>>(row_seg, rows, partial, nrows, out_len,
                                   out);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
// vals and cols 16-byte aligned, their length a multiple of 4.
extern "C" int bmsp_sell_gather(const void* vals, int vals_is_bf16,
                                const void* cols, const void* seg_off,
                                int64_t nseg, const void* row_seg,
                                const void* rows, int64_t nrows,
                                const void* v, int64_t n, int64_t col_off,
                                void* partial, void* out, int64_t out_len,
                                void* stream) {
  if (nseg < 0 || nrows < 0 || n < 0 || out_len < 0 ||
      (nseg + kWarps - 1) / kWarps > 0x7fffffff ||
      (nrows + kRowThreads - 1) / kRowThreads > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int*>(cols);
  const auto* so = static_cast<const int64_t*>(seg_off);
  const auto* rs = static_cast<const int64_t*>(row_seg);
  const auto* r = static_cast<const int*>(rows);
  const auto* vf = static_cast<const float*>(v);
  auto* pf = static_cast<float*>(partial);
  auto* of = static_cast<float*>(out);
  if (vals_is_bf16) {
    return launch<__nv_bfloat16>(vals, c, so, nseg, rs, r, nrows, vf, n,
                                 col_off, pf, of, out_len, s);
  }
  return launch<float>(vals, c, so, nseg, rs, r, nrows, vf, n, col_off, pf,
                       of, out_len, s);
}
