// Windowed SELL-group SpMV for Hopper (sm_90a), from the group's pack.
//
// Replaces: bmsparse_tpu/ops/pallas/sell_kernel.py, sell_window_group
// (kernel body _sell_window_kernel), the TPU kernel of the plan's windowed
// SELL K-groups.
//
// Computes one K-group's contribution, out (cap, 8, 128) float32:
//     out[c, i, l] = sum_k sum_w dense[w, c, k, i, l] * v[(ws[c] + rel[c, k, l]) * cw + w]
// with v read as 0 at or past n, from the group's SellPack
// (ops/cuda/sell_kernel.py), built once per matrix: each nonzero of the
// slab once, its value (float32, or bfloat16 converted to float32 in
// registers) and its column relative to the chunk's window start
// ws[c] * cw in 16 bits, laid out SELL-32. A slice is 32 output rows of
// one chunk (rows sorted by length inside the chunk; `rows` maps a
// position back to its row), padded to its longest row, and holds entry j
// of its row t at slice_off[s] + (j / G) * 32 * G + t * G + j % G, with
// G = 4 where the slice's length is a multiple of 4, else 2 where it is
// even, else 1. Padding entries hold value 0 and column 0.
//
// What bounds it on the H100: device-memory bytes of the pack (6 bytes per
// entry in float32, 4 in bfloat16) and of the output (4 bytes per row),
// one FMA per entry. The TPU layout's dense (cw * 8, 128) slot tiles,
// 97.5% zeros at road1M, are not read at all. v is read through __ldg,
// uncached in shared memory: a chunk's entries touch a few hundred of its
// window's 256 * cw scalars, and all of v (4.2 MB at road1M) stays in the
// 50 MB L2, so staging a whole 64 KB window per chunk in shared memory
// would move more bytes out of L2 than the nonzeros themselves.
//
// Design: one warp per slice, one thread per row, 8 warps per block; the
// grid covers every slice (road1M: 31,936 warps over 132 SMs). A thread
// walks its row G entries at a time with one vector load of values
// (16, 8 or 4 bytes in float32) and one of columns, so the warp's loads of
// a step are contiguous; it accumulates in float32 in entry order and
// writes its row of out once, every row of every chunk included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 32;          // rows per slice: one warp
constexpr int kChunkRows = 8 * 128;
constexpr int kSlicesPerChunk = kChunkRows / kSlice;
constexpr int kWarps = 8;           // slices per block
constexpr int kThreads = kWarps * kSlice;

__device__ __forceinline__ float vat(const float* __restrict__ v, int64_t g,
                                     int64_t n) {
  return g < n ? __ldg(v + g) : 0.f;
}

__device__ __forceinline__ float2 bf2(unsigned u) {
  __nv_bfloat162 b;
  b.x = __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu));
  b.y = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
  return __bfloat1622float2(b);
}

// G entries at index e (a multiple of G): columns, then values as float.
template <int G>
__device__ __forceinline__ void load_cols(const int16_t* __restrict__ cols,
                                          int64_t e, unsigned (&col)[G]) {
  if constexpr (G == 4) {
    const uint2 c = __ldg(reinterpret_cast<const uint2*>(cols + e));
    col[0] = c.x & 0xffffu, col[1] = c.x >> 16;
    col[2] = c.y & 0xffffu, col[3] = c.y >> 16;
  } else if constexpr (G == 2) {
    const unsigned c = __ldg(reinterpret_cast<const unsigned*>(cols + e));
    col[0] = c & 0xffffu, col[1] = c >> 16;
  } else {
    col[0] = __ldg(reinterpret_cast<const unsigned short*>(cols + e));
  }
}

template <int G>
__device__ __forceinline__ void load_vals(const float* __restrict__ vals,
                                          int64_t e, float (&a)[G]) {
  if constexpr (G == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(vals + e));
    a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
  } else if constexpr (G == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(vals + e));
    a[0] = x.x, a[1] = x.y;
  } else {
    a[0] = __ldg(vals + e);
  }
}

template <int G>
__device__ __forceinline__ void load_vals(
    const __nv_bfloat16* __restrict__ vals, int64_t e, float (&a)[G]) {
  if constexpr (G == 4) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(vals + e));
    const float2 lo = bf2(x.x), hi = bf2(x.y);
    a[0] = lo.x, a[1] = lo.y, a[2] = hi.x, a[3] = hi.y;
  } else if constexpr (G == 2) {
    const float2 x = bf2(__ldg(reinterpret_cast<const unsigned*>(vals + e)));
    a[0] = x.x, a[1] = x.y;
  } else {
    a[0] = __bfloat162float(__ushort_as_bfloat16(
        __ldg(reinterpret_cast<const unsigned short*>(vals + e))));
  }
}

// The row of slice thread t: `steps` steps of G entries from e0 on.
template <int G, typename T>
__device__ __forceinline__ float row_sum(const T* __restrict__ vals,
                                         const int16_t* __restrict__ cols,
                                         const float* __restrict__ v,
                                         int64_t e0, int steps, int64_t base,
                                         int64_t n) {
  float acc = 0.f;
#pragma unroll 2
  for (int q = 0; q < steps; ++q) {
    const int64_t e = e0 + static_cast<int64_t>(q) * kSlice * G;
    unsigned col[G];
    float a[G];
    load_cols<G>(cols, e, col);
    load_vals<G>(vals, e, a);
#pragma unroll
    for (int m = 0; m < G; ++m) {
      acc = fmaf(a[m], vat(v, base + col[m], n), acc);
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sell_window_kernel(const T* __restrict__ vals,
                       const int16_t* __restrict__ cols,
                       const int64_t* __restrict__ slice_off,
                       const int16_t* __restrict__ rows,
                       const int* __restrict__ ws,
                       const float* __restrict__ v, int64_t nslices, int cw,
                       int64_t n, float* __restrict__ out) {
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kSlice;
  if (s >= nslices) return;
  const int t = threadIdx.x % kSlice;
  const int64_t c = s / kSlicesPerChunk;
  const int64_t base = static_cast<int64_t>(__ldg(ws + c)) * cw;
  const int64_t off = __ldg(slice_off + s);
  const int len = static_cast<int>((__ldg(slice_off + s + 1) - off) / kSlice);
  float acc;
  if (len % 4 == 0) {
    acc = row_sum<4>(vals, cols, v, off + t * 4, len / 4, base, n);
  } else if (len % 2 == 0) {
    acc = row_sum<2>(vals, cols, v, off + t * 2, len / 2, base, n);
  } else {
    acc = row_sum<1>(vals, cols, v, off + t, len, base, n);
  }
  const int r = static_cast<unsigned short>(__ldg(
      reinterpret_cast<const unsigned short*>(rows) + s * kSlice + t));
  out[c * kChunkRows + r] = acc;
}

template <typename T>
cudaError_t launch(const void* vals, const int16_t* cols,
                   const int64_t* slice_off, const int16_t* rows,
                   const int* ws, const float* v, int64_t cap, int cw,
                   int64_t n, float* out, cudaStream_t s) {
  const int64_t nslices = cap * kSlicesPerChunk;
  const int64_t blocks = (nslices + kWarps - 1) / kWarps;
  sell_window_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(vals), cols, slice_off, rows, ws, v, nslices, cw,
      n, out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
extern "C" int bmsp_sell_window(const void* vals, int vals_is_bf16,
                                const void* cols, const void* slice_off,
                                const void* rows, const void* ws,
                                const void* v, int64_t cap, int64_t cw,
                                int64_t n, void* out, void* stream) {
  if (cap < 0 || cap > 0x3fffffff || cw < 1 || 256 * cw > (1 << 15)) {
    return cudaErrorInvalidValue;
  }
  if (cap == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int16_t*>(cols);
  const auto* so = static_cast<const int64_t*>(slice_off);
  const auto* r = static_cast<const int16_t*>(rows);
  const auto* w = static_cast<const int*>(ws);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  const int cwi = static_cast<int>(cw);
  if (vals_is_bf16) {
    return launch<__nv_bfloat16>(vals, c, so, r, w, vf, cap, cwi, n, of, s);
  }
  return launch<float>(vals, c, so, r, w, vf, cap, cwi, n, of, s);
}
