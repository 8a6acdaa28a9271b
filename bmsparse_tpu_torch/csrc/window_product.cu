// Stream-tier window products for Hopper (sm_90a).
//
// Replaces: bmsparse_tpu/ops/pallas/shuffle_kernel.py, window_product
// (kernel body _window_product_kernel), the v gather of the stream tier.
//
// Computes out (R, 128) float32:
//     out[r, l] = vals[r, l] * vtab[ws[r / tile_r] + rel[r, l]]
// vals (R, 128) float32, rel (R, 128) int32, ws (R / tile_r,) int32
// window starts, vtab (n_vtab,) float32. A rel outside [0, w), or a
// window entry outside vtab, reads 0. The planner puts every tile's
// sources in one w-scalar window (padding slots: rel 0, vals 0).
//
// What bounds it on the H100: device-memory bytes. Each element reads a
// coefficient and an index (8 bytes) and writes a product (4 bytes) for
// one multiply; the window (4 KB at w = 1024) is read once per tile of
// tile_r * 128 elements, an eighth of the tile's own bytes at tile_r = 32.
//
// Design: one thread block per tile. The block stages the tile's window
// of vtab in shared memory with coalesced loads, then each thread reads
// four neighbouring lanes of vals and rel as one 16-byte load each, looks
// the four v entries up in shared memory and writes four products as one
// 16-byte store. Scattered rel values spread over the banks.
//
// On the TPU the window was fetched by a double-buffered DMA once per
// panel of tiles and every lane was resolved by quarter-select lane
// shuffles over a sublane-tiled copy of v; those are workarounds for the
// missing gather, with no counterpart here. The panel ids and next-panel
// starts that drove the DMA are not read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kMaxSmem = 48 * 1024;  // default dynamic shared memory

__device__ __forceinline__ float lookup(const float* win, int r, int w) {
  return static_cast<unsigned>(r) < static_cast<unsigned>(w) ? win[r] : 0.f;
}

__global__ void __launch_bounds__(kThreads)
    window_product_kernel(const float* __restrict__ vals,
                          const int* __restrict__ rel,
                          const int* __restrict__ ws,
                          const float* __restrict__ vtab, int64_t n_vtab,
                          int tile_r, int w, float* __restrict__ out) {
  extern __shared__ float win[];     // [w]
  const int64_t t = blockIdx.x;
  const int64_t base = __ldg(ws + t);
  for (int i = threadIdx.x; i < w; i += kThreads) {
    const int64_t g = base + i;
    win[i] = (g >= 0 && g < n_vtab) ? __ldg(vtab + g) : 0.f;
  }
  __syncthreads();

  const int64_t off = t * tile_r * kLanes;
  const float4* v4 = reinterpret_cast<const float4*>(vals + off);
  const int4* r4 = reinterpret_cast<const int4*>(rel + off);
  float4* o4 = reinterpret_cast<float4*>(out + off);
  const int n4 = tile_r * kLanes / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 a = __ldg(v4 + i);
    const int4 r = __ldg(r4 + i);
    float4 p;
    p.x = a.x * lookup(win, r.x, w);
    p.y = a.y * lookup(win, r.y, w);
    p.z = a.z * lookup(win, r.z, w);
    p.w = a.w * lookup(win, r.w, w);
    o4[i] = p;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
extern "C" int bmsp_window_product(const void* vals, const void* rel,
                                   const void* ws, const void* vtab,
                                   int64_t n_vtab, int64_t ntiles,
                                   int64_t tile_r, int64_t w, void* out,
                                   void* stream) {
  const int64_t smem = w * static_cast<int64_t>(sizeof(float));
  if (ntiles < 0 || ntiles > 0x7fffffff || tile_r < 1 || tile_r > 4096 ||
      w < 1 || smem > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  if (ntiles == 0) return cudaSuccess;
  window_product_kernel<<<static_cast<unsigned>(ntiles), kThreads,
                          static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(rel),
      static_cast<const int*>(ws), static_cast<const float*>(vtab), n_vtab,
      static_cast<int>(tile_r), static_cast<int>(w),
      static_cast<float*>(out));
  return cudaGetLastError();
}
