// Shared body of the two SpGEMM numeric kernels (spgemm_sell.cu,
// spgemm_window.cu): the K-summed 8x8x8 block products of task-SELL slots.
//
// For each C block `blk` of a K-group, with operand block indices ia(k),
// ib(k) for k < kg (an index outside [0, nb) reads a zero tile):
//     out[blk, i*8 + m] = sum_k sum_j A[ia(k), i*8 + j] * B[ib(k), j*8 + m]
// A and B are (nb, 64) row-major dense tiles, float32 or bfloat16
// (converted to float32 in registers); the sum is float32.
//
// Design: 64 threads per C block, one output element (i, m) each, and
// kBlocksPerCta C blocks per thread block. For each k the 64 threads of a
// C block load its A tile and its B tile (256 bytes each in float32,
// coalesced; thread e loads slot e) into shared memory, synchronise, and
// add their 8-term dot product to a register. The next k's two slots are
// loaded into registers before the current k is summed, so each thread
// keeps two gathers in flight across the products. A warp reads A[i*8+j]
// at 4 addresses and B[j*8+m] at 8, all in distinct banks: no conflicts.
// The finished C tile is one coalesced 256-byte row of `out`.
//
// The slot layout is the caller's: `Slots::at(blk)` returns a cursor whose
// a(k) and b(k) give the operand block indices of task k.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bmsp_spgemm {

constexpr int kTile = 64;          // slots of an 8x8 block
constexpr int kBlocksPerCta = 4;   // C blocks per thread block
constexpr int kThreads = kTile * kBlocksPerCta;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float load_slot(const T* __restrict__ tbl,
                                           int64_t nb, int64_t idx, int e) {
  return (idx >= 0 && idx < nb) ? to_f32(tbl[idx * kTile + e]) : 0.f;
}

template <typename T, class Slots>
__global__ void __launch_bounds__(kThreads)
    tile_products(const T* __restrict__ a, int64_t nb_a,
                  const T* __restrict__ b, int64_t nb_b, Slots slots,
                  int64_t nblk, int kg, float* __restrict__ out) {
  __shared__ float sa[kBlocksPerCta][kTile];
  __shared__ float sb[kBlocksPerCta][kTile];
  const int g = threadIdx.x / kTile;
  const int e = threadIdx.x % kTile;
  const int i = e >> 3;
  const int m = e & 7;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kBlocksPerCta + g;
  const bool live = blk < nblk;
  const auto cur = slots.at(live ? blk : 0);

  float va = 0.f, vb = 0.f;
  if (live) {
    va = load_slot(a, nb_a, cur.a(0), e);
    vb = load_slot(b, nb_b, cur.b(0), e);
  }
  float acc = 0.f;
  // every thread of the block runs the same kg steps, so the barriers are
  // uniform even for the threads of a C block past nblk
  for (int k = 0; k < kg; ++k) {
    sa[g][e] = va;
    sb[g][e] = vb;
    __syncthreads();
    if (live && k + 1 < kg) {
      va = load_slot(a, nb_a, cur.a(k + 1), e);
      vb = load_slot(b, nb_b, cur.b(k + 1), e);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc = fmaf(sa[g][i * 8 + j], sb[g][j * 8 + m], acc);
    }
    __syncthreads();
  }
  if (live) out[blk * kTile + e] = acc;
}

template <typename T, class Slots>
cudaError_t launch(const void* a, int64_t nb_a, const void* b, int64_t nb_b,
                   const Slots& slots, int64_t nblk, int kg, float* out,
                   cudaStream_t s) {
  if (nblk == 0) return cudaSuccess;
  const int64_t grid = (nblk + kBlocksPerCta - 1) / kBlocksPerCta;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  tile_products<T, Slots><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const T*>(a), nb_a, static_cast<const T*>(b), nb_b, slots,
      nblk, kg, out);
  return cudaGetLastError();
}

template <class Slots>
cudaError_t dispatch(const void* a, const void* b, int is_bf16, int64_t nb_a,
                     int64_t nb_b, const Slots& slots, int64_t nblk, int kg,
                     float* out, cudaStream_t s) {
  if (is_bf16) {
    return launch<__nv_bfloat16>(a, nb_a, b, nb_b, slots, nblk, kg, out, s);
  }
  return launch<float>(a, nb_a, b, nb_b, slots, nblk, kg, out, s);
}

}  // namespace bmsp_spgemm
