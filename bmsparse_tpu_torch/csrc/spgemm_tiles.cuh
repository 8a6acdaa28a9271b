// Shared body of the two SpGEMM numeric kernels (spgemm_sell.cu,
// spgemm_window.cu): the K-summed 8x8x8 block products of task-SELL slots,
// over every chunk of a work table in one launch.
//
// A chunk is 128 sigma-ordered C blocks of one K-group. For C block l of a
// chunk with depth kg, and operand block indices ia(k), ib(k) for k < kg
// (an index outside [0, nb) reads a zero tile):
//     out[row0 + l, i*8 + m] = sum_k sum_j A[ia(k), i*8 + j] * B[ib(k), j*8 + m]
// A and B are (nb, 64) row-major dense tiles, float32 or bfloat16
// (converted to float32 in registers); the sum is float32.
//
// The work table has one int32 row per chunk, [kg, slot row, wsa, wsb,
// out chunk]: the chunk's slot entries for task k sit in rows
// `slot row + k * kRowStride` of the (rows, 128) int32 slot tables (lane l
// in column l), the window starts wsa/wsb turn window-relative entries into
// block indices (window kernel only), and the chunk's C rows start at
// `out chunk * 128`. The planner orders the rows by the chunk's first A
// block, so the chunks of all K-groups over the same block rows run side by
// side and share their operand tiles through L2 (ops/spgemm.py,
// _product_launches).
//
// What bounds it on the H100: bytes. Each task gathers two scattered
// 256-byte tiles (f32) for 512 FMAs, far below the card's ratio of compute
// to bandwidth; the bound counts each distinct tile once, the slot tables
// and the C rows written once. The design keeps enough gathers in flight to
// reach that rate and lets L2 serve the reuse:
//   - slot rows first: the thread block (4 warps, 128 threads) loads its
//     chunk's 2 x kg x 128 slot entries into shared memory, coalesced, as
//     absolute block indices (-1 for a zero tile). Deep groups are staged
//     in k-slices of at most kSliceMax, so shared memory stays bounded. No
//     dependent index load is left in the task loop.
//   - a pipeline per warp: each warp owns 32 C blocks and walks their tasks
//     as one flat list, across C-block boundaries (so depth-1 groups
//     pipeline too), with kStages tasks in flight through a cp.async ring
//     in its own slice of shared memory. Each lane copies 16 bytes per task
//     (16 lanes per f32 tile, 8 per bf16 tile); a zero tile is cp.async's
//     zero fill (src-size 0), never a load. Only cp.async.wait_group and
//     __syncwarp() synchronise the task loop.
//   - products from shared memory: lane (i, m..m+1) reads A's row i (two
//     16-byte broadcast loads in f32, one in bf16) and B[j, m..m+1] for
//     j < 8, and adds 16 FMAs in j order into two registers: 10 shared
//     loads per lane per task, with no bank conflicts (a warp reads 8 A
//     rows at 4 lanes each and 4 adjacent B pairs per j). At the end of a
//     C block the warp writes one coalesced 256-byte row of C.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bmsp_spgemm {

constexpr int kTile = 64;                        // slots of an 8x8 block
constexpr int kLanes = 128;                      // C blocks per chunk
constexpr int kWarps = 4;                        // warps per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerWarp = kLanes / kWarps;  // 32
constexpr int kStages = 8;                       // tasks in flight per warp
constexpr int kSliceMax = 16;                    // k-slice of staged slots
constexpr int kWorkCols = 5;   // kg, slot row, wsa, wsb, out chunk
constexpr int kSentRel = 1 << 24;                // _SENT_REL of the planner

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A's row i (8 values) and B[j, m..m+1] from a stage in shared memory
__device__ __forceinline__ void row_a(const float* s, int i, float* r) {
  const float4 x = *reinterpret_cast<const float4*>(s + i * 8);
  const float4 y = *reinterpret_cast<const float4*>(s + i * 8 + 4);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  r[4] = y.x; r[5] = y.y; r[6] = y.z; r[7] = y.w;
}
__device__ __forceinline__ void row_a(const __nv_bfloat16* s, int i,
                                      float* r) {
  const uint4 x = *reinterpret_cast<const uint4*>(s + i * 8);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    r[2 * q] = f.x;
    r[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ float2 pair_b(const float* s, int j, int m) {
  return *reinterpret_cast<const float2*>(s + j * 8 + m);
}
__device__ __forceinline__ float2 pair_b(const __nv_bfloat16* s, int j,
                                         int m) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(s + j * 8 + m));
}

// The block index a slot entry stands for, or -1 for a zero tile.
template <bool kWindow>
__device__ __forceinline__ int slot_block(int r, int ws, int64_t nb) {
  if (kWindow && r == kSentRel) return -1;
  const int64_t v = kWindow ? static_cast<int64_t>(ws) + r : r;
  return (v >= 0 && v < nb) ? static_cast<int>(v) : -1;
}

template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return kWarps * kStages * 2 * kTile * static_cast<int>(sizeof(T));
}

template <typename T>
int smem_bytes(int slice) {
  return ring_bytes<T>() +
         (2 * slice * kLanes + 1) * static_cast<int>(sizeof(int));
}

template <typename T, bool kWindow>
__global__ void __launch_bounds__(kThreads)
    chunk_products(const T* __restrict__ a, int64_t nb_a,
                   const T* __restrict__ b, int64_t nb_b,
                   const int* __restrict__ slots_a,
                   const int* __restrict__ slots_b,
                   const int* __restrict__ work, int slice,
                   float* __restrict__ out) {
  constexpr int kRowStride = kWindow ? 8 : 1;    // slot rows per k
  constexpr int kChunks = kTile * sizeof(T) / 16;  // 16-byte pieces a tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  int* idx_a = reinterpret_cast<int*>(smem + ring_bytes<T>());
  // one int apart from a multiple of 32 banks, so that the A-side and
  // B-side lanes' index reads in `fetch` do not conflict
  int* idx_b = idx_a + slice * kLanes + 1;

  const int* w = work + static_cast<int64_t>(blockIdx.x) * kWorkCols;
  const int kg = __ldg(w + 0);
  const int64_t slot_row = __ldg(w + 1);
  const int wsa = __ldg(w + 2);
  const int wsb = __ldg(w + 3);
  const int64_t out_row = static_cast<int64_t>(__ldg(w + 4)) * kLanes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = lane >> 2;
  const int m = (lane & 3) * 2;
  const int blk0 = warp * kBlocksPerWarp;
  T* my_ring = ring + warp * kStages * 2 * kTile;
  // the lane's 16-byte piece of a task's tiles: A for lanes < kChunks,
  // B for the next kChunks lanes, none for the rest (bf16)
  const bool copies = lane < 2 * kChunks;
  const bool side_b = lane >= kChunks;
  const int piece = side_b ? lane - kChunks : lane;
  const T* tbl = side_b ? b : a;

  for (int k0 = 0; k0 < kg; k0 += slice) {
    const int ks = min(slice, kg - k0);
    if (k0 > 0) __syncthreads();                 // last slice consumed
    for (int e = threadIdx.x; e < ks * kLanes; e += kThreads) {
      const int kk = e / kLanes;
      const int l = e - kk * kLanes;
      const int64_t at = (slot_row + static_cast<int64_t>(k0 + kk) *
                                         kRowStride) * kLanes + l;
      idx_a[e] = slot_block<kWindow>(__ldg(slots_a + at), wsa, nb_a);
      idx_b[e] = slot_block<kWindow>(__ldg(slots_b + at), wsb, nb_b);
    }
    __syncthreads();

    // the warp's tasks in this slice, C block major: t -> (blk, kk)
    const int n = kBlocksPerWarp * ks;
    int nxt_blk = 0, nxt_kk = 0;                 // next task to fetch
    auto fetch = [&](int stage) {
      if (nxt_blk < kBlocksPerWarp) {
        const int e = nxt_kk * kLanes + blk0 + nxt_blk;
        const int ix = side_b ? idx_b[e] : idx_a[e];
        T* dst = my_ring + (stage * 2 + (side_b ? 1 : 0)) * kTile +
                 piece * (16 / sizeof(T));
        const T* src = ix >= 0 ? tbl + static_cast<int64_t>(ix) * kTile +
                                     piece * (16 / sizeof(T))
                               : tbl;
        if (copies) cp_async16(dst, src, ix >= 0);
        if (++nxt_kk == ks) {
          nxt_kk = 0;
          ++nxt_blk;
        }
      }
      cp_async_commit();                         // uniform group count
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) fetch(s);

    float acc0 = 0.f, acc1 = 0.f;
    int blk = 0, kk = 0;
    for (int t = 0; t < n; ++t) {
      fetch((t + kStages - 1) % kStages);
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const T* sa = my_ring + (t % kStages) * 2 * kTile;
      const T* sb = sa + kTile;
      float ar[8];
      row_a(sa, i, ar);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bv = pair_b(sb, j, m);
        acc0 = fmaf(ar[j], bv.x, acc0);
        acc1 = fmaf(ar[j], bv.y, acc1);
      }
      __syncwarp();                              // stage free for reuse
      if (++kk == ks) {
        float2* o = reinterpret_cast<float2*>(
            out + (out_row + blk0 + blk) * kTile + i * 8 + m);
        if (k0 > 0) {                            // earlier slices' sum
          const float2 prev = *o;
          acc0 += prev.x;
          acc1 += prev.y;
        }
        *o = make_float2(acc0, acc1);
        acc0 = acc1 = 0.f;
        kk = 0;
        ++blk;
      }
    }
    cp_async_wait<0>();
  }
}

template <typename T, bool kWindow>
cudaError_t launch(const void* a, int64_t nb_a, const void* b, int64_t nb_b,
                   const int* slots_a, const int* slots_b, const int* work,
                   int64_t n_work, int max_kg, float* out, cudaStream_t s) {
  if (n_work == 0) return cudaSuccess;
  if (n_work > 0x7fffffff) return cudaErrorInvalidValue;
  const int slice = max_kg < kSliceMax ? max_kg : kSliceMax;
  const int bytes = smem_bytes<T>(slice);
  chunk_products<T, kWindow>
      <<<static_cast<unsigned>(n_work), kThreads, bytes, s>>>(
          static_cast<const T*>(a), nb_a, static_cast<const T*>(b), nb_b,
          slots_a, slots_b, work, slice, out);
  return cudaGetLastError();
}

// The C entry of both kernels: validates the scalars and dispatches on the
// operand type. Launches on `stream`; no synchronisation.
template <bool kWindow>
int entry(const void* a, const void* b, int is_bf16, int64_t nb_a,
          int64_t nb_b, const void* slots_a, const void* slots_b,
          const void* work, int64_t n_work, int64_t max_kg, void* out,
          void* stream) {
  if (n_work < 0 || max_kg < 1 || max_kg > (1 << 24) || nb_a < 0 ||
      nb_b < 0 || nb_a > 0x7fffffff || nb_b > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const auto sa = static_cast<const int*>(slots_a);
  const auto sb = static_cast<const int*>(slots_b);
  const auto wk = static_cast<const int*>(work);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int kg = static_cast<int>(max_kg);
  if (is_bf16) {
    return launch<__nv_bfloat16, kWindow>(a, nb_a, b, nb_b, sa, sb, wk,
                                          n_work, kg, o, s);
  }
  return launch<float, kWindow>(a, nb_a, b, nb_b, sa, sb, wk, n_work, kg, o,
                                s);
}

}  // namespace bmsp_spgemm
