// Tile-window SpGEMM products for Hopper (sm_90a).
//
// Replaces: bmsparse_tpu/ops/pallas/spgemm_window_kernel.py,
// numeric_window_pallas (grid _window_products, body
// _spgemm_window_kernel, in-VMEM gather _gather_window).
//
// Computes one K-group through the plan's tile windows,
// out (ntiles * t_real * 128, 64) float32:
//     out[(tile*t_real + tt)*128 + l, i*8 + m] =
//         sum_k sum_j A[wsa[tile] + ra[tile, k, tt, l], i*8 + j]
//                   * B[wsb[tile] + rb[tile, k, tt, l], j*8 + m]
// for tt < t_real (the tile's other chunk slots are the planner's padding
// and are skipped). ra, rb are (ntiles, K, 8, 128) int32 window-relative
// indices, wsa, wsb (ntiles,) int32 window starts; ra == 1 << 24 (the
// sentinel) and any block at or past nb read a zero tile.
//
// What bounds it on the H100: as for spgemm_sell.cu, gathered bytes (two
// 256-byte tiles per task for 512 FMAs). The windows bound where a tile's
// gathers land: every slot of a tile reads one window of at most 4096
// rows per side, so consecutive thread blocks reuse the same 1 MB (f32)
// of each table, and the reuse shows up as L2 hits.
//
// On the TPU each tile's windows were DMA'd into VMEM, double-buffered,
// and gathered with quarter-select lane shuffles. A 4096-row window is
// 1 MB per side in f32, far above the 227 KB of shared memory a Hopper
// thread block can hold, so none of that carries over: the kernel reads
// the operand rows from global memory, and the rest of the design is that
// of spgemm_sell.cu (spgemm_tiles.cuh). Staging narrower windows in
// shared memory, or with TMA, is later work.

#include "spgemm_tiles.cuh"

namespace {

constexpr int kSentRel = 1 << 24;  // _SENT_REL of the planner
constexpr int kChunkSlots = 8;     // TILE_CHUNKS of the planner

struct WindowSlots {
  const int* ra;
  const int* rb;
  const int* wsa;
  const int* wsb;
  int kg;
  int t_real;

  struct Cursor {
    const int* pa;
    const int* pb;
    int64_t sa;
    int64_t sb;
    __device__ int64_t a(int k) const {
      const int r = __ldg(pa + k * kChunkSlots * 128);
      return r == kSentRel ? -1 : sa + r;
    }
    __device__ int64_t b(int k) const {
      const int r = __ldg(pb + k * kChunkSlots * 128);
      return r == kSentRel ? -1 : sb + r;
    }
  };

  // C block blk is lane l of real chunk slot tt of tile `tile`
  __device__ Cursor at(int64_t blk) const {
    const int64_t per_tile = static_cast<int64_t>(t_real) * 128;
    const int64_t tile = blk / per_tile;
    const int64_t rem = blk - tile * per_tile;
    const int64_t base =
        (tile * kg * kChunkSlots + (rem >> 7)) * 128 + (rem & 127);
    return Cursor{ra + base, rb + base, __ldg(wsa + tile), __ldg(wsb + tile)};
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
extern "C" int bmsp_numeric_window(const void* a, const void* b, int is_bf16,
                                   int64_t nb_a, int64_t nb_b, const void* ra,
                                   const void* rb, const void* wsa,
                                   const void* wsb, int64_t ntiles,
                                   int64_t kg, int64_t t_real, void* out,
                                   void* stream) {
  if (ntiles < 0 || kg < 1 || kg > (1 << 24) || t_real < 1 ||
      t_real > kChunkSlots || nb_a < 0 || nb_b < 0) {
    return cudaErrorInvalidValue;
  }
  const WindowSlots slots{static_cast<const int*>(ra),
                          static_cast<const int*>(rb),
                          static_cast<const int*>(wsa),
                          static_cast<const int*>(wsb),
                          static_cast<int>(kg), static_cast<int>(t_real)};
  return bmsp_spgemm::dispatch(a, b, is_bf16, nb_a, nb_b, slots,
                               ntiles * t_real * 128, static_cast<int>(kg),
                               static_cast<float*>(out),
                               static_cast<cudaStream_t>(stream));
}
