// Tile-window SpGEMM products for Hopper (sm_90a).
//
// Replaces: bmsparse_tpu/ops/pallas/spgemm_window_kernel.py,
// numeric_window_pallas (grid _window_products, body
// _spgemm_window_kernel, in-VMEM gather _gather_window).
//
// Computes, in one launch, every chunk of a work table drawn from one or
// more K-groups with a tile-window plan. A group's window-relative slot
// tables are (ntiles, K, 8, 128) int32, stored as ntiles * K * 8 rows of
// the (rows, 128) slot tables, so task k of chunk slot tt of a tile is the
// row `slot row + 8k` with slot row = tile base + tt; the work row carries
// the tile's window starts wsa, wsb:
//     out[(out chunk)*128 + l, i*8 + m] =
//         sum_k sum_j A[wsa + ra[slot row + 8k, l], i*8 + j]
//                   * B[wsb + rb[slot row + 8k, l], j*8 + m]
// ra == 1 << 24 (the sentinel) and any block outside [0, nb) read a zero
// tile. The planner lists only the chunk slots whose rows it keeps (the
// first cap chunks of the group), so padding slots of the last tile are
// neither computed nor written.
//
// What bounds it on the H100: as for spgemm_sell.cu, gathered bytes. The
// windows bound where a tile's gathers land (at most 4096 rows per side),
// and the planner's row order runs the chunks of all K-groups over the
// same block rows side by side, so their shared operand tiles come from
// L2. On the TPU each tile's windows were DMA'd into VMEM, double-buffered,
// and gathered with quarter-select lane shuffles; a 4096-row window is
// 1 MB per side in f32, far above a thread block's 227 KB of shared
// memory, so here each task's two tiles are copied on their own (cp.async)
// into a per-warp ring, as in spgemm_tiles.cuh.

#include "spgemm_tiles.cuh"

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
// work: (n_work, 5) int32 rows [kg, slot row, wsa, wsb, out chunk].
extern "C" int bmsp_numeric_window(const void* a, const void* b, int is_bf16,
                                   int64_t nb_a, int64_t nb_b,
                                   const void* slots_a, const void* slots_b,
                                   const void* work, int64_t n_work,
                                   int64_t max_kg, void* out, void* stream) {
  return bmsp_spgemm::entry<true>(a, b, is_bf16, nb_a, nb_b, slots_a,
                                  slots_b, work, n_work, max_kg, out, stream);
}
