// Task-SELL SpGEMM products for Hopper (sm_90a), operand gather fused in.
//
// Replaces: bmsparse_tpu/ops/pallas/spgemm_kernel.py, numeric_sell_pallas
// (kernel body _sell_kernel, grid _sell_products, and the XLA gather
// _gather_kc that feeds it a (64, K, ch, 128) operand tensor).
//
// Computes, in one launch, every chunk of a work table drawn from one or
// more K-groups. A group's slot tables are (ch, K, 128) int32 absolute
// block indices, stored as ch * K rows of the (rows, 128) slot tables, so
// task k of a chunk is the row `slot row + k`:
//     out[(out chunk)*128 + l, i*8 + m] =
//         sum_k sum_j A[ta[slot row + k, l], i*8 + j]
//                   * B[tb[slot row + k, l], j*8 + m]
// An index outside [0, nb) reads a zero tile (the planner's sentinel is
// nb).
//
// What bounds it on the H100: gathered bytes, two scattered 256-byte tiles
// (f32) per task for 512 FMAs. The TPU gathered into a materialised
// (64, K, ch, 128) tensor and read it back; here the gather feeds the
// products directly (as the reference's multiplyV15 does, SURVEY.md §3.2),
// so the operands cross device memory once and the C tile is written once.
// One launch covers all of a product's groups that have no tile window, in
// the planner's row order. Design: spgemm_tiles.cuh.

#include "spgemm_tiles.cuh"

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
// work: (n_work, 5) int32 rows [kg, slot row, 0, 0, out chunk].
extern "C" int bmsp_numeric_sell(const void* a, const void* b, int is_bf16,
                                 int64_t nb_a, int64_t nb_b,
                                 const void* slots_a, const void* slots_b,
                                 const void* work, int64_t n_work,
                                 int64_t max_kg, void* out, void* stream) {
  return bmsp_spgemm::entry<false>(a, b, is_bf16, nb_a, nb_b, slots_a,
                                   slots_b, work, n_work, max_kg, out, stream);
}
