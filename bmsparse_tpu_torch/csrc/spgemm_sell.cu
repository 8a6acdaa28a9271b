// Task-SELL SpGEMM products for Hopper (sm_90a), operand gather fused in.
//
// Replaces: bmsparse_tpu/ops/pallas/spgemm_kernel.py, numeric_sell_pallas
// (kernel body _sell_kernel, grid _sell_products, and the XLA gather
// _gather_kc that feeds it a (64, K, ch, 128) operand tensor).
//
// Computes one K-group, out (ch * 128, 64) float32:
//     out[c*128 + l, i*8 + m] =
//         sum_k sum_j A[ta[c, k, l], i*8 + j] * B[tb[c, k, l], j*8 + m]
// with ta, tb (ch, K, 128) int32 and an index outside [0, nb) reading a
// zero tile (the planner's sentinel is nb).
//
// What bounds it on the H100: gathered bytes. Each task reads two
// scattered 256-byte tiles (f32) for 512 FMAs, 1 FLOP per byte, far below
// the card's ratio of compute to bandwidth; the tiles come from device
// memory or, when the operand tables fit in the 50 MB L2, from L2. The
// TPU gathered into a materialised (64, K, ch, 128) tensor and read it
// back; here the gather feeds the products directly (as the reference's
// multiplyV15 does, SURVEY.md §3.2), so the operands cross device memory
// once and the C tile is written once. Design: spgemm_tiles.cuh.

#include "spgemm_tiles.cuh"

namespace {

struct SellSlots {
  const int* ta;
  const int* tb;
  int kg;

  struct Cursor {
    const int* pa;
    const int* pb;
    __device__ int64_t a(int k) const { return __ldg(pa + k * 128); }
    __device__ int64_t b(int k) const { return __ldg(pb + k * 128); }
  };

  // C block blk is lane blk % 128 of chunk blk / 128
  __device__ Cursor at(int64_t blk) const {
    const int64_t base = (blk >> 7) * kg * 128 + (blk & 127);
    return Cursor{ta + base, tb + base};
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
extern "C" int bmsp_numeric_sell(const void* a, const void* b, int is_bf16,
                                 int64_t nb_a, int64_t nb_b, const void* ta,
                                 const void* tb, int64_t ch, int64_t kg,
                                 void* out, void* stream) {
  if (ch < 0 || kg < 1 || kg > (1 << 24) || nb_a < 0 || nb_b < 0) {
    return cudaErrorInvalidValue;
  }
  const SellSlots slots{static_cast<const int*>(ta),
                        static_cast<const int*>(tb), static_cast<int>(kg)};
  return bmsp_spgemm::dispatch(a, b, is_bf16, nb_a, nb_b, slots, ch * 128,
                               static_cast<int>(kg), static_cast<float*>(out),
                               static_cast<cudaStream_t>(stream));
}
