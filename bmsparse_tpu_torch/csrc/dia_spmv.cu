// DIA-tier SpMV for Hopper (sm_90a).
//
// Replaces: bmsparse_tpu/ops/pallas/spmv_kernel.py, dia_spmv_pallas
// (kernel body _dia_kernel), the TPU kernel of the plan's DIA tier.
//
// Computes, for every element e < elems of the flat (R, 128) output,
//     out[e] = sum_d dia[d, e] * v[e + shift + offsets[d]],
// where a column outside [0, n) reads 0. The shift (0 on one device) is a
// shard's column base on the multi-device path: its rows are local while v
// and the offsets are global, or v is a halo window of the global vector. dia is (nd, elems) float32 or
// bfloat16 (converted to float32 in registers); v, out and the sum are
// float32.
//
// What bounds it on the H100: device-memory bytes. Each output element
// reads nd coefficients once and does nd FMAs (0.5 FLOP per f32 byte), far
// below the card's ~20 FLOP/byte balance point, so the kernel is a stream
// of the (nd, R, 128) strip at device-memory bandwidth. The strip at
// stencil2M is 17 x 2M x 4 B = 143 MB, well past the 50 MB L2.
//
// Design: one thread per output element. For a fixed diagonal d, the 32
// threads of a warp read 32 neighbouring coefficients (one 128-byte line
// for f32) and 32 neighbouring v entries, so every load is coalesced. The
// diagonals' v reads overlap one another and stay in L1/L2, so device
// memory sees the strip, v about once, and the output. The shift is one
// more kernel parameter added to the row index, so a tall matrix whose
// late shards start past the end of v reads zeros there. The offsets are
// passed by value in the kernel's parameter space (nd <= 128, 512 bytes):
// every thread reads the same offset at the same time, a broadcast from
// the constant bank, with no copy to the device per call. Index arithmetic
// is 64-bit, since nd * R * 128 outgrows int32 on large matrices.
//
// The TPU kernel's devices do not carry over: the whole padded vector kept
// resident in VMEM (lead_rows, wpad), the pltpu.roll lane rotation and the
// 8-row-aligned overhang exist for the TPU's (8, 128) tiling. Here the
// bounds check on e + offsets[d] takes the place of the zero padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 128;   // MAX_DIAGS of the planner (ops/plan.py)
constexpr int kThreads = 256;

struct DiaOffsets {
  int o[kMaxDiags];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const T* __restrict__ dia, const float* __restrict__ v,
                    const DiaOffsets offs, int nd, int64_t elems, int64_t n,
                    int64_t shift, float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= elems) return;
  const int64_t col = e + shift;
  float acc = 0.f;
  for (int d = 0; d < nd; ++d) {
    const int64_t c = col + offs.o[d];
    const float x = (c >= 0 && c < n) ? __ldg(v + c) : 0.f;
    acc = fmaf(to_f32(dia[static_cast<int64_t>(d) * elems + e]), x, acc);
  }
  out[e] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
extern "C" int bmsp_dia_spmv(const void* dia, int dia_is_bf16, const void* v,
                             const void* offsets_host, int nd, int64_t elems,
                             int64_t n, int64_t shift, void* out,
                             void* stream) {
  if (nd < 0 || nd > kMaxDiags || elems < 0) return cudaErrorInvalidValue;
  DiaOffsets offs{};
  const int* src = static_cast<const int*>(offsets_host);
  for (int d = 0; d < nd; ++d) offs.o[d] = src[d];
  const int64_t blocks = (elems + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  if (dia_is_bf16) {
    dia_spmv_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads,
                                     0, s>>>(
        static_cast<const __nv_bfloat16*>(dia), vf, offs, nd, elems, n, shift,
        of);
  } else {
    dia_spmv_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(dia), vf, offs, nd, elems, n, shift, of);
  }
  return cudaGetLastError();
}
