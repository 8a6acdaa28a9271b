// Bitmap-rank compress for Hopper (sm_90a): the SpGEMM's dense C tiles
// packed into C's bit-order value array.
//
// Replaces no TPU kernel: the JAX package's default ("scatter") compress is
// XLA (bmsparse_tpu/ops/spgemm.py, _compress_rows / _compress_core: a
// 64-lane sort that packs each block's set lanes to the front, a rotation
// and a 128-wide row scatter-add). Added because that route, ported as
// torch, spent most of the H100's time in the cached product on a radix
// sort, gathers and an index_add_.
//
// Computes out (nnz_pad,) float32 from c_rows (R, 64) float32, one dense
// 8x8 C tile per row with lanes indexed by intra-block address, and the
// rows' bitmap words and offsets (int64 each, hi/lo holding the unsigned
// 32-bit patterns; address a at bit 63 - a of hi:lo):
//     out[off[r] + rank_r(a)] = c_rows[r, a] for every set address a,
// rank_r(a) the set addresses of row r below a (__popcll of the bits
// above a's). Positions outside [0, n_valid) drop; [n_valid, nnz_pad) is
// written with zeros. Rows with a zero bitmap (sigma padding, whose
// c_rows may hold anything) read nothing and write nothing. The caller
// gives n_valid = nnz(C), whose positions the rows cover exactly once.
//
// What bounds it on the H100: device-memory bytes. Every row of c_rows is
// read once (at most 256 bytes, fewer where a 32-byte sector holds no set
// address), 24 bytes of bitmap and offset per row, every output value
// written once; no arithmetic to speak of.
//
// Design: each position has one writer, so there is no sort, no atomic
// and no sum, and the result is the same on every run. A warp takes 32
// rows at a time: lane j loads row j's bitmap and offset (coalesced), a
// ballot lists the rows with set bits, and for each, broadcast by shuffle,
// lane l loads the float2 of addresses 2l and 2l + 1 (only where one of
// its two bits is set) and stores each set lane at offset + rank. Eight
// rows' loads are issued before their stores, so each warp keeps several
// rows in flight; a block's about 14 values land in one run [off, off +
// cnt), so a warp's stores coalesce. Blocks grid-stride over the rows,
// as many as fill every SM, then over the zero tail.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;              // rows whose loads a warp issues together
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    bitmap_compress_kernel(const float* __restrict__ c_rows,
                           const int64_t* __restrict__ hi,
                           const int64_t* __restrict__ lo,
                           const int64_t* __restrict__ off, int64_t n_rows,
                           int64_t n_valid, int64_t nnz_pad,
                           float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int a0 = 2 * lane;             // this lane's addresses: a0, a0 + 1
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const float2* rows2 = reinterpret_cast<const float2*>(c_rows);
  for (int64_t base = warp * 32; base < n_rows; base += n_warps * 32) {
    const int64_t r = base + lane;
    unsigned long long mask = 0;
    int64_t off_r = 0;
    if (r < n_rows) {
      mask = (static_cast<unsigned long long>(
                  static_cast<uint32_t>(__ldg(hi + r))) << 32) |
             static_cast<uint32_t>(__ldg(lo + r));
      off_r = __ldg(off + r);
    }
    unsigned live = __ballot_sync(kFull, mask != 0);
    while (live) {                     // uniform over the warp
      float2 v[kBatch];
      unsigned long long m[kBatch];
      int64_t o[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = live ? __ffs(live) - 1 : 0;
        const bool any = live != 0;
        live &= live - 1;
        m[k] = __shfl_sync(kFull, mask, j);
        o[k] = __shfl_sync(kFull, off_r, j);
        if (!any) m[k] = 0;
        // bit 1: address a0 (bit 63 - a0); bit 0: address a0 + 1
        const unsigned pair = static_cast<unsigned>(m[k] >> (62 - a0)) & 3u;
        v[k] = pair ? __ldg(rows2 + (base + j) * 32 + lane)
                    : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const unsigned pair = static_cast<unsigned>(m[k] >> (62 - a0)) & 3u;
        if (pair == 0) continue;
        const int64_t p0 =
            o[k] + (a0 == 0 ? 0 : __popcll(m[k] >> (64 - a0)));
        if ((pair & 2u) && p0 >= 0 && p0 < n_valid) out[p0] = v[k].x;
        const int64_t p1 = p0 + (pair >> 1);
        if ((pair & 1u) && p1 >= 0 && p1 < n_valid) out[p1] = v[k].y;
      }
    }
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = n_valid + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < nnz_pad; i += stride) {
    out[i] = 0.f;
  }
}

// Blocks that fill every SM of the current device once, cached per device.
cudaError_t resident_blocks(int* blocks) {
  static int cache[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bitmap_compress_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
// c_rows must be 8-byte aligned; 0 <= n_valid <= nnz_pad.
extern "C" int bmsp_bitmap_compress(const void* c_rows, const void* hi,
                                    const void* lo, const void* off,
                                    int64_t n_rows, int64_t n_valid,
                                    int64_t nnz_pad, void* out,
                                    void* stream) {
  if (n_rows < 0 || n_valid < 0 || nnz_pad < n_valid) {
    return cudaErrorInvalidValue;
  }
  const int64_t tiles = (n_rows + 31) / 32;
  const int64_t tail = (nnz_pad - n_valid + kThreads - 1) / kThreads;
  int64_t blocks = (tiles + kWarps - 1) / kWarps;
  if (tail > blocks) blocks = tail;
  if (blocks == 0) return cudaSuccess;
  int fill = 0;
  const cudaError_t err = resident_blocks(&fill);
  if (err != cudaSuccess) return err;
  if (blocks > fill) blocks = fill;
  bitmap_compress_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c_rows), static_cast<const int64_t*>(hi),
      static_cast<const int64_t*>(lo), static_cast<const int64_t*>(off),
      n_rows, n_valid, nnz_pad, static_cast<float*>(out));
  return cudaGetLastError();
}
