// Read leg of the device-memory bandwidth sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_hbm_sweep.py, make_auto_read (Pallas
// kernel `kernel`, grid of (bn, 512) blocks): every block of bn rows of x
// (rows, 512), float32 or bf16, is brought on chip whole, and block i writes
// x[i * bn : i * bn + 8, :128] + s to rows [8 i, 8 i + 8) of out
// (rows / bn * 8, 128), in x's dtype.
//
// What bounds it on this card: device memory. The leg's work is one read of
// the whole array; the function itself needs only the corners, so the leg is
// bound by what it stages, far above the bound of the function.
//
// What the design does about it: one CTA owns one block and walks it through
// a three-stage ring of 32 KB in shared memory with 16-byte cp.async copies
// (hbm_common.cuh, walk_block), two stages in flight while it waits for the
// third. Nothing reads the staged bytes but the corner, which lies in the
// block's first stage; cp.async is an asm volatile that the compiler cannot
// drop, and the kernel waits for the block's last stage before it exits.
// The block height bn sets the grid: rows / bn CTAs, two to an SM. A high
// block leaves SMs without work (32 CTAs at bn = 4096 and 256 MB on 132
// SMs); that is what the sweep is there to show.

#include "hbm_common.cuh"

namespace {

using namespace hbm;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
hbm_auto_read_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out, int bn, float s) {
  extern __shared__ __align__(128) unsigned char ring[];
  constexpr int kRowBytes = kCols * (kBf16 ? 2 : 4);
  constexpr int kOutRowBytes = kCornerCols * (kBf16 ? 2 : 4);
  constexpr int kChunksPerRow = kOutRowBytes / 16;
  const long long block_bytes = static_cast<long long>(bn) * kRowBytes;
  unsigned char* dst = out + static_cast<long long>(blockIdx.x) * kCornerRows * kOutRowBytes;
  if (kBf16) s = bf16_round(s);
  walk_block(ring, x + blockIdx.x * block_bytes, block_bytes, [&](const unsigned char* stage, long long base, int) {
    if (base != 0) return;  // the corner is in the first stage: 8 rows are at most 16 KB
    for (int c = threadIdx.x; c < kCornerRows * kChunksPerRow; c += kThreads) {
      const int row = c / kChunksPerRow;
      const int q = (c % kChunksPerRow) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + row * kRowBytes + q);
      *reinterpret_cast<uint4*>(dst + row * kOutRowBytes + q) = add16<kBf16>(v, s);
    }
  });
}

}  // namespace

// x (rows, 512) float32 or bf16 (is_bf16), 16-byte aligned, rows a multiple
// of bn and bn at least 8; out (rows / bn * 8, 128) in x's dtype. Both
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int howl_hbm_auto_read_forward(const void* x, void* out, int rows, int bn, int is_bf16, float s,
                                          void* stream) {
  const unsigned char* src = static_cast<const unsigned char*>(x);
  unsigned char* dst = static_cast<unsigned char*>(out);
  return is_bf16 ? launch_block_walk(hbm_auto_read_kernel<true>, rows, bn, stream, src, dst, bn, s)
                 : launch_block_walk(hbm_auto_read_kernel<false>, rows, bn, stream, src, dst, bn, s);
}
