// Copy leg of the device-memory bandwidth sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_hbm_sweep.py, make_auto_copy (Pallas
// kernel `kernel`, grid of (bn, 512) blocks in and out): out = x + s over
// the whole array x (rows, 512), float32 or bf16, block by block; out has
// x's shape and dtype.
//
// What bounds it on this card: device memory, one read and one write of the
// array; one add per element is nothing beside them.
//
// What the design does about it: one CTA owns one block of bn rows and walks
// it through a three-stage ring of 32 KB in shared memory with 16-byte
// cp.async copies (hbm_common.cuh, walk_block). Each thread then reads 16
// bytes of the landed stage, adds s and stores 16 bytes, neighbouring threads
// to neighbouring addresses; the loads of the next two stages are in flight
// while the block stores this one. The block height bn sets the grid:
// rows / bn CTAs, two to an SM, so a high block leaves SMs without work.
// The add is one __fadd_rn in float32; in bf16 s is rounded to bf16 first and
// the float32 sum rounded to nearest even: bitwise what the plain version
// computes.

#include "hbm_common.cuh"

namespace {

using namespace hbm;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
hbm_auto_copy_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out, int bn, float s) {
  extern __shared__ __align__(128) unsigned char ring[];
  const long long block_bytes = static_cast<long long>(bn) * kCols * (kBf16 ? 2 : 4);
  unsigned char* dst = out + blockIdx.x * block_bytes;
  if (kBf16) s = bf16_round(s);
  walk_block(ring, x + blockIdx.x * block_bytes, block_bytes, [&](const unsigned char* stage, long long base, int m) {
    for (int i = threadIdx.x * 16; i < m; i += kThreads * 16)
      *reinterpret_cast<uint4*>(dst + base + i) = add16<kBf16>(*reinterpret_cast<const uint4*>(stage + i), s);
  });
}

}  // namespace

// x and out (rows, 512) float32 or bf16 (is_bf16), 16-byte aligned and
// contiguous, rows a multiple of bn and bn at least 8. Returns
// cudaGetLastError() after the launch.
extern "C" int howl_hbm_auto_copy_forward(const void* x, void* out, int rows, int bn, int is_bf16, float s,
                                          void* stream) {
  const unsigned char* src = static_cast<const unsigned char*>(x);
  unsigned char* dst = static_cast<unsigned char*>(out);
  return is_bf16 ? launch_block_walk(hbm_auto_copy_kernel<true>, rows, bn, stream, src, dst, bn, s)
                 : launch_block_walk(hbm_auto_copy_kernel<false>, rows, bn, stream, src, dst, bn, s);
}
