// GEMM legs (gemm1, gemm3) of the frontend cost study for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_pallas_micro.py, run_gemm (Pallas
// kernel gemm_kernel). For the frames tensor x (total, 512) float32 and
// W (512, 512) bf16 it computes
//
//     xb  = bf16(x + s)                      float32 add, round to nearest even
//     acc = sum over n_dots of xb @ W        the whole 512-wide product, float32 sums
//     out = acc[:, :128]                     (total, 128) float32
//
// The n_dots products are identical; the study times what each one adds.
//
// What bounds it on this card: per call it stages total * 2 KB and writes
// total * 512 bytes, like the stream kernel, and runs n_dots * total * 512
// * 512 * 2 floating-point operations on the tensor cores. At one product
// the two are about even; at three the tensor cores lead.
//
// What the design does about it: a block owns 64 rows. It stages them in
// four rounds of 16 rows through the stream kernel's cp.async code, rounds
// x + s to bf16 into a (64, 512) tile with rows padded to 520, and keeps that
// tile in shared memory for the whole call, so x is read from device memory
// once. Then product_512 (micro_common.cuh) walks W's columns in four
// chunks; within a chunk the accumulators run through all n_dots products,
// so every mma depends on the one before and none can be merged. Chunk 0 is
// stored; chunks 1-3 are stored under `keep`, which is 0 at run time, so the
// compiler has to compute them. 99 KB of shared memory and at most 128
// registers a thread let two blocks share an SM: one stages while the other
// multiplies.

#include "micro_common.cuh"

namespace {

constexpr int kAStride = kNfft + 8;  // 520 bf16 per tile row
constexpr size_t kSmemBytes = static_cast<size_t>(kBM) * kAStride * sizeof(__nv_bfloat16) + kScratchBytes;

__global__ void __launch_bounds__(kThreads, 2)
micro_gemm_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int total,
                  float s, int n_dots, int keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* scratch = smem_raw + static_cast<size_t>(kBM) * kAStride * sizeof(__nv_bfloat16);
  const int r0 = blockIdx.x * kBM;
  stage_convert(x + static_cast<size_t>(r0) * kNfft, kBM * kNfft, static_cast<long long>(total - r0) * kNfft,
                reinterpret_cast<float*>(scratch), s,
                [&](int e) { return a_s + (e / kNfft) * kAStride + (e % kNfft); });
  product_512<kAStride, true>(a_s, reinterpret_cast<__nv_bfloat16*>(scratch), w,
                              out + static_cast<size_t>(r0) * kOutCols, total - r0, n_dots, keep);
}

}  // namespace

// x (total, 512) float32 and w (512, 512) bf16, both 16-byte aligned; out
// (total, 128) float32. All contiguous. keep must be 0. Returns
// cudaGetLastError() after the launch.
extern "C" int howl_micro_gemm_forward(const void* x, const void* w, void* out, int total, float s, int n_dots,
                                       int keep, void* stream) {
  if (total == 0) return 0;
  if (total < 0 || n_dots < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(micro_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (static_cast<unsigned>(total) + kBM - 1) / kBM;
  micro_gemm_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), total, s, n_dots,
      keep);
  return static_cast<int>(cudaGetLastError());
}
