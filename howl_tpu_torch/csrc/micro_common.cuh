// Shared pieces of the frontend cost study's stream kernels (micro_stream.cu:
// M1, the stream leg, and the bandwidth sweep's stream-repro entry): staging
// float32 spans of device memory into shared memory with cp.async. The
// study's products (micro_gemm.cu, micro_poly.cu) run on wgmma with bulk
// copies (hopper_async.cuh) and include nothing of this file.
//
// The study measures work whose results are mostly thrown away: the stream
// kernel stores a quarter of what it stages. The compilers must not throw
// the work away: every staged byte moves through a cp.async, which is an asm
// volatile with a memory clobber and is never eliminated, whoever reads the
// shared memory afterwards.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNfft = 512;            // frame width
constexpr int kOutCols = 128;         // columns of a row that are stored
constexpr int kStageFloats = 8192;    // one staging round: 32 KB of float32

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; with valid == false nothing is read and zeros are written
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage n floats (a multiple of 4) of src into `stage`, 16 bytes a cp.async,
// and wait for them; floats at or past n_valid are zero-filled without a
// read (`safe` is any readable address). Ends with a barrier.
__device__ __forceinline__ void stage_f32(float* stage, const float* src, const float* safe, int n,
                                          long long n_valid) {
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) {
    const bool valid = i + 4 <= n_valid;
    cp_async16(stage + i, valid ? src + i : safe, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace
