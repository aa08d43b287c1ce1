// Shared pieces of the device-memory bandwidth sweep's kernels
// (hbm_auto_read.cu, hbm_auto_copy.cu, hbm2hbm.cu and the second entry of
// micro_stream.cu), everything in namespace hbm so that a source may include
// micro_common.cuh beside it.
//
// Two asynchronous copy paths of an SM, which are what the sweep measures:
//
//   1. cp.async: every thread copies 16 bytes from device to shared memory
//      without a register in between, commits its copies as a group and
//      waits for groups. `walk_block` walks one block of the sweep (bn rows
//      of the array, a contiguous span of bytes) through a ring of kStages
//      shared-memory stages of kStageBytes with it, any element size: while
//      the block consumes stage i, the copies of stages i + 1 .. i +
//      kStages - 1 are in flight. Every staged byte moves through an
//      asm volatile cp.async with a memory clobber, which no compiler
//      drops, whoever reads the shared memory afterwards: the read kernel
//      never reads all but 8 x 128 elements of a block again.
//
//   2. bulk asynchronous copies (cp.async.bulk): one thread asks for a span
//      of bytes to be copied device -> shared memory, completion counted in
//      bytes on an mbarrier, or shared -> device memory, completion tracked
//      in bulk groups. No thread loads a byte. The helpers below are an
//      mbarrier (init, arrive.expect_tx, a wait on the phase parity that
//      traps instead of hanging), the two copies, and the group commit and
//      waits. Sizes and both addresses of a bulk copy are multiples of 16.
//
// The scalar add of the sweep, `add16`, on 16 bytes: float32 is one
// __fadd_rn per element; bf16 widens, adds in float32 the scalar that the
// caller has rounded to bf16 (`bf16_round`), and rounds to nearest even,
// which is what a bf16 + bf16 add computes. No FMA can form: there is no
// multiply.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hbm {

constexpr int kThreads = 256;
constexpr int kCols = 512;            // columns of the sweep's array
constexpr int kCornerRows = 8;        // the corner a read block stores
constexpr int kCornerCols = 128;      // and the columns the stream leg stores
constexpr int kStageBytes = 32768;    // 16 float32 rows or 32 bf16 rows
constexpr int kStages = 3;            // two CTAs of 96 KB share an SM
constexpr int kRingBytes = kStages * kStageBytes;
constexpr unsigned long long kWaitLimitNs = 2000000000ull;  // an mbarrier wait longer than 2 s traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async, 16 bytes a thread ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Walk n_bytes (a multiple of 16) from src through the ring, stage by stage.
// consume(stage, base, m) is called by every thread once per stage, after
// the stage's m bytes, which start at byte `base` of the span, have landed
// and a barrier made them visible. The walk returns when the last stage has
// landed, whether or not consume read it.
template <class Consume>
__device__ __forceinline__ void walk_block(unsigned char* ring, const unsigned char* src, long long n_bytes,
                                           Consume consume) {
  const int n_stages = static_cast<int>((n_bytes + kStageBytes - 1) / kStageBytes);
  auto stage_bytes = [&](int st) {
    const long long left = n_bytes - static_cast<long long>(st) * kStageBytes;
    return left < kStageBytes ? static_cast<int>(left) : kStageBytes;
  };
  auto start_stage = [&](int st) {
    unsigned char* dst = ring + (st % kStages) * kStageBytes;
    const unsigned char* from = src + static_cast<long long>(st) * kStageBytes;
    const int m = stage_bytes(st);
    for (int i = threadIdx.x * 16; i < m; i += kThreads * 16) cp_async16(dst + i, from + i);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) start_stage(st);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i has landed, and everyone is done with the stage refilled below
    if (i + kStages - 1 < n_stages) start_stage(i + kStages - 1);
    cp_async_commit();
    consume(ring + (i % kStages) * kStageBytes, static_cast<long long>(i) * kStageBytes, stage_bytes(i));
  }
  cp_async_wait<0>();
}

// One CTA of kThreads per block of bn rows, the ring as its dynamic shared
// memory. Returns cudaGetLastError() after the launch, or the error of the
// shared-memory attribute call; rows that are no whole number of blocks, or
// blocks lower than the corner, are cudaErrorInvalidValue.
template <class... Params, class... Args>
inline int launch_block_walk(void (*kernel)(Params...), int rows, int bn, void* stream, Args... args) {
  if (rows < 0 || bn < kCornerRows || rows % bn != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(rows / bn), kThreads, kRingBytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// ---- the scalar add ----

__device__ __forceinline__ float bf16_round(float s) { return __bfloat162float(__float2bfloat16_rn(s)); }

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t w, float s) {
  const float lo = __uint_as_float(w << 16);
  const float hi = __uint_as_float(w & 0xffff0000u);
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fadd_rn(lo, s), __fadd_rn(hi, s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// v + s on 16 bytes: four float32, or eight bf16 with s already a bf16 value
template <bool kBf16>
__device__ __forceinline__ uint4 add16(uint4 v, float s) {
  if constexpr (kBf16) {
    v.x = add_bf16x2(v.x, s);
    v.y = add_bf16x2(v.y, s);
    v.z = add_bf16x2(v.z, s);
    v.w = add_bf16x2(v.w, s);
  } else {
    v.x = __float_as_uint(__fadd_rn(__uint_as_float(v.x), s));
    v.y = __float_as_uint(__fadd_rn(__uint_as_float(v.y), s));
    v.z = __float_as_uint(__fadd_rn(__uint_as_float(v.z), s));
    v.w = __float_as_uint(__fadd_rn(__uint_as_float(v.w), s));
  }
  return v;
}

// ---- mbarrier and bulk asynchronous copies; called by one thread ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
}

// after the inits, before anyone (the async proxy included) uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, and `bytes` more to be counted off by bulk copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. The caller keeps
// one phase bit per barrier, starting at 0, and flips it after every wait.
// A wrong bit would wait for ever; here it traps after kWaitLimitNs, so the
// launch fails with an error at the next synchronisation.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > kWaitLimitNs) __trap();
  }
}

// generic-proxy writes to shared memory (data, or an mbarrier's init), before the bulk copies' proxy touches them
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// device -> shared memory; the bytes are counted off on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// shared -> device memory, part of the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// all but the newest kPending bulk groups have finished READING shared memory: their slots may be refilled
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// all but the newest kPending bulk groups are complete, their writes to device memory included
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace hbm
