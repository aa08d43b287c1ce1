// Hopper's asynchronous machinery as inline PTX, shared by the bandwidth
// sweep's kernels (through hbm_common.cuh), the tensor-core log-mel frontend
// (frontend_tc.cu), the stem fold proto (stem_fold.cu), the trunk proto
// (trunk_proto.cu), the frontend study's GEMM (micro_gemm.cu) and the fused
// int8 trunk (int8_trunk_fused.cu). Everything
// lives in namespace hopper, so that a source may include micro_common.cuh
// beside it.
//
//   1. mbarrier: init, arrive, arrive.expect_tx and a wait on the phase
//      parity that traps instead of hanging.
//   2. Bulk asynchronous copies (cp.async.bulk): one thread asks for a span
//      of bytes to be copied device -> shared memory, completion counted in
//      bytes on an mbarrier, or shared -> device memory, completion tracked in
//      bulk groups. No thread loads a byte. Sizes and both addresses of a bulk
//      copy are multiples of 16. Either copy may carry an L2 cache policy
//      (createpolicy), such as evict-first for data streamed once; a bulk
//      prefetch brings a span into the L2 alone.
//   3. Warpgroup matrix products (wgmma, sm_90a only): four warps start
//      D (64, N) += A (64, 16) @ B (16, N) in bf16 with float32 sums, A from
//      registers ("rs") or from shared memory ("ss"), B from shared memory,
//      each operand in shared memory through a 64-bit descriptor; and
//      D (64, N) += A (64, 32) @ B (32, N) in s8 with s32 sums, both operands
//      from shared memory.
//
// The wgmma operand layouts used here (PTX ISA, "Asynchronous warpgroup
// level matrix operations"), with w = warp of the warpgroup, g = lane / 4,
// t = lane % 4:
//
//   A (64, 16) in registers, four 32-bit registers of two bf16 each, the
//   lower column in the lower half:
//     a0 = A[16w + g    ][2t, 2t + 1]    a1 = A[16w + g + 8][2t, 2t + 1]
//     a2 = A[16w + g    ][2t + 8, + 9]   a3 = A[16w + g + 8][2t + 8, + 9]
//
//   D (64, N) in registers, N / 2 float32 a thread:
//     d[4j + 0], d[4j + 1] = D[16w + g    ][8j + 2t, 8j + 2t + 1]
//     d[4j + 2], d[4j + 3] = D[16w + g + 8][8j + 2t, 8j + 2t + 1]
//   so the pair (d[4j], d[4j + 1]) of a product is, rounded to bf16 and
//   packed, the a0 or a2 of a following product whose k runs over D's columns.
//
//   B (16, N) in shared memory, "K-major" without swizzle: core matrices of
//   8 columns n by 8 consecutive k, 128 contiguous bytes each (column n of
//   the core at byte 16 * (n % 8), its eight k in order). The descriptor
//   holds the first core's address, the byte offset between the two cores
//   that are neighbours in k (the "leading" offset) and between cores that
//   are neighbours in n (the "stride" offset), all in units of 16 bytes.
//   A (64, 16) in shared memory is described the same way, its rows m in
//   place of the columns n: a core is 8 rows by 8 consecutive k.
//
//   An s8 operand K-major without swizzle is laid out in the same bytes: a
//   core matrix is 8 rows by 16 consecutive k (one byte each), 128
//   contiguous bytes, so a k32 step spans two cores along k (the leading
//   offset apart). The PTX ISA takes 8-bit operands K-major only, with no
//   transpose and no scale on A or B; N = 48 is one of the shapes it lists
//   for .s8 (8, 16, 24 and the multiples of 16 from 32 to 256). The s32
//   sums sit in D's registers as the float32 sums do.
//
//   Either operand "K-major" in the 128-byte swizzle: a row (of n for B, of
//   m for A) holds 64 consecutive k in 128 bytes, eight rows make a
//   1,024-byte atom whose 16-byte chunks are permuted by chunk ^ (row % 8),
//   atoms follow each other along the rows (the stride offset, 1,024 bytes)
//   and a k16 step within the atom moves the start by 32 bytes. The swizzle
//   is a function of address bits 4-9: each 64-k block of such an operand
//   starts on a 1,024-byte boundary.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr unsigned long long kWaitLimitNs = 2000000000ull;  // an mbarrier wait longer than 2 s traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier; init and the arrivals are called by one thread each ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
}

// after the inits, before anyone (the async proxy included) uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// ---- bulk asynchronous copies; called by one thread ----

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

// An L2 cache policy that puts the lines it touches first in line for eviction: data streamed once, which
// nothing reads again, need not push anything else out of the L2.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// bulk_load and bulk_store under an L2 cache policy
__device__ __forceinline__ void bulk_load_hint(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store_hint(void* dst, const void* src, uint32_t bytes, uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes), "l"(policy)
               : "memory");
}

// device memory -> L2 only, with nothing to wait for: a bulk_load of the same span soon after finds it there
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
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

// ---- wgmma; every call is made by all 128 threads of a warpgroup ----

// before the first wgmma, and whenever ordinary code has written registers that a wgmma reads or accumulates into
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

// the wgmma started since the last commit become one group
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// all but the newest kPending groups are complete: their sums are in the registers, their operands free
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Registers that a wgmma in flight reads or writes, named after the wait: the compiler then neither moves a use
// of them above the wait nor gives their registers to another value before it.
template <int kN>
__device__ __forceinline__ void wgmma_keep(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_keep(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_keep(int (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The descriptor of a K-major operand without swizzle (see the top of the file): bits 0-13 the address, 16-29 the
// offset between cores that are neighbours in k, 32-45 between cores that are neighbours in n, each >> 4; the
// base offset (49-51) and the swizzle mode (62-63) are 0.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr, uint32_t k_core_bytes, uint32_t n_core_bytes) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(k_core_bytes >> 4) << 16) |
         (static_cast<uint64_t>(n_core_bytes >> 4) << 32);
}

// The descriptor of a K-major operand in the 128-byte swizzle (see the top of the file); the leading offset is
// unused.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

#define HOWL_ACC8(d, b)                                                                                     \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), \
      "+f"(d[b + 7])
#define HOWL_ACC32(d, b) HOWL_ACC8(d, b), HOWL_ACC8(d, b + 8), HOWL_ACC8(d, b + 16), HOWL_ACC8(d, b + 24)
#define HOWL_ACC24(d) HOWL_ACC8(d, 0), HOWL_ACC8(d, 8), HOWL_ACC8(d, 16)
#define HOWL_IACC8(d, b)                                                                                    \
  "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), "+r"(d[b + 6]), \
      "+r"(d[b + 7])
#define HOWL_IACC24(d) HOWL_IACC8(d, 0), HOWL_IACC8(d, 8), HOWL_IACC8(d, 16)

// d (64, 48) = a (64, 16) @ b (16, 48) + (scale_d ? d : 0): bf16 operands, float32 sums, a from registers
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : HOWL_ACC24(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// the same with a from shared memory, K-major, through its descriptor
__device__ __forceinline__ void wgmma_m64n48k16_ss(float (&d)[24], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : HOWL_ACC24(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64, 48) = a (64, 32) @ b (32, 48) + (scale_d ? d : 0): s8 operands, s32 sums, both from shared memory,
// K-major through their descriptors
__device__ __forceinline__ void wgmma_m64n48k32_s8_ss(int (&d)[24], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23}, %24, %25, p;\n}\n"
      : HOWL_IACC24(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64, 128) = a (64, 16) @ b (16, 128) + (scale_d ? d : 0): bf16 operands, float32 sums, a from registers
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : HOWL_ACC32(d, 0), HOWL_ACC32(d, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// d (64, 256) = a (64, 16) @ b (16, 256) + (scale_d ? d : 0): bf16 operands, float32 sums, both from shared memory
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : HOWL_ACC32(d, 0), HOWL_ACC32(d, 32), HOWL_ACC32(d, 64), HOWL_ACC32(d, 96)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64, 256) = a (64, 16) @ b (16, 256) + (scale_d ? d : 0): bf16 operands, float32 sums, a from registers,
// b K-major in shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : HOWL_ACC32(d, 0), HOWL_ACC32(d, 32), HOWL_ACC32(d, 64), HOWL_ACC32(d, 96)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// the same at N = 40
__device__ __forceinline__ void wgmma_m64nNk16(float (&d)[20], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : HOWL_ACC8(d, 0), HOWL_ACC8(d, 8), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// and at N = 80
__device__ __forceinline__ void wgmma_m64nNk16(float (&d)[40], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : HOWL_ACC32(d, 0), HOWL_ACC8(d, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

#undef HOWL_IACC24
#undef HOWL_IACC8
#undef HOWL_ACC24
#undef HOWL_ACC32
#undef HOWL_ACC8

}  // namespace hopper
