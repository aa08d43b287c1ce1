// Shared pieces of the device-memory bandwidth sweep's kernels
// (hbm_auto_read.cu, hbm_auto_copy.cu, hbm2hbm.cu, hbm_manual_read.cu,
// hbm_manual_write.cu, hbm_manual_copy.cu and the second entry of
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
//      in bulk groups. No thread loads a byte. The helpers are
//      hopper_async.cuh's: an mbarrier (init, arrive.expect_tx, a wait on the
//      phase parity that traps instead of hanging), the two copies, and the
//      group commit and waits. Sizes and both addresses of a bulk copy are
//      multiples of 16.
//      The manual read and write walk a chunk of cb rows through a ring of k
//      slots of kRingStageBytes with them, k a run-time number (`RingWalk`,
//      `launch_ring`): one CTA per chunk, the ring its dynamic shared memory.
//      The manual copy and the whole-array copy instead sweep the array's
//      stages with a persistent grid, stage j to CTA j % CTAs (`StageSweep`,
//      `ring_grid`), so that neighbouring CTAs copy neighbouring stages.
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

#include <atomic>

#include "hopper_async.cuh"

namespace hbm {

constexpr int kThreads = 256;
constexpr int kCols = 512;            // columns of the sweep's array
constexpr int kCornerRows = 8;        // the corner a read block stores
constexpr int kCornerCols = 128;      // and the columns the stream leg stores
constexpr int kStageBytes = 32768;    // 16 float32 rows or 32 bf16 rows
constexpr int kStages = 3;            // two CTAs of 96 KB share an SM
constexpr int kRingBytes = kStages * kStageBytes;

using hopper::smem_u32;

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

// ---- mbarrier and bulk asynchronous copies: hopper_async.cuh's, under this namespace's names ----

using hopper::bulk_commit;
using hopper::bulk_load;
using hopper::bulk_load_hint;
using hopper::bulk_prefetch_l2;
using hopper::bulk_store;
using hopper::bulk_store_hint;
using hopper::bulk_wait;
using hopper::bulk_wait_read;
using hopper::fence_proxy_async;
using hopper::l2_evict_first;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_try_wait;
using hopper::mbar_wait;

// cp.async.bulk.wait_group.read takes an immediate; a run-time ring depth picks its instance here
__device__ __forceinline__ void bulk_wait_read_upto(int pending) {
  switch (pending) {
    case 0: bulk_wait_read<0>(); break;
    case 1: bulk_wait_read<1>(); break;
    case 2: bulk_wait_read<2>(); break;
    case 3: bulk_wait_read<3>(); break;
    case 4: bulk_wait_read<4>(); break;
    case 5: bulk_wait_read<5>(); break;
    case 6: bulk_wait_read<6>(); break;
    case 7: bulk_wait_read<7>(); break;
    default: __trap();
  }
}

// ---- the manual legs' ring: k slots of one fixed stage size, k at run time ----

constexpr int kRingStageBytes = 16384;  // 8 float32 rows: a chunk's corner lies in its first stage
constexpr int kMinRingSlots = 2;        // the read runs k - 1 copies ahead of the one it waits for
constexpr int kMaxRingSlots = 8;        // 128 KB of an SM's 227 KB
constexpr int kDoneFloats = kCornerRows * kCornerCols;

// One CTA's chunk as stages of the ring: stage i is bytes [i * kRingStageBytes, ...) of the chunk and lives in
// slot i % k. The last stage of a chunk that is no whole number of stages is short; expect_tx and the copy take
// the same count, a multiple of 16 because a row is.
struct RingWalk {
  unsigned char* ring;
  long long chunk_bytes;
  int k;

  __device__ __forceinline__ int n_stages() const {
    return static_cast<int>((chunk_bytes + kRingStageBytes - 1) / kRingStageBytes);
  }
  __device__ __forceinline__ uint32_t stage_bytes(int i) const {
    const long long left = chunk_bytes - static_cast<long long>(i) * kRingStageBytes;
    return static_cast<uint32_t>(left < kRingStageBytes ? left : kRingStageBytes);
  }
  __device__ __forceinline__ unsigned char* slot(int i) const { return ring + (i % k) * kRingStageBytes; }
  // device -> slot of stage i, counted off on that slot's barrier; one thread
  __device__ __forceinline__ void load(int i, const unsigned char* chunk, uint64_t* full) const {
    mbar_arrive_expect_tx(&full[i % k], stage_bytes(i));
    bulk_load(slot(i), chunk + static_cast<long long>(i) * kRingStageBytes, stage_bytes(i), &full[i % k]);
  }
  // slot of stage i -> device, as a bulk group of its own; one thread
  __device__ __forceinline__ void store(int i, unsigned char* chunk) const {
    bulk_store(chunk + static_cast<long long>(i) * kRingStageBytes, slot(i), stage_bytes(i));
    bulk_commit();
  }
};

// ---- the two copies' sweep: the array's stages spread over a persistent grid ----

// The array is cut into chunks and each chunk into stages of at most `stage_bytes` (a chunk's last stage may be
// short), numbered in address order. Stage j belongs to CTA j % G of a grid of G: at any moment the grid works on a
// window of neighbouring stages, neighbouring CTAs at neighbouring addresses, as a plain copy kernel's grid sweeps
// an array. CTA g's m-th stage is g + m G.
struct StageSweep {
  long long chunk_bytes;
  long long n_stages;
  int stage_bytes;
  int stages_per_chunk;

  __host__ __device__ StageSweep(long long n_bytes, long long chunk, int stage)
      : chunk_bytes(chunk),
        n_stages(chunk > 0 ? n_bytes / chunk * ((chunk + stage - 1) / stage) : 0),
        stage_bytes(stage),
        stages_per_chunk(static_cast<int>((chunk + stage - 1) / stage)) {}
  __device__ __forceinline__ long long offset(long long j) const {
    return j / stages_per_chunk * chunk_bytes + j % stages_per_chunk * stage_bytes;
  }
  __device__ __forceinline__ uint32_t bytes(long long j) const {
    const long long left = chunk_bytes - j % stages_per_chunk * stage_bytes;
    return static_cast<uint32_t>(left < stage_bytes ? left : stage_bytes);
  }
  // the stages of CTA g in a grid of G
  __device__ __forceinline__ long long count(long long g, long long G) const {
    return g < n_stages ? (n_stages - 1 - g) / G + 1 : 0;
  }
};

// k barriers of one arrival each, ready for the bulk copies' proxy; one thread, before a CTA barrier
__device__ __forceinline__ void ring_init_barriers(uint64_t* full, int k) {
  for (int slot = 0; slot < k; ++slot) mbar_init(&full[slot], 1);
  mbar_init_fence();
  fence_proxy_async();
}

__device__ __forceinline__ void fill_done(float* done, float s, int threads) {
  for (int i = threadIdx.x; i < kDoneFloats; i += threads) done[i] = s;
}

inline bool ring_args_ok(int rows, int cb, int k) {
  return rows >= 0 && cb >= kCornerRows && cb % kCornerRows == 0 && rows % cb == 0 && k >= kMinRingSlots &&
         k <= kMaxRingSlots;
}

// A ring deeper than 48 KB needs the kernel's leave for it. Each kernel instance gets leave for the deepest ring
// once per device, not before every launch: the launches of a timed chain then make no other host call. Occupancy
// follows the bytes a launch asks for, not this ceiling.
constexpr int kMaxDevices = 64;

template <auto kKernel>
inline cudaError_t ring_allow_shared_memory() {
  static std::atomic<bool> allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxRingSlots * kRingStageBytes);
  if (err == cudaSuccess) allowed[dev].store(true, std::memory_order_release);
  return err;
}

// `ctas` CTAs of `threads` with a ring of k slots as dynamic shared memory. Returns cudaGetLastError() after the
// launch, or the error of the shared-memory attribute call.
template <auto kKernel, class... Args>
inline int launch_ring(long long ctas, int threads, int k, void* stream, Args... args) {
  const cudaError_t err = ring_allow_shared_memory<kKernel>();
  if (err != cudaSuccess) return static_cast<int>(err);
  kKernel<<<static_cast<unsigned>(ctas), threads, k * kRingStageBytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel that share an SM at ring depth k, by the occupancy calculator; minus the cudaError_t on failure
template <auto kKernel>
inline int ring_ctas_per_sm(int threads, int k) {
  if (k < kMinRingSlots || k > kMaxRingSlots) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  cudaError_t err = ring_allow_shared_memory<kKernel>();
  const int ring_bytes = k * kRingStageBytes;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kKernel, threads, ring_bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The persistent grid of a kernel whose CTAs sweep the stages of an array (`StageSweep`) at ring depth k, with
// `threads` a function of k: every CTA that fits the card at once, by the occupancy calculator, but no more CTAs than
// stages, and one for an empty array. Asked once per device and depth, so the launches of a timed chain make no
// other host call than cudaGetDevice. Minus the cudaError_t on failure.
template <auto kKernel>
inline long long ring_grid(int threads, int k, long long n_stages) {
  static std::atomic<long long> fits[kMaxDevices][kMaxRingSlots + 1] = {};
  if (k < kMinRingSlots || k > kMaxRingSlots) return -static_cast<long long>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (dev < 0 || dev >= kMaxDevices) return -static_cast<long long>(cudaErrorInvalidDevice);
  long long card = fits[dev][k].load(std::memory_order_acquire);
  if (card == 0) {
    const int per_sm = ring_ctas_per_sm<kKernel>(threads, k);
    if (per_sm < 0) return per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    card = static_cast<long long>(sms) * per_sm;
    fits[dev][k].store(card, std::memory_order_release);
  }
  return n_stages < card ? (n_stages > 0 ? n_stages : 1) : card;
}

}  // namespace hbm
