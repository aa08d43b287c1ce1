// Copy leg of the device-memory bandwidth sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_hbm_sweep.py, make_auto_copy (Pallas
// kernel `kernel`, grid of (bn, 512) blocks in and out): out = x + s over
// the whole array x (rows, 512), float32 or bf16, which the TPU kernel walks
// block by block; out has x's shape and dtype.
//
// What bounds it on this card: device memory, one read and one write of the
// array; one add per element is nothing beside them.
//
// What the design does about it. The TPU kernel's ring of blocks is how a TPU
// core hides the latency of its memory; on this card warps with loads in
// flight do that, and the shape that moves a read and a write fastest is the
// plain elementwise kernel's, not a ring. The array is cut into stages of
// 8 KB in address order, two 16-byte pieces for each of a CTA's 256 threads,
// and the grid is one CTA a stage: the block scheduler hands the stages to
// the SMs in address order as CTAs retire, so neighbouring CTAs work on
// neighbouring addresses and every SM stays busy whatever the block height.
// A block of bn rows is a whole number of stages (8 rows of bf16 are 8 KB),
// so no stage straddles two blocks: bn only says where stages end. A thread
// loads its two pieces straight into registers (ld.global.nc, no L1
// allocation), adds s and stores them; nothing passes through shared memory.
// Each CTA asks for shared memory that it leaves unused, so that four CTAs
// share an SM: 32 KB of loads in flight an SM, which the card serves faster
// than eight CTAs' 64 KB. Loads and stores carry an L2 evict-first policy:
// nothing reads the streamed lines again. Each choice was measured against
// the others (probe_kernel_variants --probe auto-copy); a persistent grid of
// every CTA that fits the card, sweeping the stages, was slower.
//
// The add is one __fadd_rn in float32; in bf16 s is rounded to bf16 first and
// the float32 sum rounded to nearest even: bitwise what the plain version
// computes.

#include "hbm_common.cuh"

namespace {

using namespace hbm;

constexpr int kCopyThreads = 256;
constexpr int kCopyLoads = 2;  // 16-byte loads a thread, both issued before either store
constexpr int kCopyStageBytes = kCopyThreads * kCopyLoads * 16;
constexpr int kCopyCtasPerSm = 4;
static_assert(kCornerRows * kCols * 2 % kCopyStageBytes == 0, "a block of 8 bf16 rows is a whole number of stages");

// 16 bytes device memory -> registers by the non-coherent path, without allocating in the L1, under an L2 policy
__device__ __forceinline__ uint4 load_streamed(const uint4* src, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(src), "l"(policy));
  return v;
}

// 16 bytes registers -> device memory under an L2 policy
__device__ __forceinline__ void store_streamed(uint4* dst, uint4 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w), "l"(policy)
               : "memory");
}

template <bool kBf16>
__global__ void __launch_bounds__(kCopyThreads)
hbm_auto_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long n_stages, float s) {
  if (kBf16) s = bf16_round(s);
  const uint64_t policy = l2_evict_first();
  // a grid-stride loop, so any grid covers the array; the launch gives each stage a CTA of its own
  for (long long j = blockIdx.x; j < n_stages; j += gridDim.x) {
    const long long i = j * (kCopyStageBytes / 16) + threadIdx.x;
    uint4 v[kCopyLoads];
    for (int u = 0; u < kCopyLoads; ++u) v[u] = load_streamed(x + i + u * kCopyThreads, policy);
    for (int u = 0; u < kCopyLoads; ++u) store_streamed(out + i + u * kCopyThreads, add16<kBf16>(v[u], s), policy);
  }
}

// The dynamic shared memory, left unused, that holds an SM to kCopyCtasPerSm CTAs of the kernel: the SM's shared
// memory over that count, less what the card keeps back for each CTA. Asked once per device, with the kernel's leave
// for it; minus the cudaError_t on failure.
template <auto kKernel>
inline int occupancy_cap_bytes() {
  static std::atomic<int> cached[kMaxDevices] = {};
  int dev = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  int bytes = cached[dev].load(std::memory_order_acquire);
  if (bytes > 0) return bytes;
  err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  bytes = per_sm / kCopyCtasPerSm - reserved;
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cached[dev].store(bytes, std::memory_order_release);
  return bytes;
}

template <bool kBf16>
int launch_auto_copy(const void* x, void* out, int rows, int bn, float s, void* stream) {
  const long long blocks = rows / bn;
  const long long stages_per_block = static_cast<long long>(bn) * kCols * (kBf16 ? 2 : 4) / kCopyStageBytes;
  const long long n_stages = blocks * stages_per_block;
  const int cap_bytes = occupancy_cap_bytes<hbm_auto_copy_kernel<kBf16>>();
  if (cap_bytes < 0) return -cap_bytes;
  const long long ctas = n_stages;
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  hbm_auto_copy_kernel<kBf16><<<static_cast<unsigned>(ctas), kCopyThreads, cap_bytes, on>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n_stages, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out (rows, 512) float32 or bf16 (is_bf16), 16-byte aligned and
// contiguous, bn a multiple of 8 and rows a multiple of bn. Returns
// cudaGetLastError() after the launch, or the error of a shared-memory
// query; other arguments are cudaErrorInvalidValue.
extern "C" int howl_hbm_auto_copy_forward(const void* x, void* out, int rows, int bn, int is_bf16, float s,
                                          void* stream) {
  if (rows < 0 || bn < kCornerRows || bn % kCornerRows != 0 || rows % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  return is_bf16 ? launch_auto_copy<true>(x, out, rows, bn, s, stream)
                 : launch_auto_copy<false>(x, out, rows, bn, s, stream);
}
