// Whole-array copy leg of the device-memory bandwidth sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_hbm_sweep.py, hbm2hbm (Pallas kernel
// `kernel`): one device-memory to device-memory copy of the whole array with
// no arithmetic, started and waited for by the kernel, no core touching the
// data; the kernel also returns `done`, (8, 128) float32 filled with s.
//
// What bounds it on this card: device memory, one read and one write of the
// array.
//
// What the design does about it: an SM has no engine that copies device
// memory to device memory, so the nearest thing is the bulk asynchronous
// copy, relayed through shared memory. The array is cut into stages of 32 KB
// in address order, and a persistent grid of two CTAs for each SM sweeps
// them: stage j belongs to CTA j % G (`StageSweep`), so at any moment
// neighbouring CTAs copy neighbouring stages, as a plain copy kernel's grid
// sweeps an array, and the device memory serves reads and writes in one
// narrow window of addresses rather than in one region per CTA. Each CTA
// relays its stages through a ring of three 32 KB slots: cp.async.bulk
// device -> shared memory, its bytes counted off on the slot's mbarrier, then
// cp.async.bulk shared -> device memory in a bulk group. One thread of the
// CTA starts both and waits; no thread loads a byte into a register. Per
// slot the thread keeps the mbarrier's phase bit and flips it after every
// wait; before a slot is refilled, cp.async.bulk.wait_group.read makes sure
// the store that reads it has read it. Stage m's store goes first and the
// slot of stage m - 1 is refilled after, so two loads and up to two stores
// are in flight per CTA. Each load also prefetches the CTA's next stage into
// the L2 (cp.async.bulk.prefetch.L2), so that stage's read from device memory
// starts one refill before its slot is free. Loads and stores carry an L2
// evict-first policy: nothing reads the streamed lines again. Block 0 also
// fills `done`.

#include "hbm_common.cuh"

namespace {

using namespace hbm;

constexpr int kSlots = kStages;
constexpr int kSlotBytes = kStageBytes;
constexpr int kCopyThreads = 32;  // lane 0 starts the copies; block 0's lanes fill `done`
constexpr int kCtasPerSm = 2;

__global__ void __launch_bounds__(kCopyThreads)
hbm2hbm_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out, float* __restrict__ done,
               StageSweep sweep, float s) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kSlots];
  if (blockIdx.x == 0) fill_done(done, s, kCopyThreads);
  if (threadIdx.x != 0) return;

  const long long ctas = gridDim.x;
  const long long n = sweep.count(blockIdx.x, ctas);  // this CTA's stages
  auto stage = [&](long long m) { return blockIdx.x + m * ctas; };  // its m-th, in the array's order
  const uint64_t policy = l2_evict_first();
  auto load = [&](long long m) {
    const int slot = static_cast<int>(m % kSlots);
    const long long j = stage(m);
    mbar_arrive_expect_tx(&full[slot], sweep.bytes(j));
    bulk_load_hint(ring + slot * kSlotBytes, x + sweep.offset(j), sweep.bytes(j), &full[slot], policy);
    // the next stage into the L2: its read from device memory starts a refill before its slot is free
    if (m + 1 < n) bulk_prefetch_l2(x + sweep.offset(stage(m + 1)), sweep.bytes(stage(m + 1)));
  };

  ring_init_barriers(full, kSlots);
  for (long long m = 0; m < kSlots && m < n; ++m) load(m);
  uint32_t phase = 0;  // bit `slot`: the parity of the phase that slot's next wait is for
  for (long long m = 0; m < n; ++m) {
    const int slot = static_cast<int>(m % kSlots);
    const long long j = stage(m);
    mbar_wait(&full[slot], (phase >> slot) & 1u);
    phase ^= 1u << slot;
    // the slot was written and is read by bulk copies alone: no generic access, so no proxy fence
    bulk_store_hint(out + sweep.offset(j), ring + slot * kSlotBytes, sweep.bytes(j), policy);
    bulk_commit();
    if (m >= 1 && m - 1 + kSlots < n) {
      bulk_wait_read<1>();  // every store but the one just started has read its slot: stage m - 1's is free
      load(m - 1 + kSlots);
    }
  }
  bulk_wait<0>();
}

}  // namespace

// x and out: n_bytes each, a multiple of 16, both 16-byte aligned; done
// (8, 128) float32. Returns cudaGetLastError() after the launch.
extern "C" int howl_hbm2hbm_forward(const void* x, void* out, void* done, long long n_bytes, float s, void* stream) {
  if (n_bytes < 0 || n_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hbm2hbm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlots * kSlotBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StageSweep sweep(n_bytes, n_bytes, kSlotBytes);  // one chunk: the whole array
  const long long max_ctas = static_cast<long long>(sms) * kCtasPerSm;
  // one CTA for an empty array still fills done
  const long long ctas = sweep.n_stages < max_ctas ? (sweep.n_stages > 0 ? sweep.n_stages : 1) : max_ctas;
  hbm2hbm_kernel<<<static_cast<unsigned>(ctas), kCopyThreads, kSlots * kSlotBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), static_cast<float*>(done), sweep, s);
  return static_cast<int>(cudaGetLastError());
}
