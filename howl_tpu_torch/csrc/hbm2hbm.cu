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
// copy. Each CTA relays its contiguous share of the array through a ring of
// three 32 KB slots of shared memory: cp.async.bulk device -> shared memory,
// its bytes counted off on the slot's mbarrier, then cp.async.bulk shared ->
// device memory in a bulk group. One thread of the CTA starts both and waits;
// no thread loads a byte into a register. Per slot the thread keeps the
// mbarrier's phase bit and flips it after every wait; before a slot is
// refilled, cp.async.bulk.wait_group.read makes sure the store that reads it
// has read it. Chunk i's store goes first and the slot of chunk i - 1
// refilled after, so two loads and up to two stores are in flight per CTA.
// The grid is two CTAs for each SM of the card (fewer for a small array);
// block 0 also fills `done`.

#include "hbm_common.cuh"

namespace {

using namespace hbm;

constexpr int kSlots = kStages;
constexpr int kSlotBytes = kStageBytes;
constexpr int kCopyThreads = 128;
constexpr int kDoneFloats = 8 * 128;
constexpr int kCtasPerSm = 2;

__global__ void __launch_bounds__(kCopyThreads)
hbm2hbm_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out, float* __restrict__ done,
               long long n_bytes, long long chunks_per_cta, float s) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kSlots];
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < kDoneFloats; i += kCopyThreads) done[i] = s;
  if (threadIdx.x != 0) return;

  const long long n_chunks = (n_bytes + kSlotBytes - 1) / kSlotBytes;
  const long long first = blockIdx.x * chunks_per_cta;
  const long long last = first + chunks_per_cta < n_chunks ? first + chunks_per_cta : n_chunks;
  const int n = static_cast<int>(last - first);  // this CTA's chunks
  auto chunk_bytes = [&](int i) {
    const long long left = n_bytes - (first + i) * kSlotBytes;
    return static_cast<uint32_t>(left < kSlotBytes ? left : kSlotBytes);
  };
  auto load = [&](int i) {
    const int slot = i % kSlots;
    mbar_arrive_expect_tx(&full[slot], chunk_bytes(i));
    bulk_load(ring + slot * kSlotBytes, x + (first + i) * kSlotBytes, chunk_bytes(i), &full[slot]);
  };

  for (int slot = 0; slot < kSlots; ++slot) mbar_init(&full[slot], 1);
  mbar_init_fence();
  fence_proxy_async();  // the initialised barriers, before the bulk copies' proxy counts bytes off on them
  for (int i = 0; i < kSlots && i < n; ++i) load(i);
  uint32_t phase = 0;  // bit `slot`: the parity of the phase that slot's next wait is for
  for (int i = 0; i < n; ++i) {
    const int slot = i % kSlots;
    mbar_wait(&full[slot], (phase >> slot) & 1u);
    phase ^= 1u << slot;
    // the slot was written and is read by bulk copies alone: no generic access, so no proxy fence
    bulk_store(out + (first + i) * kSlotBytes, ring + slot * kSlotBytes, chunk_bytes(i));
    bulk_commit();
    if (i >= 1 && i - 1 + kSlots < n) {
      bulk_wait_read<1>();  // every store but the one just started has read its slot: chunk i - 1's is free
      load(i - 1 + kSlots);
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
  const long long n_chunks = (n_bytes + kSlotBytes - 1) / kSlotBytes;
  const long long max_ctas = static_cast<long long>(sms) * kCtasPerSm;
  const long long ctas = n_chunks < max_ctas ? (n_chunks > 0 ? n_chunks : 1) : max_ctas;  // one CTA still fills done
  const long long chunks_per_cta = (n_chunks + ctas - 1) / ctas;
  hbm2hbm_kernel<<<static_cast<unsigned>(ctas), kCopyThreads, kSlots * kSlotBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), static_cast<float*>(done), n_bytes,
      chunks_per_cta, s);
  return static_cast<int>(cudaGetLastError());
}
