// Manual copy leg of the device-memory bandwidth sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_hbm_sweep.py, make_manual_copy (Pallas
// kernel `kernel`): out = x bit for bit, no arithmetic, through k per-slot
// chains read -> write -> read. A slot's next read starts only after its own
// write has landed, so each chain is serial and the k chains overlap.
// `done`, (8, 128) float32, is filled with s.
//
// What bounds it on this card: device memory, one read and one write of the
// array.
//
// What the design does about it. The TPU's slot holds a whole chunk of 1-4
// MB, and one core walks the chunks in order. Here the array is cut into
// chunks of cb rows and each chunk into stages of 16 KB (a chunk's last stage
// may be short), numbered in address order, and a persistent grid walks them
// together: stage j belongs to CTA j % G (`StageSweep`), so at any moment
// neighbouring CTAs copy neighbouring stages, as a plain copy kernel's grid
// sweeps an array, and the device memory serves reads and writes in one
// narrow window of addresses rather than in one region per CTA. The grid is
// as many CTAs as fit the card at ring depth k, by the occupancy calculator.
//
// Each CTA keeps the TPU kernel's ring: k slots of 16 KB in dynamic shared
// memory, k a run-time number from 2 to 8, and one chain per slot, run by
// lane 0 of its own warp: slot s takes the CTA's stages s, s + k, s + 2k, ...
// A chain starts a bulk copy device -> shared memory (cp.async.bulk, counted
// off on the slot's mbarrier), waits for it, starts the bulk copy shared ->
// device memory as a bulk group of its own, and waits with
// cp.async.bulk.wait_group 0, which counts only that lane's groups: the
// write has landed in device memory, not only left the slot, before the slot
// is read into again. That is the TPU kernel's wait on the write's
// semaphore; the .read form is what hbm2hbm.cu measures. No thread loads a
// byte of the array. Both copies carry an L2 evict-first policy: nothing
// reads the streamed lines again. Block 0 fills `done`.

#include "hbm_common.cuh"

namespace {

using namespace hbm;

constexpr int kChainThreads = 32;  // a warp per slot; its lane 0 runs the slot's chain

__global__ void __launch_bounds__(kChainThreads * kMaxRingSlots)
hbm_manual_copy_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out, float* __restrict__ done,
                       StageSweep sweep, float s) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxRingSlots];
  if (blockIdx.x == 0) fill_done(done, s, blockDim.x);
  const int slot = threadIdx.x / kChainThreads;
  const int k = blockDim.x / kChainThreads;
  if (threadIdx.x % kChainThreads != 0) return;

  // the chain's barrier is its own: no other thread waits on it or counts bytes off on it
  mbar_init(&full[slot], 1);
  mbar_init_fence();
  fence_proxy_async();
  const uint64_t policy = l2_evict_first();
  unsigned char* buf = ring + slot * kRingStageBytes;
  const long long ctas = gridDim.x;
  const long long stages = sweep.count(blockIdx.x, ctas);
  uint32_t phase = 0;  // the parity of the phase the slot's next wait is for
  for (long long m = slot; m < stages; m += k) {
    const long long j = blockIdx.x + m * ctas;
    const long long at = sweep.offset(j);
    const uint32_t bytes = sweep.bytes(j);
    mbar_arrive_expect_tx(&full[slot], bytes);
    bulk_load_hint(buf, x + at, bytes, &full[slot], policy);
    mbar_wait(&full[slot], phase);
    phase ^= 1u;
    // the slot was written and is read by bulk copies alone: no generic access, so no proxy fence
    bulk_store_hint(out + at, buf, bytes, policy);
    bulk_commit();
    bulk_wait<0>();  // this chain's write has landed: only now may its slot be read into again
  }
}

}  // namespace

// x and out (rows, 512) float32 or bf16 (is_bf16), contiguous, 16-byte
// aligned, rows a multiple of cb, cb a multiple of 8, k from 2 to 8; done
// (8, 128) float32. Returns cudaGetLastError() after the launch, or the error
// of the occupancy query; other arguments are cudaErrorInvalidValue.
extern "C" int howl_hbm_manual_copy_forward(const void* x, void* out, void* done, int rows, int cb, int k, int is_bf16,
                                            float s, void* stream) {
  if (!ring_args_ok(rows, cb, k)) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunk_bytes = static_cast<long long>(cb) * kCols * (is_bf16 ? 2 : 4);
  const StageSweep sweep(chunk_bytes * (rows / cb), chunk_bytes, kRingStageBytes);
  const long long ctas = ring_grid<hbm_manual_copy_kernel>(kChainThreads * k, k, sweep.n_stages);
  if (ctas < 0) return static_cast<int>(-ctas);
  return launch_ring<hbm_manual_copy_kernel>(ctas, kChainThreads * k, k, stream, static_cast<const unsigned char*>(x),
                                             static_cast<unsigned char*>(out), static_cast<float*>(done), sweep, s);
}

extern "C" int howl_hbm_manual_copy_ctas_per_sm(int k, int is_bf16) {
  (void)is_bf16;  // the copy moves bytes: one kernel for both dtypes
  return ring_ctas_per_sm<hbm_manual_copy_kernel>(kChainThreads * k, k);
}
