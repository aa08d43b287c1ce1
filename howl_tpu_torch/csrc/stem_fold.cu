// Banded-fold stem proto for Hopper (sm_90a): three GEMMs on the tensor
// cores (wgmma) with ReLU, the 3-plane time pool and the 4-block frequency
// pool in registers.
//
// Replaces the TPU kernel tools/bench_trunk_kernel_micro.py, stem_pallas
// (Pallas kernel stem_kernel). For xpre (B, 3, q_rows, 120) and w0fold
// (120, 4 * 512), both bf16, it computes
//
//     out[b, q, n] = (1/12) * sum_{j<4} sum_{r<3} relu(xpre[b, r, q, :] @ w0fold[:, 512 j + n])
//
// with float32 sums, the planes added in order r = 0, 1, 2 and then the four
// column blocks in order j = 0..3, as the Pallas kernel adds them; out is
// (B, q_rows, 512), bf16 or float32.
//
// What bounds it on this card: the tensor cores. Per clip it is 3 x 224 x
// 120 x 2048 x 2 = 0.33 GFLOP against 161 KB in and 229 KB out (bf16): 169
// GFLOP a batch of 512, 0.17 ms at the data sheet's 989 TFLOP/s.
//
// What the design does about it:
//  * Persistent blocks, W resident. A block owns one slice of 32 columns of
//    each of the four j-blocks, so one wgmma m64n128k16 (N = 4 x 32) yields
//    every column a pooled output of the slice needs. Its 128 x 128 bf16 part
//    of W (K = 120 padded to 128 with zeros) is packed by the host in the image
//    the wgmma descriptor reads (trunk_kernels.pack_fold_image: K-major, 128-byte
//    swizzle, 16 KB per 64 k), arrives by two bulk copies and stays in shared
//    memory while the block walks its (clip, 64-row tile) items. 16 slices x
//    (SMs / 16) groups of blocks; the blocks of a group walk the same items in
//    step, so all but the first slice find an xpre tile in L2.
//  * A ring of xpre tiles: an item is the 64 rows of all three planes, three
//    bulk copies of 64 x 240 bytes (a plane's rows are contiguous), 45 KB a
//    stage, kSlots = 4 stages, each on an mbarrier that counts its bytes.
//  * Two warpgroups take the ring's stages in turn; once a warpgroup holds a
//    stage's last A fragments in registers (a named barrier of its 128
//    threads), its first thread refills the slot with the stage kSlots ahead.
//    No producer warp: with nine warps three share one of the SM's four
//    register files, ptxas gives a thread 168 registers, spills and
//    serialises the wgmma (C7512); eight warps may take 255. A comes from
//    registers (32-bit loads at row * 240 + 2k bytes, conflict-free): xpre's
//    240-byte rows cannot be described as core matrices. K = 120 pads to 128
//    by zeroing the last k-step's upper half in the A fragment (the image's
//    rows 120-127 are zero too). A plane is eight products into 64 sums a
//    thread; the stage is refilled as soon as the third plane's A is loaded.
//  * ReLU and both pools in registers. In the accumulator a thread holds
//    columns 8jj + 2t, + 1 of jj = 0..15, i.e. the same column n of all four
//    j-blocks (jj = 4j + n / 8), so the ReLU of each (plane, j), the plane sum
//    and the j sum never leave the thread; a tile's pooled 64 x 32 sums are 16
//    registers, stored as pairs of neighbouring columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using namespace hopper;

constexpr int kKIn = 120;                     // banded-fold depth
constexpr int kKPad = 128;                    // padded to whole k16 steps
constexpr int kNOut = 512;                    // one j-block of w0fold's columns
constexpr int kJ = 4;                         // j-blocks (the frequency pool)
constexpr int kPlanes = 3;                    // time-pool planes
constexpr int kSliceCols = 32;                // columns of each j-block a block owns
constexpr int kSlices = kNOut / kSliceCols;   // 16
constexpr int kN = kJ * kSliceCols;           // the product's N: 128
constexpr int kM = 64;                        // rows of an item (one warpgroup's product)
constexpr int kRowBytes = kKIn * 2;           // 240
constexpr int kPlaneBytes = kM * kRowBytes;   // 15,360
constexpr int kStageBytes = kPlanes * kPlaneBytes;
constexpr int kSlots = 4;                     // stages of the ring
constexpr int kWBytes = kKPad * kN * 2;       // 32 KB of W a block
constexpr int kWBlockBytes = 64 * kN * 2;     // 64 k of the swizzled image: 16 KB
constexpr int kConsumers = 2;                 // warpgroups, which take the ring's stages in turn
constexpr int kThreads = kConsumers * 128;
constexpr int kSmemBytes = 1024 + kWBytes + kSlots * kStageBytes + (kSlots + 1) * 8;

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) { return *reinterpret_cast<const uint32_t*>(p); }

__global__ void __launch_bounds__(kThreads, 1)
stem_fold_kernel(const unsigned char* __restrict__ xpre, const unsigned char* __restrict__ w_img,
                 void* __restrict__ out, int q_rows, int n_items, int n_groups, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of address bits 4-9: the image starts on a 1,024-byte boundary
  unsigned char* s_w = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = s_w + kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSlots * kStageBytes);
  uint64_t* w_full = full + kSlots;

  const int slice = blockIdx.x % kSlices;
  const int group = blockIdx.x / kSlices;
  const int n_qt = (q_rows + kM - 1) / kM;
  const int n_local = group < n_items ? (n_items - group + n_groups - 1) / n_groups : 0;  // items group + i n_groups
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;

  // stage i of the block: its item's 64 rows of the three planes into slot i % kSlots (one thread)
  auto load_stage = [&](int i) {
    const int slot = i % kSlots;
    const int item = group + i * n_groups;
    const int b = item / n_qt;
    const int q0 = (item - b * n_qt) * kM;
    const uint32_t bytes = static_cast<uint32_t>(min(kM, q_rows - q0)) * kRowBytes;
    mbar_arrive_expect_tx(&full[slot], kPlanes * bytes);
    for (int r = 0; r < kPlanes; ++r)
      bulk_load(ring + slot * kStageBytes + r * kPlaneBytes,
                xpre + ((static_cast<size_t>(b) * kPlanes + r) * q_rows + q0) * kRowBytes, bytes, &full[slot]);
  };
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&full[s], 1);
    mbar_init(w_full, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(w_full, kWBytes);
    for (int h = 0; h < kWBytes / kWBlockBytes; ++h)
      bulk_load(s_w + h * kWBlockBytes, w_img + static_cast<size_t>(slice) * kWBytes + h * kWBlockBytes, kWBlockBytes,
                w_full);
    for (int i = 0; i < kSlots && i < n_local; ++i) load_stage(i);
  }
  __syncthreads();

  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row = 16 * (warp & 3) + g;  // this thread's first row of the item; the second is row + 8
  const uint32_t w_s = smem_u32(s_w);
  mbar_wait(w_full, 0);
  for (int i = wg; i < n_local; i += kConsumers) {
    const int slot = i % kSlots;
    mbar_wait(&full[slot], (i / kSlots) & 1);
    const unsigned char* stage = ring + slot * kStageBytes;
    float sum[64];
#pragma unroll
    for (int r = 0; r < kPlanes; ++r) {
      const unsigned char* pa = stage + r * kPlaneBytes + row * kRowBytes + 4 * t;
      uint32_t a[32];
#pragma unroll
      for (int ks = 0; ks < kKPad / 16; ++ks) {
        a[4 * ks + 0] = ld32(pa + 32 * ks);
        a[4 * ks + 1] = ld32(pa + 8 * kRowBytes + 32 * ks);
        // k 120-127 of the last step are padding: zero, not the next row's first values
        a[4 * ks + 2] = ks < kKPad / 16 - 1 ? ld32(pa + 32 * ks + 16) : 0u;
        a[4 * ks + 3] = ks < kKPad / 16 - 1 ? ld32(pa + 8 * kRowBytes + 32 * ks + 16) : 0u;
      }
      if (r == kPlanes - 1) {
        // the stage's last reads are in the warpgroup's registers: its first thread refills the slot, which only
        // this warpgroup reads (stages i and i + kSlots have the same parity), with stage i + kSlots
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if ((tid & 127) == 0 && i + kSlots < n_local) load_stage(i + kSlots);
      }
      float acc[64];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKPad / 16; ++ks)
        wgmma_m64n128k16(acc, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3],
                         desc_sw128(w_s + (ks / 4) * kWBlockBytes + (ks % 4) * 32), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_keep(acc);
      wgmma_keep(a);
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const float v = fmaxf(acc[e], 0.f);
        sum[e] = r == 0 ? v : sum[e] + v;
      }
    }
    // sum[4 jj + i]: column 8 jj + 2t + (i & 1) of the slice's 128, row row + 8 (i >> 1); jj = 4 j + jl
    const int item = group + i * n_groups;
    const int b = item / n_qt;
    const int q_base = (item - b * n_qt) * kM + row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q_base + 8 * h;
      if (q >= q_rows) continue;
#pragma unroll
      for (int jl = 0; jl < kSliceCols / 8; ++jl) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * jl + 2 * h + e;
          y[e] = (((sum[idx] + sum[idx + 16]) + sum[idx + 32]) + sum[idx + 48]) * (1.0f / 12.0f);
        }
        const size_t o = (static_cast<size_t>(b) * q_rows + q) * kNOut + slice * kSliceCols + 8 * jl + 2 * t;
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) = __floats2bfloat162_rn(y[0], y[1]);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y[0], y[1]);
      }
    }
  }
}

}  // namespace

// xpre (B, 3, q_rows, 120) bf16, 16-byte aligned; w_img the swizzled image
// of w0fold (120, 2048) bf16, 16 slices of 32 KB (trunk_kernels.pack_fold_image);
// out (B, q_rows, 512), bf16 if out_bf16 else float32. All contiguous.
// Returns cudaGetLastError() after the launch, the error of an attribute
// call, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int howl_stem_fold_forward(const void* xpre, const void* w_img, void* out, int B, int q_rows, int out_bf16,
                                      void* stream) {
  if (B == 0 || q_rows == 0) return 0;
  if (B < 0 || q_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_items_ll = static_cast<long long>(B) * ((q_rows + kM - 1) / kM);
  if (n_items_ll > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_items = static_cast<int>(n_items_ll);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_groups = sms / kSlices;
  if (n_groups < 1) n_groups = 1;
  if (n_groups > n_items) n_groups = n_items;
  stem_fold_kernel<<<kSlices * n_groups, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(xpre), static_cast<const unsigned char*>(w_img), out, q_rows, n_items,
      n_groups, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
