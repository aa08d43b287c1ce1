// GEMM legs (gemm1, gemm3) of the frontend cost study for Hopper (sm_90a):
// wgmma on the tensor cores, W and x by bulk copies.
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
// What bounds it on this card: per call it reads total * 2 KB and writes
// total * 512 bytes, and runs n_dots * total * 512 * 512 * 2 floating-point
// operations on the tensor cores. At one product the two are about even; at
// three the tensor cores lead. Beside them, W streams from L2 once per
// product and tile of rows.
//
// What the design does about it:
//  * Tiles of 128 rows, two warpgroups of 64 on the same W stage, each
//    wgmma m64n256k16 with 128 float32 sums a thread: the 512 columns are two
//    passes of 256. A block reads W from L2 once per product and 128 rows,
//    half of what a 64-row tile reads.
//  * W by bulk copies. The host packs W into stages of 64 k by 256 n, each
//    the K-major 128-byte-swizzled operand of a wgmma descriptor
//    (frontend_micro_kernels.pack_gemm_w_image, T2's layout); a stage (32 KB)
//    arrives by one bulk copy through a ring of three slots on full and empty
//    mbarriers. When both warpgroups' products of a stage are done, each
//    arrives on the slot's empty barrier, and warp 0 waits there and refills
//    the slot with the stage three ahead. No __syncthreads between stages.
//  * x by bulk copies. A tile's rows arrive in stages of 8 rows (16 KB)
//    through six slots, which take the W slots' room: the products wait
//    while a tile is staged. Each stage is rounded to bf16 once
//    (__fadd_rn, then __floats2bfloat162_rn, as stage_convert does) into the
//    tile's A image, K-major in the 128-byte swizzle, which the wgmma reads
//    through its descriptor.
//  * Every product runs: each of the n_dots products is its own chain of
//    wgmma over K = 512 into the same sums, in order, in each pass. Columns
//    0-127 are stored; the others are stored under `keep`, which the callers
//    pass as 0, so the compiler has to compute them (micro_common.cuh's rules).
//  * Persistent blocks, one to an SM, over the tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;                     // two warpgroups
constexpr int kNfft = 512;                        // frame width; K and N of the product
constexpr int kOutCols = 128;                     // columns of the product that are stored
constexpr int kRows = 128;                        // rows of a tile: 64 a warpgroup
constexpr int kPassN = 256;                       // columns of a pass
constexpr int kStageK = 64;                       // k of a W stage: one 128-byte swizzled block
constexpr int kKBlocks = kNfft / kStageK;         // 8
constexpr int kWStageBytes = kPassN * 128;        // 32 KB
constexpr int kWSlots = 3;
constexpr int kABlockBytes = kRows * 128;         // 16 KB: 64 k of the A image
constexpr int kABytes = kKBlocks * kABlockBytes;  // 128 KB
constexpr int kXRows = 8;                         // rows of an x stage
constexpr int kXStageBytes = kXRows * kNfft * 4;  // 16 KB
constexpr int kXSlots = 6;                        // x stages in flight
constexpr int kXStages = kRows / kXRows;          // 16 a tile
constexpr int kRingBytes = kXSlots * kXStageBytes;
constexpr int kSmemBytes = 1024 + kABytes + kRingBytes + (2 * kWSlots + kXSlots) * 8;

static_assert(kWSlots * kWStageBytes == kRingBytes, "the W slots and the x slots share one room");
static_assert(kSmemBytes <= 232448, "a block may use 227 KB of shared memory");

__global__ void __launch_bounds__(kThreads, 1)
micro_gemm_kernel(const float* __restrict__ x, const unsigned char* __restrict__ w_img, float* __restrict__ out,
                  int total, float s, int n_dots, int keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of address bits 4-9: A and the W slots start on 1,024-byte boundaries
  unsigned char* a_s = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = a_s + kABytes;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* w_empty = w_full + kWSlots;
  uint64_t* x_full = w_empty + kWSlots;
  const uint32_t a_u = smem_u32(a_s);
  const uint32_t ring_u = smem_u32(ring);

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int n_tiles = (total + kRows - 1) / kRows;
  const int n_stages = 2 * n_dots * kKBlocks;  // W stages a tile

  if (tid == 0) {
    for (int i = 0; i < kWSlots; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], 2);  // one arrival per warpgroup
    }
    for (int i = 0; i < kXSlots; ++i) mbar_init(&x_full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the phase bit of each slot's next wait
  uint32_t x_par = 0, w_par = 0, e_par = 0;

  // x stage u of the tile at row0: its rows inside the array into slot u % kXSlots (one thread)
  auto issue_x = [&](int row0, int u) {
    const int rows = min(kXRows, total - row0 - u * kXRows);
    const uint32_t bytes = rows > 0 ? static_cast<uint32_t>(rows) * kNfft * 4 : 0u;
    uint64_t* bar = &x_full[u % kXSlots];
    mbar_arrive_expect_tx(bar, bytes);
    if (rows > 0)
      bulk_load(ring + (u % kXSlots) * kXStageBytes, x + static_cast<size_t>(row0 + u * kXRows) * kNfft, bytes, bar);
  };
  // W stage qq of a tile (pass qq / (n_dots * 8), k-block qq % 8) into slot qq % kWSlots (one thread)
  auto issue_w = [&](int qq) {
    const int image_stage = qq / (n_dots * kKBlocks) * kKBlocks + qq % kKBlocks;
    uint64_t* bar = &w_full[qq % kWSlots];
    mbar_arrive_expect_tx(bar, kWStageBytes);
    bulk_load(ring + (qq % kWSlots) * kWStageBytes, w_img + static_cast<size_t>(image_stage) * kWStageBytes,
              kWStageBytes, bar);
  };
  // stage i's products are done in this warpgroup: the slot goes back for the stage kWSlots ahead
  auto finish = [&](int i) {
    const int next = i + kWSlots;
    const bool refill = next < n_stages;
    if (!refill) return;
    const int slot = i % kWSlots;
    if ((tid & 127) == 0) mbar_arrive(&w_empty[slot]);
    if (warp == 0) {
      mbar_wait(&w_empty[slot], (e_par >> slot) & 1u);
      e_par ^= 1u << slot;
      if (lane == 0) issue_w(next);
      __syncwarp();
    }
  };

  const int row_in_tile = wg * 64 + 16 * (warp & 3) + (lane >> 2);  // this thread's first row; the second is + 8
  const int t = lane & 3;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    __syncthreads();  // the last tile's products are done with A and the ring
    if (tid == 0)
      for (int u = 0; u < kXSlots; ++u) issue_x(row0, u);
    for (int u = 0; u < kXStages; ++u) {
      const int slot = u % kXSlots;
      mbar_wait(&x_full[slot], (x_par >> slot) & 1u);
      x_par ^= 1u << slot;
      const float* st = reinterpret_cast<const float*>(ring + slot * kXStageBytes);
#pragma unroll
      for (int i = 0; i < kXRows * kNfft / 4 / kThreads; ++i) {
        const int f = tid + i * kThreads;
        const int r = f / (kNfft / 4);
        const int k = (f % (kNfft / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(st + r * kNfft + k);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(__fadd_rn(v.x, s), __fadd_rn(v.y, s));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(__fadd_rn(v.z, s), __fadd_rn(v.w, s));
        const int m = u * kXRows + r;
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(a_s + (k / 64) * kABlockBytes + m * 128 + (((k % 64) / 8) ^ (m % 8)) * 16 +
                                  (k % 8) * 2) = packed;
      }
      fence_proxy_async();  // A is read by wgmma, and the slot is refilled by a bulk copy
      __syncthreads();
      if (tid == 0 && u + kXSlots < kXStages) issue_x(row0, u + kXSlots);
    }
    if (tid == 0)
      for (int qq = 0; qq < kWSlots && qq < n_stages; ++qq) issue_w(qq);

    float acc[128];
    int qq = 0, fin = 0;
    for (int h = 0; h < 2; ++h) {
      wgmma_fence();
      for (int d = 0; d < n_dots; ++d) {
        for (int kb = 0; kb < kKBlocks; ++kb, ++qq) {
          const int slot = qq % kWSlots;
          mbar_wait(&w_full[slot], (w_par >> slot) & 1u);
          w_par ^= 1u << slot;
#pragma unroll
          for (int ks = 0; ks < kStageK / 16; ++ks)
            wgmma_m64n256k16_ss(acc, desc_sw128(a_u + kb * kABlockBytes + wg * 64 * 128 + ks * 32),
                                desc_sw128(ring_u + slot * kWStageBytes + ks * 32), d > 0 || kb > 0 || ks > 0);
          wgmma_commit();
          wgmma_wait<1>();
          while (fin < qq) finish(fin++);
        }
      }
      wgmma_wait<0>();
      while (fin < qq) finish(fin++);
      wgmma_keep(acc);
      // acc[4j + 2hh + e]: row row_in_tile + 8 hh, column 256 h + 8 j + 2 t + e
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + row_in_tile + 8 * hh;
        if (row >= total) continue;
        float* orow = out + static_cast<size_t>(row) * kOutCols;
#pragma unroll
        for (int j = 0; j < kPassN / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if ((h == 0 && j < kOutCols / 8) || keep)
            *reinterpret_cast<float2*>(orow + col % kOutCols) = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

}  // namespace

// x (total, 512) float32, 16-byte aligned; w_img the stages of W (512, 512)
// bf16 (frontend_micro_kernels.pack_gemm_w_image); out (total, 128) float32.
// All contiguous. keep must be 0. Returns cudaGetLastError() after the
// launch, the error of an attribute call, or cudaErrorInvalidValue.
extern "C" int howl_micro_gemm_forward(const void* x, const void* w_img, void* out, int total, float s, int n_dots,
                                       int keep, void* stream) {
  if (total == 0) return 0;
  if (total < 0 || n_dots < 1 || n_dots > (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(micro_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (total + kRows - 1) / kRows;
  const int grid = n_tiles < sms ? n_tiles : sms;
  micro_gemm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const unsigned char*>(w_img), static_cast<float*>(out), total, s,
      n_dots, keep);
  return static_cast<int>(cudaGetLastError());
}
