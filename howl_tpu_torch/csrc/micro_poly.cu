// Polyphase legs (x1, x3) of the frontend cost study for Hopper (sm_90a):
// wgmma on the tensor cores with A read by descriptor from hop rows in
// shared memory, W and H by bulk copies.
//
// Replaces the TPU kernel tools/bench_pallas_micro.py, run_poly (Pallas
// kernel poly_kernel). The input is the hop-row view of the audio, H (B,
// rows, 200) float32: frame t of a clip is the 512 samples that start at
// hop row t, so the frames tensor is never written. With W_j the rows
// [200 j, 200 j + 200) of W (512, 512) bf16, zero below row 512, it computes
//
//     hb     = bf16(H + s)                          float32 add, round to nearest even
//     acc[t] = sum over j < 3 of hb[t + j] @ W_j    float32 sums, t < t_pad
//     out    = acc[:, :128]                         (B, t_pad, 128) float32
//
// n_dots times, every pass from zero, as the Pallas body does; the passes
// are identical and the study times what each one adds.
//
// What bounds it on this card: per call it reads about B * (t_pad + 2) * 800
// bytes, 0.39 of the frames tensor, writes B * t_pad * 512 bytes and runs
// n_dots * B * t_pad * 528 * 512 * 2 operations on the tensor cores: the
// tensor cores, from the first pass on. Beside them W streams from L2, once
// per pass and tile of 128 frames.
//
// What the design does about it:
//  * Polyphase, so that A needs no copy per shift. Frames overlap by 312
//    samples and no wgmma descriptor describes rows 400 bytes apart, but hop
//    rows do not overlap: frame t is the sum over j of hop row t + j times
//    W_j. A tile of 128 frames from t0 holds the 130 hop rows t0 .. t0 + 129
//    rounded to bf16 in shared memory, chunk-major without swizzle: each
//    8-sample chunk (16 bytes) is a column of 130 rows, 25 chunks of samples
//    and a 26th of zeros, so K = 208 a hop row. The A operand of warpgroup wg
//    for shift j and k16 step kk is then one descriptor: start at chunk
//    2 kk's column plus (64 wg + j) rows, leading offset one chunk column,
//    stride offset 128 bytes (trunk_proto.cu's slot rows). A shift is a start
//    address: no mask, no copy.
//  * A pass is 13 + 13 + 7 = 33 k16 steps: W_0 and W_1 over a hop row's 200
//    samples and the zero chunk, W_2 over its 112 nonzero rows only. That is
//    K = 528 against 512, and none of W_2's 88 zero rows.
//  * Tiles of 128 frames, two warpgroups of 64 on the same W stage, each
//    wgmma m64n256k16 with 128 float32 sums a thread: the 512 columns are two
//    passes of 256. W crosses from L2 once per 128 frames and pass.
//  * W by bulk copies. The host packs W in the order the kernel consumes it
//    (frontend_micro_kernels.pack_poly_w_image): per pass of 256 columns the
//    33 steps, each 16 k by 256 n K-major without swizzle (cores of 8 n by 8
//    k, 128 bytes; leading offset 4 KB). Stages of 3 steps (24 KB) go
//    through a ring of slots on full and empty mbarriers, refilled by warp 0
//    as both warpgroups release a slot, as in micro_gemm.cu; the sequence of
//    stages runs on across a block's tiles, so the ring never drains.
//  * The next tile is staged while this one multiplies. Two A buffers; H
//    arrives by bulk copies of whole hop rows (800 bytes each, only the rows
//    inside the clip) into float32 slots, and every few stages of W the
//    warpgroups round one H slot into the next tile's buffer (the float32
//    add, then __floats2bfloat162_rn, as the plain version rounds). Rows
//    past the clip are written as zeros; frames >= t_pad are computed and
//    not stored. No producer warp: a thread takes 224 registers, 128 of
//    them sums, which eight warps can have and ten cannot (frontend_tc.cu).
//  * Persistent blocks, one to an SM, walk the tiles; a barrier at each
//    tile's start hands both buffers over.
//  * Every pass of the whole 512-wide product runs. Columns 0-127 of the last
//    pass are stored; the others, and every earlier pass, are stored under
//    `keep`, which the callers pass as 0, so the compiler has to compute them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;                        // two warpgroups
constexpr int kHop = 200;                            // samples a hop row
constexpr int kNfft = 512;                           // frame width; N of the product
constexpr int kOutCols = 128;                        // columns of the product that are stored
constexpr int kTile = 128;                           // frames a tile: 64 a warpgroup
constexpr int kSpanRows = kTile + 2;                 // 130 hop rows a tile reads
constexpr int kChunks = 26;                          // 16-byte chunks of an A row: 25 of samples, one of zeros
constexpr int kChunkBytes = kSpanRows * 16;          // 2,080: one chunk column
constexpr int kABytes = kChunks * kChunkBytes;       // 54,080: one A buffer
constexpr int kPassN = 256;                          // columns of a pass
constexpr int kSteps01 = 13;                         // k16 steps of W_0 and of W_1: 200 samples and the zero chunk
constexpr int kSteps2 = 7;                           // k16 steps of W_2: its 112 nonzero rows
constexpr int kSteps = 2 * kSteps01 + kSteps2;       // 33 a pass
constexpr int kStepBytes = 16 * kPassN * 2;          // 8,192: a step of W, two k-cores of 4 KB
constexpr int kStageSteps = 3;
constexpr int kStages = kSteps / kStageSteps;        // 11 W stages a pass
constexpr int kWStageBytes = kStageSteps * kStepBytes;  // 24,576
constexpr int kWSlots = 3;
constexpr int kHRows = 26;                           // hop rows of an H stage
constexpr int kHStageBytes = kHRows * kHop * 4;      // 20,800
constexpr int kHStages = kSpanRows / kHRows;         // 5 a tile
constexpr int kHSlots = 2;
constexpr int kHEvery = 2 * kStages / kHStages;      // W stages between two H stages rounded
constexpr int kHTasks = kHRows * (kHop / 8);         // chunks of an H stage
constexpr int kSmemBytes = 2 * kABytes + kWSlots * kWStageBytes + kHSlots * kHStageBytes +
                           (2 * kWSlots + 2 * kHSlots) * 8;

static_assert(kSteps % kStageSteps == 0 && kSpanRows % kHRows == 0, "stages end on whole steps and rows");
static_assert(kHStages * kHEvery <= 2 * kStages, "a tile's H stages are rounded during one pass pair");
static_assert(kHop % 8 == 0 && (kChunks - 1) * 8 == kHop && 16 * kSteps01 == kChunks * 8, "a hop row's chunks");
static_assert(2 * kSteps01 * 16 + kSteps2 * 16 == 528 && 2 * kHop + 16 * kSteps2 == kNfft, "W_2's 112 rows");
static_assert(kSmemBytes <= 232448, "a block may use 227 KB of shared memory");

// shift j and k16 step of step q of a pass, and where its A starts in a buffer
__host__ __device__ constexpr int step_shift(int q) { return q < kSteps01 ? 0 : q < 2 * kSteps01 ? 1 : 2; }
__host__ __device__ constexpr int step_k16(int q) { return q - kSteps01 * step_shift(q); }
__host__ __device__ constexpr int step_a_bytes(int q) { return 2 * step_k16(q) * kChunkBytes + step_shift(q) * 16; }

__global__ void __launch_bounds__(kThreads, 1)
micro_poly_kernel(const float* __restrict__ h, const unsigned char* __restrict__ w_img, float* __restrict__ out,
                  int n_clips, int rows, int t_pad, float s, int n_dots, int keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* a_s = smem_raw;                           // two A buffers
  unsigned char* ring = a_s + 2 * kABytes;                 // W slots
  unsigned char* h_s = ring + kWSlots * kWStageBytes;      // H slots
  uint64_t* w_full = reinterpret_cast<uint64_t*>(h_s + kHSlots * kHStageBytes);
  uint64_t* w_empty = w_full + kWSlots;
  uint64_t* h_full = w_empty + kWSlots;
  uint64_t* h_empty = h_full + kHSlots;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int tiles_per_clip = (t_pad + kTile - 1) / kTile;
  const int n_tiles = tiles_per_clip * n_clips;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / gridDim.x;
  const uint32_t stages_a_tile = 2u * n_dots * kStages;
  const uint32_t n_w = static_cast<uint32_t>(my_tiles) * stages_a_tile;  // W stages of the block
  const uint32_t n_h = static_cast<uint32_t>(my_tiles) * kHStages;       // H stages of the block

  if (tid == 0) {
    for (int i = 0; i < kWSlots; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], 2);  // one arrival per warpgroup
    }
    for (int i = 0; i < kHSlots; ++i) {
      mbar_init(&h_full[i], 1);
      mbar_init(&h_empty[i], kThreads / 32);  // one arrival per warp
    }
    mbar_init_fence();
  }
  // the zero chunk of both buffers: 0 x W's rows 200-207 of a block must be 0, never 0 x stale bits
  for (int i = tid; i < 2 * kSpanRows; i += kThreads)
    *reinterpret_cast<uint4*>(a_s + (i / kSpanRows) * kABytes + (kChunks - 1) * kChunkBytes + (i % kSpanRows) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // the clip and first frame of the block's i-th tile
  auto tile_at = [&](uint32_t i, int& b, int& t0) {
    const int tile = static_cast<int>(blockIdx.x + i * gridDim.x);
    b = tile / tiles_per_clip;
    t0 = (tile - b * tiles_per_clip) * kTile;
  };
  // hop rows of H stage v inside the clip (the rest of the stage is written as zeros)
  auto h_valid = [&](uint32_t v, int& b, int& row0) {
    int t0;
    tile_at(v / kHStages, b, t0);
    row0 = t0 + static_cast<int>(v % kHStages) * kHRows;
    return max(0, min(kHRows, rows - row0));
  };
  // H stage v into slot v % kHSlots (one thread)
  auto issue_h = [&](uint32_t v) {
    int b, row0;
    const int n = h_valid(v, b, row0);
    uint64_t* bar = &h_full[v % kHSlots];
    mbar_arrive_expect_tx(bar, static_cast<uint32_t>(n) * kHop * 4);
    if (n > 0)
      bulk_load(h_s + (v % kHSlots) * kHStageBytes, h + (static_cast<size_t>(b) * rows + row0) * kHop,
                static_cast<uint32_t>(n) * kHop * 4, bar);
  };
  // W stage n of the block's sequence into slot n % kWSlots (one thread): pass (n % stages_a_tile) / kStages,
  // its half of the columns that pass's parity
  auto issue_w = [&](uint32_t n) {
    const uint32_t k = n % stages_a_tile;
    const uint32_t image_stage = (k / kStages) % 2 * kStages + k % kStages;
    uint64_t* bar = &w_full[n % kWSlots];
    mbar_arrive_expect_tx(bar, kWStageBytes);
    bulk_load(ring + (n % kWSlots) * kWStageBytes, w_img + static_cast<size_t>(image_stage) * kWStageBytes,
              kWStageBytes, bar);
  };
  // round H stage v into its tile's A buffer, zeros for rows past the clip; the slot goes back for stage
  // v + kHSlots once every warp is done with it
  auto round_h = [&](uint32_t v) {
    const uint32_t slot = v % kHSlots;
    mbar_wait(&h_full[slot], (v / kHSlots) & 1u);
    int b, row0;
    const int n = h_valid(v, b, row0);
    const float* src = reinterpret_cast<const float*>(h_s + slot * kHStageBytes);
    unsigned char* dst = a_s + (v / kHStages) % 2 * kABytes + (v % kHStages) * kHRows * 16;
    for (int i = tid; i < kHTasks; i += kThreads) {
      const int r = i / (kHop / 8);
      const int c = i - r * (kHop / 8);
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) {
        const float4 v0 = *reinterpret_cast<const float4*>(src + r * kHop + 8 * c);
        const float4 v1 = *reinterpret_cast<const float4*>(src + r * kHop + 8 * c + 4);
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(__fadd_rn(v0.x, s), __fadd_rn(v0.y, s));
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(__fadd_rn(v0.z, s), __fadd_rn(v0.w, s));
        const __nv_bfloat162 p2 = __floats2bfloat162_rn(__fadd_rn(v1.x, s), __fadd_rn(v1.y, s));
        const __nv_bfloat162 p3 = __floats2bfloat162_rn(__fadd_rn(v1.z, s), __fadd_rn(v1.w, s));
        packed = make_uint4(*reinterpret_cast<const uint32_t*>(&p0), *reinterpret_cast<const uint32_t*>(&p1),
                            *reinterpret_cast<const uint32_t*>(&p2), *reinterpret_cast<const uint32_t*>(&p3));
      }
      *reinterpret_cast<uint4*>(dst + c * kChunkBytes + r * 16) = packed;
    }
    fence_proxy_async();  // the A writes are read by wgmma, and the slot is refilled by a bulk copy
    __syncwarp();
    if (lane == 0) mbar_arrive(&h_empty[slot]);
    if (warp == 4 && v + kHSlots < n_h) {  // warpgroup 1's first warp refills H, warp 0 refills W
      mbar_wait(&h_empty[slot], (v / kHSlots) & 1u);
      if (lane == 0) issue_h(v + kHSlots);
      __syncwarp();
    }
  };
  // W stage i's products are done in this warpgroup: the slot goes back for the stage kWSlots ahead
  auto finish = [&](uint32_t i) {
    const uint32_t next = i + kWSlots;
    if (next >= n_w) return;
    const uint32_t slot = i % kWSlots;
    if ((tid & 127) == 0) mbar_arrive(&w_empty[slot]);
    if (warp == 0) {
      mbar_wait(&w_empty[slot], (i / kWSlots) & 1u);
      if (lane == 0) issue_w(next);
      __syncwarp();
    }
  };

  if (tid == 0) {
    for (uint32_t n = 0; n < kWSlots && n < n_w; ++n) issue_w(n);
    for (uint32_t v = 0; v < kHSlots && v < n_h; ++v) issue_h(v);
  }
  uint32_t v = 0;  // the next H stage to round
  for (; v < kHStages; ++v) round_h(v);

  const uint32_t a_u = smem_u32(a_s);
  const uint32_t ring_u = smem_u32(ring);
  const uint64_t da = wgmma_desc(a_u + wg * 64 * 16, kChunkBytes, 128);
  const uint64_t db = wgmma_desc(ring_u, kStepBytes / 2, 128);
  const int row_in_tile = wg * 64 + 16 * (warp & 3) + (lane >> 2);  // this thread's first row; the second is + 8
  const int t = lane & 3;
  uint32_t q = 0;  // the next W stage
  for (uint32_t it = 0; it < static_cast<uint32_t>(my_tiles); ++it) {
    int b, t0;
    tile_at(it, b, t0);
    const uint32_t buf = it % 2;
    const bool has_next = it + 1 < static_cast<uint32_t>(my_tiles);
    // this tile's A is rounded and fenced by every thread, and both warpgroups are done with the other buffer
    __syncthreads();
    float acc[128];
    for (int d = 0; d < n_dots; ++d) {
#pragma unroll
      for (int hp = 0; hp < 2; ++hp) {
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < kStages; ++st, ++q) {
          const uint32_t slot = q % kWSlots;
          mbar_wait(&w_full[slot], (q / kWSlots) & 1u);
#pragma unroll
          for (int u = 0; u < kStageSteps; ++u) {
            const int step = st * kStageSteps + u;
            wgmma_m64n256k16_ss(acc, da + (buf * kABytes + step_a_bytes(step)) / 16,
                                db + (slot * kWStageBytes + u * kStepBytes) / 16, step > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (st > 0) finish(q - 1);
          // the next tile's H, one stage every kHEvery W stages of its first pass pair
          const int k = hp * kStages + st;
          if (k % kHEvery == 0 && k / kHEvery < kHStages && d == 0 && has_next) round_h(v++);
        }
        wgmma_wait<0>();
        finish(q - 1);
        wgmma_keep(acc);
        // acc[4j + 2hh + e]: row row_in_tile + 8 hh, column 256 hp + 8 j + 2 t + e
        const bool last = d == n_dots - 1;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = t0 + row_in_tile + 8 * hh;
          if (row >= t_pad) continue;
          float* orow = out + (static_cast<size_t>(b) * t_pad + row) * kOutCols;
#pragma unroll
          for (int j = 0; j < kPassN / 8; ++j) {
            const int col = 8 * j + 2 * t;
            if ((hp == 0 && j < kOutCols / 8 && last) || keep)
              *reinterpret_cast<float2*>(orow + col % kOutCols) = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
          }
        }
      }
    }
  }
}

}  // namespace

// h (B, rows, 200) float32, 16-byte aligned; w_img W (512, 512) bf16 in the
// kernel's order (frontend_micro_kernels.pack_poly_w_image); out (B, t_pad,
// 128) float32, t_pad + 2 <= rows. All contiguous. keep must be 0. Returns
// cudaGetLastError() after the launch, the error of an attribute call, or
// cudaErrorInvalidValue.
extern "C" int howl_micro_poly_forward(const void* h, const void* w_img, void* out, int B, int rows, int t_pad,
                                       float s, int n_dots, int keep, void* stream) {
  if (B == 0 || t_pad == 0) return 0;
  if (B < 0 || t_pad < 0 || rows < t_pad + 2 || n_dots < 1 || n_dots > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(micro_poly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = static_cast<long long>(B) * ((t_pad + kTile - 1) / kTile);
  // the block's counters of W stages are 32-bit, its tile numbers int
  if (n_tiles >= (1ll << 31) || n_tiles * 2 * kStages * n_dots >= (1ll << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  micro_poly_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const unsigned char*>(w_img), static_cast<float*>(out), B, rows,
      t_pad, s, n_dots, keep);
  return static_cast<int>(cudaGetLastError());
}
