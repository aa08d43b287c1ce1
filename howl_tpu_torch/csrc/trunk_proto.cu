// Fused six-layer residual trunk proto for Hopper (sm_90a): six 3x3 convs as
// implicit GEMMs on the tensor cores (wgmma), with ReLU, residual, affine and
// pad mask, then the window-pool GEMM, without leaving the SM.
//
// Replaces the TPU kernel tools/bench_trunk_kernel_micro.py, make_proto
// (Pallas kernel `kernel`, both variants). Activations are position-major:
// x (B, pos_pad, 48) bf16, position p = t * 10 + f. For layer L = 0..5
//
//     acc[p] = sum over taps (dt, df) of x[p + 10 dt + df] @ W_L[tap * 48 : tap * 48 + 48]
//
// in float32, tap = 3 (dt + 1) + (df + 1); reads outside [0, pos_pad) are
// zero; df = -1 taps are masked where p % 10 == 0, df = +1 taps where
// p % 10 == 9. y = relu(acc); r = y + res for odd L, else y. For L < 5 the
// next x is bf16(p < pos ? (r - shift[L]) * scale[L] : 0), and res = x after
// odd L; r6 = r at L = 5. res starts as the layer-0 input. The output is
// (pool_t @ bf16(r6) - shift[6]) * scale[7], (B, n_win_pad, 48) float32.
// With full_build == 0 every layer's GEMM reads the layer-0 input's taps.
//
// What bounds it on this card: the tensor cores. A clip's six layers are
// 6 x 2176 x 432 x 48 x 2 = 0.54 GFLOP (plus the pool GEMM) against 0.2 MB
// of input, far above the card's ~295 FLOP/byte balance point.
//
// What the design does about it:
//  * Slots instead of masks. In shared memory a pooled frame is 12 rows, its
//    10 positions between two zero slots, so a tap with df = -1 or +1 at the
//    frame's edge reads a zero slot: every tap is the same rows shifted by
//    12 dt + df, with no mask. The rows are chunk-major: 6 chunks of 8
//    channels, each chunk a column of 16-byte rows, so the 8 rows of a core
//    matrix are 128 contiguous bytes from any starting row. A tap's A operand
//    is then a wgmma descriptor whose start address moves by (12 dt + df) x
//    16 bytes (leading offset: one chunk column; stride offset: 128 bytes),
//    and each layer is 27 wgmma m64n48k16 per 64 rows, A and B both from
//    shared memory. The slots cost 20 % more rows; the epilogue writes them
//    back as zeros, with the positions past pos (the pad mask) and before the
//    clip.
//  * Tiles with a shrinking halo. A block walks a clip in tiles of kT = 44
//    pooled frames. Layer L computes frames [a - 5 + L, a + kT + 5 - L) of
//    the tile at frame a, one frame less each side per layer, so the
//    layer-0 input spans kT + 12 frames and layer 5 exactly the tile's kT.
//    Rows are taken in whole m64 tiles, dealt to the two warpgroups in turn;
//    a warpgroup left one short recomputes tile 0 and stores nothing, since
//    the layer waits for the slower one anyway.
//  * Two activation buffers. Full build: the taps of layer L read buffer
//    L % 2, an even layer writes buffer 1, an odd layer reads res from
//    buffer 0 and writes the new x in place there (the same thread reads and
//    writes a row). Gemm-only: every layer reads buffer 0, the layer-0 input;
//    res lives in buffer 1; the even layers' products run and are not stored.
//  * Weights by bulk copies. The host packs W_L into the image a K-major
//    wgmma descriptor reads (trunk_kernels.pack_trunk_w_image: cores of 8 n
//    by 8 k, 768 bytes a k-core); each layer's 41.5 KB arrives by one bulk
//    copy on an mbarrier into one of two slots while the layer before
//    computes.
//  * Epilogue beside the products. A warpgroup's tiles go in pairs, one
//    commit group a tile; a tile of the next pair is issued before each
//    epilogue of this pair, which then runs while that tile computes.
//  * The pool product on wgmma. r6 is written as the B operand (K = the
//    tile's 528 slot rows, N = 48) into the taps' buffer once both
//    warpgroups are done with it; A is pool_t over the same slot rows, packed
//    by the host as each thread's A fragments (trunk_kernels.pack_trunk_pool_image,
//    one 16-byte load per thread and k16 step, L2-resident). Each warpgroup
//    owns 64 windows and keeps their (64, 48) float32 sums in registers
//    across the clip's tiles, with no atomics.
//  * Persistent blocks over clips. The next tile's input arrives by cp.async
//    (16 bytes a thread, zero-filled for slots and rows outside the clip)
//    into buffer 0 while the pool product runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;              // two warpgroups
constexpr int kCh = 48;                    // channels: N of each layer GEMM, K of one tap
constexpr int kChunks = kCh / 8;           // chunk columns of 16-byte rows
constexpr int kKSteps = 9 * kCh / 16;      // 27 k16 steps of K = 432
constexpr int kFOut = 10;                  // positions per pooled frame
constexpr int kSlots = 12;                 // rows per pooled frame: a zero slot each side
constexpr int kT = 44;                     // pooled frames a tile keeps
constexpr int kHalo = 6;                   // frames each side of the layer-0 input: the six layers' reach
constexpr int kLoadRows = kSlots * (kT + 2 * kHalo);  // 672
constexpr int kGuard = 1;                  // rows below the tile's row 0 (a tap reads row -1)
constexpr int kReach = kSlots + 1;         // a tap reads up to 13 rows away

// layer L's rows relative to the tile's row 0 (frame a - 6): from first_row, need_rows of them
__host__ __device__ constexpr int first_row(int layer) { return kSlots * (layer + 1); }
__host__ __device__ constexpr int need_rows(int layer) { return kSlots * (kT + 2 * (kHalo - 1) - 2 * layer); }
__host__ __device__ constexpr int m_tiles(int layer) { return (need_rows(layer) + 63) / 64; }
__host__ __device__ constexpr int per_wg(int layer) { return (m_tiles(layer) + 1) / 2; }
__host__ __device__ constexpr int max_end() {
  int e = 0;
  for (int layer = 0; layer < 6; ++layer) {
    const int v = first_row(layer) + 64 * m_tiles(layer) + kReach;
    e = v > e ? v : e;
  }
  return e;
}

constexpr int kBufRows = kGuard + max_end();  // 730
constexpr int kChunkBytes = kBufRows * 16;
constexpr int kBufBytes = kChunks * kChunkBytes;
constexpr int kKCoreBytes = kChunks * 128;    // 768: 8 k by 48 n in the W and r6 images
constexpr int kWBytes = 9 * kCh / 8 * kKCoreBytes;  // 41,472: one layer's image
constexpr int kR6Rows = kSlots * kT;          // 528: K of a tile's pool product
constexpr int kPoolSteps = kR6Rows / 16;      // 33
constexpr int kPoolBatch = 11;                // k16 steps of the pool product whose A fragments load together
constexpr int kSmemBytes = 2 * kBufBytes + 2 * kWBytes + 2 * 8;

static_assert(kR6Rows % 16 == 0, "a tile's pool product takes whole k16 steps");
static_assert(kPoolSteps % kPoolBatch == 0, "the pool product goes in whole batches");
static_assert(kR6Rows / 8 * kKCoreBytes <= kBufBytes, "r6 must fit in an activation buffer");
static_assert(kLoadRows + kGuard <= kBufRows, "the layer-0 input must fit in a buffer");
static_assert(kSmemBytes <= 232448, "a block may use 227 KB of shared memory");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

struct Ctx {
  unsigned char* buf;     // the two activation buffers, kBufBytes apart
  uint32_t buf_s;         // their shared-memory address
  uint32_t w_s;           // the two weight slots
  uint64_t* w_full;       // their mbarriers
  const unsigned char* w_img;
  const float* scale;
  const float* shift;
  int a, pos, pos_pad, wg, row, t, tid, full_build, n_layers;
};

// layer c of the block's sequence: its image into slot c % 2 (one thread)
__device__ __forceinline__ void issue_w(const Ctx& cx, int c) {
  mbar_arrive_expect_tx(&cx.w_full[c & 1], kWBytes);
  bulk_load(cx.buf + 2 * kBufBytes + (c & 1) * kWBytes,
            cx.w_img + static_cast<size_t>(c % 6) * kWBytes, kWBytes, &cx.w_full[c & 1]);
}

// a tile's layer-0 input into buffer 0: kT + 12 frames of 12 slot rows, zeros outside the clip
__device__ __forceinline__ void load_x(const Ctx& cx, const __nv_bfloat16* x, int b, int a) {
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * cx.pos_pad * kCh;
  const uint32_t base = cx.buf_s + kGuard * 16;
  for (int i = cx.tid; i < kChunks * kLoadRows; i += kThreads) {
    const int c = i / kLoadRows;
    const int r = i - c * kLoadRows;
    const int fr = a - kHalo + r / kSlots;
    const int slot = r % kSlots;
    const int p = fr * kFOut + slot - 1;
    const bool valid = slot >= 1 && slot <= kFOut && fr >= 0 && p < cx.pos_pad;
    cp_async16(base + c * kChunkBytes + r * 16, valid ? xb + static_cast<size_t>(p) * kCh + c * 8 : x, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the products of the warpgroup's tile i of layer L: 27 wgmma
// (A descriptor's address field counts 16 bytes and every operand lies below 256 KB, so a descriptor plus
// bytes / 16 describes the same operand that many bytes further on: each step adds a constant.)
template <int L>
__device__ __forceinline__ void tile_products(const Ctx& cx, float (&acc)[24], int i, int src, uint32_t w_s) {
  const int m = cx.wg + 2 * i;
  const uint32_t arow = cx.buf_s + src * kBufBytes + (kGuard + first_row(L) + 64 * (m < m_tiles(L) ? m : 0)) * 16;
  const uint64_t da = wgmma_desc(arow - kReach * 16, kChunkBytes, 128);  // the first tap reads 13 rows back
  const uint64_t db = wgmma_desc(w_s, kKCoreBytes, 128);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int tap = ks / 3;
    const int rows = kReach + kSlots * (tap / 3 - 1) + (tap % 3 - 1);  // 0 .. 26
    wgmma_m64n48k16_ss(acc, da + (2 * (ks % 3) * kChunkBytes + rows * 16) / 16, db + ks * 2 * kKCoreBytes / 16, ks > 0);
  }
}

// relu, residual, affine and masks of tile i of layer L < 5, written as the next x; sc and sh hold the affine of
// this thread's columns 8 j + 2 t + e at 2 j + e
template <int L>
__device__ __forceinline__ void layer_epilogue(const Ctx& cx, const float (&acc)[24], int i, int res, int dst,
                                               bool store, const float (&sc)[12], const float (&sh)[12]) {
  const int m = cx.wg + 2 * i;
  if (m >= m_tiles(L) || !store) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = first_row(L) + 64 * m + cx.row + 8 * h;
    if (r >= first_row(L) + need_rows(L)) continue;
    const int slot = r % kSlots;
    const int p = (cx.a - kHalo + r / kSlots) * kFOut + slot - 1;
    const bool keep = slot >= 1 && slot <= kFOut && p >= 0 && p < cx.pos;
    const int off = (kGuard + r) * 16 + cx.t * 4;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      float v0 = fmaxf(acc[4 * j + 2 * h], 0.f);
      float v1 = fmaxf(acc[4 * j + 2 * h + 1], 0.f);
      if (L & 1) {
        const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(cx.buf + res * kBufBytes + j * kChunkBytes + off);
        v0 = v0 + __low2float(rv);
        v1 = v1 + __high2float(rv);
      }
      const float y0 = keep ? (v0 - sh[2 * j]) * sc[2 * j] : 0.f;
      const float y1 = keep ? (v1 - sh[2 * j + 1]) * sc[2 * j + 1] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(cx.buf + dst * kBufBytes + j * kChunkBytes + off) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

// layer L < 5 of the tile; c is its place in the block's sequence of layers. The warpgroup's tiles go in pairs,
// the next pair in the other half of acc.
template <int L>
__device__ __forceinline__ void run_layer(const Ctx& cx, int c) {
  constexpr int kPer = per_wg(L);
  constexpr int kGroups = (kPer + 1) / 2;
  if (cx.tid == 0 && c + 1 < cx.n_layers) issue_w(cx, c + 1);
  const int src = cx.full_build ? (L & 1) : 0;
  const int res = cx.full_build || L == 1 ? 0 : 1;
  const int dst = cx.full_build && (L & 1) ? 0 : 1;
  const bool store = cx.full_build || (L & 1);
  const uint32_t w_s = cx.w_s + (c & 1) * kWBytes;
  float sc[12], sh[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    const int n = 8 * (e / 2) + 2 * cx.t + (e & 1);
    sc[e] = __ldg(cx.scale + L * kCh + n);
    sh[e] = __ldg(cx.shift + L * kCh + n);
  }
  mbar_wait(&cx.w_full[c & 1], (c >> 1) & 1);
  float acc[2][2][24];
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < 2 && u < kPer; ++u) {
    tile_products<L>(cx, acc[0][u], u, src, w_s);
    wgmma_commit();
  }
  // each tile is a commit group; a tile of the next pair is issued before each epilogue of this pair, so an
  // epilogue runs while the tensor cores work on the tile just issued
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = 2 * gi + u;
      const int next = i + 2;
      if (next < kPer) {
        wgmma_fence();
        tile_products<L>(cx, acc[(gi + 1) & 1][u], next, src, w_s);
        wgmma_commit();
      }
      if (i >= kPer) continue;
      // tile i is done when at most the tiles issued after it are pending: i + 1 and next, where they exist
      if (next < kPer && i + 1 < kPer)
        wgmma_wait<2>();
      else if (next < kPer || i + 1 < kPer)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      wgmma_keep(acc[gi & 1][u]);
      layer_epilogue<L>(cx, acc[gi & 1][u], i, res, dst, store, sc, sh);
    }
  }
  fence_proxy_async();  // the stores are read by the next layer's wgmma (the async proxy)
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
trunk_proto_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w_img,
                   const uint4* __restrict__ pool_img, const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ out, int n_clips, int pos, int pos_pad,
                   int n_win_pad, int n_tiles, int full_build) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  Ctx cx;
  cx.buf = smem;
  cx.buf_s = smem_u32(smem);
  cx.w_s = cx.buf_s + 2 * kBufBytes;
  cx.w_full = reinterpret_cast<uint64_t*>(smem + 2 * kBufBytes + 2 * kWBytes);
  cx.w_img = w_img;
  cx.scale = scale;
  cx.shift = shift;
  cx.pos = pos;
  cx.pos_pad = pos_pad;
  cx.wg = warp >> 2;
  cx.row = 16 * (warp & 3) + (lane >> 2);  // this thread's first row of a 64-row tile; the second is row + 8
  cx.t = lane & 3;
  cx.tid = tid;
  cx.full_build = full_build;
  const int n_mine = blockIdx.x < n_clips ? (n_clips - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  cx.n_layers = n_mine * n_tiles * 6;

  if (tid == 0) {
    mbar_init(&cx.w_full[0], 1);
    mbar_init(&cx.w_full[1], 1);
    mbar_init_fence();
    if (cx.n_layers > 0) issue_w(cx, 0);
  }
  if (n_mine > 0) load_x(cx, x, blockIdx.x, 0);

  float pacc[24];
#pragma unroll
  for (int e = 0; e < 24; ++e) pacc[e] = 0.f;
  int c = 0;
  for (int ci = 0; ci < n_mine; ++ci) {
    const int b = blockIdx.x + ci * gridDim.x;
    for (int j = 0; j < n_tiles; ++j, c += 6) {
      cx.a = j * kT;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      fence_proxy_async();
      __syncthreads();  // the input has landed; the last pool product is done with buffer 1
      run_layer<0>(cx, c);
      run_layer<1>(cx, c + 1);
      run_layer<2>(cx, c + 2);
      run_layer<3>(cx, c + 3);
      run_layer<4>(cx, c + 4);

      // layer 5: r6 = relu(acc) + res, rounded to bf16 (in registers, two to a word, until both warpgroups are
      // done with their taps and res) as the pool product's B operand in buffer 1
      constexpr int kPer = per_wg(5);
      constexpr int kGroups = (kPer + 1) / 2;
      if (tid == 0 && c + 6 < cx.n_layers) issue_w(cx, c + 6);
      mbar_wait(&cx.w_full[(c + 5) & 1], ((c + 5) >> 1) & 1);
      const int src = full_build ? 1 : 0;
      const int res = full_build ? 0 : 1;
      const uint32_t w5 = cx.w_s + ((c + 5) & 1) * kWBytes;
      uint32_t r6p[kPer][2 * kChunks];  // tile i: row h, chunk jj at 6 h + jj
      float acc[2][2][24];
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2 && u < kPer; ++u) tile_products<5>(cx, acc[0][u], u, src, w5);
      wgmma_commit();
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        if (gi + 1 < kGroups) {
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (2 * (gi + 1) + u < kPer) tile_products<5>(cx, acc[(gi + 1) & 1][u], 2 * (gi + 1) + u, src, w5);
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 2 * gi + u;
          if (i >= kPer) continue;
          wgmma_keep(acc[gi & 1][u]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = 64 * (cx.wg + 2 * i) + cx.row + 8 * h;  // K row of the pool product: slot row 72 + q
            const int slot = q % kSlots;
            const bool keep = slot >= 1 && slot <= kFOut && (cx.a + q / kSlots) * kFOut + slot - 1 < pos_pad;
            const int off = (kGuard + first_row(5) + q) * 16 + cx.t * 4;
#pragma unroll
            for (int jj = 0; jj < kChunks; ++jj) {
              const __nv_bfloat162 rv =
                  *reinterpret_cast<const __nv_bfloat162*>(cx.buf + res * kBufBytes + jj * kChunkBytes + off);
              const float v0 = fmaxf(acc[gi & 1][u][4 * jj + 2 * h], 0.f) + __low2float(rv);
              const float v1 = fmaxf(acc[gi & 1][u][4 * jj + 2 * h + 1], 0.f) + __high2float(rv);
              const __nv_bfloat162 r6 = __floats2bfloat162_rn(keep ? v0 : 0.f, keep ? v1 : 0.f);
              r6p[i][6 * h + jj] = *reinterpret_cast<const uint32_t*>(&r6);
            }
          }
        }
      }
      __syncthreads();  // both warpgroups are done with their taps and res: buffer 1 takes r6
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int m = cx.wg + 2 * i;
        if (m >= m_tiles(5)) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 64 * m + cx.row + 8 * h;
          if (q >= kR6Rows) continue;
          unsigned char* r6 = cx.buf + kBufBytes + (q / 8) * kKCoreBytes + (q % 8) * 2;
#pragma unroll
          for (int jj = 0; jj < kChunks; ++jj) {
            const int n = 8 * jj + 2 * cx.t;  // n and n + 1 lie 16 bytes apart in the operand's core
            *reinterpret_cast<uint16_t*>(r6 + (n / 8) * 128 + (n % 8) * 16) = static_cast<uint16_t>(r6p[i][6 * h + jj]);
            *reinterpret_cast<uint16_t*>(r6 + (n / 8) * 128 + (n % 8 + 1) * 16) =
                static_cast<uint16_t>(r6p[i][6 * h + jj] >> 16);
          }
        }
      }
      if (j + 1 < n_tiles)
        load_x(cx, x, b, (j + 1) * kT);
      else if (ci + 1 < n_mine)
        load_x(cx, x, b + gridDim.x, 0);
      fence_proxy_async();
      __syncthreads();  // r6 is complete

      // the pool product: this warpgroup's 64 windows over the tile's 528 slot rows, its A fragments in three
      // batches of 11 k16 steps through two sets of registers
      const uint4* pa = pool_img + (static_cast<size_t>(j) * kPoolSteps * 2 + cx.wg) * 128 + (tid & 127);
      const uint64_t dr = wgmma_desc(cx.buf_s + kBufBytes, kKCoreBytes, 128);
      uint4 a[2][kPoolBatch];
#pragma unroll
      for (int bt = 0; bt < 2; ++bt)
#pragma unroll
        for (int e = 0; e < kPoolBatch; ++e) a[bt][e] = __ldg(pa + (bt * kPoolBatch + e) * 2 * 128);
#pragma unroll
      for (int bt = 0; bt < kPoolSteps / kPoolBatch; ++bt) {
        if (bt >= 2) {
          wgmma_wait<1>();  // batch bt - 2 is done with its registers
          wgmma_keep(pacc);
#pragma unroll
          for (int e = 0; e < kPoolBatch; ++e) a[bt & 1][e] = __ldg(pa + (bt * kPoolBatch + e) * 2 * 128);
        }
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < kPoolBatch; ++e) {
          const int ks = bt * kPoolBatch + e;
          const uint4 f = a[bt & 1][e];
          wgmma_m64n48k16_rs(pacc, f.x, f.y, f.z, f.w, dr + ks * 2 * kKCoreBytes / 16, j > 0 || ks > 0);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      wgmma_keep(pacc);
    }
    float* ob = out + static_cast<size_t>(b) * n_win_pad * kCh;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 64 * cx.wg + cx.row + 8 * h;
      if (m >= n_win_pad) continue;
#pragma unroll
      for (int jj = 0; jj < kChunks; ++jj) {
        const int n = 8 * jj + 2 * cx.t;
        float2 v;
        v.x = (pacc[4 * jj + 2 * h] - shift[6 * kCh + n]) * scale[7 * kCh + n];
        v.y = (pacc[4 * jj + 2 * h + 1] - shift[6 * kCh + n + 1]) * scale[7 * kCh + n + 1];
        *reinterpret_cast<float2*>(ob + m * kCh + n) = v;
      }
    }
  }
}

}  // namespace

// x (B, pos_pad, 48) bf16, 16-byte aligned; w_img the six layers' weight
// images (trunk_kernels.pack_trunk_w_image); pool_img pool_t's A fragments
// (trunk_kernels.pack_trunk_pool_image, 128 windows); scale, shift (8, 48)
// float32; out (B, n_win_pad, 48) float32. All contiguous; pos_pad and
// n_win_pad multiples of 16, n_win_pad <= 128. Returns cudaGetLastError()
// after the launch, the error of an attribute call, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int howl_trunk_proto_forward(const void* x, const void* w_img, const void* pool_img, const void* scale,
                                        const void* shift, void* out, int B, int pos, int pos_pad, int n_win_pad,
                                        int full_build, void* stream) {
  if (B < 0 || pos_pad <= 0 || pos_pad % 16 || n_win_pad % 16 || n_win_pad > 128 || pos < 0 || pos > pos_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int n_tiles = ((pos_pad + kFOut - 1) / kFOut + kT - 1) / kT;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(trunk_proto_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B < sms ? B : sms;
  trunk_proto_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w_img),
      static_cast<const uint4*>(pool_img), static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(out), B, pos, pos_pad, n_win_pad, n_tiles, full_build);
  return static_cast<int>(cudaGetLastError());
}
