// Shared pieces of the frontend cost study's three kernels (micro_stream.cu,
// micro_gemm.cu, micro_poly.cu): staging float32 spans of device memory into
// shared memory with cp.async, rounding them to bf16, and the product
//
//     A (64, 512) bf16  @  W (512, 512) bf16  ->  float32 sums
//
// of one block's rows with the whole of W on the tensor cores
// (mma.sync.m16n8k16, bf16 in, float32 accumulate).
//
// The study measures work whose results are mostly thrown away: the stream
// kernel stores a quarter of what it stages, the products store 128 of the
// 512 columns they compute, and the polyphase kernel's repeated passes each
// start anew. The compilers must not throw the work away:
//   - every staged byte moves through a cp.async, which is an asm volatile
//     with a memory clobber and is never eliminated, whoever reads the
//     shared memory afterwards;
//   - every ldmatrix and mma.sync is asm volatile, so nvcc's front end
//     neither deletes nor merges repeated identical ones;
//   - ptxas may still delete an mma whose sums nobody reads, so every
//     accumulator that is not stored for real is stored under `if (keep)`,
//     where `keep` is a kernel argument that the callers always pass as 0:
//     the store never runs, and the compiler cannot know that.
//
// The product's layout: a block of 256 threads (8 warps, 2 along M by 4
// along N) owns 64 rows. W does not fit shared memory (512 KB), so the block
// walks the 512 columns in four chunks of 128 and, inside a chunk, K in 16
// tiles of 32 rows; the (32, 128) tiles of W stream from L2 through a
// three-stage cp.async ring while the tensor cores work on the tile before.
// A warp's piece of a chunk is 32 x 32: 8 mma per two A and two B ldmatrix.x4.
// W is row-major (k, n), so its fragments come from ldmatrix.trans. Rows of
// the ring are padded by 8 bf16 (272 bytes), which spreads the eight rows of
// an ldmatrix over all 32 banks; the A tile's row stride is the caller's
// (520 for padded frame rows, 200 for the polyphase kernel's flat hop rows:
// both are 4 banks modulo 32, conflict-free as well).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNfft = 512;            // frame width; K and N of the product
constexpr int kOutCols = 128;         // columns of the product that are stored
constexpr int kStageFloats = 8192;    // one staging round: 32 KB of float32
constexpr int kBM = 64;               // rows of A a block owns
constexpr int kChunkN = 128;          // columns of W per chunk
constexpr int kChunks = kNfft / kChunkN;
constexpr int kKTile = 32;            // rows of W per ring stage
constexpr int kKTiles = kNfft / kKTile;
constexpr int kStages = 3;
constexpr int kBStride = kChunkN + 8;  // bf16 per ring row
constexpr int kRingBytes = kStages * kKTile * kBStride * 2;
// the staging buffer and the ring share one region: staging ends before the product starts
constexpr int kScratchBytes = kStageFloats * 4 > kRingBytes ? kStageFloats * 4 : kRingBytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; with valid == false nothing is read and zeros are written
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage n floats (a multiple of 4) of src into `stage`, 16 bytes a cp.async,
// and wait for them; floats at or past n_valid are zero-filled without a
// read (`safe` is any readable address). Ends with a barrier.
__device__ __forceinline__ void stage_f32(float* stage, const float* src, const float* safe, int n,
                                          long long n_valid) {
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) {
    const bool valid = i + 4 <= n_valid;
    cp_async16(stage + i, valid ? src + i : safe, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Stage n floats of src in rounds of kStageFloats and write bf16(v + s) of
// each (float32 add, round to nearest even) to dst(e), e the float's index
// in the span, four at a time (e is a multiple of 4 and dst(e) 8-byte aligned).
template <class Dst>
__device__ __forceinline__ void stage_convert(const float* src, int n, long long n_valid, float* stage, float s,
                                              Dst dst) {
  for (int base = 0; base < n; base += kStageFloats) {
    const int m = n - base < kStageFloats ? n - base : kStageFloats;
    stage_f32(stage, src + base, src, m, n_valid - base);
    for (int i = threadIdx.x * 4; i < m; i += kThreads * 4) {
      const float4 v = *reinterpret_cast<const float4*>(stage + i);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(__fadd_rn(v.x, s), __fadd_rn(v.y, s));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(__fadd_rn(v.z, s), __fadd_rn(v.w, s));
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst(base + i)) = packed;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's product of its A tile with W, n_dots times.
//
// a_s: the (64, 512) bf16 tile in shared memory, row m at a_s + m * kAStride.
// ring: kRingBytes of shared memory. w: (512, 512) bf16 in device memory.
// out: the tile's first output row, (rows, 128) float32 with rows_valid of
// them inside the array.
//
// kAccumulateDots: each chunk's accumulators sum n_dots products of the same
// operands, one after the other, and chunk 0 is stored. Otherwise every pass
// computes all four chunks from zero, and chunk 0 of the last pass is stored.
// All other accumulators are stored under `keep` (see the top of the file).
template <int kAStride, bool kAccumulateDots>
__device__ __forceinline__ void product_512(const __nv_bfloat16* a_s, __nv_bfloat16* ring,
                                            const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                                            int rows_valid, int n_dots, int keep) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // 32-row half of the tile
  const int wn = warp >> 1;  // 32-column quarter of the chunk
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix: this lane's row of the 16 x 16 piece
  const int lcol = (lane >> 4) * 8;                     // and its 8-column half
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int seg_len = kAccumulateDots ? n_dots * kKTiles : kKTiles;  // steps between two resets of acc
  const int steps = n_dots * kChunks * kKTiles;

  auto load_w = [&](int step) {
    const int c = (step / seg_len) % kChunks;
    const int kt = step % kKTiles;
    __nv_bfloat16* dst = ring + (step % kStages) * (kKTile * kBStride);
#pragma unroll
    for (int i = 0; i < kKTile * (kChunkN / 8) / kThreads; ++i) {
      const int p = tid + i * kThreads;
      const int r = p / (kChunkN / 8);
      const int q = (p % (kChunkN / 8)) * 8;
      cp_async16(dst + r * kBStride + q, w + static_cast<size_t>(kt * kKTile + r) * kNfft + c * kChunkN + q, true);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    load_w(st);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tile has landed, and everyone is done with the stage refilled below
    if (step + kStages - 1 < steps) load_w(step + kStages - 1);
    cp_async_commit();

    const int in_seg = step % seg_len;
    if (in_seg == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
    const __nv_bfloat16* bs = ring + (step % kStages) * (kKTile * kBStride);
    const int k0 = (step % kKTiles) * kKTile;
#pragma unroll
    for (int ks = 0; ks < kKTile / 16; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], a_s + (wm * 32 + mt * 16 + lrow) * kAStride + k0 + ks * 16 + lcol);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], bs + (ks * 16 + lrow) * kBStride + wn * 32 + np * 16 + lcol);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
    }

    if (in_seg == seg_len - 1) {
      const int seg = step / seg_len;
      const bool real = seg % kChunks == 0 && (kAccumulateDots || seg / kChunks == n_dots - 1);
      if (real || keep) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm * 32 + mt * 16 + g + 8 * h;
            if (row >= rows_valid) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int col = wn * 32 + nt * 8 + tig * 2;
              *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * kOutCols + col) =
                  make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
            }
          }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace
