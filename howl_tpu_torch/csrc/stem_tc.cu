// Fused res8 stem on the tensor cores (sm_90a): conv0 (3x3, 1 -> ch) + ReLU +
// AvgPool(3, 4) for bf16 mels, the "tc" route of ops/stem_cuda.py.
//
// Replaces the TPU kernel howl_tpu/ops/stem_pallas.py, res8_stem_pallas
// (Pallas kernel _stem_kernel), as stem.cu does, and computes the same
// function on time-major ZMUV'd log-mels mel (B, T, n_mels):
//
//     out[b, t', f', c] = (1/12) * sum over the (3, 4) window at (t', f') of
//                         relu(sum_{dt, df} taps[dt, df, c] * mel[b, t+dt-1, f+df-1])
//
// with zero SAME padding, ReLU at full resolution and T' = T // 3. bf16 mels,
// the taps rounded to bf16, float32 sums, one rounding at the store: the
// rounding points of res8_stem_pallas with a bf16 w0fold. The output is
// channels-last (B, T', n_mels / 4, ch).
//
// What bounds it on this card: memory first. At 512 x 641 x 40 the mels are
// 26.3 MB and the output 98.1 MB (0.037 ms at 3.35 TB/s); the 10.6 GFLOP of
// the product are microseconds on the tensor cores. stem.cu spends 0.75 ms
// re-reading each mel value from shared memory 108 times an output. Here the
// next limit is the instructions that must touch every full-resolution value:
// a ReLU and an add each, 69 of the 140 instructions of a warp's pooled frame.
//
// What the design does about it:
//  * conv0 is an implicit GEMM on mma.sync.m16n8k16: M the channels (three
//    tiles of 16, 48 >= ch), N eight neighbouring mel bins of one frame, K the
//    nine taps padded to 16. The taps are A and stay in registers for the
//    block's life (12 registers a thread, from the host's tap image, (16, 48)
//    bf16, ops/stem_cuda.pack_tap_image). The taps are ordered along K (kTapDt,
//    kTapDf) so that a lane's two B values of one k pair are two mel values of
//    one row: the B fragment of a lane is two 16-bit shared-memory loads and
//    one more for the ninth tap.
//  * Pooling in registers: a lane's products hold two neighbouring bins of two
//    channels, so the three frames of a window add in the lane across three
//    products (each ReLU'd first), the two bin pairs of a window meet by one
//    shuffle, and the pre-pool activation never leaves the SM.
//  * A block owns one clip and kTile = 24 pooled frames, a warp each 8 bins
//    (five warps at 40 mels), and walks its frames by pointer steps: no index
//    arithmetic beyond an add in the loop. The tile's 3 * 24 + 2 mel rows
//    arrive by 8-byte cp.async (zero-filled outside the clip) into rows padded
//    with zero columns, so the frequency edge needs no test.
//  * The tile's output, 24 x n_mels / 4 x ch bf16, is one contiguous run of
//    the output tensor: it is staged in shared memory at the run's offset
//    modulo 16 bytes and leaves as 16-byte stores. A clip's output is 191,700
//    bytes, which is no multiple of 16, so the run's ends are written 2 bytes
//    at a time.
//  * Tried on the card and dropped: persistent blocks with the next tile's rows
//    arriving while the current one computes (slower at every tile height,
//    0.154 against 0.136 ms at 16); more blocks to an SM by capping registers
//    at 48 (spills, no gain); tiles of 8 to 72 frames (24 and 36 fastest).
//
// The geometry it serves: pool (3, 4), n_mels a multiple of 4 up to 128 and
// ch <= 48, where a block takes at most ~94 KB of shared memory
// (ops/stem_cuda.stem_route decides; the entry refuses the rest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 128;              // a warp per 8 bins of a tile, at most 16 warps
constexpr int kMaxThreads = 32 * (kMaxBins / 8);
constexpr int kTile = 24;                  // pooled frames a block owns
constexpr int kPoolT = 3;                  // the pool it serves
constexpr int kPoolF = 4;
constexpr int kRows = kPoolT * kTile + 2;  // mel rows of a tile, with the halo above and below
constexpr int kN = 48;                     // channels padded to three m16 tiles
constexpr int kChTiles = kN / 16;
constexpr int kColPad = 4;                 // zero columns before bin 0 (8 bytes: rows stay 8-byte aligned)
constexpr int kMaxSmem = 232448;           // 227 KB a block

// The tap of row k of the tap image: (dt, df) in -1..1. A lane's k pairs are
// (2q, 2q + 1) and (2q + 8, 2q + 9); the first three pairs are two
// neighbouring bins of one row, so most B halves sit side by side.
__constant__ int kTapDt[9] = {-1, -1, 0, 0, 1, 1, -1, 0, 1};
__constant__ int kTapDf[9] = {-1, 0, -1, 0, -1, 0, 1, 1, 1};

__host__ __device__ __forceinline__ int row_stride(int n_mels) { return ((n_mels + 7) & ~7) + 2 * kColPad; }

__host__ __device__ __forceinline__ int mel_bytes(int n_mels) { return kRows * row_stride(n_mels) * 2; }

__host__ __device__ __forceinline__ int out_tile_bytes(int n_mels, int ch) { return kTile * (n_mels / kPoolF) * ch * 2 + 16; }

__host__ __device__ __forceinline__ int shared_bytes(int n_mels, int ch) { return mel_bytes(n_mels) + out_tile_bytes(n_mels, ch); }

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d = a (16 x 16) @ b (16 x 8), bf16 operands, float32 sums from zero
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// 8 bytes device -> shared memory, asynchronously; zeros where !valid (src is not read then)
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
stem_tc_kernel(const __nv_bfloat16* __restrict__ mel, const __nv_bfloat16* __restrict__ img,
               __nv_bfloat16* __restrict__ out, int T, int n_mels, int ch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = row_stride(n_mels);
  __nv_bfloat16* s_mel = reinterpret_cast<__nv_bfloat16*>(smem);  // kRows x stride, bin f at column kColPad + f
  unsigned char* s_out = smem + mel_bytes(n_mels);
  const int t_out = T / kPoolT;
  const int f_out = n_mels / kPoolF;
  // one grid axis of clips x tiles, the tiles of a clip adjacent: up to 2^31 - 1 blocks, so no cap on the clips
  const int n_tiles = (t_out + kTile - 1) / kTile;
  const int b = blockIdx.x / n_tiles;
  const int tp0 = (blockIdx.x % n_tiles) * kTile;
  const int n_pooled = min(kTile, t_out - tp0);
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;  // a warp per 8 bins

  // the tile's rows, zero outside the clip, by cp.async; the zero columns on both sides of every row
  const int chunks = n_mels / 4;  // 8-byte chunks of a row
  const int r0 = tp0 * kPoolT - 1;  // the mel row in s_mel's row 0
  const uint2* src = reinterpret_cast<const uint2*>(mel + static_cast<size_t>(b) * T * n_mels);
  for (int i = tid; i < kRows * chunks; i += n_threads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int t = r0 + r;
    const bool inside = t >= 0 && t < T;
    cp_async8(s_mel + r * stride + kColPad + 4 * c, src + (inside ? static_cast<size_t>(t) * chunks + c : 0), inside);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int pad_chunks = (stride - n_mels) / 4;  // one before bin 0, the rest after the last bin
  for (int i = tid; i < kRows * pad_chunks; i += n_threads) {
    const int r = i / pad_chunks;
    const int c = i - r * pad_chunks;
    *reinterpret_cast<uint2*>(s_mel + r * stride + (c == 0 ? 0 : kColPad + n_mels + 4 * (c - 1))) = make_uint2(0u, 0u);
  }

  // A: the taps of channel tile m, rows 16m + g and + 8, k pairs (2q, 2q + 1) and (2q + 8, 2q + 9)
  const int lane = tid & 31;
  const int ft = tid >> 5;  // this warp's eight bins start at 8 ft
  const int g = lane >> 2;
  const int q = lane & 3;
  uint32_t a[kChTiles][4];
#pragma unroll
  for (int m = 0; m < kChTiles; ++m) {
    const __nv_bfloat16* col = img + 16 * m + g;
    a[m][0] = pack2(col[(2 * q) * kN], col[(2 * q + 1) * kN]);
    a[m][1] = pack2(col[(2 * q) * kN + 8], col[(2 * q + 1) * kN + 8]);
    a[m][2] = pack2(col[(2 * q + 8) * kN], col[(2 * q + 9) * kN]);
    a[m][3] = pack2(col[(2 * q + 8) * kN + 8], col[(2 * q + 9) * kN + 8]);
  }
  // B: the lane's taps as offsets from mel[t, f]; the ninth tap (k = 8) is lane q = 0's alone, k 9-15 are zero
  const int off_lo = kTapDt[2 * q] * stride + kTapDf[2 * q];
  const int off_hi = kTapDt[2 * q + 1] * stride + kTapDf[2 * q + 1];
  const int off_b1 = q == 0 ? kTapDt[8] * stride + kTapDf[8] : 0;
  const uint32_t keep_b1 = q == 0 ? 0xffffu : 0u;
  // The lane's outputs: window fo of channels 16m + g (even q) or 16m + g + 8 (odd q), see below. The run of the
  // output tensor that the tile fills starts at dst; stage holds it at dst's offset modulo 16 bytes.
  const int odd = q & 1;
  const int fo = 2 * ft + (q >> 1);
  const int c0 = g + 8 * odd;
  bool keep[kChTiles];
#pragma unroll
  for (int m = 0; m < kChTiles; ++m) keep[m] = fo < f_out && c0 + 16 * m < ch;
  const float inv_pool = 1.0f / static_cast<float>(kPoolT * kPoolF);
  __nv_bfloat16* dst = out + (static_cast<size_t>(b) * t_out + tp0) * f_out * ch;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(s_out + (reinterpret_cast<uintptr_t>(dst) & 15));
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // Pooled frame by pooled frame: three frames of three products, ReLU'd and added in the lane.
  const __nv_bfloat16* centre = s_mel + stride + kColPad + 8 * ft + g;  // the first frame of pooled frame 0
  __nv_bfloat16* o = stage + fo * ch + c0;
  for (int tl = 0; tl < n_pooled; ++tl, centre += kPoolT * stride, o += f_out * ch) {
    float acc[kChTiles][4];
#pragma unroll
    for (int r = 0; r < kPoolT; ++r) {
      const __nv_bfloat16* p = centre + r * stride;
      const uint32_t b0 = pack2(p[off_lo], p[off_hi]);
      const uint32_t b1 = keep_b1 & __bfloat16_as_ushort(p[off_b1]);
#pragma unroll
      for (int m = 0; m < kChTiles; ++m) {
        float d[4];
        mma_bf16(d, a[m], b0, b1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = fmaxf(d[i], 0.f);
          acc[m][i] = r == 0 ? v : acc[m][i] + v;
        }
      }
    }
    // acc[m][0, 1]: bins 2q, 2q + 1 of channel 16m + g; acc[m][2, 3]: the same bins of channel 16m + g + 8. Lanes q
    // and q ^ 1 hold the two bin pairs of window q / 2: the even lane keeps the first channel, the odd the second.
#pragma unroll
    for (int m = 0; m < kChTiles; ++m) {
      const float lo = acc[m][0] + acc[m][1];
      const float hi = acc[m][2] + acc[m][3];
      const float other = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
      const float y = ((odd ? hi : lo) + other) * inv_pool;
      if (keep[m]) o[16 * m] = __float2bfloat16_rn(y);
    }
  }
  __syncthreads();

  // The tile's output is one run of the output tensor: [g0, g1) in bytes. The 16-byte blocks of the run inside
  // [a0, a1) copy as whole vectors; the ends go 2 bytes at a time.
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t g1 = g0 + 2 * static_cast<uintptr_t>(n_pooled) * f_out * ch;
  const uintptr_t a0 = (g0 + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t a1 = g1 & ~static_cast<uintptr_t>(15);
  const unsigned char* s0 = reinterpret_cast<const unsigned char*>(stage);
  const uintptr_t head_end = a0 < g1 ? a0 : g1;
  for (uintptr_t v = g0 + 2 * tid; v < head_end; v += 2 * n_threads)
    *reinterpret_cast<uint16_t*>(v) = *reinterpret_cast<const uint16_t*>(s0 + (v - g0));
  for (uintptr_t v = a0 + 16 * tid; v < a1; v += 16 * n_threads)
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(s0 + (v - g0));
  for (uintptr_t v = (a1 >= a0 ? a1 : g1) + 2 * tid; v < g1; v += 2 * n_threads)
    *reinterpret_cast<uint16_t*>(v) = *reinterpret_cast<const uint16_t*>(s0 + (v - g0));
}

}  // namespace

// mel (B, T, n_mels) bf16, 8-byte aligned; img the (16, 48) bf16 tap image
// (ops/stem_cuda.pack_tap_image); out (B, T // 3, n_mels // 4, ch) bf16. All
// contiguous. Returns cudaGetLastError() after the launch, the error of the
// shared-memory attribute call, or cudaErrorInvalidValue for a geometry the
// kernel does not serve.
extern "C" int howl_res8_stem_tc_forward(const void* mel, const void* img, void* out, int B, int T, int n_mels, int ch,
                                         void* stream) {
  const int t_out = T / kPoolT;
  if (B == 0 || t_out == 0) return 0;
  if (n_mels < kPoolF || n_mels % kPoolF != 0 || n_mels > kMaxBins || ch < 1 || ch > kN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(n_mels, ch);
  const long long blocks = static_cast<long long>((t_out + kTile - 1) / kTile) * B;
  if (smem > kMaxSmem || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(stem_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(blocks));
  stem_tc_kernel<<<grid, 32 * ((n_mels + 7) / 8), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(mel), static_cast<const __nv_bfloat16*>(img),
      static_cast<__nv_bfloat16*>(out), T, n_mels, ch);
  return static_cast<int>(cudaGetLastError());
}
