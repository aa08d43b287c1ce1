// Banded-fold stem proto for Hopper (sm_90a): three GEMMs on the tensor
// cores with ReLU, the 3-plane time pool and the 4-block frequency pool in
// registers.
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
// What bounds it on this card: the tensor cores and the shared-memory reads
// that feed them. Per clip it is 3 x 224 x 120 x 2048 x 2 = 0.33 GFLOP
// against 161 KB in and 229 KB out (bf16).
//
// What the design does about it: a block owns one clip, kQTile pooled rows
// and kNSlice output columns, and so the same columns of all four j-blocks
// and all three planes: the whole reduction happens in registers and the
// output is written once. K = 120 is padded to 128 with zeros in shared
// memory (8 k16 steps). The xpre tile and the weight slice (transposed, so
// each B fragment is one 32-bit read) are staged in shared memory with rows
// padded by 8 bf16, which makes the fragment reads conflict-free. Each warp
// computes a 16-row by 16-column piece of each j-block with
// mma.sync.m16n8k16 (bf16 in, float32 accumulate). The column slices are
// the fastest grid dimension, so the blocks that share an xpre tile run
// together and find it in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKIn = 120;                // banded-fold depth
constexpr int kKPad = 128;               // padded to whole k16 steps
constexpr int kNOut = 512;               // one j-block of w0fold's columns
constexpr int kJ = 4;                    // j-blocks (the frequency pool)
constexpr int kPlanes = 3;               // time-pool planes
constexpr int kQTile = 32;               // pooled rows per block
constexpr int kNSlice = 64;              // output columns per block
constexpr int kStride = kKPad + 8;       // 136 bf16 per staged row
constexpr size_t kSmemBytes =
    (static_cast<size_t>(kPlanes) * kQTile + static_cast<size_t>(kJ) * kNSlice) * kStride * sizeof(__nv_bfloat16);

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
stem_fold_kernel(const __nv_bfloat16* __restrict__ xpre, const __nv_bfloat16* __restrict__ w, void* __restrict__ out,
                 int q_rows, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (plane, q) rows x k
  __nv_bfloat16* bt = as + kPlanes * kQTile * kStride;              // (j, n) rows x k: w0fold transposed
  const int n0 = blockIdx.x * kNSlice;
  const int q0 = blockIdx.y * kQTile;
  const int b = blockIdx.z;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  for (int i = threadIdx.x; i < kPlanes * kQTile * (kKPad / 8); i += kThreads) {
    const int row = i / (kKPad / 8);
    const int c = (i - row * (kKPad / 8)) * 8;
    const int r = row / kQTile;
    const int q = q0 + row - r * kQTile;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c < kKIn && q < q_rows)
      v = *reinterpret_cast<const uint4*>(xpre + ((static_cast<size_t>(b) * kPlanes + r) * q_rows + q) * kKIn + c);
    *reinterpret_cast<uint4*>(as + row * kStride + c) = v;
  }
  for (int i = threadIdx.x; i < kKPad * kJ * kNSlice; i += kThreads) {
    const int k = i / (kJ * kNSlice);
    const int col = i - k * (kJ * kNSlice);  // j * kNSlice + nn
    const int j = col / kNSlice;
    bt[col * kStride + k] = k < kKIn ? w[static_cast<size_t>(k) * (kJ * kNOut) + j * kNOut + n0 + col - j * kNSlice]
                                     : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp & 1;   // 16-row half of the q tile
  const int wn = warp >> 1;  // 16-column quarter of the slice
  float sum[kJ][2][4];
#pragma unroll
  for (int r = 0; r < kPlanes; ++r) {
    float acc[kJ][2][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKPad / 16; ++ks) {
      const __nv_bfloat16* a0 = as + (r * kQTile + wm * 16 + g) * kStride + ks * 16 + tig * 2;
      const uint32_t a[4] = {ld32(a0), ld32(a0 + 8 * kStride), ld32(a0 + 8), ld32(a0 + 8 * kStride + 8)};
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* bp = bt + (j * kNSlice + wn * 16 + nt * 8 + g) * kStride + ks * 16 + tig * 2;
          mma_bf16(acc[j][nt], a, ld32(bp), ld32(bp + 8));
        }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = fmaxf(acc[j][nt][i], 0.f);
          sum[j][nt][i] = r == 0 ? v : sum[j][nt][i] + v;
        }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + wm * 16 + g + 8 * h;
    if (q >= q_rows) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = n0 + wn * 16 + nt * 8 + tig * 2;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * h + e;
        y[e] = (((sum[0][nt][i] + sum[1][nt][i]) + sum[2][nt][i]) + sum[3][nt][i]) * (1.0f / 12.0f);
      }
      const size_t idx = (static_cast<size_t>(b) * q_rows + q) * kNOut + n;
      if (out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) = __floats2bfloat162_rn(y[0], y[1]);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(y[0], y[1]);
    }
  }
}

}  // namespace

// xpre (B, 3, q_rows, 120) bf16; w0fold (120, 2048) bf16; out (B, q_rows,
// 512), bf16 if out_bf16 else float32. All contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int howl_stem_fold_forward(const void* xpre, const void* w0fold, void* out, int B, int q_rows,
                                      int out_bf16, void* stream) {
  if (B == 0 || q_rows == 0) return 0;
  if (B > 65535 || q_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stem_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kNOut / kNSlice, (q_rows + kQTile - 1) / kQTile, B);
  stem_fold_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xpre), static_cast<const __nv_bfloat16*>(w0fold), out, q_rows, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
