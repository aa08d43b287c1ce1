// Fused six-layer residual trunk proto for Hopper (sm_90a): six 3x3 convs as
// implicit GEMMs on the tensor cores, with ReLU, residual, affine and pad
// mask, then the window-pool GEMM, without leaving the SM.
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
// What bounds it on this card: the tensor cores and the shared-memory reads
// that feed them. A clip's six layers are 6 x 2176 x 432 x 48 x 2 = 0.54
// GFLOP (plus the pool GEMM) against 0.2 MB of input, so it is far above
// the card's ~295 FLOP/byte balance point.
//
// What the design does about it: one block per clip keeps every layer on
// the SM. A whole clip's activation (2208 x 48 bf16, 212 KB) does not fit
// three times in the 227 KB a block may use, so the block walks the clip in
// time tiles of kTile positions and recomputes a halo of kHalo positions
// each side (six layers reach 6 x 11 = 66 positions). Three activation
// buffers (x, res, out) of kWin rows rotate between layers; the taps are
// shifted reads of the x buffer (an implicit GEMM: no im2col is stored),
// and zero guard rows above and below each buffer stand for reads past the
// window, whose error the halo absorbs. Each layer's weights are staged
// transposed. Each warp owns 4 m16 tiles x 6 n8 tiles and issues
// mma.sync.m16n8k16 (bf16 in, float32 accumulate) over K = 432. The pool
// GEMM contracts over positions, so it crosses tiles: the block keeps the
// (n_win_pad, 48) float32 output in registers (warp w owns windows
// 16 w .. 16 w + 15) and adds each tile's pool_t[:, tile] @ r6[tile] to it,
// with no atomics; r6 is staged transposed in the free buffer.
// wgmma, TMA and clusters are left for a later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCh = 48;                     // channels: N of each layer GEMM, K of one tap
constexpr int kK = 9 * kCh;                 // 432
constexpr int kNTiles = kCh / 8;            // 6 n8 tiles
constexpr int kFOut = 10;                   // positions per pooled frame
constexpr int kWin = 512;                   // positions computed per time tile
constexpr int kHalo = 72;                   // >= 66, the six layers' reach
constexpr int kTile = kWin - 2 * kHalo;     // 368 positions kept per tile (23 k16 steps)
constexpr int kGuard = 16;                  // zero rows above and below each buffer (>= 11)
constexpr int kRows = kWin + 2 * kGuard;    // 544
constexpr int kStride = kCh + 8;            // 56 bf16 per activation row: conflict-free fragment reads
constexpr int kWStride = kK + 8;            // 440 bf16 per transposed weight row
constexpr int kR6Stride = kTile + 8;        // 376 bf16 per transposed r6 row
constexpr int kMTiles = kWin / 16 / kWarps;  // 4 m16 tiles per warp
constexpr size_t kBufElems = static_cast<size_t>(kRows) * kStride;
constexpr size_t kSmemBytes = (3 * kBufElems + static_cast<size_t>(kCh) * kWStride) * sizeof(__nv_bfloat16);

static_assert(kTile % 16 == 0, "the pool GEMM steps over a tile in k16 chunks");
static_assert(static_cast<size_t>(kCh) * kR6Stride <= static_cast<size_t>(kWin) * kStride,
              "r6 must fit in a buffer's interior");

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// d += a (16 x 16, row-major) @ b (16 x 8, column-major), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
trunk_proto_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ws,
                   const __nv_bfloat16* __restrict__ pool_t, const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ out, int pos, int pos_pad,
                   int n_win_pad, int full_build) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 3 x kRows x kStride
  __nv_bfloat16* wt = bufs + 3 * kBufElems;                             // kCh x kWStride: W_L transposed
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group
  const __nv_bfloat16* xb = x + static_cast<size_t>(blockIdx.x) * pos_pad * kCh;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  for (size_t i = threadIdx.x; i < 3 * kBufElems / 8; i += kThreads)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0, 0, 0, 0);  // the guard rows stay zero

  const bool pools = warp * 16 < n_win_pad;
  float pacc[kNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) pacc[nt][i] = 0.f;

  for (int p0 = 0; p0 < pos_pad; p0 += kTile) {
    const int w0 = p0 - kHalo;  // position of window row 0
    __syncthreads();            // the previous tile's pool GEMM is done with its buffers
    for (int i = threadIdx.x; i < kWin * (kCh / 8); i += kThreads) {
      const int r = i / (kCh / 8);
      const int c = (i - r * (kCh / 8)) * 8;
      const int p = w0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p >= 0 && p < pos_pad) v = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(p) * kCh + c);
      *reinterpret_cast<uint4*>(bufs + (kGuard + r) * kStride + c) = v;
    }
    int xi = 0, ri = 0;  // buffers of x and res; buffer 0 holds the layer-0 input
    for (int layer = 0; layer < 6; ++layer) {
      const int src = full_build ? xi : 0;
      int o = 0;
      while (o == src || o == ri) ++o;
      __syncthreads();  // the last layer's outputs are written and its weights read
      const __nv_bfloat16* wl = ws + static_cast<size_t>(layer) * kK * kCh;
      for (int i = threadIdx.x; i < kK * kCh; i += kThreads) {
        const int k = i / kCh;
        wt[(i - k * kCh) * kWStride + k] = wl[i];
      }
      __syncthreads();
      const __nv_bfloat16* xs = bufs + src * kBufElems + kGuard * kStride;  // window row 0
      const __nv_bfloat16* rs = bufs + ri * kBufElems + kGuard * kStride;
      __nv_bfloat16* os = bufs + o * kBufElems + kGuard * kStride;

      float acc[kMTiles][kNTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3 - 1;
        const int df = tap % 3 - 1;
        const int off = dt * kFOut + df;
        bool ok[kMTiles][2];  // the f-edge mask of each fragment row
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = w0 + (warp * kMTiles + mt) * 16 + g + 8 * h;
            const int f = ((p % kFOut) + kFOut) % kFOut;
            ok[mt][h] = !((df == -1 && f == 0) || (df == 1 && f == kFOut - 1));
          }
#pragma unroll
        for (int kc = 0; kc < kCh / 16; ++kc) {
          uint32_t a[kMTiles][4];
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
            const __nv_bfloat16* r0 = xs + ((warp * kMTiles + mt) * 16 + g + off) * kStride + kc * 16 + tig * 2;
            const __nv_bfloat16* r1 = r0 + 8 * kStride;
            a[mt][0] = ok[mt][0] ? ld32(r0) : 0u;
            a[mt][1] = ok[mt][1] ? ld32(r1) : 0u;
            a[mt][2] = ok[mt][0] ? ld32(r0 + 8) : 0u;
            a[mt][3] = ok[mt][1] ? ld32(r1 + 8) : 0u;
          }
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            const __nv_bfloat16* wp = wt + (nt * 8 + g) * kWStride + tap * kCh + kc * 16 + tig * 2;
            const uint32_t b0 = ld32(wp);
            const uint32_t b1 = ld32(wp + 8);
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
          }
        }
      }

      // epilogue: relu, residual, affine and pad mask, or r6 for the pool
      __nv_bfloat16* r6t = os;  // at layer 5, r6 transposed: r6t[n][q], q = row - kHalo
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (warp * kMTiles + mt) * 16 + g + 8 * h;
          const int p = w0 + row;
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            const int n = nt * 8 + tig * 2;
            float v0 = fmaxf(acc[mt][nt][2 * h], 0.f);
            float v1 = fmaxf(acc[mt][nt][2 * h + 1], 0.f);
            if (layer & 1) {
              const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(rs + row * kStride + n);
              v0 = v0 + __low2float(res);
              v1 = v1 + __high2float(res);
            }
            if (layer < 5) {
              const bool keep = p >= 0 && p < pos;
              const float y0 = keep ? (v0 - shift[layer * kCh + n]) * scale[layer * kCh + n] : 0.f;
              const float y1 = keep ? (v1 - shift[layer * kCh + n + 1]) * scale[layer * kCh + n + 1] : 0.f;
              *reinterpret_cast<__nv_bfloat162*>(os + row * kStride + n) = __floats2bfloat162_rn(y0, y1);
            } else {
              const int q = row - kHalo;
              if (q >= 0 && q < kTile) {
                const bool in = p < pos_pad;
                r6t[n * kR6Stride + q] = in ? __float2bfloat16_rn(v0) : zero;
                r6t[(n + 1) * kR6Stride + q] = in ? __float2bfloat16_rn(v1) : zero;
              }
            }
          }
        }
      if (layer < 5) {
        xi = o;
        if (layer & 1) ri = o;
      } else {
        __syncthreads();  // r6 is complete
        if (pools) {
          const int m0 = warp * 16 + g;
          const __nv_bfloat16* pa0 = pool_t + static_cast<size_t>(m0) * pos_pad;
          const __nv_bfloat16* pa1 = pa0 + 8 * static_cast<size_t>(pos_pad);
          for (int k0 = 0; k0 < kTile; k0 += 16) {
            const int pk = p0 + k0 + tig * 2;  // even, and pos_pad is even: a pair is all in or all out
            uint32_t a[4];
            a[0] = pk < pos_pad ? ld32(pa0 + pk) : 0u;
            a[1] = pk < pos_pad ? ld32(pa1 + pk) : 0u;
            a[2] = pk + 8 < pos_pad ? ld32(pa0 + pk + 8) : 0u;
            a[3] = pk + 8 < pos_pad ? ld32(pa1 + pk + 8) : 0u;
#pragma unroll
            for (int nt = 0; nt < kNTiles; ++nt) {
              const __nv_bfloat16* bp = r6t + (nt * 8 + g) * kR6Stride + k0 + tig * 2;
              mma_bf16(pacc[nt], a, ld32(bp), ld32(bp + 8));
            }
          }
        }
      }
    }
  }

  if (pools) {
    float* ob = out + static_cast<size_t>(blockIdx.x) * n_win_pad * kCh;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp * 16 + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int n = nt * 8 + tig * 2;
        float2 v;
        v.x = (pacc[nt][2 * h] - shift[6 * kCh + n]) * scale[7 * kCh + n];
        v.y = (pacc[nt][2 * h + 1] - shift[6 * kCh + n + 1]) * scale[7 * kCh + n + 1];
        *reinterpret_cast<float2*>(ob + m * kCh + n) = v;
      }
    }
  }
}

}  // namespace

// x (B, pos_pad, 48) bf16; ws (6, 432, 48) bf16; pool_t (n_win_pad, pos_pad)
// bf16; scale, shift (8, 48) float32; out (B, n_win_pad, 48) float32. All
// contiguous; pos_pad and n_win_pad multiples of 16, n_win_pad <= 128.
// Returns cudaGetLastError() after the launch.
extern "C" int howl_trunk_proto_forward(const void* x, const void* ws, const void* pool_t, const void* scale,
                                        const void* shift, void* out, int B, int pos, int pos_pad, int n_win_pad,
                                        int full_build, void* stream) {
  if (pos_pad <= 0 || pos_pad % 16 || n_win_pad % 16 || n_win_pad > 16 * kWarps || pos < 0 || pos > pos_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(trunk_proto_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_proto_kernel<<<B, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ws),
      static_cast<const __nv_bfloat16*>(pool_t), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(out), pos, pos_pad, n_win_pad, full_build);
  return static_cast<int>(cudaGetLastError());
}
