// One layer of res8's int8 residual trunk for Hopper (sm_90a): the 3x3 SAME
// conv in s8 x s8 -> s32 on the tensor cores, with the quantize on load and
// the dequant, ReLU, residual add and BatchNorm in the epilogue.
//
// Replaces the s8 x s8 -> s32 convolutions of the JAX package's int8 trunk,
// howl_tpu/ops/int8_trunk.py, residual_features_int8, which XLA lowers
// (conv_general_dilated with preferred_element_type=int32); there is no
// Pallas kernel for it and no PyTorch call that computes it (F.conv2d takes no
// int8). One launch computes, on channels-last activations x (B, T, F, C) in
// the compute dtype (bf16 or float32), with s_a the layer's activation scale:
//
//     xq  = clip(round_half_even(float(x) * inv_s), -127, 127)       (s8)
//     acc = conv3x3_same(xq, w_i8)                                     (s32)
//     y   = cdt(cdt(max(acc, 0)) * cdt(w_scale * s_a))
//     pre = y + residual          (optional: layers 2, 4 and 6)
//     out = cdt(cdt(pre * cdt(bn_scale)) + cdt(bn_shift))   (optional BN)
//
// where cdt() rounds to the compute dtype (a no-op in float32), each product
// and sum rounded on its own as the JAX package's and the plain version's
// separate operations are (no FMA contraction). pre is stored where the caller
// asks (layers 2 and 4: the next residual reads it). Six launches make the
// trunk on its "layer" route (ops/int8_trunk.residual_features_int8).
//
// What bounds it on this card: bytes. At the serving batch (512 clips of 8 s:
// T = 213, F = 10, C = 45, 1,090,560 positions) one bf16 activation is
// 98.15 MB, and layers 1-6 move 2, 4, 2, 4, 2 and 3 of them: 1,668.6 MB,
// 0.498 ms at 3.35 TB/s. The products are 6 x 39.75 GOP = 238.5 GOP, 0.121 ms
// at 1,979 int8 TOPS. The trunk fused over its six layers is bound by
// operations: csrc/int8_trunk_fused.cu (wgmma on s8, one launch), which
// ops/int8_trunk.int8_trunk_route picks wherever its block holds the
// geometry; this kernel serves the rest (route "layer").
//
// What the design does about it:
//  * A block owns one clip and TT = 256 / F frames (25 at F = 10): 256
//    positions, eight warps of two m16 tiles. The tile's input frames with a
//    one-frame halo above and below are one contiguous run of x; the threads
//    read it in order (coalesced, one element each) and quantize as they
//    store s8 into shared memory, a position's 45 channels padded to 48
//    bytes, with a zero column on both frequency edges and zero frames outside
//    the clip. A position stride of 48 bytes (12 words) puts the eight rows of
//    an A fragment in eight different bank quads.
//  * The conv is an implicit GEMM on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32:
//    M the positions, N the output channels padded to 48 (six n8 tiles), K the
//    nine taps x 48 channels = 432, 14 k32 steps (the last half zero). Every
//    16 consecutive k lie in one tap, so a lane's A register is four channels
//    of one position at one tap: one 4-byte shared-memory load at the
//    position's offset plus the tap's. The weights are one 21,504-byte image
//    in fragment order (ops/int8_trunk.pack_w_image), copied into shared
//    memory once a block: a lane's B fragment of a step and n8 tile is one
//    8-byte load.
//  * The s32 sums stay in registers for the ReLU, the cast and the dequant;
//    the values are staged in shared memory (over the s8 tile, which is no
//    longer read) in the output's own order, so the residual read, the BN and
//    the stores of out and pre run over contiguous runs of the tensors,
//    coalesced. A position's 45 bf16 channels are 90 bytes, so rows are not
//    16-byte aligned (as csrc/stem_tc.cu's stores found); the element-wise
//    runs take every alignment and the layout stays the model's (B, T, F, 45)
//    between layers.
//  * One grid axis of clips x tiles, as the frontend and stem kernels have.
//
// Exactness: |acc| <= 127 * 127 * 405 = 6,532,245 < 2^24, so the s32 sums
// are the exact integer sums, as are the plain version's float32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;                        // m16 tiles a warp
constexpr int kPositions = 16 * kMTiles * kWarps;  // positions a block
constexpr int kCPad = 48;                         // bytes of a position's channels in shared memory
constexpr int kN8 = kCPad / 8;                    // n8 tiles of the output channels
constexpr int kKSteps = 14;                       // 9 taps x 48 = 432 of K, in k32 steps (the last half)
constexpr int kWImageBytes = kKSteps * kN8 * 32 * 8;
constexpr int kMaxSmem = 232448;                  // 227 KB a block
constexpr int kUnroll = 4;                        // 16-byte vectors a thread has in flight

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

__host__ __device__ __forceinline__ int act_bytes(int tt, int F) { return (tt + 2) * (F + 2) * kCPad; }

template <typename T>
__host__ __device__ __forceinline__ int shared_bytes(int tt, int F, int C) {
  const int act = act_bytes(tt, F);
  const int vals = tt * F * C * static_cast<int>(sizeof(T));
  // the values sit at the output run's offset modulo 16 bytes, so that they can leave as 16-byte vectors
  return kWImageBytes + round16(2 * F * C) + round16(F * C) + round16(act > vals + 16 ? act : vals + 16);
}

// Element k of a 16-byte vector of T, and its assignment (k a compile-time constant after unrolling)
template <typename T>
__device__ __forceinline__ float vec_get(const uint4& v, int k) {
  const uint32_t w = (&v.x)[k * static_cast<int>(sizeof(T)) / 4];
  if constexpr (sizeof(T) == 2) return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>((k & 1) ? w >> 16 : w)));
  return __uint_as_float(w);
}

template <typename T>
__device__ __forceinline__ void vec_set(uint4& v, int k, float x) {
  uint32_t& w = (&v.x)[k * static_cast<int>(sizeof(T)) / 4];
  if constexpr (sizeof(T) == 2) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    w = (k & 1) ? ((w & 0xffffu) | (h << 16)) : ((w & 0xffff0000u) | h);
  } else {
    w = __float_as_uint(x);
  }
}

// A run of n elements of T at p: elements [0, head) and [tail, n) lie outside its 16-byte aligned interior, which
// holds n_vec vectors from element head on.
template <typename T>
struct Run {
  int head, n_vec, tail;
  __device__ __forceinline__ Run(const T* p, int n) {
    const uintptr_t b0 = reinterpret_cast<uintptr_t>(p), b1 = b0 + static_cast<uintptr_t>(n) * sizeof(T);
    uintptr_t a0 = (b0 + 15) & ~static_cast<uintptr_t>(15), a1 = b1 & ~static_cast<uintptr_t>(15);
    if (a0 > b1) a0 = b1;
    if (a1 < a0) a1 = a0;
    head = static_cast<int>((a0 - b0) / sizeof(T));
    n_vec = static_cast<int>((a1 - a0) / 16);
    tail = static_cast<int>((a1 - b0) / sizeof(T));
  }
};

__device__ __forceinline__ float load_val(const float* p) { return *p; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// v rounded to T: the value the compute dtype holds
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// d += a (16 x 32, s8) @ b (32 x 8, s8), s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_kernel(const T* __restrict__ x, const unsigned char* __restrict__ w_img, const float* __restrict__ w_scale,
                 const float* __restrict__ bn_scale, const float* __restrict__ bn_shift, const T* __restrict__ res,
                 T* __restrict__ out, T* __restrict__ pre, int T_len, int F, int C, int tt, float inv_s, float s_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int FC = F * C;
  unsigned char* s_w = smem;                                                          // the weight image
  uint16_t* s_off = reinterpret_cast<uint16_t*>(smem + kWImageBytes);                 // element i of a frame -> its byte in a frame of s_act
  unsigned char* s_chan = smem + kWImageBytes + round16(2 * FC);                      // element i of a frame -> its channel
  unsigned char* s_tile = smem + kWImageBytes + round16(2 * FC) + round16(FC);
  signed char* s_act = reinterpret_cast<signed char*>(s_tile);                       // (tt + 2) x (F + 2) x 48 s8

  const int n_tiles = (T_len + tt - 1) / tt;
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x % n_tiles) * tt;
  const int tv = min(tt, T_len - t0);  // the tile's frames
  const int tid = threadIdx.x;
  const size_t run0 = (static_cast<size_t>(b) * T_len + t0) * FC;  // the tile's run of out, res and pre
  // then tt x F x C dequantized values, at the output run's offset modulo 16 bytes
  T* s_val = reinterpret_cast<T*>(s_tile + (reinterpret_cast<uintptr_t>(out + run0) & 15));

  // the weight image, the frame tables, a zero tile
  const uint4* w_src = reinterpret_cast<const uint4*>(w_img);
  for (int i = tid; i < kWImageBytes / 16; i += kThreads) reinterpret_cast<uint4*>(s_w)[i] = __ldg(w_src + i);
  for (int i = tid; i < FC; i += kThreads) {
    const int f = i / C;
    const int c = i - f * C;
    s_off[i] = static_cast<uint16_t>((f + 1) * kCPad + c);
    s_chan[i] = static_cast<unsigned char>(c);
  }
  for (int i = tid; i < act_bytes(tt, F) / 16; i += kThreads) reinterpret_cast<uint4*>(s_act)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // the input frames [t0 - 1, t0 + tv] inside the clip, one contiguous run of x, quantized into s_act
  {
    const int f_lo = max(t0 - 1, 0);
    const int f_hi = min(t0 + tv + 1, T_len);
    const int n = (f_hi - f_lo) * FC;
    const T* src = x + (static_cast<size_t>(b) * T_len + f_lo) * FC;
    signed char* dst0 = s_act + (f_lo - (t0 - 1)) * (F + 2) * kCPad;
    const int row = (F + 2) * kCPad;
    auto put = [&](int fr, int i, float v) {
      const int q = __float2int_rn(__fmul_rn(v, inv_s));
      dst0[fr * row + s_off[i]] = static_cast<signed char>(max(-127, min(127, q)));
    };
    const Run<T> run(src, n);
    for (int e = tid; e < run.head; e += kThreads) put(e / FC, e % FC, load_val(src + e));
    for (int e = run.tail + tid; e < n; e += kThreads) put(e / FC, e % FC, load_val(src + e));
    // the aligned interior: kUnroll vectors a thread in flight, then their elements in order
    constexpr int kPer = 16 / sizeof(T);
    const uint4* vsrc = reinterpret_cast<const uint4*>(src + run.head);
    for (int c0 = tid; c0 < run.n_vec; c0 += kThreads * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kThreads;
        v[u] = c < run.n_vec ? __ldg(vsrc + c) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kThreads;
        if (c >= run.n_vec) continue;
        const int e = run.head + c * kPer;
        int fr = e / FC;
        int i = e - fr * FC;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          put(fr, i, vec_get<T>(v[u], k));
          if (++i == FC) {
            i = 0;
            ++fr;
          }
        }
      }
    }
  }
  __syncthreads();

  // the implicit GEMM: warp w owns m16 tiles 2w and 2w + 1, rows = positions p = t * F + f of the tile
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q4 = lane & 3;
  const int n_pos = tv * F;
  const int row_bytes = (F + 2) * kCPad;
  int base[kMTiles][2];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (warp * kMTiles + m) * 16 + g + 8 * h;
      const int pc = p < n_pos ? p : 0;  // rows past the tile read position 0 and are dropped
      const int t = pc / F;
      base[m][h] = (t + 1) * row_bytes + (pc - t * F + 1) * kCPad + 4 * q4;
    }
  int acc[kMTiles][kN8][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0;

  const uint2* s_b = reinterpret_cast<const uint2*>(s_w) + lane;
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    uint32_t a[kMTiles][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k0 = 32 * s + 16 * j;  // 16 consecutive k: one tap, channels cb .. cb + 15
      if (k0 >= 9 * kCPad) {
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) a[m][2 * j] = a[m][2 * j + 1] = 0u;
        continue;
      }
      const int tap = k0 / kCPad;
      const int off = ((tap / 3 - 1) * (F + 2) + (tap % 3 - 1)) * kCPad + (k0 % kCPad);
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        a[m][2 * j] = *reinterpret_cast<const uint32_t*>(s_act + base[m][0] + off);
        a[m][2 * j + 1] = *reinterpret_cast<const uint32_t*>(s_act + base[m][1] + off);
      }
    }
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
      const uint2 bw = s_b[(s * kN8 + n) * 32];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) mma_s8(acc[m][n], a[m], bw.x, bw.y);
    }
  }
  __syncthreads();  // every warp is done with s_act: the values take its place

  // ReLU on the s32 sum, the cast, the dequant: acc[m][n][2h + e] is position row g + 8h, channel 8n + 2q4 + e
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (warp * kMTiles + m) * 16 + g + 8 * h;
      if (p >= n_pos) continue;
#pragma unroll
      for (int n = 0; n < kN8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * q4 + e;
          if (c >= C) continue;
          const float dq = rnd<T>(__fmul_rn(__ldg(w_scale + c), s_a));
          const float v = rnd<T>(__int2float_rn(max(acc[m][n][2 * h + e], 0)));
          store_val(s_val + p * C + c, rnd<T>(__fmul_rn(v, dq)));
        }
    }
  __syncthreads();

  // the residual, the pre-BN store, BN and the output over the tile's run of the tensors, in order: the elements
  // outside the run's 16-byte aligned interior one at a time, the interior as vectors (res, out and pre are laid
  // out alike, so one interior serves all three)
  const int n = tv * FC;
  const bool has_bn = bn_scale != nullptr;
  auto residual = [&](float v, float r) { return res != nullptr ? rnd<T>(__fadd_rn(v, r)) : v; };
  auto norm = [&](float v, int c) {
    return has_bn ? rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(v, rnd<T>(__ldg(bn_scale + c)))), rnd<T>(__ldg(bn_shift + c))))
                  : v;
  };
  const Run<T> run(out + run0, n);
  auto one = [&](int e) {
    const float v = residual(load_val(s_val + e), res != nullptr ? load_val(res + run0 + e) : 0.f);
    if (pre != nullptr) store_val(pre + run0 + e, v);
    store_val(out + run0 + e, norm(v, s_chan[e % FC]));
  };
  for (int e = tid; e < run.head; e += kThreads) one(e);
  for (int e = run.tail + tid; e < n; e += kThreads) one(e);
  constexpr int kPer = 16 / sizeof(T);
  for (int c0 = tid; c0 < run.n_vec; c0 += kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c < run.n_vec && res != nullptr) r[u] = __ldg(reinterpret_cast<const uint4*>(res + run0 + run.head) + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c >= run.n_vec) continue;
      const int e = run.head + c * kPer;
      const uint4 vv = *reinterpret_cast<const uint4*>(s_val + e);
      uint4 po = make_uint4(0u, 0u, 0u, 0u), oo = po;
      int i = e % FC;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float v = residual(vec_get<T>(vv, k), res != nullptr ? vec_get<T>(r[u], k) : 0.f);
        vec_set<T>(po, k, v);
        vec_set<T>(oo, k, norm(v, s_chan[i]));
        if (++i == FC) i = 0;
      }
      if (pre != nullptr) reinterpret_cast<uint4*>(pre + run0 + run.head)[c] = po;
      reinterpret_cast<uint4*>(out + run0 + run.head)[c] = oo;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w_img, const void* w_scale, const void* bn_scale, const void* bn_shift,
           const void* res, void* out, void* pre, int B, int T_len, int F, int C, int tt, float inv_s, float s_a,
           cudaStream_t stream) {
  const int smem = shared_bytes<T>(tt, F, C);
  const long long blocks = static_cast<long long>((T_len + tt - 1) / tt) * B;
  if (smem > kMaxSmem || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int8_conv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(w_img), static_cast<const float*>(w_scale),
      static_cast<const float*>(bn_scale), static_cast<const float*>(bn_shift), static_cast<const T*>(res),
      static_cast<T*>(out), static_cast<T*>(pre), T_len, F, C, tt, inv_s, s_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, T, F, C) bf16 (is_bf16) or float32; w_img the layer's 21,504-byte
// weight image (ops/int8_trunk.pack_w_image); w_scale (C,) float32; bn_scale
// and bn_shift (C,) float32 or both null (no BN); res (B, T, F, C) or null (no
// residual); out (B, T, F, C); pre (B, T, F, C) or null (pre-BN sum not
// kept); all contiguous, in x's dtype where shaped like x, and x, res, out and
// pre 16-byte aligned. tt: frames a block,
// tt * F <= 256. Returns cudaGetLastError() after the launch, the error of the
// shared-memory attribute call, or cudaErrorInvalidValue for a geometry the
// kernel does not serve.
extern "C" int howl_int8_conv_forward(const void* x, const void* w_img, const void* w_scale, const void* bn_scale,
                                      const void* bn_shift, const void* res, void* out, void* pre, int B, int T_len,
                                      int F, int C, int tt, float inv_s, float s_a, int is_bf16, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (C < 1 || C > kCPad || F < 1 || tt < 1 || tt * F > kPositions || (bn_scale == nullptr) != (bn_shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w_img, w_scale, bn_scale, bn_shift, res, out, pre, B, T_len, F, C, tt, inv_s,
                                         s_a, s)
                 : launch<float>(x, w_img, w_scale, bn_scale, bn_shift, res, out, pre, B, T_len, F, C, tt, inv_s, s_a, s);
}
