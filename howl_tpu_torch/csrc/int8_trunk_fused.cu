// res8's int8 residual trunk for Hopper (sm_90a), its six layers fused in one
// persistent kernel: the 3x3 SAME convs in s8 x s8 -> s32 on wgmma, the
// quantize, dequant, ReLU, residual adds and BatchNorm in shared memory and
// registers, and only the trunk's input and output in device memory.
//
// Replaces the s8 x s8 -> s32 convolutions of the JAX package's int8 trunk,
// howl_tpu/ops/int8_trunk.py, residual_features_int8 (lines 142-169), which
// XLA lowers (conv_general_dilated with preferred_element_type=int32); there
// is no Pallas kernel for it and no PyTorch call that computes it (F.conv2d
// takes no int8). It computes exactly ops/int8_trunk.residual_features_int8_plain
// on channels-last y (B, T, F, C) in the compute dtype (bf16 or float32): per
// layer L = 1..6, s_L its activation scale and x_1 = y,
//
//     xq   = clip(round_half_even(float(x_L) * inv_s_L), -127, 127)          (s8)
//     acc  = conv3x3_same(xq, w_L)                                            (s32)
//     v    = cdt(cdt(max(acc, 0)) * cdt(w_scale_L * s_L))
//     pre  = cdt(v + res)      (layers 2, 4, 6: res = y, then pre_2, then pre_4)
//     x_L+1 = cdt(cdt(pre * cdt(bn_scale_L)) + cdt(bn_shift_L))
//
// each product and sum rounded on its own (no FMA contraction), as the layer
// kernel csrc/int8_trunk.cu does; x_7 is the output.
//
// What bounds it on this card: operations. At the serving batch (512 clips
// of 8 s: T = 213, F = 10, C = 45, 1,090,560 positions) the six convs are
// 6 x 1,090,560 x 405 x 45 x 2 = 238.5 GOP, 0.1205 ms at 1,979 int8 TOPS;
// y in and the output out are 196 MB, 0.059 ms at 3.35 TB/s. The products
// the kernel runs are larger: K = 9 taps x 64 for 405, N = 48 for 45, two
// zero slots a frame and the halo.
//
// What the design does about it (the trunk proto csrc/trunk_proto.cu's
// schedule, on s8):
//  * Tiles with a shrinking halo, persistent blocks. A block walks (clip,
//    tile) items of kT frames (43 in bf16: 5 tiles for 213 frames; 24 in
//    float32, whose y and residual take twice the bytes). Layer L computes
//    frames [a - 6 + L, a + kT + 6 - L) of the tile at frame a, so the
//    layer-1 input spans kT + 12 frames and layer 6 the tile. That span of y
//    is one contiguous run of the tensor; it arrives by cp.async into a
//    staging buffer while the previous item computes.
//  * Slots instead of masks. In shared memory a frame is F + 2 rows of s8,
//    its F positions between two zero slots, and the rows are chunk-major:
//    three columns of 16-byte rows, channels 0-15, 16-31 and 32-47. A tap
//    (dt, df) is then the same rows shifted by (F + 2) dt + df, with no mask,
//    and a layer's K is 27 cores of 16 channels (a column at a tap's shift)
//    taken two to a k32 step of the dense
//    wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8, A and B both from
//    shared memory, each step's A one descriptor: 14 steps per 64 rows (the
//    last core alone, beside B's zero rows), the s32 sums in registers. Where
//    a step crosses from tap t's last column to tap t + 1's first, the later
//    core comes first in K, so that the second core lies above the first by
//    two columns less the taps' shift: a descriptor's leading offset is
//    unsigned. Five warpgroups (three in float32) take the layer's m64
//    tiles in turns, each issuing its next tile before the epilogue of the
//    last. The epilogue's rounding chain costs about as much as the products
//    and does not all hide behind them; each warpgroup more hides more of it,
//    until the registers spill (``python -m
//    howl_tpu_torch.tools.probe_kernel_variants --probe int8-fused`` times
//    the other counts and the kernel without its epilogue).
//  * Weights by bulk copies. The host packs each layer's 21,504-byte K-major
//    image (ops/int8_trunk.pack_w_image_wgmma); each arrives by one
//    cp.async.bulk on an mbarrier into one of two slots while the layer
//    before computes.
//  * The epilogue in registers. The rounding chain above runs on the s32
//    sums; each layer's x_L+1 is quantized with the next layer's inverse
//    scale straight into the other s8 buffer. The residual lives in shared
//    memory in the compute dtype: y at first, updated in place with the pre
//    of layers 2 and 4. Rows outside the clip and the zero slots are written
//    back as zeros after every layer (SAME padding holds at every layer, not
//    only at the first).
//  * Only layer 6's output leaves the SM: it is staged in the tile's own
//    order over the free weight slot and s8 buffer, then stored as 16-byte
//    vectors over the run's aligned interior and single elements at its ends
//    (a position's 45 bf16 channels are 90 bytes).
//  * The serving geometry (F = 10, C = 45) runs an instance of the kernel
//    with both as constants, so that the epilogue's addresses and its map
//    from rows to frames fold into immediates; other geometries run the
//    generic instance.
//
// Exactness: |acc| <= 127 * 127 * 405 = 6,532,245 < 2^24, so the s32 sums
// are the exact integer sums, as are the plain version's float32 sums, and
// every later operation rounds where the plain version rounds: the kernel
// and the plain version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_async.cuh"

namespace {

using namespace hopper;

constexpr int kLayers = 6;
constexpr int kHalo = 6;                      // frames each side of a tile: the six layers' reach
constexpr int kCPad = 48;                     // channels a position holds in the buffers; N of each product
constexpr int kCores = 27;                    // k16 cores of a layer's K: 9 taps x 3 columns of 16 channels
constexpr int kSteps = (kCores + 1) / 2;      // 14 k32 steps, two cores each (the last one alone)
constexpr int kStepBytes = 2 * 6 * 128;       // a step's B: two k cores of six n cores
constexpr int kWBytes = kSteps * kStepBytes;  // 21,504: one layer's image
constexpr int kGuard = 1;                     // s8 rows below row 0 (a tap of the first row reads row -1)
constexpr int kTabBytes = kLayers * 3 * kCPad * 4;
constexpr int kMaxSmem = 232448;              // 227 KB a block

// Per compute dtype: kT, the frames a block item keeps (the largest whose buffers fit: 5 tiles of 213 frames
// in bf16, 9 in float32), and kWG, the warpgroups, each taking every kWG-th m64 tile of a layer (more hide
// more of the epilogue behind the other warpgroups' products, until the registers spill too much: five in
// bf16, two m64 tiles each a layer, three in float32; ``tools/probe_kernel_variants --probe int8-fused``
// times one fewer and one more)
template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kT = 43, kWG = 5;
};
template <>
struct Tile<float> {
  static constexpr int kT = 24, kWG = 3;
};
template <typename T>
constexpr int kThreads = 128 * Tile<T>::kWG;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Step s's first core n = 3 tap + column in K: 2 s, or 2 s + 1 where the step crosses from tap t's column 2
// to tap t + 1's column 0 (then the later core comes first)
__host__ __device__ constexpr bool step_crosses(int s) { return (2 * s) % 3 == 2 && 2 * s + 1 < kCores; }
__host__ __device__ constexpr int step_core0(int s) { return step_crosses(s) ? 2 * s + 1 : 2 * s; }
// the row shift of tap t = 3 (dt + 1) + (df + 1) in rows of F + 2 = S slots
__host__ __device__ constexpr int tap_rows(int t, int S) { return S * (t / 3 - 1) + (t % 3 - 1); }

// layer L's rows of the tile, relative to its row 0 (frame a - 6): need_rows(L) of them from first_row(L)
__host__ __device__ constexpr int first_row(int L, int S) { return S * L; }
__host__ __device__ constexpr int need_rows(int L, int S, int tt) { return S * (tt + 2 * kHalo - 2 * L); }
__host__ __device__ constexpr int m_tiles(int L, int S, int tt) { return (need_rows(L, S, tt) + 63) / 64; }

// The shared-memory layout of a block, in bytes. The free weight slot and s8 buffer of layer 6 (w0, buf0) are
// adjacent: the output is staged over them.
struct Layout {
  int S, chunk_bytes, buf_bytes, stg_bytes, res_pos, res_bytes;
  uint32_t s_magic;  // ceil(2^32 / S): q / S = umulhi(q, s_magic) for the rows here (q S < 2^32)
  int w0, buf0, buf1, w1, stg, res, tab, bar, total, out_bytes;
};

template <typename T>
__host__ __device__ Layout layout(int F, int C) {
  constexpr int tt = Tile<T>::kT;
  Layout l;
  l.S = F + 2;
  l.s_magic = 0xFFFFFFFFu / static_cast<uint32_t>(l.S) + 1u;
  int end = 0;  // one past the last row a layer's taps read
  for (int L = 1; L <= kLayers; ++L) {
    const int e = first_row(L, l.S) + 64 * m_tiles(L, l.S, tt) + l.S + 1;
    end = e > end ? e : end;
  }
  l.chunk_bytes = round_up(kGuard + end, 8) * 16;
  l.buf_bytes = 3 * l.chunk_bytes;
  l.stg_bytes = round_up((tt + 2 * kHalo) * F * C * static_cast<int>(sizeof(T)) + 32, 128);
  l.res_pos = (tt + 2 * kHalo - 4) * F;  // layer 2's frames
  l.res_bytes = round_up(6 * l.res_pos * 8 * static_cast<int>(sizeof(T)), 128);
  l.w0 = 0;
  l.buf0 = l.w0 + kWBytes;
  l.buf1 = l.buf0 + l.buf_bytes;
  l.w1 = l.buf1 + l.buf_bytes;
  l.stg = l.w1 + kWBytes;
  l.res = l.stg + l.stg_bytes;
  l.tab = l.res + l.res_bytes;
  l.bar = l.tab + kTabBytes;
  l.total = l.bar + 16;
  l.out_bytes = tt * F * C * static_cast<int>(sizeof(T)) + 16;
  return l;
}

template <typename T>
bool layout_fits(int F, int C) {
  const Layout l = layout<T>(F, C);
  return l.total <= kMaxSmem && l.out_bytes <= kWBytes + l.buf_bytes;
}

struct Params {
  const void* y;
  void* out;
  const unsigned char* w_img[kLayers];
  const float* w_scale[kLayers];
  const float* bn_scale[kLayers];
  const float* bn_shift[kLayers];
  float s_a[kLayers];
  float inv_s[kLayers];
  int B, T, F, C, n_tiles, n_items;
};

__device__ __forceinline__ float load_val(const float* p) { return *p; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// v rounded to T: the value the compute dtype holds
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

// The epilogue avoids the conversion instructions, which issue at a quarter of the float rate: both integer
// conversions are exact float additions, and the bf16 chain runs on bf16x2 products and sums (each rounds the
// exact result once, as the float operation followed by the rounding to bf16 does; the _rn forms, which the
// compiler does not contract into an FMA).

// clip(round_half_even(v * inv_s), -127, 127) in the low byte of a word (the other bytes are not zero): the clip
// first (its bounds are integers, so clip and round commute), then 1.5 x 2^23 + x, whose last place is 1, holds
// the rounded x in its low bits
__device__ __forceinline__ uint32_t quantize(float v, float inv_s) {
  const float x = fminf(fmaxf(__fmul_rn(v, inv_s), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(x, 12582912.f));
}

// max(a, 0) as a float: 2^23 + a is the float whose last 23 bits are a (0 <= a <= 6,532,245 < 2^23), and
// max(a + 2^23's bits, 2^23's bits) is one instruction
__device__ __forceinline__ float relu_float(int a) {
  return __fadd_rn(__int_as_float(__viaddmax_s32(a, 0x4B000000, 0x4B000000)), -8388608.f);
}

// A layer's dq, bn scale and bn shift for this thread's channels 8 j + 2 t and 8 j + 2 t + 1, as pairs
template <typename T>
struct Consts;
template <>
struct Consts<__nv_bfloat16> {
  __nv_bfloat162 dq[6], bs[6], bb[6];
};
template <>
struct Consts<float> {
  float2 dq[6], bs[6], bb[6];
};

__device__ __forceinline__ void make_pair(__nv_bfloat162& d, float a, float b) { d = __floats2bfloat162_rn(a, b); }
__device__ __forceinline__ void make_pair(float2& d, float a, float b) { d = make_float2(a, b); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int valid_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid_bytes) : "memory");
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

template <typename T>
struct Ctx {
  unsigned char* smem;
  uint32_t smem_s;  // its shared-memory address
  Layout l;
  const Params* p;
  uint64_t* w_full;  // the two weight slots' mbarriers
  int F, C;          // the geometry: constants in the serving geometry's instance of the kernel
  int b, a, tid, wg, row, t;
};

// layer c % 6 of the block's sequence of layers c: its image into slot c % 2 (one thread)
template <typename T>
__device__ __forceinline__ void issue_w(const Ctx<T>& cx, int c) {
  uint64_t* bar = &cx.w_full[c & 1];
  mbar_arrive_expect_tx(bar, kWBytes);
  bulk_load(cx.smem + ((c & 1) ? cx.l.w1 : cx.l.w0), cx.p->w_img[c % kLayers], kWBytes, bar);
}

// The tile's input frames [a - 6, a + kT + 6) inside the clip: one contiguous run of y, by 16-byte cp.async into
// the staging buffer from its 16-byte aligned start (the last vector cut at the end of y)
template <typename T>
__device__ __forceinline__ void load_y(const Ctx<T>& cx, int b, int a) {
  constexpr int tt = Tile<T>::kT;
  const Params& p = *cx.p;
  const size_t fc = static_cast<size_t>(cx.F) * cx.C;
  const size_t byte0 = (static_cast<size_t>(b) * p.T + max(a - kHalo, 0)) * fc * sizeof(T);
  const size_t byte1 = (static_cast<size_t>(b) * p.T + min(a + tt + kHalo, p.T)) * fc * sizeof(T);
  const size_t total = static_cast<size_t>(p.B) * p.T * fc * sizeof(T);
  const size_t a0 = byte0 & ~static_cast<size_t>(15);
  const int n16 = static_cast<int>((byte1 - a0 + 15) / 16);
  const unsigned char* src = static_cast<const unsigned char*>(p.y) + a0;
  const uint32_t dst = cx.smem_s + cx.l.stg;
  for (int i = cx.tid; i < n16; i += kThreads<T>) {
    const size_t left = total - (a0 + 16 * static_cast<size_t>(i));
    cp_async16(dst + 16 * i, src + 16 * static_cast<size_t>(i), left < 16 ? static_cast<int>(left) : 16);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The layer-1 input: the staged y quantized into s8 buffer 0 (zeros in the slots and outside the clip), and y in
// the compute dtype into the residual buffer over layer 2's frames
template <typename T>
__device__ __forceinline__ void quantize_input(const Ctx<T>& cx) {
  constexpr int tt = Tile<T>::kT;
  const Params& p = *cx.p;
  const Layout& l = cx.l;
  const int S = l.S, F = cx.F, C = cx.C;
  const int f_lo = max(cx.a - kHalo, 0);
  const size_t byte0 = (static_cast<size_t>(cx.b) * p.T + f_lo) * F * C * sizeof(T);
  const T* stg = reinterpret_cast<const T*>(cx.smem + l.stg + (byte0 & 15));
  T* res = reinterpret_cast<T*>(cx.smem + l.res);
  const int rows = (tt + 2 * kHalo) * S;
  const float inv = p.inv_s[0];
  for (int i = cx.tid; i < 3 * rows; i += kThreads<T>) {
    const int k = i / rows;
    const int q = i - k * rows;
    const int fr_rel = static_cast<int>(__umulhi(static_cast<uint32_t>(q), l.s_magic));
    const int slot = q - fr_rel * S;
    const int fr = cx.a - kHalo + fr_rel;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (slot >= 1 && slot <= F && fr >= 0 && fr < p.T) {
      const T* src = stg + ((fr - f_lo) * F + slot - 1) * C;
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = 16 * k + e;
        v[e] = c < C ? load_val(src + c) : 0.f;
        w[e / 4] |= (quantize(v[e], inv) & 0xffu) << (8 * (e % 4));
      }
      if (fr_rel >= 2 && fr_rel < tt + 2 * kHalo - 2) {
        const int pi = (fr_rel - 2) * F + slot - 1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          T* dst = res + (static_cast<size_t>(2 * k + h) * l.res_pos + pi) * 8;
#pragma unroll
          for (int e = 0; e < 8; e += 2) store_pair(dst + e, v[8 * h + e], v[8 * h + e + 1]);
        }
      }
    }
    *reinterpret_cast<uint4*>(cx.smem + l.buf0 + k * l.chunk_bytes + (kGuard + q) * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the 14 products of the warpgroup's 64 rows from row q0 of layer L: A from s8 buffer src, each step's two
// cores at their taps' shifts, B from the weight slot
// (A descriptor's address field counts 16 bytes and every operand lies below 256 KB, so a descriptor plus
// bytes / 16 describes the same operand that many bytes further on.)
template <typename T>
__device__ __forceinline__ void products(const Ctx<T>& cx, int (&acc)[24], int q0, int src, int slot) {
  const int S = cx.l.S;
  const uint32_t buf = cx.smem_s + (src ? cx.l.buf1 : cx.l.buf0);
  const int cb = cx.l.chunk_bytes;
  // the first tap's rows, the leading offset 0: each step adds its own
  uint64_t da = wgmma_desc(buf + (kGuard + q0 - S - 1) * 16, 0, 128);
  uint64_t db = wgmma_desc(cx.smem_s + (slot ? cx.l.w1 : cx.l.w0), 6 * 128, 128);
  // computed anew for each tile: the compiler would otherwise keep all 28 descriptors of a layer in registers
  asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int n = step_core0(s);
    const int t = n / 3;
    // the second core: the next column of the same tap (past the last column for the lone last core, whose B
    // rows are zero: whatever bytes lie there give zero products), or column 2 of tap t - 1, two columns on and
    // the taps' shift back
    const int lead = step_crosses(s) ? 2 * cb - 16 * (tap_rows(t, S) - tap_rows(t - 1, S)) : cb;
    const uint64_t a = da + (n % 3) * (cb / 16) + (S + 1) + tap_rows(t, S) + (static_cast<uint64_t>(lead / 16) << 16);
    wgmma_m64n48k32_s8_ss(acc, a, db + s * (kStepBytes / 16), s > 0);
  }
}

// The epilogue of layer L on the warpgroup's 64 rows from q0: acc[4 j + 2 h + e] is row q0 + row + 8 h, channel
// 8 j + 2 t + e; k holds the layer's constants of those channels.
template <typename T, int L>
__device__ __forceinline__ void epilogue(const Ctx<T>& cx, const int (&acc)[24], int q0, const Consts<T>& k) {
  constexpr int tt = Tile<T>::kT;
  const Params& p = *cx.p;
  const Layout& l = cx.l;
  const int S = l.S, F = cx.F, C = cx.C;
  const int end = first_row(L, S) + need_rows(L, S, tt);
  T* res = reinterpret_cast<T*>(cx.smem + l.res);
  unsigned char* dst = cx.smem + ((L & 1) ? l.buf1 : l.buf0);  // layer L's output is layer L + 1's input
  const float inv_next = L < kLayers ? p.inv_s[L % kLayers] : 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + cx.row + 8 * h;
    if (q >= end) continue;
    const int fr_rel = static_cast<int>(__umulhi(static_cast<uint32_t>(q), l.s_magic));
    const int slot = q - fr_rel * S;
    const int fr = cx.a - kHalo + fr_rel;
    const bool real = slot >= 1 && slot <= F && fr >= 0 && fr < p.T;
    // channel 8 j + 2 t lies in chunk j / 2, at byte 8 (j % 2) + 2 t of its row
    unsigned char* drow = dst + (kGuard + q) * 16 + 2 * cx.t;
    if (!real) {
      if constexpr (L < kLayers) {
#pragma unroll
        for (int j = 0; j < 6; ++j) *reinterpret_cast<uint16_t*>(drow + (j / 2) * l.chunk_bytes + 8 * (j & 1)) = 0;
      }
      continue;
    }
    const int pi = (fr_rel - 2) * F + slot - 1;  // the residual's position (layers 2, 4 and 6)
    T* orow = nullptr;
    if constexpr (L == kLayers) {
      const T* out_run = static_cast<const T*>(p.out) + (static_cast<size_t>(cx.b) * p.T + cx.a) * F * C;
      orow = reinterpret_cast<T*>(cx.smem + l.w0 + (reinterpret_cast<uintptr_t>(out_run) & 15)) +
             ((fr - cx.a) * F + slot - 1) * C;
    }
    // the residual pairs first: no store below may be taken for one of theirs, so the loads leave together
    T* rp0 = res + static_cast<size_t>(pi) * 8 + 2 * cx.t;
    using Pair = std::conditional_t<sizeof(T) == 2, __nv_bfloat162, float2>;
    Pair rpair[6];
    if constexpr ((L & 1) == 0) {
#pragma unroll
      for (int j = 0; j < 6; ++j) rpair[j] = *reinterpret_cast<const Pair*>(rp0 + static_cast<size_t>(j) * l.res_pos * 8);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float r0 = relu_float(acc[4 * j + 2 * h]), r1 = relu_float(acc[4 * j + 2 * h + 1]);
      T* rp = rp0 + static_cast<size_t>(j) * l.res_pos * 8;
      float o0, o1;
      uint32_t bits = 0u;  // the bf16 pair of the output, as it is stored
      if constexpr (sizeof(T) == 2) {
        __nv_bfloat162 v = __hmul2_rn(__floats2bfloat162_rn(r0, r1), k.dq[j]);
        if constexpr ((L & 1) == 0) v = __hadd2_rn(v, rpair[j]);
        if constexpr (L == 2 || L == 4) *reinterpret_cast<__nv_bfloat162*>(rp) = v;
        const __nv_bfloat162 o = __hadd2_rn(__hmul2_rn(v, k.bs[j]), k.bb[j]);
        o0 = __low2float(o);
        o1 = __high2float(o);
        bits = *reinterpret_cast<const uint32_t*>(&o);
      } else {
        float v0 = __fmul_rn(r0, k.dq[j].x), v1 = __fmul_rn(r1, k.dq[j].y);
        if constexpr ((L & 1) == 0) {
          v0 = __fadd_rn(v0, rpair[j].x);
          v1 = __fadd_rn(v1, rpair[j].y);
        }
        if constexpr (L == 2 || L == 4) *reinterpret_cast<float2*>(rp) = make_float2(v0, v1);
        o0 = __fadd_rn(__fmul_rn(v0, k.bs[j].x), k.bb[j].x);
        o1 = __fadd_rn(__fmul_rn(v1, k.bs[j].y), k.bb[j].y);
      }
      if constexpr (L < kLayers) {
        *reinterpret_cast<uint16_t*>(drow + (j / 2) * l.chunk_bytes + 8 * (j & 1)) =
            static_cast<uint16_t>(__byte_perm(quantize(o0, inv_next), quantize(o1, inv_next), 0x0040));
      } else {
        const int c = 8 * j + 2 * cx.t;
        if constexpr (sizeof(T) == 2) {
          if (c < C) reinterpret_cast<uint16_t*>(orow)[c] = static_cast<uint16_t>(bits);
          if (c + 1 < C) reinterpret_cast<uint16_t*>(orow)[c + 1] = static_cast<uint16_t>(bits >> 16);
        } else {
          if (c < C) orow[c] = o0;
          if (c + 1 < C) orow[c + 1] = o1;
        }
      }
    }
  }
}

// Layer L of the tile, c its place in the block's sequence of layers. The warpgroups take the layer's m64 tiles
// in turns, each its tiles one after another with the next one's products issued before each epilogue, so that
// one group of products is always in flight when a loop turn ends and the compiler sees every wgmma's wait. A
// warpgroup left one short computes tile 0 again and stores nothing.
template <typename T, int L>
__device__ __forceinline__ void run_layer(const Ctx<T>& cx, int c) {
  constexpr int tt = Tile<T>::kT;
  const int S = cx.l.S;
  if (L < kLayers && cx.tid == 0) issue_w(cx, c + 1);
  const int tiles = m_tiles(L, S, tt);
  constexpr int kWG = Tile<T>::kWG;
  const int n = (tiles + kWG - 1) / kWG;  // tiles a warpgroup takes, the last one perhaps a repeat of tile 0
  const int first = first_row(L, S);
  const float* tab = reinterpret_cast<const float*>(cx.smem + cx.l.tab) + (L - 1) * 3 * kCPad;
  Consts<T> k;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int col = 8 * j + 2 * cx.t;
    make_pair(k.dq[j], tab[col], tab[col + 1]);
    make_pair(k.bs[j], tab[kCPad + col], tab[kCPad + col + 1]);
    make_pair(k.bb[j], tab[2 * kCPad + col], tab[2 * kCPad + col + 1]);
  }
  const int src = (L - 1) & 1;
  const int slot = c & 1;
  auto row0 = [&](int i) {
    const int m = cx.wg + kWG * i;
    return first + 64 * (m < tiles ? m : 0);
  };
  auto finish = [&](const int (&acc)[24], int i) {
    if (cx.wg + kWG * i < tiles) epilogue<T, L>(cx, acc, row0(i), k);
  };
  mbar_wait(&cx.w_full[slot], (c >> 1) & 1);
  int acc0[24], acc1[24];
  wgmma_fence();
  products(cx, acc0, row0(0), src, slot);
  wgmma_commit();
  int i = 0;
#pragma unroll 1
  for (; i + 2 < n; i += 2) {
    wgmma_fence();
    products(cx, acc1, row0(i + 1), src, slot);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_keep(acc0);
    finish(acc0, i);
    wgmma_fence();
    products(cx, acc0, row0(i + 2), src, slot);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_keep(acc1);
    finish(acc1, i + 1);
  }
  if (i + 1 < n) {
    wgmma_fence();
    products(cx, acc1, row0(i + 1), src, slot);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_keep(acc0);
    finish(acc0, i);
    wgmma_wait<0>();
    wgmma_keep(acc1);
    finish(acc1, i + 1);
  } else {
    wgmma_wait<0>();
    wgmma_keep(acc0);
    finish(acc0, i);
  }
  fence_proxy_async();  // the s8 stores are read by the next layer's wgmma (the async proxy)
  __syncthreads();
}

// the tile's output, staged by layer 6 over w0 and buf0 in its own order, to its run of out
template <typename T>
__device__ __forceinline__ void store_output(const Ctx<T>& cx) {
  constexpr int tt = Tile<T>::kT;
  const Params& p = *cx.p;
  const int n = min(tt, p.T - cx.a) * cx.F * cx.C;
  T* out = static_cast<T*>(p.out) + (static_cast<size_t>(cx.b) * p.T + cx.a) * cx.F * cx.C;
  const T* s_out = reinterpret_cast<const T*>(cx.smem + cx.l.w0 + (reinterpret_cast<uintptr_t>(out) & 15));
  const Run<T> run(out, n);
  for (int e = cx.tid; e < run.head; e += kThreads<T>) out[e] = s_out[e];
  for (int e = run.tail + cx.tid; e < n; e += kThreads<T>) out[e] = s_out[e];
  const uint4* vsrc = reinterpret_cast<const uint4*>(s_out + run.head);
  uint4* vdst = reinterpret_cast<uint4*>(out + run.head);
  for (int v = cx.tid; v < run.n_vec; v += kThreads<T>) vdst[v] = vsrc[v];
}

// kF and kC: the geometry as constants (the serving geometry's instance), or 0 to read it from p
template <typename T, int kF, int kC>
__global__ void __launch_bounds__(kThreads<T>, 1) int8_trunk_fused_kernel(const __grid_constant__ Params p) {
  constexpr int tt = Tile<T>::kT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  Ctx<T> cx;
  cx.smem = smem;
  cx.smem_s = smem_u32(smem);
  cx.F = kF ? kF : p.F;
  cx.C = kC ? kC : p.C;
  cx.l = layout<T>(cx.F, cx.C);
  cx.p = &p;
  cx.w_full = reinterpret_cast<uint64_t*>(smem + cx.l.bar);
  cx.tid = tid;
  cx.wg = warp >> 2;
  cx.row = 16 * (warp & 3) + (lane >> 2);  // this thread's first row of a 64-row tile; the second is row + 8
  cx.t = lane & 3;
  const int n_mine = static_cast<int>(blockIdx.x) < p.n_items ? (p.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  // each layer's dq = cdt(w_scale * s_a), bn scale and bn shift rounded to the compute dtype, zeros past C
  float* tab = reinterpret_cast<float*>(smem + cx.l.tab);
  for (int i = tid; i < kLayers * kCPad; i += kThreads<T>) {
    const int L = i / kCPad;
    const int c = i - L * kCPad;
    const bool ok = c < cx.C;
    tab[L * 3 * kCPad + c] = ok ? rnd<T>(__fmul_rn(__ldg(p.w_scale[L] + c), p.s_a[L])) : 0.f;
    tab[L * 3 * kCPad + kCPad + c] = ok ? rnd<T>(__ldg(p.bn_scale[L] + c)) : 0.f;
    tab[L * 3 * kCPad + 2 * kCPad + c] = ok ? rnd<T>(__ldg(p.bn_shift[L] + c)) : 0.f;
  }
  if (tid == 0) {
    mbar_init(&cx.w_full[0], 1);
    mbar_init(&cx.w_full[1], 1);
    mbar_init_fence();
    if (n_mine > 0) issue_w(cx, 0);
  }
  if (n_mine > 0) load_y(cx, blockIdx.x / p.n_tiles, (blockIdx.x % p.n_tiles) * tt);

  for (int k = 0; k < n_mine; ++k) {
    const int item = blockIdx.x + k * gridDim.x;
    cx.b = item / p.n_tiles;
    cx.a = (item - cx.b * p.n_tiles) * tt;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the input has landed; the tables and barriers are ready
    quantize_input(cx);
    fence_proxy_async();
    __syncthreads();  // buffer 0 is complete, the staging buffer free
    if (k + 1 < n_mine) {
      const int next = item + gridDim.x;
      load_y(cx, next / p.n_tiles, (next % p.n_tiles) * tt);
    }
    const int c = kLayers * k;
    run_layer<T, 1>(cx, c);
    run_layer<T, 2>(cx, c + 1);
    run_layer<T, 3>(cx, c + 2);
    run_layer<T, 4>(cx, c + 3);
    run_layer<T, 5>(cx, c + 4);
    run_layer<T, 6>(cx, c + 5);
    store_output(cx);
    if (k + 1 < n_mine) {
      fence_proxy_async();
      __syncthreads();  // the staged output is out: slot 0 takes the next item's first layer
      if (tid == 0) issue_w(cx, c + kLayers);
    }
  }
}

template <typename T, int kF, int kC>
int launch(const Params& p, int smem, int sms, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(int8_trunk_fused_kernel<T, kF, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_trunk_fused_kernel<T, kF, kC><<<p.n_items < sms ? p.n_items : sms, kThreads<T>, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// res8's serving geometry (40 mels pooled by 4, 45 maps) runs an instance with its geometry as constants
template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  if (!layout_fits<T>(p.F, p.C)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = layout<T>(p.F, p.C).total;
  return p.F == 10 && p.C == 45 ? launch<T, 10, 45>(p, smem, sms, stream) : launch<T, 0, 0>(p, smem, sms, stream);
}

}  // namespace

// y (B, T, F, C) bf16 (is_bf16) or float32, contiguous and 16-byte aligned;
// w_img, w_scale, bn_scale and bn_shift host arrays of the six layers'
// device pointers: the 21,504-byte weight images
// (ops/int8_trunk.pack_w_image_wgmma, 16-byte aligned) and the (C,) float32
// vectors; s_a and inv_s host arrays of the six activation scales and
// float32(1 / s_a); out (B, T, F, C) in y's dtype, contiguous. Returns
// cudaGetLastError() after the launch, the error of an attribute call, or
// cudaErrorInvalidValue for a geometry the kernel does not serve.
extern "C" int howl_int8_trunk_fused_forward(const void* y, const void* const* w_img, const void* const* w_scale,
                                             const void* const* bn_scale, const void* const* bn_shift,
                                             const float* s_a, const float* inv_s, void* out, int B, int T_len,
                                             int F, int C, int is_bf16, void* stream) {
  if (B < 0 || T_len < 0 || F < 1 || C < 1 || C > kCPad) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T_len == 0) return 0;
  Params p;
  p.y = y;
  p.out = out;
  for (int L = 0; L < kLayers; ++L) {
    p.w_img[L] = static_cast<const unsigned char*>(w_img[L]);
    p.w_scale[L] = static_cast<const float*>(w_scale[L]);
    p.bn_scale[L] = static_cast<const float*>(bn_scale[L]);
    p.bn_shift[L] = static_cast<const float*>(bn_shift[L]);
    p.s_a[L] = s_a[L];
    p.inv_s[L] = inv_s[L];
  }
  p.B = B;
  p.T = T_len;
  p.F = F;
  p.C = C;
  const int tt = is_bf16 ? Tile<__nv_bfloat16>::kT : Tile<float>::kT;
  p.n_tiles = (T_len + tt - 1) / tt;
  const long long items = static_cast<long long>(p.n_tiles) * B;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_items = static_cast<int>(items);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

// The kernel's tile (frames a block item keeps) and shared memory in bytes for F bins of C channels, or -1 where
// it does not serve that geometry: what ops/int8_trunk's route computes on the host.
extern "C" int howl_int8_trunk_fused_geometry(int F, int C, int is_bf16, int want_tile) {
  if (want_tile) return is_bf16 ? Tile<__nv_bfloat16>::kT : Tile<float>::kT;
  if (F < 1 || C < 1 || C > kCPad) return -1;
  if (is_bf16) return layout_fits<__nv_bfloat16>(F, C) ? layout<__nv_bfloat16>(F, C).total : -1;
  return layout_fits<float>(F, C) ? layout<float>(F, C).total : -1;
}
