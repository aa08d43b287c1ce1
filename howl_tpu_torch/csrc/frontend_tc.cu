// Fused log-mel frontend on Hopper's tensor cores (sm_90a): audio -> ZMUV'd
// log-mels, the "tc" route of ops/frontend_cuda.py for the three bf16 grades
// and the exact grade "f32".
//
// Replaces the TPU kernel howl_tpu/ops/frontend_pallas.py,
// log_mel_spectrogram_pallas (Pallas kernel _kernel), as frontend.cu does,
// and computes the same function:
//
//     out = (log(mel + log_offset) - mean) * inv_std,
//     mel = bf16(|frames @ W|^2) @ fb
//
// with frame t the samples [t*hop, t*hop + n_fft) of the center
// reflect-padded audio rounded to bf16, W the bf16 [cos | -sin] DFT basis
// with the Hann window folded in (grade "bf16"), or its bf16 hi and lo parts
// one after the other, frames @ W_hi + frames @ W_lo (grade "bf16x2"), and
// fb the bf16 mel filterbank. Sums are float32. The three-pass grade
// ("bf16x3", the JAX kernel's default) splits the audio, the power and fb
// as well, each into its bf16 part and the bf16 rounding of the rest, and
// drops only the lo x lo terms:
//
//     re|im = x_hi @ W_hi + x_hi @ W_lo + x_lo @ W_hi,
//     mel   = p_hi @ fb_hi + p_lo @ fb_hi + p_hi @ fb_lo.
//
// The exact grade ("f32", the JAX kernel's Precision.HIGHEST, which the TPU
// lowers as six bf16 products) splits every operand one level deeper, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each difference exact
// in float32, and keeps the six products whose order is at most lo:
//
//     re|im = x_hi W_hi + x_hi W_mid + x_mid W_hi + x_hi W_lo + x_mid W_mid + x_lo W_hi,
//
// and the same six on the float32 power and fb. A product of two bf16 values
// is exact in float32, so what differs from the float32 product is the order
// of the float32 sums and the dropped terms, ~2^-24 relative.
//
// What bounds it on this card: the operations of the DFT product,
// n_fft * 2 * n_bins multiply-adds a frame (0.5 MFLOP at 512 / 256; three
// times that for "bf16x3", six for "f32") against 200 new samples read, so the product
// belongs on the tensor cores; and next the traffic of W, which every block
// reads whole from L2.
//
// What the design does about it:
//  * A block owns one clip and a tile of kTile frames, a template parameter
//    the host picks (64, 128 or 256 at 40 mels, 128 at 80; 128 by default):
//    one warpgroup of 64 frames for a tile of 64, otherwise two warpgroups,
//    256 threads, each taking its 64-frame row blocks in kTile / 128 rounds
//    (a thread's 128 sums leave no registers for a second row block at
//    once, and a third warpgroup's would not fit an SM's register file).
//    Every round streams W through the ring once more, so W's reads from L2
//    follow the frames whatever the tile; the span does not. A frame's sums
//    run in the same order whatever tile holds it, so every tile gives the
//    same bits. The tile's audio span, (kTile - 1) * hop + n_fft samples,
//    is read once with the reflect padding applied, rounded to bf16 and
//    kept in shared memory; the overlapping frames are never built. A (frames) comes from registers: the fragment of a thread is
//    pairs of neighbouring samples of a frame, one 32-bit shared-memory load
//    each at sample t * hop + k (hop is even).
//  * W is packed by the host in the very image the wgmma descriptor reads
//    (frontend_cuda.pack_w_image): per half of 128 bins an N = 256 tile [re
//    of the half's bins | im of the same bins], per 16 rows of k two by 32
//    core matrices of 128 bytes. A stage of the ring is 64 rows of k, 32 KB,
//    one contiguous bulk copy (cp.async.bulk) that one thread starts as soon
//    as all eight warps have released the slot; a "full" and an "empty"
//    mbarrier per slot, kSlots = 3. With 128-frame tiles a batch of 512 x
//    8 s reads W 3,072 times from L2, not 10,752.
//  * "bf16x3" streams W_hi and W_lo through the ring as "bf16x2" does (the
//    same image). A W_hi stage takes two groups of products: A from the
//    span's bf16 part, then, once the first group is waited for, A from its
//    remainder, a second span kept beside the first (both rounded once, as
//    the span is loaded), loaded into the same registers. So no second A
//    fragment set is live, and W_hi is read once: a stage of the ring costs
//    about as much whether its products run or not, so streaming W_hi a
//    third time would cost as much as a pass (1.45 ms against 1.27 at
//    512 x 8 s on an NVIDIA H100 80GB HBM3 at 700 W; probe_kernel_variants
//    --probe k1-x3 splits the rest). Its block holds two spans and fb_hi
//    and fb_lo (one image after the other, both resident), and two ring
//    slots (kSlotsX3) to stay within a block's shared memory: 210,184 bytes
//    at 512 / 200 and 40 mels. At 80 mels that is 251,144 bytes, so 512 /
//    200 at 80 mels takes the FMA kernel (frontend_cuda.frontend_route);
//    400 / 160 at 80 mels fits.
//  * "f32" streams W_hi, W_mid and W_lo through the same two-slot ring, each
//    once: a W_hi stage takes three groups of products (A from x_hi, x_mid,
//    x_lo), a W_mid stage two (x_hi, x_mid), a W_lo stage one, each group's
//    A loaded into the same registers once the group before it is waited
//    for. Three bf16 spans and three fb images would not fit a block, so the
//    span is kept once in float32 (the bytes of two bf16 spans) and split
//    into its hi, mid or lo part as the A fragments are loaded; fb_hi, fb_mid
//    and fb_lo lie resident one after the other: 230,664 bytes at 512 / 200
//    and 40 mels, 1,784 under the limit. The power is split into three
//    fragment sets once the sums are dead. Any 80-mel geometry with 256 bins
//    takes the FMA kernel.
//  * There is no producer warp. A thread needs about 240 registers (128 of
//    them sums), which eight warps of an SM can have and nine cannot, and
//    the compiler plans a kernel's registers for the count at entry whatever
//    setmaxnreg moves at run time: with a producer warpgroup the sums
//    spilled and every wgmma waited for the one before. So the first warp
//    refills the ring between its own products. The wait before a refill is
//    made by the whole warp and only the copy by one lane: a one-thread
//    branch around a wait loop, in the loop of the products, makes the
//    compiler serialise them as well.
//  * A warpgroup's sums are 64 x 256 float32, 128 registers a thread. re and
//    im of a bin fall to the same thread, 64 registers apart, so the power
//    is formed in registers, rounded to bf16 and packed straight into the A
//    fragments of a second wgmma against fb, which lies in shared memory
//    whole (frontend_cuda.pack_fb_image); the halves' mel products add up in
//    n_mels_pad / 2 registers. The power never reaches shared memory. For
//    "bf16x3" the power's remainder is packed into a second fragment set
//    once the sums are dead, and the half's three mel products go out as one
//    group.
//  * A warpgroup whose 64 frames all lie past the clip's last frame skips
//    its products (641 frames are 5 tiles and one frame) but keeps its place
//    at the barriers.
//  * The epilogue (bf16 rounding of the mel for bf16 output, log, ZMUV) runs
//    in registers; the tile's outputs are staged in the ring's shared
//    memory, and leave as 16-byte stores ("tm": the tile is one contiguous
//    run of the output) or as runs along t ("fm").
//
// The geometry it serves: n_fft a multiple of 16, hop even, n_mels a
// multiple of 8 and at most 80, and shared memory for the ring, fb and the
// span (frontend_cuda.frontend_route decides; the entry refuses the rest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using namespace hopper;

constexpr int kHalfBins = 128;                    // bins of one N = 256 tile: [re | im]
constexpr int kStepBytes = 16 * 2 * kHalfBins * 2;  // 16 rows of k of a tile: 8 KB
constexpr int kStageSteps = 4;                    // 64 rows of k a stage
constexpr int kStageBytes = kStageSteps * kStepBytes;
constexpr int kSlots = 3;                         // stages of the ring; 4 measured the same
constexpr int kSlotsX3 = 2;                       // the ring of the split grades, beside their spans and fbs
constexpr int kMaxSmem = 232448;                  // 227 KB a block

__host__ __device__ __forceinline__ int round_up16(int x) { return (x + 15) & ~15; }

__host__ __device__ __forceinline__ int fb_image_bytes(int n_halves, int mel_n) { return n_halves * kHalfBins * mel_n * 2; }

// A tile of kTile frames: its warpgroups of 64 frames (one for a tile of 64, else two), its threads, and the rounds
// in which the warpgroups take its row blocks of 64 frames
__host__ __device__ constexpr int tile_warpgroups(int tile) { return tile < 128 ? 1 : 2; }
__host__ __device__ constexpr int tile_threads(int tile) { return 128 * tile_warpgroups(tile); }
__host__ __device__ constexpr int tile_rounds(int tile) { return tile / (64 * tile_warpgroups(tile)); }

template <int kTile>
__host__ __device__ __forceinline__ int span_samples(int n_fft, int hop) { return (kTile - 1) * hop + n_fft; }

// The operands' parts, kParts: 1 for "bf16" and "bf16x2" (the image's n_passes passes of W against the span's bf16
// part), 2 for "bf16x3" (hi and lo of the span, the power and fb; W_hi and W_lo), 3 for "f32" (hi, mid and lo of
// all four). The span's bytes: one bf16 span a part, or for "f32" the span in float32.
template <int kParts, int kTile>
__host__ __device__ __forceinline__ int span_bytes(int n_fft, int hop) {
  return kParts == 3 ? round_up16(span_samples<kTile>(n_fft, hop) * 4)
                     : kParts * round_up16(span_samples<kTile>(n_fft, hop) * 2);
}

// the block's shared memory: the ring, fb's parts, the span's, a full and an empty barrier a slot and fb's
template <int kMelN, int kParts, int kTile>
__host__ __device__ __forceinline__ int block_smem(int n_fft, int hop, int n_halves) {
  constexpr int slots = kParts > 1 ? kSlotsX3 : kSlots;
  return slots * kStageBytes + kParts * fb_image_bytes(n_halves, kMelN) + span_bytes<kParts, kTile>(n_fft, hop) +
         (2 * slots + 1) * static_cast<int>(sizeof(uint64_t));
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x less its bf16 rounding, exact in float32 (split_bf16's rule)
__device__ __forceinline__ float bf16_rest(float x) { return __fsub_rn(x, round_bf16(x)); }

// part 0, 1 or 2 (hi, mid, lo) of two float32 values, packed as a bf16 pair
__device__ __forceinline__ uint32_t pack_part(float x0, float x1, int part) {
  for (int i = 0; i < part; ++i) {
    x0 = bf16_rest(x0);
    x1 = bf16_rest(x1);
  }
  return pack_bf16(x0, x1);
}

// Sample p of the padded signal: reflect within `pad` of either end (the
// edge sample itself is not repeated), zeros past the padded end.
__device__ __forceinline__ float padded_sample(const float* row, long S, long pad, long p) {
  long i = p - pad;
  if (i >= S + pad) return 0.f;
  if (i < 0) i = -i;
  else if (i >= S) i = 2 * (S - 1) - i;
  return row[i];
}

// kParts 2: the three-pass grade, n_passes 3 (the image holds W_hi and W_lo; a W_hi stage also multiplies the span's
// remainder); kParts 3: the exact grade, n_passes 6 (the image holds W_hi, W_mid and W_lo); kTile the frames a block
// owns
template <int kMelN, int kParts, int kTile>
__global__ void __launch_bounds__(tile_threads(kTile), 1)
logmel_tc_kernel(const float* __restrict__ audio, const unsigned char* __restrict__ w_img,
                 const unsigned char* __restrict__ fb_img, void* __restrict__ out, int S, int n_frames, int n_fft,
                 int hop, int pad, int n_halves, int n_passes, int n_mels, int round_mel, int out_bf16,
                 int layout_fm, float log_offset, float mean, float inv_std) {
  constexpr bool kX3 = kParts == 2;
  constexpr bool kF32 = kParts == 3;
  constexpr int kRingSlots = kParts > 1 ? kSlotsX3 : kSlots;
  constexpr int kThreads = tile_threads(kTile);
  constexpr int kWarpgroups = tile_warpgroups(kTile);
  constexpr int kRounds = tile_rounds(kTile);
  static_assert(kTile == 64 * kWarpgroups * kRounds, "a tile is whole row blocks of 64 frames");
  static_assert(kTile * kMelN * 4 <= kRingSlots * kStageBytes, "the tile's outputs are staged in the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  const int fb_bytes = fb_image_bytes(n_halves, kMelN);  // one part's image
  const int span = span_samples<kTile>(n_fft, hop);
  unsigned char* ring = smem;
  unsigned char* s_fb = ring + kRingSlots * kStageBytes;  // fb_hi, then fb_lo (or fb_mid and fb_lo)
  __nv_bfloat16* s_audio = reinterpret_cast<__nv_bfloat16*>(s_fb + kParts * fb_bytes);  // x_hi, then x_lo
  __nv_bfloat16* s_audio_lo = s_audio + round_up16(span * 2) / 2;
  float* s_audio_f32 = reinterpret_cast<float*>(s_audio);  // "f32": the span in float32 instead
  uint64_t* full = reinterpret_cast<uint64_t*>(s_fb + kParts * fb_bytes + span_bytes<kParts, kTile>(n_fft, hop));
  uint64_t* empty = full + kRingSlots;
  uint64_t* fb_full = empty + kRingSlots;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // the same in every lane, and the compiler knows it
  const int lane = tid & 31;
  // one grid axis of clips x tiles, the tiles of a clip adjacent: up to 2^31 - 1 blocks, so no cap on the clips
  const int n_tiles = (n_frames + kTile - 1) / kTile;
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x % n_tiles) * kTile;

  // The stages of W in the order they are consumed: per round, the image in its order, per half, per pass of W (hi
  // then lo for the three-pass grade, hi, mid, lo for "f32"), 64 rows of k at a time; the last stage of a pass is
  // short when n_fft is no multiple of 64.
  const int k_steps = n_fft / 16;
  const int stages_per_pass = (k_steps + kStageSteps - 1) / kStageSteps;
  const int w_passes = kParts > 1 ? kParts : n_passes;
  const int image_stages = n_halves * w_passes * stages_per_pass;
  const int n_stages = kRounds * image_stages;
  // stage i's round and its place in the image; no division where a tile is one round, since load_a runs in the
  // loop of the products
  auto round_of = [&](int i) { return kRounds == 1 ? 0 : i / image_stages; };
  auto image_stage = [&](int i) { return kRounds == 1 ? i : i % image_stages; };
  auto stage_steps = [&](int i) {
    const int left = k_steps - (i % stages_per_pass) * kStageSteps;
    return left < kStageSteps ? left : kStageSteps;
  };
  auto load_stage = [&](int i) {  // one thread
    const int slot = i % kRingSlots;
    const uint32_t bytes = stage_steps(i) * kStepBytes;
    const int at = image_stage(i);
    const size_t first_step = static_cast<size_t>(at / stages_per_pass) * k_steps + (at % stages_per_pass) * kStageSteps;
    mbar_arrive_expect_tx(&full[slot], bytes);
    bulk_load(ring + slot * kStageBytes, w_img + first_step * kStepBytes, bytes, &full[slot]);
  };

  if (tid == 0) {
    for (int slot = 0; slot < kRingSlots; ++slot) {
      mbar_init(&full[slot], 1);
      mbar_init(&empty[slot], kThreads / 32);  // one arrival a warp
    }
    mbar_init(fb_full, 1);
    mbar_init_fence();
    fence_proxy_async();
    mbar_arrive_expect_tx(fb_full, kParts * fb_bytes);
    bulk_load(s_fb, fb_img, kParts * fb_bytes, fb_full);
    for (int i = 0; i < kRingSlots && i < n_stages; ++i) load_stage(i);
  }
  // The span, rounded to bf16 (and for "bf16x3" the bf16 rounding of the rest, x - x_hi, exact in float32:
  // split_bf16's rule, which commutes with the padding; for "f32" the samples as they are). A tile inside the clip
  // (all but the first and the last, when the clip's rows are 16-byte aligned; the span's first sample is a
  // multiple of 4 samples into the clip) takes 16-byte loads, kSpanLoads of them in flight a thread, since the
  // block has nothing else to hide their latency behind. A tile at an edge goes sample by sample through the
  // padding.
  auto store_sample = [&](int i, float x) {
    if (kF32) {
      s_audio_f32[i] = x;
      return;
    }
    s_audio[i] = __float2bfloat16_rn(x);
    if (kX3) s_audio_lo[i] = __float2bfloat16_rn(bf16_rest(x));
  };
  const float* clip = audio + static_cast<size_t>(b) * S;
  const long p0 = static_cast<long>(t0) * hop;
  const long first = p0 - pad;
  if ((reinterpret_cast<uintptr_t>(clip) & 15) == 0 && first >= 0 && first + span <= S) {
    constexpr int kSpanLoads = 13;
    const float4* src = reinterpret_cast<const float4*>(clip + first);
    const int n4 = span / 4;
    for (int base = tid; base < n4; base += kThreads * kSpanLoads) {
      float4 v[kSpanLoads];
#pragma unroll
      for (int u = 0; u < kSpanLoads; ++u)
        if (base + u * kThreads < n4) v[u] = __ldg(src + base + u * kThreads);
#pragma unroll
      for (int u = 0; u < kSpanLoads; ++u)
        if (base + u * kThreads < n4) {
          const float4 x = v[u];
          if (kF32)
            reinterpret_cast<float4*>(s_audio_f32)[base + u * kThreads] = x;
          else
            reinterpret_cast<uint2*>(s_audio)[base + u * kThreads] =
                make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
          if (kX3)
            reinterpret_cast<uint2*>(s_audio_lo)[base + u * kThreads] =
                make_uint2(pack_bf16(__fsub_rn(x.x, round_bf16(x.x)), __fsub_rn(x.y, round_bf16(x.y))),
                           pack_bf16(__fsub_rn(x.z, round_bf16(x.z)), __fsub_rn(x.w, round_bf16(x.w))));
        }
    }
    for (int i = n4 * 4 + tid; i < span; i += kThreads) store_sample(i, clip[first + i]);
  } else {
    for (int i = tid; i < span; i += kThreads) store_sample(i, padded_sample(clip, S, pad, p0 + i));
  }
  __syncthreads();  // the span is written and the barriers are initialised

  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int tig = lane & 3;
  // this thread's first frame of the tile in round r; the second is 8 frames on
  auto row_of = [&](int r) { return (r * kWarpgroups + wg) * 64 + (warp & 3) * 16 + g; };
  const int x_off0 = row_of(0) * hop + 2 * tig;  // its first sample in round 0; a round is kWarpgroups * 64 frames on
  // a warpgroup with no frame of the clip in a round computes nothing in it
  auto active_in = [&](int r) { return t0 + (r * kWarpgroups + wg) * 64 < n_frames; };

  // the A fragments of a stage's products: samples k0 + 16 ks + {2 tig, 2 tig + 1} and + 8 of both frames of the
  // stage's round, from the span's part `part` (0 its bf16 part; 1 its remainder, the three-pass grade's second
  // products of a W_hi stage; for "f32" 0, 1 or 2, hi, mid or lo, split from the float32 span as they are loaded)
  uint32_t a[kStageSteps * 4];
  auto load_a = [&](int i, int part) {
    const int k0 = (i % stages_per_pass) * kStageSteps * 16;
    const int steps = stage_steps(i);
    const int x_off = x_off0 + round_of(i) * (kWarpgroups * 64 * hop);
    if constexpr (kF32) {
      const float* xa = s_audio_f32 + x_off;
      const float* xb = xa + 8 * hop;
      auto pair = [&](const float* x) {
        const float2 v = *reinterpret_cast<const float2*>(x);
        return pack_part(v.x, v.y, part);
      };
#pragma unroll
      for (int ks = 0; ks < kStageSteps; ++ks)
        if (ks < steps) {
          const int k = k0 + ks * 16;
          a[ks * 4 + 0] = pair(xa + k);
          a[ks * 4 + 1] = pair(xb + k);
          a[ks * 4 + 2] = pair(xa + k + 8);
          a[ks * 4 + 3] = pair(xb + k + 8);
        }
    } else {
      const __nv_bfloat16* xa = (part ? s_audio_lo : s_audio) + x_off;
      const __nv_bfloat16* xb = xa + 8 * hop;
#pragma unroll
      for (int ks = 0; ks < kStageSteps; ++ks)
        if (ks < steps) {
          const int k = k0 + ks * 16;
          a[ks * 4 + 0] = *reinterpret_cast<const uint32_t*>(xa + k);
          a[ks * 4 + 1] = *reinterpret_cast<const uint32_t*>(xb + k);
          a[ks * 4 + 2] = *reinterpret_cast<const uint32_t*>(xa + k + 8);
          a[ks * 4 + 3] = *reinterpret_cast<const uint32_t*>(xb + k + 8);
        }
    }
  };

  // the round's mel sums, and those of the rounds before, kept until the ring is free to stage them (a round is a
  // run-time loop, so each finished round's sums are copied out under a constant index, not indexed by the round)
  float mel[kMelN / 2];
  float mel_done[kRounds > 1 ? kRounds - 1 : 1][kMelN / 2];
#pragma unroll
  for (int i = 0; i < kStageSteps * 4; ++i) a[i] = 0u;
  if (active_in(0)) load_a(0, 0);

  int stage = 0;
  for (int rd = 0; rd < kRounds; ++rd) {  // the rounds of the tile's row blocks
    const bool active = active_in(rd);
#pragma unroll
    for (int i = 0; i < kMelN / 2; ++i) mel[i] = 0.f;
    for (int h = 0; h < n_halves; ++h) {
      float acc[128];  // (64, 256) sums: d[4j + i] is re of bin 8j + 2 tig + (i & 1), d[64 + 4j + i] its im
      if constexpr (kF32) {
        // The first product of a half reads acc under a run-time scale, so the compiler keeps the last half's sums
        // live through its mel products unless they are written here: beside the power's three fragment sets they
        // would spill and serialize the wgmma.
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      }
      for (int j = 0; j < w_passes * stages_per_pass; ++j, ++stage) {
        const int slot = stage % kRingSlots;
        const int steps = stage_steps(stage);
        mbar_wait(&full[slot], (stage / kRingSlots) & 1);
        if (active) {
          const uint32_t w_s = smem_u32(ring + slot * kStageBytes);
          // one group of the stage's products with the A fragments in registers, waited for: then the fragments may
          // be loaded again
          auto products = [&](bool first) {
            wgmma_fence();
            auto product = [&](int ks) {
              wgmma_m64n256k16(acc, a[ks * 4], a[ks * 4 + 1], a[ks * 4 + 2], a[ks * 4 + 3],
                               wgmma_desc(w_s + ks * kStepBytes, kStepBytes / 2, 128), !first || ks > 0);
            };
            if (steps == kStageSteps) {  // no branch between the products of a full stage
#pragma unroll
              for (int ks = 0; ks < kStageSteps; ++ks) product(ks);
            } else {
#pragma unroll
              for (int ks = 0; ks < kStageSteps - 1; ++ks)
                if (ks < steps) product(ks);
            }
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_keep(a);
          };
          products(j == 0);
          if (kX3 && j < stages_per_pass) {  // a W_hi stage: x_lo @ W_hi from the same slot
            load_a(stage, 1);
            products(false);
          }
          if (kF32 && j < 2 * stages_per_pass) {  // a W_hi or W_mid stage: x_mid against it
            load_a(stage, 1);
            products(false);
          }
          if (kF32 && j < stages_per_pass) {  // a W_hi stage: x_lo against it
            load_a(stage, 2);
            products(false);
          }
          if (stage + 1 < n_stages) load_a(stage + 1, 0);  // the products have read them: the next stage's
        }
        if (lane == 0) mbar_arrive(&empty[slot]);
        if (warp == 0 && stage + kRingSlots < n_stages) {
          // every warp has released the slot: refill it (the wait by the whole warp, see the top of the file)
          mbar_wait(&empty[slot], (stage / kRingSlots) & 1);
          if (lane == 0) load_stage(stage + kRingSlots);
        }
      }
      if (active) {
        wgmma_keep(acc);
        // power = re^2 + im^2, each product and the sum rounded as float32, then to bf16: the A fragments of the
        // mel product over this half's 128 bins, 16 bins a step; for "bf16x3" also the bf16 rounding of the rest;
        // for "f32" the power's mid part in q and its lo part in u
        uint32_t p[32];
        uint32_t q[kParts > 1 ? 32 : 1];
        uint32_t u[kF32 ? 32 : 1];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float re0 = acc[4 * j + 2 * r], re1 = acc[4 * j + 2 * r + 1];
            const float im0 = acc[64 + 4 * j + 2 * r], im1 = acc[64 + 4 * j + 2 * r + 1];
            const float pw0 = __fadd_rn(__fmul_rn(re0, re0), __fmul_rn(im0, im0));
            const float pw1 = __fadd_rn(__fmul_rn(re1, re1), __fmul_rn(im1, im1));
            p[2 * j + r] = pack_bf16(pw0, pw1);
            if constexpr (kX3) q[2 * j + r] = pack_bf16(__fsub_rn(pw0, round_bf16(pw0)), __fsub_rn(pw1, round_bf16(pw1)));
            if constexpr (kF32) {
              q[2 * j + r] = pack_part(pw0, pw1, 1);
              u[2 * j + r] = pack_part(pw0, pw1, 2);
            }
          }
        if (rd == 0 && h == 0) mbar_wait(fb_full, 0);
        // fb's image: per 16 bins two by kMelN / 8 core matrices; fb_lo's image follows fb_hi's (fb_mid's and fb_lo's
        // for "f32")
        const uint32_t fb_s = smem_u32(s_fb) + h * (kHalfBins / 16) * (kMelN * 32);
        auto mel_product = [&](const uint32_t(&frag)[32], uint32_t fb_at) {
#pragma unroll
          for (int kk = 0; kk < kHalfBins / 16; ++kk)
            wgmma_m64nNk16(mel, frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2], frag[4 * kk + 3],
                           wgmma_desc(fb_at + kk * (kMelN * 32), kMelN * 16, 128), 1);
        };
        wgmma_fence();
        mel_product(p, fb_s);
        if constexpr (kX3) {
          mel_product(q, fb_s);             // p_lo @ fb_hi
          mel_product(p, fb_s + fb_bytes);  // p_hi @ fb_lo
        }
        if constexpr (kF32) {  // the other five of the six: hi x mid, mid x hi, hi x lo, mid x mid, lo x hi
          mel_product(p, fb_s + fb_bytes);
          mel_product(q, fb_s);
          mel_product(p, fb_s + 2 * fb_bytes);
          mel_product(q, fb_s + fb_bytes);
          mel_product(u, fb_s);
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_keep(p);
        wgmma_keep(q);
        wgmma_keep(u);
        wgmma_keep(mel);
      }
    }
#pragma unroll
    for (int q = 0; q < kRounds - 1; ++q)
      if (q == rd)
#pragma unroll
        for (int i = 0; i < kMelN / 2; ++i) mel_done[q][i] = mel[i];
  }

  __syncthreads();  // every warpgroup is done with the ring: it now stages the tile's outputs
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    if (!active_in(rd)) continue;
#pragma unroll
    for (int j = 0; j < kMelN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 8 * j + 2 * tig + (i & 1);
        const int f = row_of(rd) + 8 * (i >> 1);
        if (m < n_mels) {
          float v = rd == kRounds - 1 ? mel[4 * j + i] : mel_done[rd < kRounds - 1 ? rd : 0][4 * j + i];
          if (round_mel) v = round_bf16(v);
          const float y = (logf(v + log_offset) - mean) * inv_std;
          const int idx = layout_fm ? m * kTile + f : f * n_mels + m;
          if (out_bf16)
            reinterpret_cast<__nv_bfloat16*>(ring)[idx] = __float2bfloat16_rn(y);
          else
            reinterpret_cast<float*>(ring)[idx] = y;
        }
      }
  }
  __syncthreads();

  const int valid = n_frames - t0 < kTile ? n_frames - t0 : kTile;
  const int esize = out_bf16 ? 2 : 4;
  if (!layout_fm) {
    // (B, n_frames, n_mels): the tile's valid frames are one run, a multiple of 16 bytes at a multiple of 16
    unsigned char* dst = static_cast<unsigned char*>(out) + (static_cast<size_t>(b) * n_frames + t0) * n_mels * esize;
    const int bytes = valid * n_mels * esize;
    for (int o = tid * 16; o < bytes; o += kThreads * 16)
      *reinterpret_cast<uint4*>(dst + o) = *reinterpret_cast<const uint4*>(ring + o);
  } else {
    // (B, n_mels, n_frames): a run of `valid` frames for each mel
    for (int o = tid; o < n_mels * valid; o += kThreads) {
      const int m = o / valid;
      const int f = o - m * valid;
      const size_t idx = (static_cast<size_t>(b) * n_mels + m) * n_frames + t0 + f;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[idx] = reinterpret_cast<const __nv_bfloat16*>(ring)[m * kTile + f];
      else
        static_cast<float*>(out)[idx] = reinterpret_cast<const float*>(ring)[m * kTile + f];
    }
  }
}

template <int kMelN, int kParts, int kTile>
int launch(const void* audio, const void* w_img, const void* fb_img, void* out, int B, int S, int n_frames, int n_fft,
           int hop, int center, int n_halves, int n_passes, int n_mels, int out_bf16, int layout_fm,
           float log_offset, float mean, float inv_std, void* stream) {
  const int smem = block_smem<kMelN, kParts, kTile>(n_fft, hop, n_halves);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(logmel_tc_kernel<kMelN, kParts, kTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((n_frames + kTile - 1) / kTile) * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  logmel_tc_kernel<kMelN, kParts, kTile><<<grid, tile_threads(kTile), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const unsigned char*>(w_img),
      static_cast<const unsigned char*>(fb_img), out, S, n_frames, n_fft, hop, center ? n_fft / 2 : 0, n_halves,
      n_passes, n_mels, out_bf16, out_bf16, layout_fm, log_offset, mean, inv_std);
  return static_cast<int>(cudaGetLastError());
}

using Launch = decltype(&launch<40, 1, 128>);

// the instance of a mel width and tile for the operands' parts (1, 2 or 3)
template <int kMelN, int kTile>
Launch instance(int parts) {
  return parts == 3 ? launch<kMelN, 3, kTile> : parts == 2 ? launch<kMelN, 2, kTile> : launch<kMelN, 1, kTile>;
}

}  // namespace

// audio (B, S) float32; w_img the bf16 image of W, n_halves x n_passes x
// (n_fft / 16) steps of 8 KB (frontend_cuda.pack_w_image): n_passes 1
// ("bf16": W), 2 ("bf16x2": W_hi, W_lo), 3 ("bf16x3": the same two passes
// of W, the audio split as well, so n_halves x 2 x (n_fft / 16) steps) or 6
// ("f32": W_hi, W_mid, W_lo, so n_halves x 3 x (n_fft / 16) steps); fb_img
// the bf16 image of fb, (n_halves * 128, mel_n) (frontend_cuda.pack_fb_image),
// for n_passes 3 fb_hi's image and then fb_lo's, for 6 fb_hi's, fb_mid's and
// fb_lo's; mel_n 40 or 80 and at least n_mels; frame_tile the frames a block
// owns, 64, 128 or 256 at mel_n 40 and 128 at 80; out (B, n_frames, n_mels)
// ("tm") or (B, n_mels, n_frames) ("fm"), float32 or bf16, the pre-log mel
// rounded to bf16 first for bf16. All contiguous. Returns cudaGetLastError()
// after the launch, the error of the shared-memory attribute call, or
// cudaErrorInvalidValue for a geometry or a (mel_n, frame_tile) the kernel
// does not serve.
extern "C" int howl_logmel_tc_forward(const void* audio, const void* w_img, const void* fb_img, void* out, int B,
                                      int S, int n_frames, int n_fft, int hop, int center, int n_halves,
                                      int n_passes, int n_mels, int mel_n, int frame_tile, int out_bf16,
                                      int layout_fm, float log_offset, float mean, float inv_std, void* stream) {
  if (B == 0 || n_frames == 0) return 0;
  if (n_fft < 16 || n_fft % 16 != 0 || hop < 2 || hop % 2 != 0 || n_mels < 8 || n_mels % 8 != 0 || n_mels > mel_n ||
      n_halves < 1 || n_passes < 1 || (n_passes > 3 && n_passes != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  const int parts = n_passes == 6 ? 3 : n_passes == 3 ? 2 : 1;
  Launch fn = nullptr;
  if (mel_n == 40 && frame_tile == 64) fn = instance<40, 64>(parts);
  if (mel_n == 40 && frame_tile == 128) fn = instance<40, 128>(parts);
  if (mel_n == 40 && frame_tile == 256) fn = instance<40, 256>(parts);
  if (mel_n == 80 && frame_tile == 128) fn = instance<80, 128>(parts);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(audio, w_img, fb_img, out, B, S, n_frames, n_fft, hop, center, n_halves, n_passes, n_mels, out_bf16,
            layout_fm, log_offset, mean, inv_std, stream);
}
