// Fused log-mel frontend for Hopper (sm_90a): audio -> ZMUV'd log-mels.
//
// Replaces the TPU kernel howl_tpu/ops/frontend_pallas.py,
// log_mel_spectrogram_pallas (Pallas kernel _kernel). It computes
//
//     out = (log(mel + log_offset) - mean) * inv_std,
//     mel = (|frames @ W|^2) @ fb
//
// where frame t is samples [t*hop, t*hop + n_fft) of the center reflect-padded
// audio, W is the (n_fft, 2*n_bins) [cos | -sin] DFT basis with the periodic
// Hann window folded in and the Nyquist bin cropped, and fb is the HTK mel
// filterbank. Both matrices are built once on the host from the same numpy
// builders as the JAX package (ops/frontend.py) and passed in as float32.
//
// What bounds it on this card: arithmetic. The windowed DFT costs
// n_fft * 2*n_bins = 262,144 multiply-adds (~0.5 MFLOP, ~0.6 with the mel
// product) per frame, against 200 new audio samples (400-800 bytes) read per
// frame. This first version runs on the CUDA cores in float32 FMA, so it is
// FMA-bound; moving the DFT product onto the tensor cores (mma.sync / wgmma
// in bf16 with float32 accumulation) is later work.
//
// What the design does about it:
//  * One block takes one clip and a tile of kFramesPerBlock frames, a
//    template parameter the host picks (16, 32 or 64; 32 by default), with
//    8 threads a frame, so at 256 bins every thread owns one item of the
//    product below whatever the tile. A frame's sums run in the same order
//    whatever tile holds it, so every tile gives the same bits. It loads
//    the tile's audio span -- its hop rows plus the n_fft - hop lookahead --
//    into shared memory once, applying the reflect padding as it reads, so
//    the 2.56x overlapping frames tensor is never built in device memory.
//  * The DFT is a register-tiled product: each thread owns 8 frames x 4 bins
//    and accumulates both re and im of those bins (64 float32 accumulators),
//    reading frame samples as shared-memory broadcasts and W rows staged
//    through shared memory kChunk rows at a time.
//  * re^2 + im^2 goes to a shared (frames, bins) power tile; the full
//    (frames, 2*n_bins) re/im tensor never reaches device memory. The mel
//    product, the log and the ZMUV affine run from there in the same block.
//
// Precision grades are reproduced by rounding operands to bf16 and
// accumulating in float32: round_audio rounds the samples, round_power the
// power, and the host passes W and fb already rounded where the grade asks.
// round_mel rounds the pre-log mel to bf16, as the TPU path does when it
// writes bf16 output tiles. The three-pass grade ("bf16x3", the TPU kernel's
// passes == 3) runs here only where frontend_tc.cu's three-pass block does not
// fit in shared memory (512 / 200 at 80 mels) or when the caller forces
// route="fma". It is a second instance of the kernel: the host passes W_hi and
// fb_hi as w and fb and their bf16 remainders as w_lo and fb_lo; the span is
// split into its bf16 part and the bf16 rounding of the rest as it is staged,
// and the power as the epilogue reads it. Each term is x_hi * W_hi + x_hi *
// W_lo + x_lo * W_hi (then p_hi * fb_hi + p_lo * fb_hi + p_hi * fb_lo): a
// product of two bf16 values is exact in float32, so FMA on the rounded
// operands is the grade, up to the order of the sums. It does three times
// the FMAs of the other grades.
//
// Any n_fft / hop overlap is handled: the span is read directly. A geometry
// whose tile does not fit in shared memory fails the launch, and the caller
// raises; there is no quiet fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFramesPerThread = 8;
constexpr int kBinsPerThread = 4;
constexpr int kChunk = 16;  // W rows staged per step

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sample p of the padded signal: reflect within `pad` of either end (the
// edge sample itself is not repeated, as torch and numpy reflect), zeros past
// the padded end.
__device__ __forceinline__ float padded_sample(const float* row, long S, long pad, long p) {
  long i = p - pad;
  if (i >= S + pad) return 0.f;
  if (i < 0) i = -i;
  else if (i >= S) i = 2 * (S - 1) - i;
  return row[i];
}

__host__ __device__ __forceinline__ int round_up4(int x) { return (x + 3) & ~3; }

// the threads of a block of kFramesPerBlock frames
__host__ __device__ constexpr int block_threads(int frames) { return 8 * frames; }

// Shared memory of one block: the span (twice with three passes: hi, lo), W's
// staged rows (twice: hi, lo), the power tile.
template <int kFramesPerBlock>
__host__ __device__ __forceinline__ size_t smem_floats(int span, int n_bins_pad, bool three) {
  const int parts = three ? 2 : 1;
  return static_cast<size_t>(parts) * round_up4(span) + static_cast<size_t>(parts) * kChunk * 2 * n_bins_pad +
         static_cast<size_t>(kFramesPerBlock) * n_bins_pad;
}

template <bool kThree, int kFramesPerBlock>
__global__ void __launch_bounds__(block_threads(kFramesPerBlock))
logmel_kernel(const float* __restrict__ audio, const float* __restrict__ w,
              const float* __restrict__ fb, const float* __restrict__ w_lo,
              const float* __restrict__ fb_lo, void* __restrict__ out, int S, int n_frames,
              int n_fft, int hop, int pad, int n_bins_pad, int n_mels, int round_audio,
              int round_power, int round_mel, int out_bf16, int layout_fm, float log_offset,
              float mean, float inv_std) {
  constexpr int kThreads = block_threads(kFramesPerBlock);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int span = (kFramesPerBlock - 1) * hop + n_fft;
  const int w_cols = 2 * n_bins_pad;
  float* s_audio = smem;                                   // span samples (their bf16 part with three passes)
  float* s_audio_lo = s_audio + round_up4(span);           // three passes: the rest, rounded to bf16
  float* s_w = s_audio + (kThree ? 2 : 1) * round_up4(span);  // kChunk x w_cols
  float* s_w_lo = s_w + kChunk * w_cols;                   // three passes: W_lo's rows
  float* s_power = s_w + (kThree ? 2 : 1) * kChunk * w_cols;  // kFramesPerBlock x n_bins_pad

  // one grid axis of clips x tiles, the tiles of a clip adjacent: up to 2^31 - 1 blocks, so no cap on the clips
  const int n_tiles = (n_frames + kFramesPerBlock - 1) / kFramesPerBlock;
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x % n_tiles) * kFramesPerBlock;
  const float* row = audio + static_cast<size_t>(b) * S;
  const long p0 = static_cast<long>(t0) * hop;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const float v = padded_sample(row, S, pad, p0 + i);
    if (kThree) {
      const float hi = round_bf16(v);
      s_audio[i] = hi;
      s_audio_lo[i] = round_bf16(v - hi);
    } else {
      s_audio[i] = round_audio ? round_bf16(v) : v;
    }
  }

  // work item = (frame group of 8, bin group of 4); rounds keep every thread
  // at every barrier when there are more items than threads
  const int n_bin_groups = n_bins_pad / kBinsPerThread;
  const int n_items = (kFramesPerBlock / kFramesPerThread) * n_bin_groups;
  for (int base = 0; base < n_items; base += kThreads) {
    const int item = base + threadIdx.x;
    const bool active = item < n_items;
    const int fg = active ? item / n_bin_groups : 0;
    const int bg = active ? item % n_bin_groups : 0;
    float acc_re[kFramesPerThread][kBinsPerThread];
    float acc_im[kFramesPerThread][kBinsPerThread];
#pragma unroll
    for (int f = 0; f < kFramesPerThread; ++f)
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) acc_re[f][j] = acc_im[f][j] = 0.f;

    const float* x_base = s_audio + fg * kFramesPerThread * hop;
    const float* x_lo_base = s_audio_lo + fg * kFramesPerThread * hop;
    for (int k0 = 0; k0 < n_fft; k0 += kChunk) {
      const int kc = min(kChunk, n_fft - k0);
      __syncthreads();  // the previous chunk is consumed; s_audio is written
      const float4* w_src = reinterpret_cast<const float4*>(w + static_cast<size_t>(k0) * w_cols);
      for (int i = threadIdx.x; i < kc * w_cols / 4; i += kThreads)
        reinterpret_cast<float4*>(s_w)[i] = __ldg(w_src + i);
      if (kThree) {
        const float4* w_lo_src = reinterpret_cast<const float4*>(w_lo + static_cast<size_t>(k0) * w_cols);
        for (int i = threadIdx.x; i < kc * w_cols / 4; i += kThreads)
          reinterpret_cast<float4*>(s_w_lo)[i] = __ldg(w_lo_src + i);
      }
      __syncthreads();
      if (active) {
        for (int kk = 0; kk < kc; ++kk) {
          const float4 wr = reinterpret_cast<const float4*>(s_w + kk * w_cols)[bg];
          const float4 wi = reinterpret_cast<const float4*>(s_w + kk * w_cols + n_bins_pad)[bg];
          const float* xk = x_base + k0 + kk;
          if (kThree) {
            const float4 lr = reinterpret_cast<const float4*>(s_w_lo + kk * w_cols)[bg];
            const float4 li = reinterpret_cast<const float4*>(s_w_lo + kk * w_cols + n_bins_pad)[bg];
            const float* xlk = x_lo_base + k0 + kk;
#pragma unroll
            for (int f = 0; f < kFramesPerThread; ++f) {
              const float x = xk[f * hop];
              const float xl = xlk[f * hop];
              // x_hi W_hi + x_hi W_lo + x_lo W_hi, each product exact
              acc_re[f][0] = fmaf(xl, wr.x, fmaf(x, lr.x, fmaf(x, wr.x, acc_re[f][0])));
              acc_re[f][1] = fmaf(xl, wr.y, fmaf(x, lr.y, fmaf(x, wr.y, acc_re[f][1])));
              acc_re[f][2] = fmaf(xl, wr.z, fmaf(x, lr.z, fmaf(x, wr.z, acc_re[f][2])));
              acc_re[f][3] = fmaf(xl, wr.w, fmaf(x, lr.w, fmaf(x, wr.w, acc_re[f][3])));
              acc_im[f][0] = fmaf(xl, wi.x, fmaf(x, li.x, fmaf(x, wi.x, acc_im[f][0])));
              acc_im[f][1] = fmaf(xl, wi.y, fmaf(x, li.y, fmaf(x, wi.y, acc_im[f][1])));
              acc_im[f][2] = fmaf(xl, wi.z, fmaf(x, li.z, fmaf(x, wi.z, acc_im[f][2])));
              acc_im[f][3] = fmaf(xl, wi.w, fmaf(x, li.w, fmaf(x, wi.w, acc_im[f][3])));
            }
          } else {
#pragma unroll
            for (int f = 0; f < kFramesPerThread; ++f) {
              const float x = xk[f * hop];
              acc_re[f][0] = fmaf(x, wr.x, acc_re[f][0]);
              acc_re[f][1] = fmaf(x, wr.y, acc_re[f][1]);
              acc_re[f][2] = fmaf(x, wr.z, acc_re[f][2]);
              acc_re[f][3] = fmaf(x, wr.w, acc_re[f][3]);
              acc_im[f][0] = fmaf(x, wi.x, acc_im[f][0]);
              acc_im[f][1] = fmaf(x, wi.y, acc_im[f][1]);
              acc_im[f][2] = fmaf(x, wi.z, acc_im[f][2]);
              acc_im[f][3] = fmaf(x, wi.w, acc_im[f][3]);
            }
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f) {
        float p[kBinsPerThread];
#pragma unroll
        for (int j = 0; j < kBinsPerThread; ++j) {
          p[j] = acc_re[f][j] * acc_re[f][j] + acc_im[f][j] * acc_im[f][j];
          if (!kThree && round_power) p[j] = round_bf16(p[j]);
        }
        reinterpret_cast<float4*>(s_power + (fg * kFramesPerThread + f) * n_bins_pad)[bg] =
            make_float4(p[0], p[1], p[2], p[3]);
      }
    }
  }
  __syncthreads();

  // mel product + log + ZMUV epilogue, one output per thread per pass
  for (int o = threadIdx.x; o < kFramesPerBlock * n_mels; o += kThreads) {
    const int f = o / n_mels;
    const int m = o - f * n_mels;
    const int t = t0 + f;
    if (t >= n_frames) continue;
    const float* pw = s_power + f * n_bins_pad;
    float mel = 0.f;
    if (kThree) {
      // p_hi fb_hi + p_lo fb_hi + p_hi fb_lo
      for (int k = 0; k < n_bins_pad; ++k) {
        const float p_hi = round_bf16(pw[k]);
        const float p_lo = round_bf16(pw[k] - p_hi);
        const float f_hi = __ldg(fb + k * n_mels + m);
        mel = fmaf(p_hi, __ldg(fb_lo + k * n_mels + m), fmaf(p_lo, f_hi, fmaf(p_hi, f_hi, mel)));
      }
    } else {
      for (int k = 0; k < n_bins_pad; ++k) mel = fmaf(pw[k], __ldg(fb + k * n_mels + m), mel);
    }
    if (round_mel) mel = round_bf16(mel);
    const float y = (logf(mel + log_offset) - mean) * inv_std;
    const size_t idx = layout_fm
                           ? (static_cast<size_t>(b) * n_mels + m) * n_frames + t
                           : (static_cast<size_t>(b) * n_frames + t) * n_mels + m;
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[idx] = y;
  }
}

template <int kFramesPerBlock>
int launch(const float* audio, const float* w, const float* fb, const float* w_lo, const float* fb_lo, void* out,
           int B, int S, int n_frames, int n_fft, int hop, int center, int n_bins_pad, int n_mels, int round_audio,
           int round_power, int round_mel, int out_bf16, int layout_fm, float log_offset, float mean,
           float inv_std, cudaStream_t stream) {
  const bool three = w_lo != nullptr;
  const int span = (kFramesPerBlock - 1) * hop + n_fft;
  const size_t smem = smem_floats<kFramesPerBlock>(span, n_bins_pad, three) * sizeof(float);
  auto kernel = three ? logmel_kernel<true, kFramesPerBlock> : logmel_kernel<false, kFramesPerBlock>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((n_frames + kFramesPerBlock - 1) / kFramesPerBlock) * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  kernel<<<grid, block_threads(kFramesPerBlock), smem, stream>>>(
      audio, w, fb, w_lo, fb_lo, out, S, n_frames, n_fft, hop, center ? n_fft / 2 : 0, n_bins_pad, n_mels,
      round_audio, round_power, round_mel, out_bf16, layout_fm, log_offset, mean, inv_std);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio (B, S) float32; w (n_fft, 2*n_bins_pad) float32; fb (n_bins_pad,
// n_mels) float32; w_lo and fb_lo null, or (three passes) W's and fb's bf16
// remainders shaped as w and fb, with W_hi and fb_hi as w and fb;
// frame_tile the frames a block owns, 16, 32 or 64; out (B, n_frames,
// n_mels) ("tm") or (B, n_mels, n_frames) ("fm"), float32 or bf16. All
// contiguous. Returns cudaGetLastError() after the launch, the error of the
// shared-memory attribute call, or cudaErrorInvalidValue for a frame_tile
// the kernel is not built for.
extern "C" int howl_logmel_forward(const void* audio, const void* w, const void* fb, const void* w_lo,
                                   const void* fb_lo, void* out, int B, int S, int n_frames, int n_fft,
                                   int hop, int center, int n_bins_pad, int n_mels, int round_audio,
                                   int round_power, int round_mel, int out_bf16, int layout_fm,
                                   float log_offset, float mean, float inv_std, int frame_tile, void* stream) {
  if (B == 0 || n_frames == 0) return 0;
  if (n_bins_pad % kBinsPerThread != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((w_lo != nullptr) != (fb_lo != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<32>) fn = frame_tile == 16 ? launch<16> : frame_tile == 32 ? launch<32>
                           : frame_tile == 64 ? launch<64> : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(static_cast<const float*>(audio), static_cast<const float*>(w), static_cast<const float*>(fb),
            static_cast<const float*>(w_lo), static_cast<const float*>(fb_lo), out, B, S, n_frames, n_fft, hop,
            center, n_bins_pad, n_mels, round_audio, round_power, round_mel, out_bf16, layout_fm, log_offset, mean,
            inv_std, static_cast<cudaStream_t>(stream));
}
