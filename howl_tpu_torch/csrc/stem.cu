// Fused res8 stem for Hopper (sm_90a): conv0 (3x3, 1 -> ch) + ReLU + AvgPool.
//
// Replaces the TPU kernel howl_tpu/ops/stem_pallas.py, res8_stem_pallas
// (Pallas kernel _stem_kernel, weights prepared by fold_stem_weights). It
// computes, for time-major ZMUV'd log-mels mel (B, T, n_mels),
//
//     out[b, t', f', c] = mean over the (pool_t, pool_f) window at (t', f') of
//                         relu(sum_{dt, df} taps[dt, df, c] * mel[b, t+dt-1, f+df-1])
//
// with zero SAME padding in time and frequency, ReLU at full resolution and
// VALID pooling: T' = T // pool_t, F' = n_mels // pool_f. The output is
// channels-last (B, T', F', ch), the layout the residual convs consume.
//
// What bounds it on this card: memory. Per pooled output it does
// pool_t * pool_f * 9 = 108 multiply-adds and reads almost nothing new, so
// the work is ~10 GFLOP per 512 x 8 s batch, while the (B, 641, 40) input
// and the (B, 213, 10, 45) output are the bytes that must move. The
// full-resolution pre-pool activation (B, 641, 40, 45) would be ~14x the
// output's bytes.
//
// What the design does about it: one block takes one clip and a tile of
// kPooledPerBlock pooled frames. It stages the tile's pool_t * tile + 2 mel
// rows, with a zero column on each side, and the 3 x 3 x ch taps in shared
// memory; each thread then produces whole pooled outputs from registers, so
// the pre-pool activation never leaves the SM. Outputs are numbered with the
// channel fastest, so a warp's stores are contiguous.
//
// Precision: inputs are float32 or bf16 and the output has the input's
// dtype. Taps arrive as float32 (already rounded to bf16 by the host for bf16
// serving). All sums are float32, rounded once at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPooledPerBlock = 8;

__global__ void __launch_bounds__(kThreads)
stem_kernel(const void* __restrict__ mel, const float* __restrict__ taps, void* __restrict__ out,
            int T, int n_mels, int ch, int pool_t, int pool_f, int in_bf16) {
  extern __shared__ float smem[];
  const int t_out = T / pool_t;
  const int f_out = n_mels / pool_f;
  const int rows = kPooledPerBlock * pool_t + 2;
  const int cols = n_mels + 2;
  float* s_mel = smem;                // rows x cols, zero outside the clip
  float* s_taps = smem + rows * cols;  // 9 x ch

  const int b = blockIdx.y;
  const int tp0 = blockIdx.x * kPooledPerBlock;
  const int r0 = tp0 * pool_t - 1;  // mel row held in s_mel row 0
  const size_t clip = static_cast<size_t>(b) * T * n_mels;
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    const int f = i - r * cols - 1;
    const int t = r0 + r;
    float v = 0.f;
    if (t >= 0 && t < T && f >= 0 && f < n_mels) {
      const size_t idx = clip + static_cast<size_t>(t) * n_mels + f;
      v = in_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(mel)[idx])
                  : static_cast<const float*>(mel)[idx];
    }
    s_mel[i] = v;
  }
  for (int i = threadIdx.x; i < 9 * ch; i += kThreads) s_taps[i] = taps[i];
  __syncthreads();

  const int n_pooled = min(kPooledPerBlock, t_out - tp0);
  const int n_out = n_pooled * f_out * ch;
  const float inv_pool = 1.0f / static_cast<float>(pool_t * pool_f);
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const int c = o % ch;
    const int rest = o / ch;
    const int fo = rest % f_out;
    const int tp = rest / f_out;
    float w[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) w[i] = s_taps[i * ch + c];
    float acc = 0.f;
    for (int dr = 0; dr < pool_t; ++dr) {
      const float* centre_row = s_mel + (tp * pool_t + dr + 1) * cols;
      for (int j = 0; j < pool_f; ++j) {
        const float* x = centre_row + fo * pool_f + j + 1;
        float v = 0.f;
#pragma unroll
        for (int dt = -1; dt <= 1; ++dt)
#pragma unroll
          for (int df = -1; df <= 1; ++df)
            v = fmaf(w[(dt + 1) * 3 + (df + 1)], x[dt * cols + df], v);
        acc += fmaxf(v, 0.f);
      }
    }
    const float y = acc * inv_pool;
    const size_t idx = (static_cast<size_t>(b) * t_out + tp0) * f_out * ch + o;
    if (in_bf16)
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[idx] = y;
  }
}

}  // namespace

// mel (B, T, n_mels) float32 or bf16; taps (3, 3, ch) float32; out
// (B, T // pool_t, n_mels // pool_f, ch) in the dtype of mel. All contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int howl_res8_stem_forward(const void* mel, const void* taps, void* out, int B, int T,
                                      int n_mels, int ch, int pool_t, int pool_f, int in_bf16,
                                      void* stream) {
  const int t_out = T / pool_t;
  if (B == 0 || t_out == 0) return 0;
  const int rows = kPooledPerBlock * pool_t + 2;
  const size_t smem = (static_cast<size_t>(rows) * (n_mels + 2) + 9 * ch) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((t_out + kPooledPerBlock - 1) / kPooledPerBlock, B);
  stem_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mel, static_cast<const float*>(taps), out, T, n_mels, ch, pool_t, pool_f, in_bf16);
  return static_cast<int>(cudaGetLastError());
}
