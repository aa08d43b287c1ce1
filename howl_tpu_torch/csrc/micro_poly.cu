// Polyphase legs (x1, x3) of the frontend cost study for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_pallas_micro.py, run_poly (Pallas
// kernel poly_kernel). The input is the hop-row view of the audio, H (B,
// rows, 200) float32: frame t of a clip is the 512 samples that start at
// hop row t, so the frames tensor is never written. With W_j the rows
// [200 j, 200 j + 200) of W (512, 512) bf16, zero below row 512, it computes
//
//     hb     = bf16(H + s)                          float32 add, round to nearest even
//     acc[t] = sum over j < 3 of hb[t + j] @ W_j    float32 sums, t < t_pad
//     out    = acc[:, :128]                         (B, t_pad, 128) float32
//
// n_dots times, every pass from zero, as the Pallas body does; the passes
// are identical and the study times what each one adds.
//
// What bounds it on this card: per call it reads about B * (t_pad + 2) * 800
// bytes, 0.39 of the frames tensor, writes B * t_pad * 512 bytes and runs
// n_dots * B * t_pad * 512 * 512 * 2 operations on the tensor cores: the
// tensor cores, from the first pass on.
//
// What the design does about it: a block owns 64 frames of one clip. It
// stages the 66 hop rows they span, which are one contiguous 52,800-byte
// piece of H (no second shifted view as on the TPU), through the stream
// kernel's cp.async code and rounds them to bf16 into a flat shared-memory
// array with no padding. Frame t is then the 512 bf16 that start at element
// 200 t of that array: the tile of a plain (64, 512) @ (512, 512) product
// whose rows are 400 bytes apart, which is 16-byte aligned for ldmatrix and
// free of bank conflicts. So the three W_j products become one K = 512
// product over W itself (product_512, micro_common.cuh), the 88 zero rows of
// W_2 are skipped (K = 512, not the Pallas kernel's 600), and K = 200 a hop
// row needs no padding to whole mma steps. Hop rows at or past `rows` are
// zero-filled. Accumulators that are not the last pass's first 128 columns
// are stored under `keep`, which is 0 at run time.

#include "micro_common.cuh"

namespace {

constexpr int kHop = 200;
constexpr int kSpanRows = kBM + (kNfft + kHop - 1) / kHop - 1;  // 66 hop rows a tile reads
constexpr int kSpanFloats = kSpanRows * kHop;
constexpr size_t kSmemBytes = static_cast<size_t>(kSpanFloats) * sizeof(__nv_bfloat16) + kScratchBytes;
static_assert((kBM - 1) * kHop + kNfft <= kSpanFloats, "the last frame of a tile lies inside the staged span");
static_assert(kSpanFloats * sizeof(__nv_bfloat16) % 16 == 0 && kHop % 8 == 0, "16-byte aligned tile rows");

__global__ void __launch_bounds__(kThreads, 2)
micro_poly_kernel(const float* __restrict__ h, const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int rows,
                  int t_pad, float s, int n_dots, int keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* scratch = smem_raw + static_cast<size_t>(kSpanFloats) * sizeof(__nv_bfloat16);
  const int t0 = blockIdx.x * kBM;
  const int b = blockIdx.y;
  stage_convert(h + (static_cast<size_t>(b) * rows + t0) * kHop, kSpanFloats,
                static_cast<long long>(rows - t0) * kHop, reinterpret_cast<float*>(scratch), s,
                [&](int e) { return a_s + e; });
  product_512<kHop, false>(a_s, reinterpret_cast<__nv_bfloat16*>(scratch), w,
                           out + (static_cast<size_t>(b) * t_pad + t0) * kOutCols, t_pad - t0, n_dots, keep);
}

}  // namespace

// h (B, rows, 200) float32 and w (512, 512) bf16, both 16-byte aligned; out
// (B, t_pad, 128) float32, t_pad + 2 <= rows. All contiguous. keep must be
// 0. Returns cudaGetLastError() after the launch.
extern "C" int howl_micro_poly_forward(const void* h, const void* w, void* out, int B, int rows, int t_pad, float s,
                                       int n_dots, int keep, void* stream) {
  if (B == 0 || t_pad == 0) return 0;
  if (B < 0 || B > 65535 || t_pad < 0 || rows < t_pad || n_dots < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(micro_poly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_pad + kBM - 1) / kBM, B);
  micro_poly_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), rows, t_pad, s,
      n_dots, keep);
  return static_cast<int>(cudaGetLastError());
}
