// Plane-sweep bilinear sampling with zero padding (K6).
//
// Replaces: mdfnet_tpu/ops/pallas/warp_kernel.py:143 pallas_sample_2d_multi
// (kernel body _warp_kernel, line 38), with its single-source wrapper
// pallas_sample_2d (:124), as homography_warp_pallas (:267) and
// homography_warp_pallas_multi (:304) call them: the forward of the
// training warp.
//
// out[s, n, c] = bilinear sample of img[s] (H, W, C, channels-last) at the
// f32 pixel coordinates (x[s, n], y[s, n]), zero padding, f32 arithmetic,
// stored in the image's dtype. The taps and weights are rounded as the plain
// gather (mdfnet_tpu_torch/ops/sample.py) rounds them, and the products and
// sums are non-contracted (__fmul_rn / __fadd_rn), so in f32 the kernel
// reproduces the plain version's rounding. One difference: a NaN coordinate
// samples zeros here.
//
// What bounds it on the H100: DRAM and L2 traffic. Each sample reads its
// coordinates (8 B) and four taps of C values, and writes C values; the
// taps of neighbouring samples overlap, so most tap reads hit L1/L2. At the
// DTU train stage 0 (16 source images of 64x80x32 bf16, 48 planes) the
// output is 252 MB.
//
// Design: one thread per (sample, chunk of 8 channels), the chunk index
// fastest, so a warp reads each tap as whole 16-byte vectors of consecutive
// channels. There is no source window: unlike the TPU kernel, whose DMA
// window and 128-aligned starts impose a coverage contract, every thread
// may read any source pixel, so the kernel is exact for any camera. One
// launch serves one source (S = batch) or many (S = batch x sources).

#include "common.cuh"

namespace {

constexpr int kBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kBlock) sample_2d_kernel(
    const T* __restrict__ img,      // (S, H, W, C)
    const float* __restrict__ xs,   // (S, N)
    const float* __restrict__ ys,   // (S, N)
    T* __restrict__ out,            // (S, N, C)
    int S, int N, int H, int W, int C) {
  const int chunks = C / 8;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= (long long)S * N * chunks) return;
  const int ck = (int)(i % chunks);
  const long long sn = i / chunks;  // s * N + n
  const int s = (int)(sn / N);

  const mdf::Taps t = mdf::bilinear_taps(xs[sn], ys[sn], H, W);
  const bool vx0 = t.x0 >= 0, vx1 = t.x0 + 1 < W;
  const bool vy0 = t.y0 >= 0, vy1 = t.y0 + 1 < H;
  const T* row0 = img + (((long long)s * H + t.y0) * W + t.x0) * C + ck * 8;
  const T* row1 = row0 + (long long)W * C;
  float v00[8] = {0}, v01[8] = {0}, v10[8] = {0}, v11[8] = {0};
  if (vy0 && vx0) mdf::load8(row0, v00);
  if (vy0 && vx1) mdf::load8(row0 + C, v01);
  if (vy1 && vx0) mdf::load8(row1, v10);
  if (vy1 && vx1) mdf::load8(row1 + C, v11);

  const float ux = __fsub_rn(1.0f, t.wx), uy = __fsub_rn(1.0f, t.wy);
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float top = __fadd_rn(__fmul_rn(v00[j], ux), __fmul_rn(v01[j], t.wx));
    const float bot = __fadd_rn(__fmul_rn(v10[j], ux), __fmul_rn(v11[j], t.wx));
    o[j] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, t.wy));
  }
  mdf::store8(out + sn * C + ck * 8, o);
}

template <typename T>
cudaError_t launch(const void* img, const void* x, const void* y, void* out, int S, int N,
                   int H, int W, int C, cudaStream_t stream) {
  const long long total = (long long)S * N * (C / 8);
  const unsigned grid = (unsigned)((total + kBlock - 1) / kBlock);
  sample_2d_kernel<T><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<T*>(out), S, N, H, W, C);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). C % 8 == 0.
extern "C" int mdf_sample_2d(const void* img, const void* x, const void* y, void* out,
                             int S, int N, int H, int W, int C, int dtypes, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_F32_F32: return launch<float>(img, x, y, out, S, N, H, W, C, st);
    case MDF_BF16_BF16: return launch<__nv_bfloat16>(img, x, y, out, S, N, H, W, C, st);
    default: return cudaErrorInvalidValue;
  }
}
