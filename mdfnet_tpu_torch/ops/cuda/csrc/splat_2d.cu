// Adjoint of the plane-sweep bilinear sample: the gradient splat (K7).
//
// Replaces: mdfnet_tpu/ops/pallas/splat_kernel.py:129 pallas_splat_2d
// (kernel body _splat_kernel, line 52), the backward of the training warp
// (mdfnet_tpu/ops/warp_dense.py:173 _planes_sample_bwd).
//
// d_img[b, yi, xi, c] = sum over the samples n of image b and their taps
// (xi, yi) of  g[b, n, c] * wy_tap * wx_tap,  with the taps and weights of
// K6 (common.cuh bilinear_taps), in f32.
//
// Exact for any camera and deterministic. The TPU kernel gathers each
// output tile from a row band and an x window of the samples, a contract
// that a strongly rotated camera breaks (and its caller drops the coverage
// flag). Float atomics would scatter in any order and make two launches on
// the same inputs differ. Here instead:
//   1. splat_keys_kernel writes, for each (sample, tap), the flat target
//      pixel (b * H + yi) * W + xi, or B * H * W for a tap outside the image;
//   2. the wrapper sorts the keys stably (torch.sort(stable=True)) and finds
//      each pixel's run of entries (torch.searchsorted): a fixed order;
//   3. splat_reduce_kernel sums each pixel's run in that order.
// No atomics anywhere: two launches give bit-identical output.
//
// What bounds it on the H100: the sort (4 keys per sample) and the reduce
// pass's reads of g, 16-byte vectors at the sorted samples (L2-resident
// runs for the plane sweep: neighbouring pixels receive neighbouring
// samples).

#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) splat_keys_kernel(
    const float* __restrict__ xs,   // (B, N)
    const float* __restrict__ ys,   // (B, N)
    int* __restrict__ keys,         // (B, N, 4)
    int B, int N, int H, int W) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= (long long)B * N) return;
  const int b = (int)(i / N);
  const mdf::Taps t = mdf::bilinear_taps(xs[i], ys[i], H, W);
  const int outside = B * H * W;
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) {
    const int xi = t.x0 + (tap & 1), yi = t.y0 + (tap >> 1);
    const bool in = xi >= 0 && xi < W && yi >= 0 && yi < H;
    keys[i * 4 + tap] = in ? ((b * H + yi) * W + xi) : outside;
  }
}

// One thread per (target pixel, chunk of 8 channels): sum the pixel's run
// of sorted (sample, tap) entries in order.
template <typename T>
__global__ void __launch_bounds__(kBlock) splat_reduce_kernel(
    const T* __restrict__ g,               // (B, N, C) sample cotangents
    const float* __restrict__ xs,          // (B, N)
    const float* __restrict__ ys,          // (B, N)
    const long long* __restrict__ order,   // (B*N*4) entries, sorted by target
    const long long* __restrict__ start,   // (B*H*W + 1) run starts
    float* __restrict__ out,               // (B, H, W, C)
    int B, int H, int W, int C) {
  const int chunks = C / 8;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= (long long)B * H * W * chunks) return;
  const int ck = (int)(i % chunks);
  const long long pix = i / chunks;
  float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (long long e = start[pix], end = start[pix + 1]; e < end; ++e) {
    const long long entry = order[e];
    const long long n = entry >> 2;   // flat sample b * N + n
    const int tap = (int)(entry & 3);
    const mdf::Taps t = mdf::bilinear_taps(xs[n], ys[n], H, W);
    const float wx = (tap & 1) ? t.wx : __fsub_rn(1.0f, t.wx);
    const float wy = (tap >> 1) ? t.wy : __fsub_rn(1.0f, t.wy);
    float v[8];
    mdf::load8(g + n * C + ck * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(__fmul_rn(v[j], wy), wx));
  }
  mdf::store8(out + pix * C + ck * 8, acc);
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 on success).
extern "C" int mdf_splat_keys(const void* x, const void* y, void* keys, int B, int N, int H,
                              int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * N;
  const unsigned grid = (unsigned)((total + kBlock - 1) / kBlock);
  splat_keys_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<int*>(keys), B, N,
      H, W);
  return cudaGetLastError();
}

extern "C" int mdf_splat_reduce(const void* g, const void* x, const void* y, const void* order,
                                const void* start, void* out, int B, int H, int W, int C,
                                int dtypes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C % 8 != 0) return cudaErrorInvalidValue;
  const long long total = (long long)B * H * W * (C / 8);
  const unsigned grid = (unsigned)((total + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const long long* ord = static_cast<const long long*>(order);
  const long long* sta = static_cast<const long long*>(start);
  float* o = static_cast<float*>(out);
  switch (dtypes) {
    case MDF_F32_F32:
      splat_reduce_kernel<float><<<grid, kBlock, 0, st>>>(static_cast<const float*>(g), xf, yf,
                                                          ord, sta, o, B, H, W, C);
      break;
    case MDF_BF16_F32:
      splat_reduce_kernel<__nv_bfloat16><<<grid, kBlock, 0, st>>>(
          static_cast<const __nv_bfloat16*>(g), xf, yf, ord, sta, o, B, H, W, C);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
