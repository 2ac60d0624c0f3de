// Batch statistics of DepthWeight's pre-BN field for the train-mode fused
// aggregate (pass 1 of K9).
//
// Replaces: mdfnet_tpu/ops/pallas/aggregate_kernel.py:604 rowsweep_stats
// (kernel body _rowsweep_stats_kernel, line 185), as
// mdfnet_tpu/ops/pallas/aggregate_vjp.py:46-57 calls it: once per batch item,
// the per-item sums then added up. Here one launch covers the whole batch.
//
// For each source view s: (sum s, sum s^2) of s = k0 . sim over every
// (b, d, h, w) of the batch's plane sweep, with sim the similarity of the
// aggregate kernel (K1). Train-mode BatchNorm normalises s with these batch
// statistics, which the aggregation pass must know before it runs. The chain
// per (pixel, plane, source) is mdf::sweep_similarity (common.cuh), the very
// function K1 runs, so the statistics describe exactly the field K1 then
// normalises.
//
// What bounds it on the H100: the same chain as K1 without its output: each
// thread reads its G reference values, four bilinear taps of G values per
// source (L1/L2 hits, as in K1) and writes nothing but its block's partials,
// so the kernel is bound by the chain's arithmetic and load latency, not by
// DRAM.
//
// Design: one thread per (b, d, h, w). The sums are f64 (each f32 field value
// is widened before it is squared and summed), so sum s^2 / n - mu^2 does not
// cancel the way it does in f32 when |mu| >> sigma. No float atomics: each
// block reduces its threads' values in a fixed tree in shared memory and
// writes one partial per (source, block) at a fixed place; a second kernel,
// one block per source, adds a source's partials in a fixed order. Two
// launches on the same inputs give bit-identical sums.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ void block_sum2(double* red, double a, double b, double* out) {
  const int t = threadIdx.x;
  red[t] = a;
  red[kBlock + t] = b;
  __syncthreads();
#pragma unroll
  for (int off = kBlock / 2; off > 0; off >>= 1) {
    if (t < off) {
      red[t] += red[t + off];
      red[kBlock + t] += red[kBlock + t + off];
    }
    __syncthreads();
  }
  if (t == 0) {
    out[0] = red[0];
    out[1] = red[kBlock];
  }
  __syncthreads();
}

template <typename T, int G>
__global__ void __launch_bounds__(kBlock) rowsweep_stats_kernel(
    const T* __restrict__ src,         // (B, S, H, W, G) source pair diffs
    const T* __restrict__ ref,         // (B, H, W, G) reference pair diffs
    const float* __restrict__ rel,     // (B, S, 4, 4) src_proj @ inv(ref_proj)
    const float* __restrict__ hypos,   // (B, D, H, W) or (B, D)
    const float* __restrict__ k0,      // (G,)
    double* __restrict__ partial,      // (S, nblocks, 2)
    int B, int S, int D, int H, int W, int hypo_per_pixel, float sx, float sy) {
  __shared__ double red[2 * kBlock];
  const long long total = (long long)B * D * H * W;
  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool valid = p < total;
  int w = 0, h = 0, d = 0, b = 0;
  float hyp = 0.0f;
  float q[G], sim[G];
  if (valid) {
    w = (int)(p % W);
    long long r = p / W;
    h = (int)(r % H);
    r /= H;
    d = (int)(r % D);
    b = (int)(r / D);
    hyp = hypo_per_pixel ? hypos[p] : hypos[(long long)b * D + d];
    mdf::load_q<T, G>(ref + (((long long)b * H + h) * W + w) * G, q);
  }
  const float xf = (float)w, yf = (float)h;
  for (int s = 0; s < S; ++s) {
    double v = 0.0;
    if (valid)
      v = (double)mdf::sweep_similarity<T, G>(
          src + ((long long)b * S + s) * H * W * G, rel + ((long long)b * S + s) * 16, xf,
          yf, hyp, H, W, sx, sy, q, k0, sim);
    block_sum2(red, v, v * v, partial + ((long long)s * gridDim.x + blockIdx.x) * 2);
  }
}

// One block per source: out[s] = the sum of its nblocks partials, in order.
__global__ void __launch_bounds__(kBlock) rowsweep_stats_final_kernel(
    const double* __restrict__ partial, int nblocks, double* __restrict__ out) {
  __shared__ double red[2 * kBlock];
  const int s = blockIdx.x;
  const double* ps = partial + (long long)s * nblocks * 2;
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < nblocks; i += kBlock) {
    a += ps[2 * i];
    b += ps[2 * i + 1];
  }
  block_sum2(red, a, b, out + 2 * s);
}

template <typename T, int G>
cudaError_t launch(const void* src, const void* ref, const void* rel, const void* hypos,
                   const void* k0, void* partial, void* out, int B, int S, int D, int H,
                   int W, int hypo_per_pixel, float sx, float sy, int nblocks,
                   cudaStream_t stream) {
  rowsweep_stats_kernel<T, G><<<nblocks, kBlock, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref), static_cast<const float*>(rel),
      static_cast<const float*>(hypos), static_cast<const float*>(k0),
      static_cast<double*>(partial), B, S, D, H, W, hypo_per_pixel, sx, sy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rowsweep_stats_final_kernel<<<S, kBlock, 0, stream>>>(static_cast<const double*>(partial),
                                                        nblocks, static_cast<double*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_groups(int G, const void* src, const void* ref, const void* rel,
                            const void* hypos, const void* k0, void* partial, void* out,
                            int B, int S, int D, int H, int W, int hypo_per_pixel, float sx,
                            float sy, int nblocks, cudaStream_t st) {
  switch (G) {
    case 8: return launch<T, 8>(src, ref, rel, hypos, k0, partial, out, B, S, D, H, W, hypo_per_pixel, sx, sy, nblocks, st);
    case 16: return launch<T, 16>(src, ref, rel, hypos, k0, partial, out, B, S, D, H, W, hypo_per_pixel, sx, sy, nblocks, st);
    case 32: return launch<T, 32>(src, ref, rel, hypos, k0, partial, out, B, S, D, H, W, hypo_per_pixel, sx, sy, nblocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success). partial:
// (S, nblocks, 2) f64 scratch with nblocks = ceil(B*D*H*W / 256); out: (S, 2)
// f64 [sum s, sum s^2].
extern "C" int mdf_rowsweep_stats(const void* src, const void* ref, const void* rel,
                                  const void* hypos, const void* k0, void* partial, void* out,
                                  int B, int S, int D, int H, int W, int G,
                                  int hypo_per_pixel, int dtypes, float sx, float sy,
                                  int nblocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * D * H * W;
  if (nblocks != (int)((total + kBlock - 1) / kBlock)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtypes == MDF_BF16_F32)
    return dispatch_groups<__nv_bfloat16>(G, src, ref, rel, hypos, k0, partial, out, B, S, D,
                                          H, W, hypo_per_pixel, sx, sy, nblocks, st);
  if (dtypes == MDF_F32_F32)
    return dispatch_groups<float>(G, src, ref, rel, hypos, k0, partial, out, B, S, D, H, W,
                                  hypo_per_pixel, sx, sy, nblocks, st);
  return cudaErrorInvalidValue;
}
