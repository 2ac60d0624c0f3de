// Fused plane-sweep warp + group-wise vector cost aggregation (K1), eval and
// train.
//
// Replaces: mdfnet_tpu/ops/pallas/aggregate_kernel.py:427 rowsweep_aggregate
// (kernel body _rowsweep_kernel, line 52), C/G == 2: the eval path, and with
// with_wsum=True and a per-view BN affine (:66-71, :178-182) the aggregation
// pass of the train-mode fused aggregate (ops/pallas/aggregate_vjp.py:81).
//
// Per reference pixel (b, h, w) and plane d, for each source s: project the
// pixel lifted to the plane's depth into s, bilinearly sample the source's G
// pair-difference features with zero padding, p = sigmoid(sample),
// q = sigmoid(ref pair diffs), sim = p q + (1-p)(1-q), visibility weight
// w = sigmoid(k1 relu(bn_s (k0 . sim) + bn_o) + b1); output
// sum_s w sim / sum_s w as (B, D, H, W, G) f32.
//
// What bounds it on the H100: not DRAM — the sources are a few MB per stage
// and served by L1/L2 (the four bilinear taps are G contiguous values,
// channels-last, one to four 16-byte loads each), and the (B, D, H, W, G)
// f32 output is ~180 MB at DTU stage 0 — nor the special-function units
// (G sigmoids per pixel, plane and source). Each thread keeps 3G floats in
// registers (209 registers at G = 32), which caps occupancy at two 128-thread
// blocks per SM, so the kernel is latency bound: 0.84-1.02 ms at DTU stage 0
// on an H100 (700 W), ~0.2 TB/s of output.
//
// Design: one thread per (b, d, h, w); the projection is computed once per
// (pixel, plane, source); q, the similarities and the accumulators live in
// registers (G templated). There is no source window, so unlike the TPU
// kernel (whose DMA window imposes a coverage contract) it is exact for any
// camera. Coordinates follow mdfnet_tpu/geometry.py reference_grid_coords and
// the gather warp's tap rounding (mdfnet_tpu/ops/sample.py): the coordinate
// chain uses non-contracted multiplies/adds so it rounds like the unfused
// reference. One difference: a NaN coordinate (z == 0) samples zeros here.
// The chain per (pixel, plane, source) is mdf::sweep_similarity (common.cuh),
// which the stats kernel (rowsweep_stats.cu) shares.
//
// The train instantiation (TRAIN = true) reads a per-source-view BN affine
// bn = [bn_s[S], bn_o[S]] instead of the two scalars in params, and also
// writes the weight sum wsum (B, D, H, W) f32, which the backward needs.

#include "common.cuh"

namespace {

constexpr int kBlock = 128;

template <typename T, int G, bool TRAIN>
__global__ void __launch_bounds__(kBlock) rowsweep_aggregate_kernel(
    const T* __restrict__ src,         // (B, S, H, W, G) source pair diffs
    const T* __restrict__ ref,         // (B, H, W, G) reference pair diffs
    const float* __restrict__ rel,     // (B, S, 4, 4) src_proj @ inv(ref_proj)
    const float* __restrict__ hypos,   // (B, D, H, W) or (B, D)
    const float* __restrict__ params,  // [bn_s, bn_o, k1, b1, k0[G]]
    const float* __restrict__ bn,      // TRAIN: [bn_s[S], bn_o[S]]
    float* __restrict__ out,           // (B, D, H, W, G)
    float* __restrict__ wsum_out,      // TRAIN: (B, D, H, W)
    int B, int S, int D, int H, int W, int hypo_per_pixel, float sx, float sy) {
  const long long total = (long long)B * D * H * W;
  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (p >= total) return;
  const int w = (int)(p % W);
  long long r = p / W;
  const int h = (int)(r % H);
  r /= H;
  const int d = (int)(r % D);
  const int b = (int)(r / D);

  const float hyp = hypo_per_pixel ? hypos[p] : hypos[(long long)b * D + d];
  const float k1 = params[2], b1 = params[3];
  const float* k0 = params + 4;

  float q[G], acc[G], sim[G];
  mdf::load_q<T, G>(ref + (((long long)b * H + h) * W + w) * G, q);
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  float wsum = 0.0f;
  const float xf = (float)w, yf = (float)h;

  for (int s = 0; s < S; ++s) {
    const float sfield = mdf::sweep_similarity<T, G>(
        src + ((long long)b * S + s) * H * W * G, rel + ((long long)b * S + s) * 16, xf, yf,
        hyp, H, W, sx, sy, q, k0, sim);
    const float bn_s = TRAIN ? bn[s] : params[0];
    const float bn_o = TRAIN ? bn[S + s] : params[1];
    const float act = fmaxf(sfield * bn_s + bn_o, 0.0f);
    const float wgt = mdf::sigmoid(act * k1 + b1);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] += wgt * sim[g];
    wsum += wgt;
  }

  float* op = out + p * G;
#pragma unroll
  for (int g0 = 0; g0 < G; g0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = acc[g0 + j] / wsum;
    mdf::store8(op + g0, v);
  }
  if (TRAIN) wsum_out[p] = wsum;
}

struct Args {
  const void *src, *ref, *rel, *hypos, *params, *bn;
  void *out, *wsum;
  int B, S, D, H, W, hypo_per_pixel;
  float sx, sy;
};

template <typename T, int G, bool TRAIN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long total = (long long)a.B * a.D * a.H * a.W;
  const unsigned grid = (unsigned)((total + kBlock - 1) / kBlock);
  rowsweep_aggregate_kernel<T, G, TRAIN><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(a.src), static_cast<const T*>(a.ref),
      static_cast<const float*>(a.rel), static_cast<const float*>(a.hypos),
      static_cast<const float*>(a.params), static_cast<const float*>(a.bn),
      static_cast<float*>(a.out), static_cast<float*>(a.wsum), a.B, a.S, a.D, a.H, a.W,
      a.hypo_per_pixel, a.sx, a.sy);
  return cudaGetLastError();
}

template <bool TRAIN>
cudaError_t dispatch(const Args& a, int G, int dtypes, cudaStream_t st) {
  if (dtypes == MDF_BF16_F32) {
    switch (G) {
      case 8: return launch<__nv_bfloat16, 8, TRAIN>(a, st);
      case 16: return launch<__nv_bfloat16, 16, TRAIN>(a, st);
      case 32: return launch<__nv_bfloat16, 32, TRAIN>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtypes == MDF_F32_F32) {
    switch (G) {
      case 8: return launch<float, 8, TRAIN>(a, st);
      case 16: return launch<float, 16, TRAIN>(a, st);
      case 32: return launch<float, 32, TRAIN>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 on success).
extern "C" int mdf_rowsweep_aggregate(const void* src, const void* ref, const void* rel,
                                      const void* hypos, const void* params, void* out,
                                      int B, int S, int D, int H, int W, int G,
                                      int hypo_per_pixel, int dtypes, float sx, float sy,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{src, ref, rel, hypos, params, nullptr, out, nullptr,
               B, S, D, H, W, hypo_per_pixel, sx, sy};
  return dispatch<false>(a, G, dtypes, static_cast<cudaStream_t>(stream));
}

// The train instantiation: bn = [bn_s[S], bn_o[S]] (f32), wsum (B, D, H, W).
extern "C" int mdf_rowsweep_aggregate_train(const void* src, const void* ref, const void* rel,
                                            const void* hypos, const void* params,
                                            const void* bn, void* out, void* wsum, int B,
                                            int S, int D, int H, int W, int G,
                                            int hypo_per_pixel, int dtypes, float sx,
                                            float sy, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{src, ref, rel, hypos, params, bn, out, wsum,
               B, S, D, H, W, hypo_per_pixel, sx, sy};
  return dispatch<true>(a, G, dtypes, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
