// Fused plane-sweep warp + group-wise vector cost aggregation (K1).
//
// Replaces: mdfnet_tpu/ops/pallas/aggregate_kernel.py:427 rowsweep_aggregate
// (kernel body _rowsweep_kernel, line 52), eval path, C/G == 2.
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

#include "common.cuh"

namespace {

constexpr int kBlock = 128;

template <typename T, int G>
__global__ void __launch_bounds__(kBlock) rowsweep_aggregate_kernel(
    const T* __restrict__ src,         // (B, S, H, W, G) source pair diffs
    const T* __restrict__ ref,         // (B, H, W, G) reference pair diffs
    const float* __restrict__ rel,     // (B, S, 4, 4) src_proj @ inv(ref_proj)
    const float* __restrict__ hypos,   // (B, D, H, W) or (B, D)
    const float* __restrict__ params,  // [bn_s, bn_o, k1, b1, k0[G]]
    float* __restrict__ out,           // (B, D, H, W, G)
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
  const float bn_s = params[0], bn_o = params[1], k1 = params[2], b1 = params[3];
  const float* k0 = params + 4;

  float q[G], acc[G], sim[G];
  const T* rp = ref + (((long long)b * H + h) * W + w) * G;
#pragma unroll
  for (int g0 = 0; g0 < G; g0 += 8) {
    float v[8];
    mdf::load8(rp + g0, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      q[g0 + j] = mdf::sigmoid(v[j]);
      acc[g0 + j] = 0.0f;
    }
  }
  float wsum = 0.0f;
  const float xf = (float)w, yf = (float)h;

  for (int s = 0; s < S; ++s) {
    const float* R = rel + ((long long)b * S + s) * 16;
    // rot @ [x, y, 1], then * depth + trans, in the reference's order
    const float rx = __fadd_rn(__fadd_rn(__fmul_rn(R[0], xf), __fmul_rn(R[1], yf)), R[2]);
    const float ry = __fadd_rn(__fadd_rn(__fmul_rn(R[4], xf), __fmul_rn(R[5], yf)), R[6]);
    const float rz = __fadd_rn(__fadd_rn(__fmul_rn(R[8], xf), __fmul_rn(R[9], yf)), R[10]);
    const float X = __fadd_rn(__fmul_rn(rx, hyp), R[3]);
    const float Y = __fadd_rn(__fmul_rn(ry, hyp), R[7]);
    const float Z = __fadd_rn(__fmul_rn(rz, hyp), R[11]);
    float x = __fsub_rn(__fmul_rn(__fdiv_rn(X, Z), sx), 0.5f);
    float y = __fsub_rn(__fmul_rn(__fdiv_rn(Y, Z), sy), 0.5f);
    // fully outside (or NaN): snap to -1, where both taps read zero
    if (!(x > -1.0f && x < (float)W)) x = -1.0f;
    if (!(y > -1.0f && y < (float)H)) y = -1.0f;
    const float x0f = floorf(x), y0f = floorf(y);
    const float wx = x - x0f, wy = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const bool vx0 = x0 >= 0, vx1 = x0 + 1 < W;
    const bool vy0 = y0 >= 0, vy1 = y0 + 1 < H;
    const T* sp = src + ((long long)b * S + s) * H * W * G;
    const T* row0 = sp + ((long long)y0 * W + x0) * G;
    const T* row1 = row0 + (long long)W * G;

    float sfield = 0.0f;
#pragma unroll
    for (int g0 = 0; g0 < G; g0 += 8) {
      float v00[8] = {0}, v01[8] = {0}, v10[8] = {0}, v11[8] = {0};
      if (vy0 && vx0) mdf::load8(row0 + g0, v00);
      if (vy0 && vx1) mdf::load8(row0 + G + g0, v01);
      if (vy1 && vx0) mdf::load8(row1 + g0, v10);
      if (vy1 && vx1) mdf::load8(row1 + G + g0, v11);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float top = v00[j] * (1.0f - wx) + v01[j] * wx;
        const float bot = v10[j] * (1.0f - wx) + v11[j] * wx;
        const float pv = mdf::sigmoid(top * (1.0f - wy) + bot * wy);
        const float qq = q[g0 + j];
        const float sm = pv * qq + (1.0f - pv) * (1.0f - qq);
        sim[g0 + j] = sm;
        sfield += sm * k0[g0 + j];
      }
    }
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
}

template <typename T, int G>
cudaError_t launch(const void* src, const void* ref, const void* rel, const void* hypos,
                   const void* params, void* out, int B, int S, int D, int H, int W,
                   int hypo_per_pixel, float sx, float sy, cudaStream_t stream) {
  const long long total = (long long)B * D * H * W;
  const unsigned grid = (unsigned)((total + kBlock - 1) / kBlock);
  rowsweep_aggregate_kernel<T, G><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref), static_cast<const float*>(rel),
      static_cast<const float*>(hypos), static_cast<const float*>(params),
      static_cast<float*>(out), B, S, D, H, W, hypo_per_pixel, sx, sy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_groups(int G, const void* src, const void* ref, const void* rel,
                            const void* hypos, const void* params, void* out, int B, int S,
                            int D, int H, int W, int hypo_per_pixel, float sx, float sy,
                            cudaStream_t stream) {
  switch (G) {
    case 8: return launch<T, 8>(src, ref, rel, hypos, params, out, B, S, D, H, W, hypo_per_pixel, sx, sy, stream);
    case 16: return launch<T, 16>(src, ref, rel, hypos, params, out, B, S, D, H, W, hypo_per_pixel, sx, sy, stream);
    case 32: return launch<T, 32>(src, ref, rel, hypos, params, out, B, S, D, H, W, hypo_per_pixel, sx, sy, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mdf_rowsweep_aggregate(const void* src, const void* ref, const void* rel,
                                      const void* hypos, const void* params, void* out,
                                      int B, int S, int D, int H, int W, int G,
                                      int hypo_per_pixel, int dtypes, float sx, float sy,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtypes == MDF_BF16_F32)
    return dispatch_groups<__nv_bfloat16>(G, src, ref, rel, hypos, params, out, B, S, D, H, W,
                                          hypo_per_pixel, sx, sy, st);
  if (dtypes == MDF_F32_F32)
    return dispatch_groups<float>(G, src, ref, rel, hypos, params, out, B, S, D, H, W,
                                  hypo_per_pixel, sx, sy, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* mdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
