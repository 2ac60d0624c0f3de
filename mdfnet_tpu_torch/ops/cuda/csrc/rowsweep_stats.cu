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
// statistics, which the aggregation pass must know before it runs.
//
// What bounds it on the H100: the chain of K1 without its output. Per
// (pixel, plane, source) G sigmoids (an exp and a reciprocal each on the
// special-function units, MUFU, 16 per SM and clock) and the projection's
// two divisions; per pixel G more for q: the least time, ~0.062 ms at DTU
// train stage 0. Each exact sigmoid also costs ~20 other instructions (the
// exp's range reduction, the bilinear blend, the reciprocal's Newton step,
// the similarity and the field's FMAs), so instruction issue comes first:
// ~320 instructions a lane per (pixel, plane, source) at G = 32, which at 4
// a clock on each of 132 SMs at 1.98 GHz take 64-75% of the measured time;
// the MUFU work takes under 30%. The taps are L1/L2 hits and nothing but
// the partials is written.
//
// Design: K1's lane groups (common.cuh): L = G / 8 lanes share a pixel,
// each lane owns 8 channels (one 16-byte bf16 load a tap), lane l projects
// the pixel into source s0 + l and shuffles hand its taps to the group, and
// group_field sums the field in channel order, so every voxel's f32 field
// is bit for bit the one that K1's train instantiation normalises with
// these statistics. A block of 128 threads owns 128 / L consecutive pixels
// of one batch item and walks all D planes for them (the statistics keep no
// output order), so q is computed once a pixel. Lane l of a group keeps
// source s0 + l's sums over the planes in f64 registers (each f32 value is
// widened before it is squared and summed, so sum s^2 / n - mu^2 does not
// cancel the way it does in f32 when |mu| >> sigma). Then one fixed
// __shfl_down_sync tree a warp for each group of L sources, one fixed sum
// over the block's warps in shared memory, and one partial per (source,
// block) at a fixed place; a second kernel, one block per source, adds a
// source's partials in a fixed order. No float atomics, and the grid
// follows from the shape alone (ops/cuda/aggregate_kernel.py stats_plan,
// checked here), so the sums' bits do not depend on the SM count, and two
// launches on the same inputs give bit-identical sums.

#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kMinBlocks = 5;   // per SM: 20 warps, at most 96 registers a thread
constexpr int kFinal = 256;     // threads of the final kernel
constexpr int kMaxSources = 48 * 1024 / (kWarps * 2 * sizeof(double));
using mdf::from_lane;
using mdf::kCh;

// The launch plan, which ops/cuda/aggregate_kernel.py stats_plan mirrors:
// L lanes per pixel, P pixels per block; block i covers pixel tile i %
// tiles of item i / tiles, all D planes.
template <int G> struct Plan {
  static constexpr int L = G / kCh;
  static constexpr int P = kBlock / L;
};

template <typename T, int G>
__global__ void __launch_bounds__(kBlock, kMinBlocks) rowsweep_stats_kernel(
    const T* __restrict__ src,         // (B, S, H, W, G) source pair diffs
    const T* __restrict__ ref,         // (B, H, W, G) reference pair diffs
    const float* __restrict__ rel,     // (B, S, 4, 4) src_proj @ inv(ref_proj)
    const float* __restrict__ hypos,   // (B, D, H, W) or (B, D)
    const float* __restrict__ k0g,     // (G,)
    double* __restrict__ partial,      // (S, blocks, 2)
    int S, int D, int H, int W, int hypo_per_pixel, float sx, float sy) {
  extern __shared__ double red[];      // (kWarps, S, 2): each warp's sums
  constexpr int L = Plan<G>::L, P = Plan<G>::P;
  const int HW = H * W;
  const int tiles = (HW + P - 1) / P;
  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles;

  const int lane = threadIdx.x % L, c0 = kCh * lane;   // channels c0 .. c0 + kCh - 1
  const int pixel = tile * P + threadIdx.x / L;
  const bool live = pixel < HW;   // the others compute a copy and add nothing
  const int pix = live ? pixel : HW - 1;
  const float xf = (float)(pix % W), yf = (float)(pix / W);

  float q[kCh], k0[kCh];
  mdf::ldg8(ref + ((long long)b * HW + pix) * G + c0, q);
#pragma unroll
  for (int i = 0; i < kCh; ++i) {
    q[i] = mdf::sigmoid(q[i]);
    k0[i] = __ldg(k0g + c0 + i);
  }
  const T* srcb = src + (long long)b * S * HW * G + c0;
  const float* relb = rel + (long long)b * S * 16;
  const float* hypb = hypo_per_pixel ? hypos + (long long)b * D * HW + pix
                                     : hypos + (long long)b * D;
  const long long hyp_step = hypo_per_pixel ? HW : 1;
  const int warp = threadIdx.x / 32, wlane = threadIdx.x % 32;

  for (int s0 = 0; s0 < S; s0 += L) {
    const int ns = min(L, S - s0);
    float R[12];   // source s0 + lane's projection, in registers for all planes
#pragma unroll
    for (int i = 0; i < 12; ++i) R[i] = __ldg(relb + min(s0 + lane, S - 1) * 16 + i);
    double sum = 0.0, sum2 = 0.0;   // lane l: source s0 + l's, over the planes
    for (int d = 0; d < D; ++d) {
      const float hyp = __ldg(hypb + d * hyp_step);
      // the group's L lanes project the pixel into L sources at once, lane
      // l into source s0 + l; each tap set then goes to the whole group
      const mdf::Taps mine = mdf::sweep_taps(R, xf, yf, hyp, H, W, sx, sy);
      float own = 0.0f;
      for (int k = 0; k < ns; ++k) {
        const mdf::Taps t{from_lane<L>(mine.x0, k), from_lane<L>(mine.y0, k),
                          from_lane<L>(mine.wx, k), from_lane<L>(mine.wy, k)};
        float sim[kCh];
        mdf::lane_similarity<T, G>(srcb + (long long)(s0 + k) * HW * G, t, H, W, q, sim);
        const float field = mdf::group_field<L>(sim, k0);
        if (lane == k) own = field;
      }
      if (live && lane < ns) {
        const double v = own;
        sum += v;
        sum2 += v * v;
      }
    }
    // the lanes of a warp that share a lane index l hold source s0 + l's
    // sums: a fixed tree leaves them on lanes 0 .. L - 1
#pragma unroll
    for (int off = 16; off >= L; off >>= 1) {
      sum += __shfl_down_sync(0xffffffffu, sum, off);
      sum2 += __shfl_down_sync(0xffffffffu, sum2, off);
    }
    if (wlane < ns) {
      red[(warp * S + s0 + wlane) * 2] = sum;
      red[(warp * S + s0 + wlane) * 2 + 1] = sum2;
    }
  }
  __syncthreads();
  // the block's partial of (source i / 2, sum or sum of squares), warps in order
  for (int i = threadIdx.x; i < 2 * S; i += kBlock) {
    double v = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w * 2 * S + i];
    partial[((long long)(i / 2) * gridDim.x + blockIdx.x) * 2 + i % 2] = v;
  }
}

__device__ __forceinline__ void block_sum2(double* red, double a, double b, double* out) {
  const int t = threadIdx.x;
  red[t] = a;
  red[kFinal + t] = b;
  __syncthreads();
#pragma unroll
  for (int off = kFinal / 2; off > 0; off >>= 1) {
    if (t < off) {
      red[t] += red[t + off];
      red[kFinal + t] += red[kFinal + t + off];
    }
    __syncthreads();
  }
  if (t == 0) {
    out[0] = red[0];
    out[1] = red[kFinal];
  }
  __syncthreads();
}

// One block per source: out[s] = the sum of its nblocks partials, in order.
__global__ void __launch_bounds__(kFinal) rowsweep_stats_final_kernel(
    const double* __restrict__ partial, int nblocks, double* __restrict__ out) {
  __shared__ double red[2 * kFinal];
  const int s = blockIdx.x;
  const double* ps = partial + (long long)s * nblocks * 2;
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < nblocks; i += kFinal) {
    a += ps[2 * i];
    b += ps[2 * i + 1];
  }
  block_sum2(red, a, b, out + 2 * s);
}

struct Args {
  const void *src, *ref, *rel, *hypos, *k0;
  void *partial, *out;
  int B, S, D, H, W, hypo_per_pixel, blocks;
  float sx, sy;
};

template <typename T, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int P = Plan<G>::P;
  // the wrapper's plan must be this kernel's
  const long long hw = (long long)a.H * a.W;
  const long long blocks = (long long)a.B * ((hw + P - 1) / P);
  if (blocks != a.blocks || blocks > 0x7fffffffLL || hw * G > 0x7fffffffLL || a.S < 1 ||
      a.S > kMaxSources)
    return cudaErrorInvalidValue;
  rowsweep_stats_kernel<T, G><<<(unsigned)blocks, kBlock, kWarps * a.S * 2 * sizeof(double),
                                 stream>>>(
      static_cast<const T*>(a.src), static_cast<const T*>(a.ref),
      static_cast<const float*>(a.rel), static_cast<const float*>(a.hypos),
      static_cast<const float*>(a.k0), static_cast<double*>(a.partial), a.S, a.D, a.H, a.W,
      a.hypo_per_pixel, a.sx, a.sy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rowsweep_stats_final_kernel<<<a.S, kFinal, 0, stream>>>(
      static_cast<const double*>(a.partial), a.blocks, static_cast<double*>(a.out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_groups(const Args& a, int G, cudaStream_t st) {
  switch (G) {
    case 8: return launch<T, 8>(a, st);
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success). blocks is the
// wrapper's launch plan (stats_plan), checked against the kernel's; partial:
// (S, blocks, 2) f64 scratch; out: (S, 2) f64 [sum s, sum s^2].
extern "C" int mdf_rowsweep_stats(const void* src, const void* ref, const void* rel,
                                  const void* hypos, const void* k0, void* partial, void* out,
                                  int B, int S, int D, int H, int W, int G,
                                  int hypo_per_pixel, int dtypes, float sx, float sy,
                                  int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{src, ref, rel, hypos, k0, partial, out, B, S, D, H, W, hypo_per_pixel, blocks,
               sx, sy};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtypes == MDF_BF16_F32) return dispatch_groups<__nv_bfloat16>(a, G, st);
  if (dtypes == MDF_F32_F32) return dispatch_groups<float>(a, G, st);
  return cudaErrorInvalidValue;
}
