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
// What bounds it on the H100: not DRAM. The sources are a few MB per stage
// and stay in L2; the f32 output is ~180 MB at DTU stage 0 (0.06 ms at
// 3.35 TB/s). The f32 operations (~4.2 GFLOP at stage 0, 0.063 ms at
// 67 TFLOP/s) and the special-function units are: each sigmoid is one
// MUFU.EX2 and one MUFU.RCP, each division one more MUFU.RCP, at 16 per SM
// and clock. Per (pixel, plane) this design issues 2G + 2L per source (G
// sigmoids, the weight's sigmoid on each of the L lanes of the pixel's
// group), 2L per L sources (one projection per lane), G final divisions
// and 2G / planes for q: ~344 at G = 32 (L = 4) with 4 sources and runs of
// 8 planes, ~0.12 ms at stage 0 on 132 SMs at 1.98 GHz. Each exact sigmoid
// and division also costs a dozen other instructions (the exp's range
// reduction, the reciprocal's corrections), so instruction issue comes
// before the MUFU bound. The first version (one thread per voxel, 3G
// floats of registers, two blocks per SM) was latency bound at
// 0.84-1.02 ms there.
//
// Design: a lane group of L = G / 8 lanes shares a pixel and each lane owns
// 8 of its channels, so a bilinear tap is one 16-byte (bf16) or two
// (f32) loads per lane, G contiguous values per group, and q, the
// similarities and the accumulators are 8 floats per lane (at G = 8 a lane
// is a whole pixel). A block of 128 threads covers
// 128 / L consecutive pixels of the flattened H x W (neighbours in w, rows
// wrapping), so a warp's output stores are one contiguous run, and walks a
// run of up to 8 planes for them, computing q once per run. Per plane the
// group's lanes project the pixel into L sources at once (lane l into
// source l), and shuffles hand each source's taps to the whole group: the
// projection and its two divisions run once per (pixel, plane, source),
// not on every lane. The field k0 . sim passes from lane to lane in channel
// order (group_field), one FMA per term, so the kernel gives the bits of
// the one-thread version it replaced. The stats kernel (rowsweep_stats.cu)
// runs the same chain on the same lane groups (common.cuh: sweep_taps,
// lane_similarity, group_field), so the batch statistics describe exactly
// the field normalised here. The coordinate chain keeps the non-contracted
// multiplies and adds (sweep_taps), so it rounds like the
// unfused reference (mdfnet_tpu/geometry.py reference_grid_coords, the
// gather warp's tap rounding in mdfnet_tpu/ops/sample.py). There is no
// source window, so unlike the TPU kernel (whose DMA window imposes a
// coverage contract) it is exact for any camera. One difference: a NaN
// coordinate (z == 0) samples zeros here.
//
// The train instantiation (TRAIN = true) reads a per-source-view BN affine
// bn = [bn_s[S], bn_o[S]] instead of the two scalars in params, and also
// writes the weight sum wsum (B, D, H, W) f32, which the backward needs.
//
// The reference grid may be a band of the sources' rows (spatial sharding
// of the eval forward, mdfnet_tpu_torch/parallel/spatial.py): H x W
// reference pixels at source rows row0 .. row0 + H - 1, against sources of
// Hs rows, which bound the taps and normalise the grid convention (sy =
// Hs / (Hs - 1)). The pixel's row enters the projection as row0 + h, an
// exact float, so a band's coordinates are bitwise those of the same
// pixels in the full launch. The train entry passes Hs = H, row0 = 0.

#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMinBlocks = 5;   // per SM: 20 warps, at most 96 registers a thread
using mdf::from_lane;
using mdf::group_field;
using mdf::kCh;

// The launch plan, which ops/cuda/aggregate_kernel.py aggregate_plan
// mirrors: L lanes per pixel, P pixels per block; block i covers pixel tile
// i % tiles, plane run (i / tiles) % runs and item i / (tiles * runs).
template <int G> struct Plan {
  static constexpr int L = G / kCh;
  static constexpr int P = kBlock / L;
};

template <typename T, int G, bool TRAIN>
__global__ void __launch_bounds__(kBlock, kMinBlocks) rowsweep_aggregate_kernel(
    const T* __restrict__ src,         // (B, S, Hs, W, G) source pair diffs
    const T* __restrict__ ref,         // (B, H, W, G) reference pair diffs
    const float* __restrict__ rel,     // (B, S, 4, 4) src_proj @ inv(ref_proj)
    const float* __restrict__ hypos,   // (B, D, H, W) or (B, D)
    const float* __restrict__ params,  // [bn_s, bn_o, k1, b1, k0[G]]
    const float* __restrict__ bn,      // TRAIN: [bn_s[S], bn_o[S]]
    float* __restrict__ out,           // (B, D, H, W, G)
    float* __restrict__ wsum_out,      // TRAIN: (B, D, H, W)
    int S, int D, int H, int W, int Hs, int row0, int hypo_per_pixel, int planes, float sx,
    float sy) {
  constexpr int L = Plan<G>::L, P = Plan<G>::P;
  const int HW = H * W, HsW = Hs * W;
  const int tiles = (HW + P - 1) / P, runs = (D + planes - 1) / planes;
  const int tile = blockIdx.x % tiles;
  const int run = (blockIdx.x / tiles) % runs;
  const int b = blockIdx.x / tiles / runs;

  const int lane = threadIdx.x % L, c0 = kCh * lane;   // channels c0 .. c0 + kCh - 1
  const int pixel = tile * P + threadIdx.x / L;
  const bool live = pixel < HW;   // the others compute a copy and store nothing
  const int pix = live ? pixel : HW - 1;
  const float xf = (float)(pix % W), yf = (float)(row0 + pix / W);

  float q[kCh], k0[kCh];
  mdf::ldg8(ref + ((long long)b * HW + pix) * G + c0, q);
#pragma unroll
  for (int i = 0; i < kCh; ++i) {
    q[i] = mdf::sigmoid(q[i]);
    k0[i] = __ldg(params + 4 + c0 + i);
  }
  const float k1 = params[2], b1 = params[3];
  const T* srcb = src + (long long)b * S * HsW * G + c0;
  const float* relb = rel + (long long)b * S * 16;

  const int d_end = min(D, (run + 1) * planes);
  for (int d = run * planes; d < d_end; ++d) {
    const long long voxel = ((long long)b * D + d) * HW + pix;
    const float hyp = __ldg(hypo_per_pixel ? hypos + voxel : hypos + (long long)b * D + d);
    float acc[kCh] = {};
    float wsum = 0.0f;
    for (int s0 = 0; s0 < S; s0 += L) {
      // the group's L lanes project the pixel into L sources at once, lane
      // l into source s0 + l; each tap set then goes to the whole group
      const mdf::Taps mine =
          mdf::sweep_taps(relb + min(s0 + lane, S - 1) * 16, xf, yf, hyp, Hs, W, sx, sy);
      const int ns = min(L, S - s0);
      for (int k = 0; k < ns; ++k) {
        const int s = s0 + k;
        const mdf::Taps t{from_lane<L>(mine.x0, k), from_lane<L>(mine.y0, k),
                          from_lane<L>(mine.wx, k), from_lane<L>(mine.wy, k)};
        float sim[kCh];
        mdf::lane_similarity<T, G>(srcb + (long long)s * HsW * G, t, Hs, W, q, sim);
        const float sfield = group_field<L>(sim, k0);
        const float bn_s = TRAIN ? bn[s] : params[0];
        const float bn_o = TRAIN ? bn[S + s] : params[1];
        const float act = fmaxf(sfield * bn_s + bn_o, 0.0f);
        const float wgt = mdf::sigmoid(act * k1 + b1);
#pragma unroll
        for (int i = 0; i < kCh; ++i) acc[i] += wgt * sim[i];
        wsum += wgt;
      }
    }
    if (live) {
      float v[kCh];
#pragma unroll
      for (int i = 0; i < kCh; ++i) v[i] = acc[i] / wsum;
      mdf::store8(out + voxel * G + c0, v);
      if (TRAIN && c0 == 0) wsum_out[voxel] = wsum;
    }
  }
}

struct Args {
  const void *src, *ref, *rel, *hypos, *params, *bn;
  void *out, *wsum;
  int B, S, D, H, W, Hs, row0, hypo_per_pixel, planes, blocks;
  float sx, sy;
};

template <typename T, int G, bool TRAIN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int P = Plan<G>::P;
  if (a.planes < 1 || a.Hs < 2 || a.row0 < 0) return cudaErrorInvalidValue;
  // the wrapper's plan must be this kernel's
  const long long hw = (long long)a.H * a.W;
  const long long blocks =
      (long long)a.B * ((a.D + a.planes - 1) / a.planes) * ((hw + P - 1) / P);
  if (blocks != a.blocks || blocks > 0x7fffffffLL || hw * G > 0x7fffffffLL ||
      (long long)a.Hs * a.W * G > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  rowsweep_aggregate_kernel<T, G, TRAIN><<<(unsigned)blocks, kBlock, 0, stream>>>(
      static_cast<const T*>(a.src), static_cast<const T*>(a.ref),
      static_cast<const float*>(a.rel), static_cast<const float*>(a.hypos),
      static_cast<const float*>(a.params), static_cast<const float*>(a.bn),
      static_cast<float*>(a.out), static_cast<float*>(a.wsum), a.S, a.D, a.H, a.W, a.Hs,
      a.row0, a.hypo_per_pixel, a.planes, a.sx, a.sy);
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

// Each entry returns cudaGetLastError() after the launch (0 on success);
// planes and blocks are the wrapper's launch plan, checked against the
// kernel's. The eval entry's reference grid is H rows from the sources'
// row row0 (of Hs; sy = Hs / (Hs - 1)).
extern "C" int mdf_rowsweep_aggregate(const void* src, const void* ref, const void* rel,
                                      const void* hypos, const void* params, void* out,
                                      int B, int S, int D, int H, int W, int G, int Hs,
                                      int row0, int hypo_per_pixel, int planes, int blocks,
                                      int dtypes, float sx, float sy, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{src, ref, rel, hypos, params, nullptr, out, nullptr,
               B, S, D, H, W, Hs, row0, hypo_per_pixel, planes, blocks, sx, sy};
  return dispatch<false>(a, G, dtypes, static_cast<cudaStream_t>(stream));
}

// The train instantiation: bn = [bn_s[S], bn_o[S]] (f32), wsum (B, D, H, W).
extern "C" int mdf_rowsweep_aggregate_train(const void* src, const void* ref, const void* rel,
                                            const void* hypos, const void* params,
                                            const void* bn, void* out, void* wsum, int B,
                                            int S, int D, int H, int W, int G,
                                            int hypo_per_pixel, int planes, int blocks,
                                            int dtypes, float sx, float sy, int device,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{src, ref, rel, hypos, params, bn, out, wsum,
               B, S, D, H, W, H, 0, hypo_per_pixel, planes, blocks, sx, sy};
  return dispatch<true>(a, G, dtypes, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
