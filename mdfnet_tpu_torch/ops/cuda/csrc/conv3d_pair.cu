// Two chained stride-1 3x3x3 convolutions with a folded-BN epilogue each, in
// one launch (K10).
//
// Replaces: mdfnet_tpu/ops/pallas/conv3d_kernel.py:472 conv3d_pair_bn_relu
// (kernel body _conv3d_pair_kernel, line 302). As in the JAX package, no
// model path runs it; it is the fused form of two conv3d_bn_act (K2) calls.
//
//   mid = relu?(conv(x, w1) * s1 + o1), rounded to x's type
//   y   = relu?(conv(mid, w2) * s2 + o2)
// with pad 1 on both convs, channels-last (N, D, H, W, C), f32 accumulation.
//
// What bounds it on the H100: two U-Net layers of 16 to 64 channels are
// narrow GEMMs; unfused, the intermediate volume is written and read back
// once (at DTU stage 0, 48x148x200x16 bf16: 45 MB each way). Here it never
// goes to device memory. This first kernel runs on the CUDA cores in f32 FMA
// (67 TFLOP/s peak), so it is bound by FMA issue, and it pays for the fusion
// with recompute: each block computes its tile's intermediate with a 1-voxel
// halo, (2+2) x (8+2) x (16+2) = 720 voxels for 256 outputs, 2.8x the first
// conv's work.
//
// Design: one block per 2 x 8 x 16 output tile, one thread per output voxel.
// Phase 1: the block's threads compute the intermediate tile, one (voxel,
// chunk of 8 channels) per step, chunk-major so a warp reads the same weights
// (a broadcast), round it to x's type and keep it in shared memory (<= 180 KB
// at Cm = 64 in f32). An intermediate voxel outside the volume is stored as
// zero: the second conv's zero padding, not relu(o1) (the fault the JAX
// kernel guards against at conv3d_kernel.py:437-442). Phase 2: each thread
// runs the second conv from shared memory for its voxel, 8 output channels
// at a time. Weights are read from device memory through L1, 16 bytes a
// load (uniform within a warp). wgmma / TMA tiles are later work.

#include "common.cuh"

namespace {

constexpr int kTD = 2, kTH = 8, kTW = 16;           // output tile
constexpr int kBlock = kTD * kTH * kTW;             // one thread per output voxel
constexpr int kMD = kTD + 2, kMH = kTH + 2, kMW = kTW + 2;
constexpr int kMid = kMD * kMH * kMW;               // intermediate tile + halo
constexpr int kCob = 8;                             // channels per accumulator set

struct PairArgs {
  const void* x;      // (N, D, H, W, Ci)
  const float* w1;    // (27, Ci, Cm) f32
  const float* s1;    // (Cm)
  const float* o1;    // (Cm)
  const float* w2;    // (27, Cm, CoP) f32
  const float* s2;    // (CoP)
  const float* o2;    // (CoP)
  void* y;            // (N, D, H, W, Co)
  int N, D, H, W, Ci, Cm, Co, CoP, relu, tiles_d, tiles_h, tiles_w;
};

// The 8 weights of one input channel (wr: 32-byte aligned) as two 16-byte
// read-only loads.
__device__ __forceinline__ void weights8(const float* __restrict__ wr, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(wr));
  const float4 b = __ldg(reinterpret_cast<const float4*>(wr) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// acc[c] += sum_ci xp[ci] * wp[ci * stride + c], c < 8; stride % 8 == 0
template <typename T>
__device__ __forceinline__ void tap_fma(const T* xp, const float* __restrict__ wp, int C,
                                        int stride, float* acc) {
  float w[kCob];
  if ((C & 7) == 0) {
    for (int ci = 0; ci < C; ci += 8) {
      float xv[8];
      mdf::load8(xp + ci, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        weights8(wp + (long long)(ci + j) * stride, w);
#pragma unroll
        for (int c = 0; c < kCob; ++c) acc[c] = fmaf(xv[j], w[c], acc[c]);
      }
    }
  } else {
    for (int ci = 0; ci < C; ++ci) {
      const float xv = mdf::to_f32(xp[ci]);
      weights8(wp + (long long)ci * stride, w);
#pragma unroll
      for (int c = 0; c < kCob; ++c) acc[c] = fmaf(xv, w[c], acc[c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) conv3d_pair_kernel(const PairArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* mid = reinterpret_cast<T*>(smem);              // (kMid, Cm)
  int t = blockIdx.x;
  const int tw = t % a.tiles_w;
  t /= a.tiles_w;
  const int th = t % a.tiles_h;
  t /= a.tiles_h;
  const int td = t % a.tiles_d;
  const int n = t / a.tiles_d;
  const int d0 = td * kTD, h0 = th * kTH, w0 = tw * kTW;
  const T* x = static_cast<const T*>(a.x);

  // phase 1: the intermediate tile at (d0-1.., h0-1.., w0-1..)
  const int chunks = a.Cm / kCob;
  for (int item = threadIdx.x; item < chunks * kMid; item += kBlock) {
    const int c8 = item / kMid, m = item - c8 * kMid;
    const int mw = m % kMW, mh = (m / kMW) % kMH, md = m / (kMW * kMH);
    const int gd = d0 - 1 + md, gh = h0 - 1 + mh, gw = w0 - 1 + mw;
    float v[kCob];
#pragma unroll
    for (int c = 0; c < kCob; ++c) v[c] = 0.0f;
    if (gd >= 0 && gd < a.D && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W) {
      float acc[kCob];
#pragma unroll
      for (int c = 0; c < kCob; ++c) acc[c] = 0.0f;
      for (int kd = 0; kd < 3; ++kd) {
        const int id = gd - 1 + kd;
        if (id < 0 || id >= a.D) continue;
        for (int kh = 0; kh < 3; ++kh) {
          const int ih = gh - 1 + kh;
          if (ih < 0 || ih >= a.H) continue;
          for (int kw = 0; kw < 3; ++kw) {
            const int iw = gw - 1 + kw;
            if (iw < 0 || iw >= a.W) continue;
            const T* xp = x + ((((long long)n * a.D + id) * a.H + ih) * a.W + iw) * a.Ci;
            const float* wp =
                a.w1 + (long long)((kd * 3 + kh) * 3 + kw) * a.Ci * a.Cm + c8 * kCob;
            tap_fma(xp, wp, a.Ci, a.Cm, acc);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCob; ++c) {
        const float u = acc[c] * a.s1[c8 * kCob + c] + a.o1[c8 * kCob + c];
        v[c] = a.relu ? fmaxf(u, 0.0f) : u;
      }
    }
    // outside the volume: zero, the second conv's padding
    mdf::store8(mid + (long long)m * a.Cm + c8 * kCob, v);
  }
  __syncthreads();

  // phase 2: one output voxel per thread
  const int lw = threadIdx.x % kTW, lh = (threadIdx.x / kTW) % kTH, ld = threadIdx.x / (kTW * kTH);
  const int od = d0 + ld, oh = h0 + lh, ow = w0 + lw;
  if (od >= a.D || oh >= a.H || ow >= a.W) return;
  const long long p = (((long long)n * a.D + od) * a.H + oh) * a.W + ow;
  T* yp = static_cast<T*>(a.y) + p * a.Co;
  for (int cb0 = 0; cb0 < a.CoP; cb0 += kCob) {
    float acc[kCob];
#pragma unroll
    for (int c = 0; c < kCob; ++c) acc[c] = 0.0f;
    for (int kd = 0; kd < 3; ++kd)
      for (int kh = 0; kh < 3; ++kh)
        for (int kw = 0; kw < 3; ++kw) {
          const T* mp = mid + (long long)(((ld + kd) * kMH + lh + kh) * kMW + lw + kw) * a.Cm;
          const float* wp = a.w2 + (long long)((kd * 3 + kh) * 3 + kw) * a.Cm * a.CoP + cb0;
          tap_fma(mp, wp, a.Cm, a.CoP, acc);
        }
    float v[kCob];
#pragma unroll
    for (int c = 0; c < kCob; ++c) {
      const float u = acc[c] * a.s2[cb0 + c] + a.o2[cb0 + c];
      v[c] = a.relu ? fmaxf(u, 0.0f) : u;
    }
    if ((a.Co & 7) == 0) {
      mdf::store8(yp + cb0, v);
    } else {
#pragma unroll
      for (int c = 0; c < kCob; ++c)
        if (cb0 + c < a.Co) yp[cb0 + c] = mdf::from_f32<T>(v[c]);
    }
  }
}

template <typename T>
cudaError_t launch(const PairArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)kMid * a.Cm * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(conv3d_pair_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)a.N * a.tiles_d * a.tiles_h * a.tiles_w;
  conv3d_pair_kernel<T><<<(unsigned)blocks, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). x and y share
// one type (dtypes MDF_F32_F32 or MDF_BF16_BF16); Cm % 8 == 0; w1 (27, Ci,
// Cm), w2 (27, Cm, CoP) f32 with CoP = Co rounded up to 8, s2/o2 padded to
// CoP.
extern "C" int mdf_conv3d_pair(const void* x, const void* w1, const void* s1, const void* o1,
                               const void* w2, const void* s2, const void* o2, void* y, int N,
                               int D, int H, int W, int Ci, int Cm, int Co, int CoP, int relu,
                               int dtypes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Cm % kCob != 0 || CoP % kCob != 0 || CoP < Co) return cudaErrorInvalidValue;
  const PairArgs a{x, static_cast<const float*>(w1), static_cast<const float*>(s1),
                   static_cast<const float*>(o1), static_cast<const float*>(w2),
                   static_cast<const float*>(s2), static_cast<const float*>(o2), y, N, D, H,
                   W, Ci, Cm, Co, CoP, relu, (D + kTD - 1) / kTD, (H + kTH - 1) / kTH,
                   (W + kTW - 1) / kTW};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_F32_F32: return launch<float>(a, st);
    case MDF_BF16_BF16: return launch<__nv_bfloat16>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
