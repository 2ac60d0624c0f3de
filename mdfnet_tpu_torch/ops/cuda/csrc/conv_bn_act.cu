// Direct convolutions with a fused folded-BN / bias epilogue (K2, K3, K4 and
// the launches of K5) on the CUDA cores. Since the tensor-core kernels
// (conv_tc.cu) took the bf16 convs and transposed convs with Ci and Co
// multiples of 8, and conv_co1.cu the 3x3(x3) stride-1 convs to Co = 1
// (ProbConv, refine's tail), this one serves the rest (ops/cuda/
// conv_kernel.py conv_route): the f32 convs with Co > 1, Ci in {1, 3} (the
// trunk's and refine's heads, ProbConv's input gradient), and the f32
// transposed convs; route="direct" still forces it, as a yardstick.
//
// Replaces:
//   K2 mdfnet_tpu/ops/pallas/conv3d_kernel.py:577 conv3d_bn_relu
//      (kernels _conv_kernel :33, _conv_kernel_unstacked :106)
//   K3 mdfnet_tpu/ops/pallas/conv3d_kernel.py:741 trconv3d_bn_relu
//   K4 mdfnet_tpu/ops/pallas/conv2d_kernel.py:242 conv2d_fused
//      (kernels _conv2d_kernel_unstacked :60, _conv2d_kernel_s2i :137)
//   K5 mdfnet_tpu/ops/pallas/conv2d_kernel.py:654 conv2d_chain_fused runs as
//      consecutive launches of conv_bn_act_kernel (ops/cuda/conv_kernel.py).
//
// conv_bn_act_kernel: NDHWC input (2D is D = 1), kernel size K (KD = 1 or
// 3 along D), stride 1 or 2, torch padding (K-1)/2, f32 accumulation, then
//   y = relu?(acc * scale[co] + offset[co]) (+ residual)
// stored as bf16 or f32. trconv_bn_act_kernel: ConvTranspose3d(k3, s2, p1,
// output_padding 1) with the same epilogue, equal to torch's.
//
// What bounds it on the H100: these convolutions have 1 to 64 channels, so
// they are narrow GEMMs (M = output voxels, N = Co <= 64, K = taps * Ci <=
// 1728). At bf16 the tensor cores would make them bound by DRAM traffic; this
// first kernel runs on the CUDA cores in f32 FMA (67 TFLOP/s peak), so it is
// bound by FMA issue and by the shared-memory weight reads that feed it: the
// stage-0 U-Net's first conv (32 -> 16 channels, 48x148x200) runs 39 GFLOP in
// ~2.0 ms on an H100 (700 W), ~20 TFLOP/s.
//
// Design: one thread per output voxel and per chunk of COB = 8 output
// channels (grid.y walks the chunks); the block stages its chunk of the
// weights (taps x Ci x 8, f32, <= 55 KB at Ci = 64) in shared memory, where
// every thread of a warp reads the same address (a broadcast). Input channels
// are read 8 at a time with 16-byte loads when Ci % 8 == 0. A conv to Co = 1
// forced here runs correctly with 7 of the 8 accumulators idle (conv_co1.cu
// is its kernel). The transposed conv gathers only
// the taps where (o + pad - k) is even: blockIdx.z is the output parity
// phase, so all threads of a block run the same 1..8 taps without divergence.

#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kCob = 8;  // output channels per thread

struct ConvArgs {
  const void* x;       // (N, Di, Hi, Wi, Ci)
  const float* w;      // (taps, Ci, CoP) f32
  const float* scale;  // (CoP)
  const float* offset; // (CoP)
  const void* res;     // (N, Do, Ho, Wo, Co) or null, output type
  void* y;             // (N, Do, Ho, Wo, Co)
  int N, Di, Hi, Wi, Ci, Do, Ho, Wo, Co, CoP, relu;
};

template <typename TO>
__device__ __forceinline__ void epilogue(const float* acc, long long p, int cb0,
                                         const ConvArgs& a) {
  float v[kCob];
#pragma unroll
  for (int c = 0; c < kCob; ++c) {
    float t = acc[c] * a.scale[cb0 + c] + a.offset[cb0 + c];
    v[c] = a.relu ? fmaxf(t, 0.0f) : t;
  }
  TO* yp = static_cast<TO*>(a.y) + p * a.Co + cb0;
  const TO* rp = a.res ? static_cast<const TO*>(a.res) + p * a.Co + cb0 : nullptr;
  if ((a.Co & 7) == 0) {
    if (rp) {
      float r[kCob];
      mdf::load8(rp, r);
#pragma unroll
      for (int c = 0; c < kCob; ++c) v[c] += r[c];
    }
    mdf::store8(yp, v);
  } else {
#pragma unroll
    for (int c = 0; c < kCob; ++c) {
      if (cb0 + c < a.Co) {
        float t = v[c];
        if (rp) t += mdf::to_f32(rp[c]);
        yp[c] = mdf::from_f32<TO>(t);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void accumulate_tap(const T* xp, const float* wp, int Ci,
                                               float* acc) {
  if ((Ci & 7) == 0) {
    for (int ci = 0; ci < Ci; ci += 8) {
      float xv[8];
      mdf::load8(xp + ci, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* wr = wp + (ci + j) * kCob;
#pragma unroll
        for (int c = 0; c < kCob; ++c) acc[c] = fmaf(xv[j], wr[c], acc[c]);
      }
    }
  } else {
    for (int ci = 0; ci < Ci; ++ci) {
      const float xv = mdf::to_f32(xp[ci]);
      const float* wr = wp + ci * kCob;
#pragma unroll
      for (int c = 0; c < kCob; ++c) acc[c] = fmaf(xv, wr[c], acc[c]);
    }
  }
}

__device__ __forceinline__ void stage_weights(float* ws, const ConvArgs& a, int taps,
                                              int cb0) {
  const int n = taps * a.Ci * kCob;
  for (int i = threadIdx.x; i < n; i += kBlock) {
    const int tc = i / kCob;
    ws[i] = a.w[(long long)tc * a.CoP + cb0 + (i - tc * kCob)];
  }
  __syncthreads();
}

template <typename T, typename TO, int KD, int K, int S>
__global__ void __launch_bounds__(kBlock) conv_bn_act_kernel(const ConvArgs a) {
  extern __shared__ float ws[];
  constexpr int kTaps = KD * K * K;
  constexpr int PD = KD / 2, P = K / 2;
  const int cb0 = blockIdx.y * kCob;
  stage_weights(ws, a, kTaps, cb0);

  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (p >= (long long)a.N * a.Do * a.Ho * a.Wo) return;
  const int ow = (int)(p % a.Wo);
  long long r = p / a.Wo;
  const int oh = (int)(r % a.Ho);
  r /= a.Ho;
  const int od = (int)(r % a.Do);
  const int n = (int)(r / a.Do);

  const T* x = static_cast<const T*>(a.x);
  float acc[kCob];
#pragma unroll
  for (int c = 0; c < kCob; ++c) acc[c] = 0.0f;
  for (int kd = 0; kd < KD; ++kd) {
    const int id = od * S - PD + kd;
    if (id < 0 || id >= a.Di) continue;
    for (int kh = 0; kh < K; ++kh) {
      const int ih = oh * S - P + kh;
      if (ih < 0 || ih >= a.Hi) continue;
      for (int kw = 0; kw < K; ++kw) {
        const int iw = ow * S - P + kw;
        if (iw < 0 || iw >= a.Wi) continue;
        const T* xp = x + ((((long long)n * a.Di + id) * a.Hi + ih) * a.Wi + iw) * a.Ci;
        accumulate_tap(xp, ws + ((kd * K + kh) * K + kw) * a.Ci * kCob, a.Ci, acc);
      }
    }
  }
  epilogue<TO>(acc, p, cb0, a);
}

// ConvTranspose3d(k=3, stride=2, pad=1, output_padding=1): output o receives
// input i = (o + 1 - k) / 2 where that is an integer. Parity 0 (o = 2i):
// k = 1 from i; parity 1 (o = 2i + 1): k = 0 from i + 1 and k = 2 from i.
template <typename T, typename TO>
__global__ void __launch_bounds__(kBlock) trconv_bn_act_kernel(const ConvArgs a) {
  extern __shared__ float ws[];
  const int cb0 = blockIdx.y * kCob;
  stage_weights(ws, a, 27, cb0);

  const int pd = blockIdx.z >> 2, ph = (blockIdx.z >> 1) & 1, pw = blockIdx.z & 1;
  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (p >= (long long)a.N * a.Di * a.Hi * a.Wi) return;
  const int w = (int)(p % a.Wi);
  long long r = p / a.Wi;
  const int h = (int)(r % a.Hi);
  r /= a.Hi;
  const int d = (int)(r % a.Di);
  const int n = (int)(r / a.Di);

  const T* x = static_cast<const T*>(a.x);
  float acc[kCob];
#pragma unroll
  for (int c = 0; c < kCob; ++c) acc[c] = 0.0f;
  for (int td = 0; td <= pd; ++td) {
    const int kd = pd ? 2 * td : 1, id = d + pd - td;
    if (id >= a.Di) continue;
    for (int th = 0; th <= ph; ++th) {
      const int kh = ph ? 2 * th : 1, ih = h + ph - th;
      if (ih >= a.Hi) continue;
      for (int tw = 0; tw <= pw; ++tw) {
        const int kw = pw ? 2 * tw : 1, iw = w + pw - tw;
        if (iw >= a.Wi) continue;
        const T* xp = x + ((((long long)n * a.Di + id) * a.Hi + ih) * a.Wi + iw) * a.Ci;
        accumulate_tap(xp, ws + ((kd * 3 + kh) * 3 + kw) * a.Ci * kCob, a.Ci, acc);
      }
    }
  }
  const long long op =
      (((long long)n * a.Do + 2 * d + pd) * a.Ho + 2 * h + ph) * a.Wo + 2 * w + pw;
  epilogue<TO>(acc, op, cb0, a);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const ConvArgs& a, int taps, long long points, int phases,
                   cudaStream_t stream) {
  const size_t smem = (size_t)taps * a.Ci * kCob * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((points + kBlock - 1) / kBlock), a.CoP / kCob, phases);
  kernel<<<grid, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t dispatch_conv(const ConvArgs& a, int kd, int k, int s, cudaStream_t st) {
  const long long pts = (long long)a.N * a.Do * a.Ho * a.Wo;
  const int taps = kd * k * k;
  if (kd == 3 && k == 3 && s == 1) return launch(conv_bn_act_kernel<T, TO, 3, 3, 1>, a, taps, pts, 1, st);
  if (kd == 3 && k == 3 && s == 2) return launch(conv_bn_act_kernel<T, TO, 3, 3, 2>, a, taps, pts, 1, st);
  if (kd == 1 && k == 1 && s == 1) return launch(conv_bn_act_kernel<T, TO, 1, 1, 1>, a, taps, pts, 1, st);
  if (kd == 1 && k == 1 && s == 2) return launch(conv_bn_act_kernel<T, TO, 1, 1, 2>, a, taps, pts, 1, st);
  if (kd == 1 && k == 3 && s == 1) return launch(conv_bn_act_kernel<T, TO, 1, 3, 1>, a, taps, pts, 1, st);
  if (kd == 1 && k == 3 && s == 2) return launch(conv_bn_act_kernel<T, TO, 1, 3, 2>, a, taps, pts, 1, st);
  if (kd == 1 && k == 5 && s == 1) return launch(conv_bn_act_kernel<T, TO, 1, 5, 1>, a, taps, pts, 1, st);
  if (kd == 1 && k == 5 && s == 2) return launch(conv_bn_act_kernel<T, TO, 1, 5, 2>, a, taps, pts, 1, st);
  return cudaErrorInvalidValue;
}

ConvArgs make_args(const void* x, const void* w, const void* scale, const void* offset,
                   const void* res, void* y, int N, int Di, int Hi, int Wi, int Ci, int Do,
                   int Ho, int Wo, int Co, int CoP, int relu) {
  return ConvArgs{x, static_cast<const float*>(w), static_cast<const float*>(scale),
                  static_cast<const float*>(offset), res, y, N, Di, Hi, Wi, Ci, Do, Ho, Wo,
                  Co, CoP, relu};
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 on success).
extern "C" int mdf_conv_bn_act(const void* x, const void* w, const void* scale,
                               const void* offset, const void* res, void* y, int N, int Di,
                               int Hi, int Wi, int Ci, int Do, int Ho, int Wo, int Co, int CoP,
                               int kd, int k, int stride, int relu, int dtypes, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ConvArgs a = make_args(x, w, scale, offset, res, y, N, Di, Hi, Wi, Ci, Do, Ho, Wo, Co,
                               CoP, relu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_F32_F32: return dispatch_conv<float, float>(a, kd, k, stride, st);
    case MDF_BF16_BF16: return dispatch_conv<__nv_bfloat16, __nv_bfloat16>(a, kd, k, stride, st);
    case MDF_BF16_F32: return dispatch_conv<__nv_bfloat16, float>(a, kd, k, stride, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int mdf_trconv_bn_act(const void* x, const void* w, const void* scale,
                                 const void* offset, const void* res, void* y, int N, int Di,
                                 int Hi, int Wi, int Ci, int Co, int CoP, int relu, int dtypes,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ConvArgs a = make_args(x, w, scale, offset, res, y, N, Di, Hi, Wi, Ci, 2 * Di, 2 * Hi,
                               2 * Wi, Co, CoP, relu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pts = (long long)N * Di * Hi * Wi;
  switch (dtypes) {
    case MDF_F32_F32: return launch(trconv_bn_act_kernel<float, float>, a, 27, pts, 8, st);
    case MDF_BF16_BF16:
      return launch(trconv_bn_act_kernel<__nv_bfloat16, __nv_bfloat16>, a, 27, pts, 8, st);
    case MDF_BF16_F32:
      return launch(trconv_bn_act_kernel<__nv_bfloat16, float>, a, 27, pts, 8, st);
    default: return cudaErrorInvalidValue;
  }
}
