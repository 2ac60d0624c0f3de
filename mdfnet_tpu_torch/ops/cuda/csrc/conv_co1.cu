// Convolution to one output channel with a fused scale / offset epilogue:
// the ProbConvs (3x3x3, C -> 1) of the U-Nets and refine's C -> 1 tail
// (3x3, 2D). ops/cuda/conv_kernel.py conv_route sends here every conv with
// Co = 1, K = 3, stride 1 and Ci a multiple of 8 (KD in {1, 3}; bf16 or f32
// input; f32 or the input's type out).
//
// Replaces, for Co = 1 (the JAX package's eval ProbConv is three Co = 1
// conv2d_fused launches, mdfnet_tpu/models/regularize.py:79-93):
//   K2 mdfnet_tpu/ops/pallas/conv3d_kernel.py:577 conv3d_bn_relu
//   K4 mdfnet_tpu/ops/pallas/conv2d_kernel.py:242 conv2d_fused
//
// What it computes: NDHWC input (2D is D = 1), zero padding 1 (along D too
// when KD = 3), f32 accumulation over Ci x KD x 3 x 3 taps per voxel, then
// y = relu?(acc * scale + offset) (+ residual).
//
// What bounds it on the H100: it is a reduction, not a GEMM: 2 x 27 Ci
// operations per output against 2 Ci (bf16) bytes read, so at Ci = 8 the
// stage-2 ProbConv (1, 8, 592, 800, 8) -> 1 moves 76 MB (0.023 ms at
// 3.35 TB/s) for 1.6 GFLOP (0.024 ms at 67 TFLOP/s of f32 FMA). The direct
// kernel (conv_bn_act.cu) ran it at 0.597 ms: one voxel per thread with 8
// output-channel accumulators, 7 of them idle, and every tap read from
// global memory.
//
// Design: a block of 256 threads owns an output tile of TD x TH x 32 voxels
// (KD = 3: 4 x 8 x 32; KD = 1: 1 x 32 x 32) and copies its input with a
// one-voxel halo into shared memory once per stage of channels (16-byte
// cp.async per 8 bf16 or 4 f32 channels of a voxel; an out-of-range voxel is
// zero-filled, which is the padding). A thread accumulates 4 consecutive w
// outputs in f32 registers; for each (kd, kh) it holds the weights of the
// three kw taps (f32, from a shared-memory copy, read as broadcasts) and
// slides along 6 input columns, each read once for up to 3 outputs. Each
// output's sum runs over (kd, kh, kw, channel) in that order with one FMA
// per term, which is the direct kernel's order: with all Ci channels in one
// stage (Ci <= 16, every conv of the model) the two give the same bits, in
// f32 and in bf16. A row of the tile is stored in shared memory by w mod 4,
// then w / 4, so the 8 threads of a row that read one 16-byte word each
// read 8 consecutive words (no bank conflicts); the 32 threads of a warp
// cover 4 rows. The epilogue stores a thread's 4 outputs as one vector
// where the row allows, as f32 or bf16. Ci > 16 goes through in stages of
// 8 or 16 channels (ops/cuda/conv_kernel.py co1_plan).

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 32;      // tile width: 8 threads of 4 outputs along w
constexpr int kCols = 4;     // outputs per thread, along w
constexpr int kRow = 36;     // 16-byte words per staged row: 34 w, padded to 4 x 9
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

// The output tile (ops/cuda/conv_kernel.py co1_plan mirrors it)
template <int KD> struct Tile {
  static constexpr int TD = KD == 3 ? 4 : 1;
  static constexpr int TH = kThreads / (kTW / kCols) / TD;
  static constexpr int VD = TD + KD - 1, VH = TH + 2;
  static constexpr int V = VD * VH * kRow;   // staged words per 16-byte unit
};

// the staged word of input column vw (0 .. 33) within its row
__host__ __device__ constexpr int col_word(int vw) { return vw % 4 * (kRow / 4) + vw / 4; }

struct Co1Args {
  const void* x;       // (N, D, H, W, Ci)
  const float* w;      // (KD * 9, Ci) f32, tap (kd * 3 + kh) * 3 + kw
  const float* scale;  // (1)
  const float* offset; // (1)
  const void* res;     // (N, D, H, W) or null, output type
  void* y;             // (N, D, H, W)
  int N, D, H, W, Ci, relu;
};

// 16 bytes of shared memory as f32: 8 bf16 or 4 f32 channels
__device__ __forceinline__ void unpack(const uint4& u, float* o, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float* o, const float*) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__host__ __device__ constexpr size_t weight_bytes(int kd, int ci) {
  return ((size_t)kd * 9 * ci * sizeof(float) + 15) / 16 * 16;
}

// CS: input channels per stage (8 or 16, dividing Ci)
template <typename T, typename TO, int KD, int CS>
__global__ void __launch_bounds__(kThreads) conv_co1_kernel(const Co1Args a) {
  using TL = Tile<KD>;
  constexpr int E = 16 / sizeof(T);   // channels per 16-byte unit
  constexpr int NU = CS / E;          // units per stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  uint4* xs = reinterpret_cast<uint4*>(smem + weight_bytes(KD, a.Ci));  // [unit][vd][vh][word]

  // block -> output tile, w tiles fastest
  const int tws = (a.W + kTW - 1) / kTW, ths = (a.H + TL::TH - 1) / TL::TH;
  const int tds = (a.D + TL::TD - 1) / TL::TD;
  int blk = blockIdx.x;
  const int w0 = blk % tws * kTW;
  blk /= tws;
  const int h0 = blk % ths * TL::TH;
  blk /= ths;
  const int d0 = blk % tds * TL::TD;
  const int n = blk / tds;

  for (int i = threadIdx.x; i < KD * 9 * a.Ci; i += kThreads) ws[i] = a.w[i];

  // thread -> outputs (ld, lh, 4 lc .. 4 lc + 3) of the tile
  const int lc = threadIdx.x % (kTW / kCols);
  const int lh = threadIdx.x / (kTW / kCols) % TL::TH;
  const int ld = threadIdx.x / (kTW / kCols * TL::TH);

  const T* x = static_cast<const T*>(a.x);
  float acc[kCols] = {};
  for (int c0 = 0; c0 < a.Ci; c0 += CS) {
    if (c0) __syncthreads();   // every read of the last stage is done
    constexpr int VW = kTW + 2;
    for (int i = threadIdx.x; i < TL::VD * TL::VH * VW * NU; i += kThreads) {
      const int vw = i % VW;
      int r = i / VW;
      const int vh = r % TL::VH;
      r /= TL::VH;
      const int vd = r % TL::VD, u = r / TL::VD;
      const int gd = d0 + vd - KD / 2, gh = h0 + vh - 1, gw = w0 + vw - 1;
      const bool in = gd >= 0 && gd < a.D && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
      const T* src =
          in ? x + ((((long long)n * a.D + gd) * a.H + gh) * a.W + gw) * a.Ci + c0 + u * E : x;
      mdf::cp_async16(mdf::smem_u32(xs + u * TL::V + (vd * TL::VH + vh) * kRow + col_word(vw)),
                      src, in ? 16 : 0);
    }
    mdf::cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float wk[3][CS];   // the three kw taps' weights of this stage
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4* wp =
              reinterpret_cast<const float4*>(ws + ((kd * 3 + kh) * 3 + kw) * a.Ci + c0);
#pragma unroll
          for (int i = 0; i < CS / 4; ++i) {
            const float4 f = wp[i];
            wk[kw][4 * i] = f.x;
            wk[kw][4 * i + 1] = f.y;
            wk[kw][4 * i + 2] = f.z;
            wk[kw][4 * i + 3] = f.w;
          }
        }
        const uint4* row = xs + ((ld + kd) * TL::VH + lh + kh) * kRow;
#pragma unroll
        for (int c = 0; c < kCols + 2; ++c) {   // input column 4 lc + c
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            float xv[E];
            unpack(row[u * TL::V + col_word(c) + lc], xv, x);
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              const int kw = c - j;
              if (kw >= 0 && kw < 3) {
#pragma unroll
                for (int e = 0; e < E; ++e) acc[j] = fmaf(xv[e], wk[kw][u * E + e], acc[j]);
              }
            }
          }
        }
      }
    }
  }

  const int od = d0 + ld, oh = h0 + lh, ow = w0 + kCols * lc;
  if (od >= a.D || oh >= a.H || ow >= a.W) return;
  const float scale = a.scale[0], offset = a.offset[0];
  const long long p = (((long long)n * a.D + od) * a.H + oh) * a.W + ow;
  TO* y = static_cast<TO*>(a.y) + p;
  const TO* res = a.res ? static_cast<const TO*>(a.res) + p : nullptr;
  float v[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    // the direct kernel's epilogue, term for term
    float t = acc[j] * scale + offset;
    t = a.relu ? fmaxf(t, 0.0f) : t;
    if (res && ow + j < a.W) t += mdf::to_f32(res[j]);
    v[j] = t;
  }
  if (a.W % kCols == 0) {   // ow + 3 < W, and the row's start is aligned
    store4(y, v);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (ow + j < a.W) y[j] = mdf::from_f32<TO>(v[j]);
  }
}

// Once per kernel instantiation and device: allow the most shared memory a
// block may take (a launch still takes only the bytes it asks for).
template <typename T, typename TO, int KD, int CS>
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> opted_in[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && opted_in[device].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_co1_kernel<T, TO, KD, CS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && known) opted_in[device].store(true);
  return err;
}

template <typename T, typename TO, int KD, int CS>
cudaError_t launch(const Co1Args& a, int td, int th, int tw, int device, cudaStream_t stream) {
  using TL = Tile<KD>;
  const size_t smem = weight_bytes(KD, a.Ci) + (size_t)TL::V * 16 * (CS * sizeof(T) / 16);
  // the wrapper's plan must be this kernel's
  if (td != TL::TD || th != TL::TH || tw != kTW || a.Ci % CS || smem > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)a.N * ((a.D + TL::TD - 1) / TL::TD) *
                           ((a.H + TL::TH - 1) / TL::TH) * ((a.W + kTW - 1) / kTW);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = allow_max_smem<T, TO, KD, CS>(device);
  if (err != cudaSuccess) return err;
  conv_co1_kernel<T, TO, KD, CS><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t dispatch(const Co1Args& a, int kd, int cs, int td, int th, int tw, int device,
                     cudaStream_t st) {
  if (kd == 3 && cs == 8) return launch<T, TO, 3, 8>(a, td, th, tw, device, st);
  if (kd == 3 && cs == 16) return launch<T, TO, 3, 16>(a, td, th, tw, device, st);
  if (kd == 1 && cs == 8) return launch<T, TO, 1, 8>(a, td, th, tw, device, st);
  if (kd == 1 && cs == 16) return launch<T, TO, 1, 16>(a, td, th, tw, device, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); td, th, tw
// and cs (channels per stage) are the wrapper's plan, checked against the
// kernel's tile.
extern "C" int mdf_conv_co1(const void* x, const void* w, const void* scale,
                            const void* offset, const void* res, void* y, int N, int D, int H,
                            int W, int Ci, int kd, int relu, int td, int th, int tw, int cs,
                            int dtypes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Co1Args a{x, static_cast<const float*>(w), static_cast<const float*>(scale),
                  static_cast<const float*>(offset), res, y, N, D, H, W, Ci, relu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_F32_F32: return dispatch<float, float>(a, kd, cs, td, th, tw, device, st);
    case MDF_BF16_BF16:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(a, kd, cs, td, th, tw, device, st);
    case MDF_BF16_F32:
      return dispatch<__nv_bfloat16, float>(a, kd, cs, td, th, tw, device, st);
    default: return cudaErrorInvalidValue;
  }
}
