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
// An intermediate voxel outside the volume is zero (the second conv's
// padding), not relu(o1): the fault the JAX kernel guards against at
// conv3d_kernel.py:437-442.
//
// What bounds it on the H100: the bytes of x and y (3.35 TB/s) against the
// two convs' products on the tensor cores (989 TFLOP/s): at the stage-0
// U-Net's first pair (48 x 148 x 200, 32 -> 16 -> 16) 136 MB (0.041 ms)
// against 59 GFLOP (0.060 ms). Unfused, the intermediate (45 MB) goes to
// device memory and back. The cost of keeping it on chip is recompute: a
// tile's intermediate needs a halo.
//
// Two bodies, chosen by ops/cuda/conv_kernel.py pair_plan:
//
// The tensor-core body (bf16, Ci % 16 == 0, Cm and Co in {16, 32, 64}):
// conv3d_pair_tc_kernel. A block of four warpgroups owns an output column,
// a TH x TW (h, w) tile of one item, and walks a segment of `L` planes
// along D, so no D halo is recomputed: each intermediate plane is computed
// once. Shared memory holds a ring of RX (3 or 4) input planes with a
// two-voxel H/W halo, a ring of three intermediate planes with a one-voxel
// halo, and the weights (both convs' whole, or one stage of G taps at a
// time where they do not fit). Every plane buffer is [8-channel chunk]
// [position] in 16-byte rows, the (h, w) positions flattened with one pitch
// P = TW + 4: a GEMM row is a position, so an M block of 64 rows is 8 core
// matrices of wgmma's no-swizzle K-major layout 128 bytes apart, and a tap
// (kh, kw) is the same buffer at a start kh P + kw rows later; a K step is
// one tap and two chunks (LBO: a chunk's rows). Both convs compute the
// columns past their region too (P - TW - 2 of them for the first, P - TW
// for the second) and leave them: at 16 x 16 the first conv computes 384
// rows for 324 intermediate voxels, the second 320 for 256 outputs. Step
// for intermediate plane m (outputs plane m - 1):
//   1. the input plane m + 2 starts copying (cp.async, 16 bytes a chunk of
//      a voxel, zero outside the volume) into the ring slot it frees (RX =
//      4: at once; RX = 3: once the first conv is done);
//   2. the first conv, over input planes m - 1 .. m + 1, into registers;
//      its epilogue applies the folded BN and the ReLU, rounds to bf16,
//      writes zero for a position outside the volume, and stores the
//      accumulators straight into the intermediate ring's A layout;
//   3. the second conv, over intermediate planes m - 2 .. m, to output
//      plane m - 1, stored from the registers.
// The accumulators go into f32 totals every kFlush K steps, as in
// conv_tc.cu. A warpgroup owns the M blocks wg, wg + 4, ..., at most
// PairTile<N>::MB of them (the plan sizes the tile so). A K step costs one
// 64-bit shared-memory load (its A descriptor, from a table written for
// the step's ring slots) and the warpgroup's wgmmas, with no branch
// between them: the 16 warps of a block issue every instruction of the K
// loop, and a loop that works out its addresses step by step is bound by
// that issue, not by the tensor cores. The plan also splits D into segments
// where the columns alone leave SMs idle; a segment recomputes the
// intermediate planes at its ends.
//
// What it reaches (chip_smoke.py pair phase, PERF.md section 6): more
// device time than the two tc launches it replaces, at every pair: the
// recomputed halo rows make 1.55x their wgmmas at the first pair (the
// columns past the region and the halo: 384 + 320 GEMM rows a plane for
// 256 outputs, against 256 + 256).
//
// The CUDA-core body (f32, and what the tensor-core body does not take):
// conv3d_pair_kernel, one block per 2 x 8 x 16 output tile, one thread per
// output voxel. Phase 1: the block's threads compute the intermediate tile
// with its one-voxel halo, (2+2) x (8+2) x (16+2) = 720 voxels for 256
// outputs, one (voxel, chunk of 8 channels) per step, chunk-major so a warp
// reads the same weights (a broadcast), round it to x's type and keep it in
// shared memory (<= 180 KB at Cm = 64 in f32). Phase 2: each thread runs
// the second conv from shared memory for its voxel, 8 output channels at a
// time. Weights are read from device memory through L1, 16 bytes a load
// (uniform within a warp). It is bound by FMA issue on the CUDA cores (67
// TFLOP/s peak).

#include <atomic>

#include "wgmma.cuh"

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

// ------------------------------------- the tensor-core body: D streamed

namespace {

constexpr int kPairWG = 4;               // warpgroups a block
constexpr int kPairThreads = 128 * kPairWG;
constexpr int kPairMaxSmem = 227 * 1024;
constexpr int kPairMaxDevices = 64;

using mdf::cp_async16;
using mdf::cp_async_wait_all;
using mdf::descriptor;
using mdf::kFlush;
using mdf::smem_u32;
using mdf::Wgmma;

// 64-row M blocks a warpgroup holds at once, by N: a block's four
// warpgroups hold 8, 8 and 4 (conv_kernel.py _PAIR_BLOCKS), their
// accumulators and f32 totals 32 registers a thread and M block at N = 16,
// 64 at N = 32 and 64 (a thread has 128 at four warpgroups)
template <int N> struct PairTile;
template <> struct PairTile<16> { static constexpr int MB = 2; };
template <> struct PairTile<32> { static constexpr int MB = 2; };
template <> struct PairTile<64> { static constexpr int MB = 1; };

struct PairTcArgs {
  const __nv_bfloat16* x;   // (N, D, H, W, Ci)
  const __nv_bfloat16* w1;  // (27 Ci/8, Cm, 8): K chunk tap * Ci/8 + c
  const float* s1;          // (Cm)
  const float* o1;
  const __nv_bfloat16* w2;  // (27 Cm/8, Co, 8)
  const float* s2;          // (Co)
  const float* o2;
  __nv_bfloat16* y;         // (N, D, H, W, Co)
  int N, D, H, W, Ci, Cm, Co, relu;
  int TH, TW;               // output tile (h, w)
  int L;                    // output planes a block walks
  int RX;                   // input planes in the ring (3 or 4)
  int G;                    // taps per weight stage; 27: both convs whole
  int segs;                 // D segments
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory extents (conv_kernel.py pair_geometry computes the same):
// P, the pitch of every plane buffer's positions; the two convs' M blocks;
// the 16-byte rows of a channel chunk of an input and an intermediate plane
// (the plane and what the last M block's taps read past it; odd); the rows
// of a plane; the byte offsets of the rings and the weights, after two
// tables of the K steps' A descriptors (a step's iteration and the next's).
struct PairGeometry {
  int P, nb1, nb2, npx, npm, nchx, nchm, xplane, mplane, wrows1, wrows2, steps1, steps2;
  size_t x_off, m_off, w_off, bytes;
  __host__ __device__ explicit PairGeometry(const PairTcArgs& a) {
    P = a.TW + 4;
    nb1 = ((a.TH + 2) * P + 63) / 64;
    nb2 = (a.TH * P + 63) / 64;
    npx = imax((a.TH + 4) * P, 64 * nb1 + 2 * P + 2) | 1;
    npm = imax(64 * nb1, 64 * nb2 + 2 * P + 2) | 1;
    nchx = a.Ci / 8;
    nchm = a.Cm / 8;
    xplane = nchx * npx;
    mplane = nchm * npm;
    wrows1 = 27 * nchx * a.Cm;
    wrows2 = 27 * nchm * a.Co;
    steps1 = 27 * nchx / 2;
    steps2 = 27 * nchm / 2;
    x_off = (2 * 8 * (size_t)(steps1 + steps2) + 127) / 128 * 128;
    m_off = x_off + 16 * (size_t)a.RX * xplane;
    w_off = m_off + 16 * 3 * (size_t)mplane;
    const int wrows = a.G == 27 ? wrows1 + wrows2 : a.G * imax(nchx * a.Cm, nchm * a.Co);
    bytes = w_off + 16 * (size_t)wrows;
  }
};

// cp.async of `rows` consecutive 16-byte rows from global to shared memory
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, int rows) {
  for (int r = threadIdx.x; r < rows; r += kPairThreads)
    cp_async16(dst + 16 * r, src + 8 * (size_t)r, 16);
}

// Input plane p into ring slot `slot`: the tile's (TH + 4) x (TW + 4)
// positions with its two-voxel halo, zero outside the volume.
__device__ __forceinline__ void load_input_plane(uint32_t xs, const PairTcArgs& a,
                                                 const PairGeometry& g, int n, int p,
                                                 int h0, int w0, int slot) {
  const uint32_t dst = xs + 16u * slot * g.xplane;
  const int ww = a.TW + 4, vectors = (a.TH + 4) * ww * g.nchx;
  const bool plane_in = p >= 0 && p < a.D;
  for (int v = threadIdx.x; v < vectors; v += kPairThreads) {
    const int c = v % g.nchx, t = v / g.nchx;
    const int lw = t % ww, lh = t / ww;
    const int gh = h0 - 2 + lh, gw = w0 - 2 + lw;
    const bool in = plane_in && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
    const __nv_bfloat16* src =
        in ? a.x + ((((size_t)n * a.D + p) * a.H + gh) * a.W + gw) * a.Ci + 8 * c : a.x;
    cp_async16(dst + 16 * (c * g.npx + lh * g.P + lw), src, in ? 16 : 0);
  }
}

// One conv over a plane: warpgroup wg's first CNT M blocks wg, wg + 4, ...
// into total[i] (f32), K steps of 16 (a tap and two chunks) whose A
// descriptors the table `tab` holds (fill_tables); B from the weights at
// `ws` (27 taps whole, or stage by stage from `w_src` when G < 27: a
// barrier, the stage's copy, a barrier). The accumulators go into the
// totals every kFlush K steps (and at a stage's end). A K step is one
// shared-memory load and CNT wgmmas: CNT is a constant, so no wgmma stands
// under a branch.
template <int N, int MB, int CNT>
__device__ __forceinline__ void products(float (&total)[MB][N / 2], const uint64_t* tab,
                                         int steps, int wg, uint32_t ws,
                                         const __nv_bfloat16* w_src, int G) {
  float acc[MB][N / 2];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[i][j] = total[i][j] = 0.0f;
  const int stage_steps = steps / 27 * G;
  const uint64_t db0 = descriptor(ws, N, 8);
  const uint64_t wgoff = 64 * wg;
  for (int st0 = 0; st0 < steps; st0 += stage_steps) {
    if (G != 27) {
      __syncthreads();  // every warpgroup is done with the previous stage
      copy_rows(ws, w_src + (size_t)st0 * 2 * N * 8, stage_steps * 2 * N);
      cp_async_wait_all();
      mdf::fence_proxy_async();
      __syncthreads();
    }
    const int st1 = st0 + stage_steps;
    const uint64_t dbs = db0 - (uint64_t)(G == 27 ? 0 : 2 * N * st0);
    for (int s0 = st0; s0 < st1; s0 += kFlush) {
      const int s1 = min(s0 + kFlush, st1);
      mdf::wgmma_fence();
      for (int s = s0; s < s1; ++s) {
        const uint64_t da = tab[s] + wgoff;
        const uint64_t db = dbs + (uint64_t)(2 * N * s);
#pragma unroll
        for (int i = 0; i < CNT; ++i)
          Wgmma<N>::mma(acc[i], da + 64 * kPairWG * i, db, s > s0);
      }
      mdf::wgmma_commit_and_wait();
#pragma unroll
      for (int i = 0; i < CNT; ++i)
#pragma unroll
        for (int j = 0; j < N / 2; ++j) total[i][j] += acc[i][j];
    }
  }
}

// products() for warpgroup wg's M blocks of the nb a conv has
template <int N, int MB>
__device__ __forceinline__ void plane_products(float (&total)[MB][N / 2], const uint64_t* tab,
                                               int steps, int nb, int wg, uint32_t ws,
                                               const __nv_bfloat16* w_src, int G) {
  const int cnt = min(MB, (nb - wg + kPairWG - 1) / kPairWG);
  if (cnt >= MB) {
    products<N, MB, MB>(total, tab, steps, wg, ws, w_src, G);
  } else if (MB > 1 && cnt == 1) {
    products<N, MB, 1>(total, tab, steps, wg, ws, w_src, G);
  } else {
    products<N, MB, 0>(total, tab, steps, wg, ws, w_src, G);
  }
}

// Step j's tables of A descriptors (table j % 2): the first conv's K steps
// over input ring entries j .. j + 2, the second's over intermediate ring
// entries j - 2 .. j. K step s of a conv is tap s / (nch / 2), chunks 2 cp
// and 2 cp + 1 (cp = s % (nch / 2)): the slot of its kd, shifted by kh P +
// kw rows, its chunks npx (npm) rows apart.
__device__ __forceinline__ void fill_tables(uint64_t* tabs, const PairTcArgs& a,
                                            const PairGeometry& g, uint32_t xs, uint32_t ms,
                                            int j) {
  uint64_t* tab = tabs + (j & 1) * (g.steps1 + g.steps2);
  for (int e = threadIdx.x; e < g.steps1 + g.steps2; e += kPairThreads) {
    const bool first = e < g.steps1;
    const int s = first ? e : e - g.steps1, half = (first ? g.nchx : g.nchm) / 2;
    const int tap = s / half, cp = s - tap * half;
    const int kd = tap / 9, r9 = tap - 9 * kd, kh = r9 / 3, kw = r9 - 3 * kh;
    const int rows = first ? g.npx : g.npm;
    const uint32_t slot = first ? xs + 16u * g.xplane * ((j + kd) % a.RX)
                                : ms + 16u * g.mplane * ((j + 1 + kd) % 3);
    tab[e] = descriptor(slot + 16u * (2 * cp * rows + kh * g.P + kw), rows, 8);
  }
}

template <int N1, int N2>
__global__ void __launch_bounds__(kPairThreads, 1) conv3d_pair_tc_kernel(const PairTcArgs a) {
  constexpr int MB1 = PairTile<N1>::MB, MB2 = PairTile<N2>::MB;
  extern __shared__ __align__(128) uint8_t smem[];
  const PairGeometry g(a);
  const uint32_t base = smem_u32(smem);
  const uint32_t xs = base + (uint32_t)g.x_off, ms = base + (uint32_t)g.m_off,
                 ws = base + (uint32_t)g.w_off;
  uint64_t* tabs = reinterpret_cast<uint64_t*>(smem);
  const int seg = blockIdx.z % a.segs, n = blockIdx.z / a.segs;
  const int h0 = blockIdx.y * a.TH, w0 = blockIdx.x * a.TW;
  const int d0 = seg * a.L, planes = min(a.L, a.D - d0);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int q = lane % 4;

  // input plane d0 - 2 + r is ring entry r, in slot r % RX; intermediate
  // plane d0 - 1 + r is entry r, in slot r % 3
  if (a.G == 27) {
    copy_rows(ws, a.w1, g.wrows1);
    copy_rows(ws + 16u * g.wrows1, a.w2, g.wrows2);
  }
  for (int r = 0; r < 3; ++r) load_input_plane(xs, a, g, n, d0 - 2 + r, h0, w0, r % a.RX);
  fill_tables(tabs, a, g, xs, ms, 0);
  cp_async_wait_all();
  mdf::fence_proxy_async();
  __syncthreads();

  for (int j = 0; j < planes + 2; ++j) {
    const int m = d0 - 1 + j;  // the intermediate plane of this step
    if (a.RX == 4 && j <= planes)
      load_input_plane(xs, a, g, n, m + 2, h0, w0, (j + 3) % 4);
    uint8_t* mslot_p = smem + g.m_off + 16 * (size_t)g.mplane * (j % 3);
    const uint64_t* tab = tabs + (j & 1) * (g.steps1 + g.steps2);
    if (m >= 0 && m < a.D) {
      // 2. the first conv and its epilogue into the intermediate ring
      float total[MB1][N1 / 2];
      plane_products<N1, MB1>(total, tab, g.steps1, g.nb1, wg, ws, a.w1, a.G);
#pragma unroll
      for (int i = 0; i < MB1; ++i) {
        if (wg + kPairWG * i >= g.nb1) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos = 64 * (wg + kPairWG * i) + warp * 16 + half * 8 + lane / 4;
          const int lh = pos / g.P, lw = pos - lh * g.P;
          const int gh = h0 - 1 + lh, gw = w0 - 1 + lw;
          const bool in = lh < a.TH + 2 && lw < a.TW + 2 && gh >= 0 && gh < a.H && gw >= 0 &&
                          gw < a.W;
#pragma unroll
          for (int c8 = 0; c8 < N1 / 8; ++c8) {
            const int col = 8 * c8 + 2 * q;
            float v0 = total[i][4 * c8 + 2 * half] * __ldg(a.s1 + col) + __ldg(a.o1 + col);
            float v1 =
                total[i][4 * c8 + 2 * half + 1] * __ldg(a.s1 + col + 1) + __ldg(a.o1 + col + 1);
            if (a.relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            if (!in) v0 = v1 = 0.0f;  // the second conv's padding
            *reinterpret_cast<__nv_bfloat162*>(mslot_p + 16 * ((size_t)c8 * g.npm + pos) +
                                               4 * q) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    } else {
      // an intermediate plane outside the volume: zero
      for (int v = threadIdx.x; v < g.mplane; v += kPairThreads)
        reinterpret_cast<uint4*>(mslot_p)[v] = make_uint4(0u, 0u, 0u, 0u);
    }
    mdf::fence_proxy_async();
    __syncthreads();
    // 1. (RX = 3) the slot of input plane m - 1 is free now
    if (a.RX == 3 && j <= planes)
      load_input_plane(xs, a, g, n, m + 2, h0, w0, (j + 3) % 3);
    if (j >= 2) {
      // 3. the second conv: output plane m - 1 from intermediate planes
      //    m - 2, m - 1, m
      const int od = m - 1;
      float total[MB2][N2 / 2];
      plane_products<N2, MB2>(total, tab + g.steps1, g.steps2, g.nb2, wg,
                              ws + (a.G == 27 ? 16u * g.wrows1 : 0u), a.w2, a.G);
#pragma unroll
      for (int i = 0; i < MB2; ++i) {
        if (wg + kPairWG * i >= g.nb2) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos = 64 * (wg + kPairWG * i) + warp * 16 + half * 8 + lane / 4;
          const int lh = pos / g.P, lw = pos - lh * g.P;
          const int gh = h0 + lh, gw = w0 + lw;
          if (lh >= a.TH || lw >= a.TW || gh >= a.H || gw >= a.W) continue;
          __nv_bfloat16* yp = a.y + ((((size_t)n * a.D + od) * a.H + gh) * a.W + gw) * a.Co;
#pragma unroll
          for (int c8 = 0; c8 < N2 / 8; ++c8) {
            const int col = 8 * c8 + 2 * q;
            float v0 = total[i][4 * c8 + 2 * half] * __ldg(a.s2 + col) + __ldg(a.o2 + col);
            float v1 =
                total[i][4 * c8 + 2 * half + 1] * __ldg(a.s2 + col + 1) + __ldg(a.o2 + col + 1);
            if (a.relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            *reinterpret_cast<__nv_bfloat162*>(yp + col) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    // the next step's input plane has landed and its tables are written;
    // every warpgroup is done with this step's intermediate and input slots
    fill_tables(tabs, a, g, xs, ms, j + 1);
    cp_async_wait_all();
    mdf::fence_proxy_async();
    __syncthreads();
  }
}

template <int N1, int N2>
cudaError_t pair_tc_launch(const PairTcArgs& a, size_t smem, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[kPairMaxDevices];
  auto kernel = conv3d_pair_tc_kernel<N1, N2>;
  const bool known = device >= 0 && device < kPairMaxDevices;
  if (!known || !opted_in[device].load()) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPairMaxSmem);
    if (err != cudaSuccess) return err;
    if (known) opted_in[device].store(true);
  }
  const dim3 grid((unsigned)((a.W + a.TW - 1) / a.TW), (unsigned)((a.H + a.TH - 1) / a.TH),
                  (unsigned)(a.N * a.segs));
  kernel<<<grid, kPairThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int N1>
cudaError_t pair_tc_dispatch(const PairTcArgs& a, size_t smem, int device, cudaStream_t st) {
  switch (a.Co) {
    case 16: return pair_tc_launch<N1, 16>(a, smem, device, st);
    case 32: return pair_tc_launch<N1, 32>(a, smem, device, st);
    case 64: return pair_tc_launch<N1, 64>(a, smem, device, st);
    default: return cudaErrorInvalidValue;
  }
}

// M blocks a conv may have: its warpgroups' PairTile<N>::MB each
int pair_blocks(int n) { return kPairWG * (n == 64 ? PairTile<64>::MB : PairTile<16>::MB); }

}  // namespace

// The tensor-core body (bf16 in and out); returns cudaGetLastError() after
// the launch. w1 (27 Ci/8, Cm, 8) and w2 (27 Cm/8, Co, 8) bf16 packed by
// conv_kernel.py pack_tap_weight; th x tw the output tile, `planes` the
// planes a block walks, `ring` the input planes held (3 or 4), `taps` the
// taps a weight stage (27, 9 or 3), `smem` the plan's shared-memory bytes,
// which must be this file's for the same plan.
extern "C" int mdf_conv3d_pair_tc(const void* x, const void* w1, const void* s1, const void* o1,
                                  const void* w2, const void* s2, const void* o2, void* y, int N,
                                  int D, int H, int W, int Ci, int Cm, int Co, int relu, int th,
                                  int tw, int planes, int ring, int taps, int smem,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool nm = Cm == 16 || Cm == 32 || Cm == 64, no = Co == 16 || Co == 32 || Co == 64;
  if (Ci <= 0 || Ci % 16 || !nm || !no || th < 1 || tw < 1 || planes < 1 ||
      (ring != 3 && ring != 4) || (taps != 27 && taps != 9 && taps != 3))
    return cudaErrorInvalidValue;
  const PairTcArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
                     static_cast<const float*>(s1), static_cast<const float*>(o1),
                     static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(s2),
                     static_cast<const float*>(o2), static_cast<__nv_bfloat16*>(y), N, D, H, W,
                     Ci, Cm, Co, relu, th, tw, planes, ring, taps, (D + planes - 1) / planes};
  const PairGeometry g(a);
  if (g.bytes != (size_t)smem || g.bytes > (size_t)kPairMaxSmem || g.nb1 > pair_blocks(Cm) ||
      g.nb2 > pair_blocks(Co) || g.npx > 0x3FFF || g.npm > 0x3FFF)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Cm) {
    case 16: return pair_tc_dispatch<16>(a, g.bytes, device, st);
    case 32: return pair_tc_dispatch<32>(a, g.bytes, device, st);
    default: return pair_tc_dispatch<64>(a, g.bytes, device, st);
  }
}
