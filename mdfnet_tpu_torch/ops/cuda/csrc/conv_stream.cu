// A K-streamed implicit-GEMM 3x3x3 convolution on wgmma with a folded-BN
// epilogue: the route of the transposed conv's input gradient in training
// (K8) where the resident tile of conv_tc.cu starves the card
// (ops/cuda/conv_kernel.py stream_route).
//
// Replaces, for those launches: mdfnet_tpu/ops/pallas/conv3d_vjp.py:112
// trconv3d_train (its VJP in x: the stride-2 conv of the cotangent with the
// transposed conv's own weight). Elsewhere that input gradient, and every
// other conv, stays on conv_tc.cu.
//
// What it computes: NDHWC bf16 input, a 3x3x3 kernel at stride 1 or 2 with
// pad 1, f32 accumulation, y = relu?(acc * scale[co] + offset[co]) (+
// residual), stored as bf16 or f32; conv_kernel.py _conv_plain is its plain
// version.
//
// What bounds it on the H100: at the stage-0 shape of a DTU train step, g
// (4, 24, 32, 40, 32) -> dx (4, 12, 16, 20, 64), the bytes (g 7.9 MB, dx
// 3.9 MB: 0.0035 ms) against 0.85 GFLOP (0.0009 ms). conv_tc.cu's plan
// there holds a stride-2 input tile with its halo, 176 KB for 256
// outputs, and streams its weights in three kd slabs beside it: one block
// an SM, 72 blocks for 132 SMs, each loading with nothing to hide behind.
//
// Design: no halo tile. A block is one warpgroup and owns 64 consecutive
// output voxels of the flattened (N, D, H, W) and the whole Co (padded to N
// = 16, 32 or 64). K, the 27 taps x Ci/8 chunks of 8 channels (tap-major,
// conv_kernel.py pack_tap_weight's order), streams through a ring of
// kStages stages of QS chunks (four taps', at most 32; a count that QS does
// not divide ends with zero chunks). A stage holds its slice of A,
// gathered per output row by 16-byte cp.async from the input voxel of the
// chunk's tap (im2col on the fly, zero outside the volume: a mask of the
// row's taps inside it, worked out once), as [chunk][row] 16-byte rows (a
// chunk's rows 65 apart, so the copies spread over the banks), and the
// matching slice of the packed weights as [chunk][channel]. While a stage
// computes, the copies of the next kStages - 1 are in flight; a stage's
// wgmmas finish before the barrier that frees its slot. The accumulators go
// into f32 totals every kFlush K steps, as in conv_tc.cu; the epilogue
// applies the folded BN and the ReLU from the registers into an f32 stage
// over the ring, from which each thread writes 8 channels (and adds the
// residual) in runs along the rows. A block's shared memory (98 KB at the
// shape above) lets two share an SM; the input is re-read from L2. What
// bounds it there: the issue of its 16-byte copies (two a row and tap, A
// and B), not the bytes they move; zero-filled copies that read nothing
// take as long.

#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTM = 64;        // output voxels (GEMM rows) a block
constexpr int kStages = 3;     // stages in the ring (conv_kernel.py _STREAM_STAGES)
constexpr int kStreamMaxSmem = 227 * 1024;
constexpr int kStreamMaxDevices = 64;

using mdf::cp_async16;
using mdf::descriptor;
using mdf::kFlush;
using mdf::smem_u32;
using mdf::Wgmma;

struct StreamArgs {
  const __nv_bfloat16* x;  // (Nb, Di, Hi, Wi, Ci)
  const __nv_bfloat16* w;  // (27 Ci/8, Co, 8) packed K chunks
  const float* scale;      // (Co)
  const float* offset;     // (Co)
  const void* res;         // (Nb, Do, Ho, Wo, Co) or null, output type
  void* y;                 // (Nb, Do, Ho, Wo, Co)
  int Nb, Di, Hi, Wi, Ci, Do, Ho, Wo, Co, S, relu;
  int M;        // output voxels
  int QS;       // K chunks a stage
  int nstages;  // stages: ceil(27 Ci/8 / QS)
};

// Shared-memory layout: the block's rows (their taps' origin and mask, 8
// bytes; 16 a row reserved), then the ring: a stage's A (QS chunks of kTM +
// 1 rows) and B (QS chunks of N rows), 16-byte rows.
struct StreamLayout {
  int a_rows, stage_rows;
  size_t bytes;
  __host__ __device__ StreamLayout(int qs, int n) {
    a_rows = qs * (kTM + 1);
    stage_rows = a_rows + qs * n;
    bytes = 16 * ((size_t)kTM + (size_t)kStages * stage_rows);
  }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until this thread's copies of all but the last kStages - 2 committed
// stages have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Stage st's copies into ring slot `slot`: A, each row's voxel of each
// chunk's tap, and B, the chunks' weights; a chunk past the last (q >= 27
// Ci/8), a tap outside the volume (the row's mask) and a channel >= Co are
// zero-filled. QS divides the block's threads, so a thread copies one
// chunk of the stage for every (kThreads / QS)-th row: its tap's offset is
// worked out once a stage.
template <int N>
__device__ __forceinline__ void load_stage(uint32_t ring, const int2* rows,
                                           const StreamArgs& a, const StreamLayout& l, int st,
                                           int slot) {
  const uint32_t sa = ring + 16u * slot * l.stage_rows, sb = sa + 16u * l.a_rows;
  const int nch = a.Ci / 8, q_end = 27 * nch;
  const int jq = threadIdx.x % a.QS, q = st * a.QS + jq;
  const int tap = q / nch, c = q - tap * nch;
  const int kd = tap / 9, r9 = tap - 9 * kd, kh = r9 / 3, kw = r9 - 3 * kh;
  const int toff = ((kd * a.Hi + kh) * a.Wi + kw) * a.Ci + 8 * c;
  const uint32_t bit = q < q_end ? 1u << tap : 0u;
  for (int r = threadIdx.x / a.QS; r < kTM; r += kThreads / a.QS) {
    const int2 o = rows[r];  // the row's tap origin (an element offset) and tap mask
    const bool in = (uint32_t)o.y & bit;
    cp_async16(sa + 16 * (jq * (kTM + 1) + r), in ? a.x + ((long long)o.x + toff) : a.x,
               in ? 16 : 0);
  }
  for (int v = threadIdx.x; v < a.QS * N; v += kThreads) {
    const int jb = v / N, co = v % N, qb = st * a.QS + jb;
    const bool in = qb < q_end && co < a.Co;
    cp_async16(sb + 16 * v, in ? a.w + ((size_t)qb * a.Co + co) * 8 : a.w, in ? 16 : 0);
  }
}

template <int N, typename TO>
__global__ void __launch_bounds__(kThreads) conv_stream_kernel(const StreamArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const StreamLayout l(a.QS, N);
  int2* rows = reinterpret_cast<int2*>(smem);
  const uint32_t ring = smem_u32(smem) + 16u * kTM;
  const int m0 = blockIdx.x * kTM;

  // the rows' tap origins: output voxel (n, od, oh, ow) reads input (S od -
  // 1 + kd, S oh - 1 + kh, S ow - 1 + kw); the origin's element offset
  // (possibly before the volume) and a mask of the taps inside it (none
  // past the last voxel)
  for (int r = threadIdx.x; r < kTM; r += kThreads) {
    int p = m0 + r;
    int2 o = make_int2(0, 0);
    if (p < a.M) {
      const int ow = p % a.Wo;
      p /= a.Wo;
      const int oh = p % a.Ho;
      p /= a.Ho;
      const int od = p % a.Do, n = p / a.Do;
      const int d0 = a.S * od - 1, h0 = a.S * oh - 1, w0 = a.S * ow - 1;
      uint32_t mask = 0;
      for (int tap = 0; tap < 27; ++tap) {
        const int id = d0 + tap / 9, ih = h0 + tap / 3 % 3, iw = w0 + tap % 3;
        if (id >= 0 && id < a.Di && ih >= 0 && ih < a.Hi && iw >= 0 && iw < a.Wi)
          mask |= 1u << tap;
      }
      o = make_int2((((n * a.Di + d0) * a.Hi + h0) * a.Wi + w0) * a.Ci, (int)mask);
    }
    rows[r] = o;
  }
  __syncthreads();
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < a.nstages) load_stage<N>(ring, rows, a, l, st, st);
    cp_async_commit();  // one group a stage, empty or not
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[N / 2], total[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = total[j] = 0.0f;
  int run = 0;  // K steps in the accumulators since the last flush
  for (int st = 0; st < a.nstages; ++st) {
    cp_async_wait_ring();  // this thread's copies of stage st
    mdf::fence_proxy_async();
    __syncthreads();  // everyone's copies; every wgmma of stage st - 1 done
    const int next = st + kStages - 1;
    if (next < a.nstages) load_stage<N>(ring, rows, a, l, next, next % kStages);
    cp_async_commit();
    const uint32_t sa = ring + 16u * (st % kStages) * l.stage_rows;
    const uint64_t da = descriptor(sa, kTM + 1, 8);
    const uint64_t db = descriptor(sa + 16u * l.a_rows, N, 8);
    // the K steps in runs of kFlush across the stages, each run's sums
    // added into the totals in f32; a stage's wgmmas done before the next
    // barrier
    mdf::wgmma_fence();
    for (int k = 0; k < a.QS / 2; ++k) {
      if (run == kFlush) {
        mdf::wgmma_commit_and_wait();
#pragma unroll
        for (int j = 0; j < N / 2; ++j) total[j] += acc[j];
        run = 0;
        mdf::wgmma_fence();
      }
      Wgmma<N>::mma(acc, da + (uint64_t)(2 * k * (kTM + 1)), db + (uint64_t)(2 * N * k),
                    run > 0);
      ++run;
    }
    mdf::wgmma_commit_and_wait();
  }
#pragma unroll
  for (int j = 0; j < N / 2; ++j) total[j] += acc[j];

  // epilogue: the folded BN and the ReLU from the registers (thread t
  // holds rows warp*16 + lane/4 (+8) and channel pairs 8j + 2 (lane % 4))
  // into an f32 stage over the ring, then 8 channels a thread to the
  // output, a row's channels in one run, with the residual added before
  // the one rounding to TO
  __syncthreads();  // every thread is done with the ring
  constexpr int SS = N + 8;  // floats a staged row: the 8 rows a warp writes at once on other banks
  float* stage = reinterpret_cast<float*>(smem + 16 * kTM);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + half * 8 + lane / 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col >= a.Co) continue;
      float v0 = total[4 * j + 2 * half] * __ldg(a.scale + col) + __ldg(a.offset + col);
      float v1 = total[4 * j + 2 * half + 1] * __ldg(a.scale + col + 1) +
                 __ldg(a.offset + col + 1);
      if (a.relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<float2*>(stage + r * SS + col) = make_float2(v0, v1);
    }
  }
  __syncthreads();
  TO* y = static_cast<TO*>(a.y);
  const TO* res = static_cast<const TO*>(a.res);
  const int vecs = a.Co / 8;  // 8-channel vectors a row
  for (int v = threadIdx.x; v < kTM * vecs; v += kThreads) {
    const int r = v / vecs, c8 = 8 * (v % vecs);
    const int p = m0 + r;
    if (p >= a.M) continue;
    const size_t o = (size_t)p * a.Co + c8;
    float val[8];
    mdf::load8(stage + r * SS + c8, val);
    if (res) {
      float rv[8];
      mdf::load8(res + o, rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) val[e] += rv[e];
    }
    mdf::store8(y + o, val);
  }
}

template <int N, typename TO>
cudaError_t stream_launch(const StreamArgs& a, int smem, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[kStreamMaxDevices];
  const StreamLayout l(a.QS, N);
  // the epilogue's f32 stage (kTM rows of N + 8) lies over the ring
  if (l.bytes != (size_t)smem || l.bytes > (size_t)kStreamMaxSmem ||
      16 * (size_t)kTM + (size_t)kTM * (N + 8) * sizeof(float) > l.bytes)
    return cudaErrorInvalidValue;
  auto kernel = conv_stream_kernel<N, TO>;
  const bool known = device >= 0 && device < kStreamMaxDevices;
  if (!known || !opted_in[device].load()) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStreamMaxSmem);
    if (err != cudaSuccess) return err;
    if (known) opted_in[device].store(true);
  }
  kernel<<<(unsigned)((a.M + kTM - 1) / kTM), kThreads, l.bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t stream_dispatch(const StreamArgs& a, int n, int smem, int device, cudaStream_t st) {
  switch (n) {
    case 16: return stream_launch<16, TO>(a, smem, device, st);
    case 32: return stream_launch<32, TO>(a, smem, device, st);
    case 64: return stream_launch<64, TO>(a, smem, device, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``w`` holds
// the packed (27 Ci/8, Co, 8) weights; ``n`` is Co padded to the kernel's
// N (16, 32 or 64); ``chunks`` the K chunks of a stage (even, dividing
// 128); ``smem`` the plan's bytes, which must be this file's; dtypes is
// MDF_BF16_BF16 or MDF_BF16_F32.
extern "C" int mdf_conv_stream(const void* x, const void* w, const void* scale,
                               const void* offset, const void* res, void* y, int Nb, int Di,
                               int Hi, int Wi, int Ci, int Do, int Ho, int Wo, int Co, int n,
                               int stride, int relu, int chunks, int smem, int dtypes,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Ci <= 0 || Ci % 8 || Co <= 0 || Co % 8 || Co > n || chunks < 2 || chunks % 2 ||
      kThreads % chunks || (stride != 1 && stride != 2) ||
      (long long)Nb * Di * Hi * Wi * Ci >= (1ll << 31))
    return cudaErrorInvalidValue;
  const int q = 27 * (Ci / 8);
  const StreamArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                     static_cast<const float*>(scale), static_cast<const float*>(offset),
                     res, y, Nb, Di, Hi, Wi, Ci, Do, Ho, Wo, Co, stride, relu,
                     Nb * Do * Ho * Wo, chunks, (q + chunks - 1) / chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_BF16_BF16: return stream_dispatch<__nv_bfloat16>(a, n, smem, device, st);
    case MDF_BF16_F32: return stream_dispatch<float>(a, n, smem, device, st);
    default: return cudaErrorInvalidValue;
  }
}
