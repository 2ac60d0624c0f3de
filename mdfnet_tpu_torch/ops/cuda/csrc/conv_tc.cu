// Tensor-core implicit-GEMM convolution with a fused folded-BN / bias
// epilogue: the bf16 route of K2, K4 and K5's layers (ops/cuda/conv_kernel.py
// conv_route sends a bf16 conv with Ci % 8 == 0 and Co % 8 == 0 here).
//
// Replaces, as conv_bn_act_kernel does on the other route:
//   K2 mdfnet_tpu/ops/pallas/conv3d_kernel.py:577 conv3d_bn_relu
//   K4 mdfnet_tpu/ops/pallas/conv2d_kernel.py:242 conv2d_fused
//   K5 mdfnet_tpu/ops/pallas/conv2d_kernel.py:654 conv2d_chain_fused (its
//      layers, as consecutive launches)
//
// What it computes: NDHWC bf16 input (2D is D = 1), a KD x K x K kernel (KD
// in {1, 3}, K in {1, 3, 5}) at stride 1 or 2 with torch padding (K-1)/2, f32
// accumulation, then y = relu?(acc * scale[co] + offset[co]) (+ residual),
// stored as bf16 or f32.
//
// What bounds it on the H100: as a GEMM, M = output voxels, N = Co <= 64,
// K = taps x Ci. At bf16 on the tensor cores (989 TFLOP/s) the work is bound
// by the bytes of the input and output (3.35 TB/s): the stage-0 U-Net's
// first conv moves 136 MB (0.041 ms) for 39 GFLOP (0.040 ms).
//
// Design: a block of two warpgroups owns an output tile of TD x 8*BH x 8
// voxels and the whole Co (padded to N in {8, 16, 32, 64}), so the input is
// read once per tile, not once per 8 output channels. The block copies the
// tile's input with its halo into shared memory once (16-byte cp.async per
// 8-channel chunk of a voxel; an out-of-range voxel is zero-filled, which is
// the conv's padding), laid out as [d][h][chunk][w parity][w / S] rows of 16
// bytes. A 64-row M block is 8 h x 8 w at one d: its 8 consecutive w are 8
// consecutive 16-byte rows, i.e. one core matrix of wgmma's no-swizzle
// K-major layout, and its 8 h rows are a constant stride (SBO) apart. So each
// tap's A operand is the same tile at a shifted start address: one
// descriptor per K step, nothing gathered twice. At stride 2 the w parity
// split makes every tap a unit shift again. A K step of 16 is two
// (tap, chunk) pairs of the K order ((kd*K + kh)*nch + chunk)*K + kw slot
// (the slots list even kw before odd kw at stride 2), in which the tile
// addresses rise, so the second pair is a positive leading offset (LBO) from
// the first; at Ci = 8 a step spans two taps, and an odd count ends with a
// zero-weight pair (LBO 0). The weights come packed by the wrapper as bf16
// (K chunks, Co, 8), one gather of the torch-layout weight; the block copies
// them into B's core matrices for the same K step, (Q, N, 8) with the
// channels beyond Co and the zero pair zero-filled, held in shared memory
// for the whole tile, or one kd slab at a time when they do not fit beside
// the tile (Ci = Co = 64). wgmma.m64nNk16.f32.bf16.bf16 runs with A
// and B from shared memory; the epilogue applies the folded BN, ReLU and
// residual straight from the accumulator registers. No pipelining across
// tiles yet: the loads of one block overlap the products of the others on
// the same SM.

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // two warpgroups
constexpr int kTableBytes = 1024;   // K-step descriptors (<= 108 of 8 bytes)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;
// K steps (of 16) summed in the tensor cores before one f32 add into the
// totals. The tensor cores align each step's sum to the accumulator by
// truncation, so one long run of steps ends further from the exact sum than
// f32 FMA does. The interval trades that error against time: at 9 the sums
// of K2's and K4's main-path convs come nearer the exact (f64) sums than the
// direct kernel's (chip_smoke.py's "tc sums" line) for a few percent of K2's
// time; a shorter interval adds f32 adds and waits on the tensor cores to
// every tile for little more accuracy.
constexpr int kFlush = 9;

// 64-row M blocks per warpgroup, by N (ops/cuda/conv_kernel.py _TC_MB)
template <int N> struct Tile;
template <> struct Tile<8> { static constexpr int MB = 4; };
template <> struct Tile<16> { static constexpr int MB = 4; };
template <> struct Tile<32> { static constexpr int MB = 2; };
template <> struct Tile<64> { static constexpr int MB = 2; };

struct TcArgs {
  const __nv_bfloat16* x;  // (Nb, Di, Hi, Wi, Ci)
  const __nv_bfloat16* w;  // (KD*K*K*Ci/8, Co, 8) packed K chunks
  const float* scale;      // (Co)
  const float* offset;     // (Co)
  const void* res;         // (Nb, Do, Ho, Wo, Co) or null, output type
  void* y;                 // (Nb, Do, Ho, Wo, Co)
  int Nb, Di, Hi, Wi, Ci, Do, Ho, Wo, Co, relu;
  int KD, K, S;  // kernel extent along D, along H and W; stride
  int TD, BH;    // output tile TD x 8*BH x 8; TD * BH = 2 * MB
  int Q;         // K chunks (even), of which the last may be a zero pair
  int Qs;        // K chunks per weight stage: Q, or Q / KD
  int dtiles;    // tiles along D
};

// Shared-memory extents of a tile, in 16-byte rows.
struct Geometry {
  int nch, Wp, seg, Hin, Din, Win, row, plane, a_rows;
  __host__ __device__ explicit Geometry(const TcArgs& a) {
    nch = a.Ci >> 3;
    Wp = 8 + (a.K - 1) / a.S;   // rows of one w parity
    seg = a.S * Wp;             // rows of one (d, h, chunk)
    Hin = a.S * (8 * a.BH - 1) + a.K;
    Din = a.S * (a.TD - 1) + a.KD;
    Win = a.S * 7 + a.K;
    row = nch * seg;
    plane = Hin * row;
    a_rows = Din * plane;
  }
};

// f32 floats per staged output row of the epilogue: N, padded by 8 so that
// the 8 rows a warp writes at once fall on different banks
__host__ __device__ constexpr int stage_stride(int n) { return n + 8; }

size_t smem_bytes(const TcArgs& a, int n) {
  const Geometry g(a);
  const size_t tile = 16 * ((size_t)g.a_rows + (size_t)a.Qs * n);
  const size_t stage = 2 * 64 * stage_stride(n) * sizeof(float);  // per warpgroup
  return kTableBytes + (tile > stage ? tile : stage);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wgmma matrix descriptor, no swizzle: start, LBO and SBO in 16-byte units
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo & 0x3FFF) << 16) |
         ((uint64_t)(sbo & 0x3FFF) << 32);
}

// Shared-memory row of K chunk q of the tile (output voxel (0, 0, 0)).
__device__ __forceinline__ uint32_t chunk_row(int q, const TcArgs& a, const Geometry& g) {
  const int slot = q % a.K;
  int t = q / a.K;
  const int c = t % g.nch;
  t /= g.nch;
  const int kh = t % a.K, kd = t / a.K;
  const int half = (a.K + 1) / 2;
  const int kw = a.S == 1 ? slot : (slot < half ? 2 * slot : 2 * (slot - half) + 1);
  return (kd * g.Hin + kh) * g.row + c * g.seg + (kw % a.S) * g.Wp + kw / a.S;
}

// D = A B (+ D where acc_in != 0), A and B from shared memory (K-major),
// f32 accumulators.
template <int N> struct Wgmma;

template <> struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(acc_in));
  }
};

template <> struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc_in));
  }
};

template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, "
        "%17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc_in));
  }
};

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, "
        "p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc_in));
  }
};

// Copy rows [row0, row0 + rows) of B, (Q, N, 8) in 16-byte rows, to shared
// memory from the packed (q_real, Co, 8) weights; a row of a channel >= Co
// or of the zero pair (chunk >= q_real) is zero-filled.
template <int N>
__device__ __forceinline__ void load_weights(uint32_t dst, const TcArgs& a, int q_real, int row0,
                                             int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int q = (row0 + r) / N, co = (row0 + r) % N;
    const bool in = co < a.Co && q < q_real;
    cp_async16(dst + 16 * r, in ? a.w + ((size_t)q * a.Co + co) * 8 : a.w, in ? 16 : 0);
  }
}

template <int N, typename TO>
__global__ void __launch_bounds__(kThreads) conv_tc_kernel(const TcArgs a) {
  constexpr int MB = Tile<N>::MB;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* table = reinterpret_cast<uint64_t*>(smem);
  const Geometry g(a);
  const uint32_t tile_a = smem_u32(smem + kTableBytes);
  const uint32_t tile_w = tile_a + 16u * g.a_rows;

  const int th = 8 * a.BH;
  const int ow0 = blockIdx.x * 8, oh0 = blockIdx.y * th;
  const int n = blockIdx.z / a.dtiles, od0 = (blockIdx.z % a.dtiles) * a.TD;
  const int id0 = od0 * a.S - a.KD / 2, ih0 = oh0 * a.S - a.K / 2, iw0 = ow0 * a.S - a.K / 2;

  // 1. the input tile with its halo; zero outside the volume (the padding)
  const __nv_bfloat16* xb = a.x + (size_t)n * a.Di * a.Hi * a.Wi * a.Ci;
  const int vectors = g.Din * g.Hin * g.Win * g.nch;
  for (int v = threadIdx.x; v < vectors; v += kThreads) {
    const int c = v % g.nch;
    int r = v / g.nch;
    const int lw = r % g.Win;
    r /= g.Win;
    const int lh = r % g.Hin, ld = r / g.Hin;
    const int id = id0 + ld, ih = ih0 + lh, iw = iw0 + lw;
    const bool in = id >= 0 && id < a.Di && ih >= 0 && ih < a.Hi && iw >= 0 && iw < a.Wi;
    const __nv_bfloat16* src =
        in ? xb + (((size_t)id * a.Hi + ih) * a.Wi + iw) * a.Ci + c * 8 : a.x;
    const int row = (ld * g.Hin + lh) * g.row + c * g.seg + (lw % a.S) * g.Wp + lw / a.S;
    cp_async16(tile_a + 16 * row, src, in ? 16 : 0);
  }
  // 2. the first weight stage, and one A descriptor per K step: two K chunks,
  //    the second LBO rows after the first (0 for the zero-weight pair)
  const int q_real = a.KD * a.K * a.K * g.nch;
  load_weights<N>(tile_w, a, q_real, 0, a.Qs * N);
  for (int s = threadIdx.x; s < a.Q / 2; s += kThreads) {
    const uint32_t r0 = chunk_row(2 * s, a, g);
    const uint32_t r1 = 2 * s + 1 < q_real ? chunk_row(2 * s + 1, a, g) : r0;
    table[s] = descriptor(tile_a + 16 * r0, r1 - r0, a.S * g.row);
  }
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // 3. the products: warpgroup wg owns M blocks wg*MB .. wg*MB + MB-1
  const int wg = threadIdx.x / 128;
  uint32_t base[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int b = wg * MB + i, bd = b / a.BH, bh = b % a.BH;
    base[i] = (uint32_t)((a.S * bd * g.Hin + a.S * 8 * bh) * g.row);
  }
  // every kFlush K steps the tensor cores' partial sums go into `total`
  // with f32 adds, and the next step overwrites the accumulators
  float acc[MB][N / 2], total[MB][N / 2];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[i][j] = total[i][j] = 0.0f;
  // B: core matrices of 8 output channels x 8 K values, N rows per K chunk
  const uint64_t desc_w = descriptor(tile_w, N, 8);
  const int nstages = a.Q / a.Qs;
  for (int st = 0; st < nstages; ++st) {
    if (st > 0) {
      __syncthreads();  // both warpgroups are done with the previous stage
      load_weights<N>(tile_w, a, q_real, st * a.Qs * N, a.Qs * N);
      cp_async_wait_all();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    const uint64_t* tab = table + st * (a.Qs / 2);
    for (int s0 = 0; s0 < a.Qs / 2; s0 += kFlush) {
      const int s1 = min(s0 + kFlush, a.Qs / 2);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int s = s0; s < s1; ++s) {
        const uint64_t da = tab[s];
        const uint64_t db = desc_w + (uint64_t)(2 * N * s);
#pragma unroll
        for (int i = 0; i < MB; ++i) Wgmma<N>::mma(acc[i], da + base[i], db, s > s0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int j = 0; j < N / 2; ++j) total[i][j] += acc[i][j];
    }
  }

  // 4. epilogue, one M block at a time per warpgroup: the folded BN and the
  //    ReLU from the accumulators (thread t holds rows warp*16 + lane/4
  //    (+8) and channel pairs 8j + 2*(lane%4)) into an f32 stage over the
  //    A tile, then 8 channels per thread to the output, coalesced along
  //    the row's 8 consecutive w, with the residual added before the one
  //    rounding to TO
  __syncthreads();  // both warpgroups are done with the A tile
  constexpr int SS = stage_stride(N);
  float* stage = reinterpret_cast<float*>(smem + kTableBytes) + wg * 64 * SS;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int vecs = a.Co / 8;  // 8-channel vectors per output voxel
  TO* y = static_cast<TO*>(a.y);
  const TO* res = static_cast<const TO*>(a.res);
#pragma unroll
  for (int i = 0; i < MB; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + half * 8 + lane / 4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        if (col >= a.Co) continue;
        float v0 = total[i][4 * j + 2 * half] * a.scale[col] + a.offset[col];
        float v1 = total[i][4 * j + 2 * half + 1] * a.scale[col + 1] + a.offset[col + 1];
        if (a.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        *reinterpret_cast<float2*>(stage + r * SS + col) = make_float2(v0, v1);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
    const int b = wg * MB + i, bd = b / a.BH, bh = b % a.BH;
    const int od = od0 + bd;
    for (int v = t; v < 64 * vecs; v += 128) {
      const int r = v / vecs, c8 = 8 * (v % vecs);
      const int oh = oh0 + 8 * bh + r / 8, ow = ow0 + r % 8;
      if (od >= a.Do || oh >= a.Ho || ow >= a.Wo) continue;
      const size_t p = ((((size_t)n * a.Do + od) * a.Ho + oh) * a.Wo + ow) * a.Co + c8;
      float val[8];
      mdf::load8(stage + r * SS + c8, val);
      if (res) {
        float rv[8];
        mdf::load8(res + p, rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) val[e] += rv[e];
      }
      mdf::store8(y + p, val);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
  }
}

template <int N, typename TO>
cudaError_t launch(const TcArgs& a, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes(a, N);
  if (smem > (size_t)kMaxSmem || 2 * Tile<N>::MB != a.TD * a.BH || a.Q % a.Qs ||
      a.Qs % 2 || a.Q / 2 * 8 > kTableBytes)
    return cudaErrorInvalidValue;
  auto kernel = conv_tc_kernel<N, TO>;
  // once per instantiation and device: allow the most shared memory a block
  // may take (a launch still takes only the bytes it asks for)
  static std::atomic<bool> opted_in[kMaxDevices];
  if (device < 0 || device >= kMaxDevices || !opted_in[device].load()) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) opted_in[device].store(true);
  }
  const int th = 8 * a.BH;
  const dim3 grid((unsigned)((a.Wo + 7) / 8), (unsigned)((a.Ho + th - 1) / th),
                  (unsigned)(a.Nb * a.dtiles));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch(const TcArgs& a, int n, int device, cudaStream_t st) {
  switch (n) {
    case 8: return launch<8, TO>(a, device, st);
    case 16: return launch<16, TO>(a, device, st);
    case 32: return launch<32, TO>(a, device, st);
    case 64: return launch<64, TO>(a, device, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``w`` holds
// the packed (kd*k*k*Ci/8, Co, 8) weights; ``n`` is Co padded to the
// kernel's N (8, 16, 32 or 64); dtypes is MDF_BF16_BF16 or MDF_BF16_F32.
extern "C" int mdf_conv_tc(const void* x, const void* w, const void* scale, const void* offset,
                           const void* res, void* y, int Nb, int Di, int Hi, int Wi, int Ci,
                           int Do, int Ho, int Wo, int Co, int n, int kd, int k, int stride,
                           int relu, int td, int bh, int q, int q_stage, int dtypes, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Ci % 8 || Co % 8 || Co > n) return cudaErrorInvalidValue;
  const TcArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                 static_cast<const float*>(scale), static_cast<const float*>(offset),
                 res, y, Nb, Di, Hi, Wi, Ci, Do, Ho, Wo, Co, relu, kd, k, stride, td, bh, q,
                 q_stage, (Do + td - 1) / td};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_BF16_BF16: return dispatch<__nv_bfloat16>(a, n, device, st);
    case MDF_BF16_F32: return dispatch<float>(a, n, device, st);
    default: return cudaErrorInvalidValue;
  }
}
