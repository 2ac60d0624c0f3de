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
//
// trconv_tc_kernel, on the same core, replaces
//   K3 mdfnet_tpu/ops/pallas/conv3d_kernel.py:741 trconv3d_bn_relu:
// ConvTranspose3d(k3, s2, p1, output_padding 1) from bf16 NDHWC input, the
// same epilogue (the residual after the ReLU), bf16 or f32 output.
// Along each axis output 2i + 0 takes tap k = 1 at input i, and 2i + 1 takes
// k = 2 at i and k = 0 at i + 1. So each output parity (pd, ph, pw) is a
// stride-1 GEMM over the coarse (input) voxels with its own 1-8 taps, whose
// input tile needs a halo of one voxel at the far end of each axis only (zero
// outside the volume). The two w parities of a (pd, ph) pair are stacked on
// N = 2 Co: at w offset 0 the even parity takes k = 1 and the odd one k = 2,
// at w offset 1 the odd one takes k = 0 and the even one a zero weight. A
// GEMM row then holds the output of one coarse voxel for fine w = 2i and 2i
// + 1, which lie next to each other in memory (2 Co channels), so the
// epilogue stores whole 8-row runs of 16 consecutive fine w per warp, and
// loads the residual the same way. What bounds it: the bytes, ~90% of them
// the output and the residual (8x the input's voxels); the products are
// 36 Ci Co per coarse voxel (27 of them non-zero) on the tensor cores. One
// block owns a coarse tile TD x 8*BH x 8 and reads its input once for all
// four (pd, ph) GEMMs; no dilated input and no interleave pass exist. Where
// such tiles would leave the card's SMs short of work (the small volumes of
// the stage-1 and -2 U-Nets), 2 or 4 blocks share a tile, each running half
// or one of its GEMMs (the ones with more taps scheduled first), so the
// short launches are not bound by one block's latency.

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

using mdf::cp_async16;
using mdf::cp_async_wait_all;
using mdf::smem_u32;

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

// Once per kernel instantiation (Transposed, N, TO) and device: allow the
// most shared memory a block may take (a launch still takes only the bytes
// it asks for).
template <bool Transposed, int N, typename TO>
cudaError_t allow_max_smem(const void* kernel, int device) {
  static std::atomic<bool> opted_in[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && opted_in[device].load()) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && known) opted_in[device].store(true);
  return err;
}

template <int N, typename TO>
cudaError_t launch(const TcArgs& a, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes(a, N);
  if (smem > (size_t)kMaxSmem || 2 * Tile<N>::MB != a.TD * a.BH || a.Q % a.Qs ||
      a.Qs % 2 || a.Q / 2 * 8 > kTableBytes)
    return cudaErrorInvalidValue;
  auto kernel = conv_tc_kernel<N, TO>;
  const cudaError_t err = allow_max_smem<false, N, TO>((const void*)kernel, device);
  if (err != cudaSuccess) return err;
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

// ------------------------------------------------- the transposed conv (K3)

struct TrArgs {
  const __nv_bfloat16* x;  // (Nb, Di, Hi, Wi, Ci)
  const __nv_bfloat16* w;  // (Ci/8 * 18, 2 Co, 8) packed K chunks
  const float* scale;      // (Co)
  const float* offset;     // (Co)
  const void* res;         // (Nb, 2Di, 2Hi, 2Wi, Co) or null, output type
  void* y;                 // (Nb, 2Di, 2Hi, 2Wi, Co)
  int Nb, Di, Hi, Wi, Ci, Co, relu;
  int TD, BH;     // coarse tile TD x 8*BH x 8; TD * BH = 2 * MB
  int groups;     // blocks per tile (1, 2 or 4), each runs 4 / groups of the GEMMs
  int whole;      // 1: the weights of a block's GEMMs in shared memory at once;
                  // 0: one GEMM's at a time
  int dtiles;     // tiles along D
};

// The four (pd, ph) GEMMs, p = 2 pd + ph, have (pd + 1)(ph + 1) input offsets
// (od, oh) each; a K step is one offset and one 8-channel chunk c, both w
// offsets (its two K chunks, 16 bytes apart in the tile). Steps run GEMM by
// GEMM, within one c-major: step s of GEMM p is c = s / taps, offset t = s %
// taps, (od, oh) = (t / (ph + 1), t % (ph + 1)). GEMM p's first step (p = 4:
// the count of all):
__host__ __device__ constexpr int tr_first_step(int p, int nch) {
  return nch * (p == 0 ? 0 : p == 1 ? 1 : p == 2 ? 3 : p == 3 ? 5 : 9);
}

// GEMM p, chunk c and offset t of K step s (global). The wrapper packs the
// weights c-major, 18 chunks per c: GEMM p's from 2 tr_first_step(p, 1) =
// 0, 2, 6, 10 on, offset t's two chunks (ow = 0, 1) at 2t there
// (ops/cuda/conv_kernel.py pack_trconv_tc_weight).
__device__ __forceinline__ void tr_step(int s, int nch, int& p, int& c, int& t) {
  p = s < tr_first_step(1, nch) ? 0 : s < tr_first_step(2, nch) ? 1
      : s < tr_first_step(3, nch) ? 2 : 3;
  const int taps = ((p >> 1) + 1) * ((p & 1) + 1);
  const int si = s - tr_first_step(p, nch);
  c = si / taps;
  t = si % taps;
}

struct TrGeometry {
  int nch, Hin, row, a_rows;
  __host__ __device__ explicit TrGeometry(const TrArgs& a) {
    nch = a.Ci >> 3;
    Hin = 8 * a.BH + 1;
    row = nch * 9;  // rows of one (d, h): 9 w per chunk
    a_rows = (a.TD + 1) * Hin * row;
  }
};

__host__ __device__ inline int tr_weight_rows(const TrArgs& a, int n) {
  return (a.whole ? 18 : 8) * (a.Ci >> 3) * n;
}

size_t tr_smem_bytes(const TrArgs& a, int n) {
  const TrGeometry g(a);
  return kTableBytes + 16 * ((size_t)g.a_rows + tr_weight_rows(a, n)) +
         2 * 64 * stage_stride(n) * sizeof(float);
}

// Copy the weights of global K steps [s0, s0 + steps) to shared memory as
// B's core matrices, (2 steps, N, 8) rows of 16 bytes; a row of a channel >=
// 2 Co or of the even w parity at w offset 1 (no tap) is zero-filled.
template <int N>
__device__ __forceinline__ void load_tr_weights(uint32_t dst, const TrArgs& a, int nch, int s0,
                                                int steps) {
  const int n2 = 2 * a.Co;
  for (int r = threadIdx.x; r < 2 * steps * N; r += kThreads) {
    const int ql = r / N, col = r % N, ow = ql & 1;
    int p, c, t;
    tr_step(s0 + (ql >> 1), nch, p, c, t);
    const int q = c * 18 + 2 * (tr_first_step(p, 1) + t) + ow;
    const bool in = col < n2 && (ow == 0 || col >= a.Co);
    cp_async16(dst + 16 * r, in ? a.w + ((size_t)q * n2 + col) * 8 : a.w, in ? 16 : 0);
  }
}

template <int N, typename TO>
__global__ void __launch_bounds__(kThreads) trconv_tc_kernel(const TrArgs a) {
  constexpr int MB = Tile<N>::MB;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* table = reinterpret_cast<uint64_t*>(smem);
  const TrGeometry g(a);
  const uint32_t tile_a = smem_u32(smem + kTableBytes);
  const uint32_t tile_w = tile_a + 16u * g.a_rows;
  const int nsteps = tr_first_step(4, g.nch);

  const int tile_h = 8 * a.BH;
  const int w0 = blockIdx.x * 8, h0 = blockIdx.y * tile_h;
  // this block's GEMMs [p_lo, p_hi): the blocks of the later GEMMs, which
  // have more taps, come first in the grid, so that a launch's last wave
  // holds the cheapest GEMM's blocks
  const int tiles_z = a.Nb * a.dtiles, z = blockIdx.z % tiles_z;
  const int p_lo = 4 / a.groups * (a.groups - 1 - (int)blockIdx.z / tiles_z);
  const int p_hi = p_lo + 4 / a.groups;
  const int n = z / a.dtiles, d0 = (z % a.dtiles) * a.TD;

  // 1. the coarse input tile and its far-end halo, [d][h][chunk][w] rows of
  //    16 bytes; zero outside the volume
  const __nv_bfloat16* xb = a.x + (size_t)n * a.Di * a.Hi * a.Wi * a.Ci;
  const int vectors = (a.TD + 1) * g.Hin * 9 * g.nch;
  for (int v = threadIdx.x; v < vectors; v += kThreads) {
    const int c = v % g.nch;
    int r = v / g.nch;
    const int lw = r % 9;
    r /= 9;
    const int lh = r % g.Hin, ld = r / g.Hin;
    const int id = d0 + ld, ih = h0 + lh, iw = w0 + lw;
    const bool in = id < a.Di && ih < a.Hi && iw < a.Wi;
    const __nv_bfloat16* src =
        in ? xb + (((size_t)id * a.Hi + ih) * a.Wi + iw) * a.Ci + c * 8 : a.x;
    cp_async16(tile_a + 16 * ((ld * g.Hin + lh) * g.row + c * 9 + lw), src, in ? 16 : 0);
  }
  // 2. the weights (of all the block's GEMMs, or of its first), one A
  //    descriptor per K step: its w offsets 0 and 1 are one row apart (LBO 1)
  const int s_lo = tr_first_step(p_lo, g.nch);
  load_tr_weights<N>(tile_w, a, g.nch, s_lo,
                     tr_first_step(a.whole ? p_hi : p_lo + 1, g.nch) - s_lo);
  for (int s = threadIdx.x; s < nsteps; s += kThreads) {
    int p, c, t;
    tr_step(s, g.nch, p, c, t);
    const int od = t / ((p & 1) + 1), oh = t % ((p & 1) + 1);
    table[s] = descriptor(tile_a + 16 * ((od * g.Hin + oh) * g.row + c * 9), 1, g.row);
  }
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128;
  uint32_t base[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int b = wg * MB + i, bd = b / a.BH, bh = b % a.BH;
    base[i] = (uint32_t)((bd * g.Hin + 8 * bh) * g.row);
  }
  const uint64_t desc_w = descriptor(tile_w, N, 8);
  constexpr int SS = stage_stride(N);
  float* stage = reinterpret_cast<float*>(smem + kTableBytes +
                                          16 * ((size_t)g.a_rows + tr_weight_rows(a, N))) +
                 wg * 64 * SS;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int n2 = 2 * a.Co, vecs = n2 / 8;  // 8-channel vectors per GEMM row
  const int Do = 2 * a.Di, Ho = 2 * a.Hi, Wo = 2 * a.Wi;
  TO* y = static_cast<TO*>(a.y);
  const TO* res = static_cast<const TO*>(a.res);

  for (int p = p_lo; p < p_hi; ++p) {
    const int pd = p >> 1, ph = p & 1;
    const int s_begin = tr_first_step(p, g.nch), s_end = tr_first_step(p + 1, g.nch);
    if (!a.whole && p > p_lo) {
      __syncthreads();  // both warpgroups are done with the previous weights
      load_tr_weights<N>(tile_w, a, g.nch, s_begin, s_end - s_begin);
      cp_async_wait_all();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    const int s_w = a.whole ? s_lo : s_begin;  // the step whose weights lead tile_w
    // 3. this GEMM's products, flushed into `total` every kFlush K steps
    float acc[MB][N / 2], total[MB][N / 2];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[i][j] = total[i][j] = 0.0f;
    for (int s0 = s_begin; s0 < s_end; s0 += kFlush) {
      const int s1 = min(s0 + kFlush, s_end);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int s = s0; s < s1; ++s) {
        const uint64_t da = table[s];
        const uint64_t db = desc_w + (uint64_t)(2 * N * (s - s_w));
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
    // 4. epilogue of output parities (pd, ph, 0) and (pd, ph, 1), one M
    //    block at a time per warpgroup, as conv_tc_kernel's: column col is
    //    channel col % Co of w parity col / Co, and a row's 2 Co channels
    //    are fine w 2i and 2i + 1, consecutive in memory
#pragma unroll
    for (int i = 0; i < MB; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + half * 8 + lane / 4;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          if (col >= n2) continue;
          const int co = col < a.Co ? col : col - a.Co;
          float v0 = total[i][4 * j + 2 * half] * a.scale[co] + a.offset[co];
          float v1 = total[i][4 * j + 2 * half + 1] * a.scale[co + 1] + a.offset[co + 1];
          if (a.relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          *reinterpret_cast<float2*>(stage + r * SS + col) = make_float2(v0, v1);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
      const int b = wg * MB + i, bd = b / a.BH, bh = b % a.BH;
      const int d = d0 + bd;
      for (int v = t; v < 64 * vecs; v += 128) {
        const int r = v / vecs, c8 = 8 * (v % vecs);
        const int h = h0 + 8 * bh + r / 8, w = w0 + r % 8;
        if (d >= a.Di || h >= a.Hi || w >= a.Wi) continue;
        const size_t pos =
            ((((size_t)n * Do + 2 * d + pd) * Ho + 2 * h + ph) * Wo + 2 * w) * a.Co + c8;
        float val[8];
        mdf::load8(stage + r * SS + c8, val);
        if (res) {
          float rv[8];
          mdf::load8(res + pos, rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) val[e] += rv[e];
        }
        mdf::store8(y + pos, val);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
    }
  }
}

template <int N, typename TO>
cudaError_t tr_launch(const TrArgs& a, int device, cudaStream_t stream) {
  const size_t smem = tr_smem_bytes(a, N);
  if (smem > (size_t)kMaxSmem || 2 * Tile<N>::MB != a.TD * a.BH || 2 * a.Co > N ||
      tr_first_step(4, a.Ci >> 3) * 8 > kTableBytes || 4 % a.groups)
    return cudaErrorInvalidValue;
  auto kernel = trconv_tc_kernel<N, TO>;
  const cudaError_t err = allow_max_smem<true, N, TO>((const void*)kernel, device);
  if (err != cudaSuccess) return err;
  const int tile_h = 8 * a.BH;
  const dim3 grid((unsigned)((a.Wi + 7) / 8), (unsigned)((a.Hi + tile_h - 1) / tile_h),
                  (unsigned)(a.Nb * a.dtiles * a.groups));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t tr_dispatch(const TrArgs& a, int n, int device, cudaStream_t st) {
  switch (n) {
    case 16: return tr_launch<16, TO>(a, device, st);
    case 32: return tr_launch<32, TO>(a, device, st);
    case 64: return tr_launch<64, TO>(a, device, st);
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

// The transposed conv (K3); returns cudaGetLastError() after the launch.
// ``w`` holds the packed (Ci/8 * 18, 2 Co, 8) weights; ``n`` is 2 Co padded
// to the kernel's N (16, 32 or 64); ``groups`` blocks share a coarse tile,
// each running 4 / groups of its GEMMs; ``whole`` keeps a block's weights
// in shared memory at once (else one GEMM's at a time).
extern "C" int mdf_trconv_tc(const void* x, const void* w, const void* scale, const void* offset,
                             const void* res, void* y, int Nb, int Di, int Hi, int Wi, int Ci,
                             int Co, int n, int relu, int td, int bh, int groups, int whole,
                             int dtypes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Ci % 8 || Co % 8 || 2 * Co > n || groups < 1) return cudaErrorInvalidValue;
  const TrArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                 static_cast<const float*>(scale), static_cast<const float*>(offset),
                 res, y, Nb, Di, Hi, Wi, Ci, Co, relu, td, bh, groups, whole,
                 (Di + td - 1) / td};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_BF16_BF16: return tr_dispatch<__nv_bfloat16>(a, n, device, st);
    case MDF_BF16_F32: return tr_dispatch<float>(a, n, device, st);
    default: return cudaErrorInvalidValue;
  }
}
