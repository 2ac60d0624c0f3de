// A chain of 2D convolutions in one launch, each layer's output kept in
// shared memory for the next: the bf16 route of K5 (ops/cuda/conv_kernel.py
// conv2d_chain, chain_route "fused").
//
// Replaces K5 mdfnet_tpu/ops/pallas/conv2d_kernel.py:654 conv2d_chain_fused.
//
// What it computes: NHWC bf16 input, layers l = 0 .. L-1 of k x k convs (k in
// {1, 3, 5}) with torch padding (k-1)/2, all at stride 1 but the last (1 or
// 2), each y_l = relu?(conv(y_{l-1}) * scale + offset) (+ y_j of an earlier
// layer j: the Res blocks' skips) with f32 accumulation, every intermediate
// rounded to bf16 as the plain chain rounds it (_conv_plain per layer); the
// last layer stored as bf16 or f32.
//
// What bounds it on the H100: the bytes of the chain's input and output
// (3.35 TB/s); its products are few (the backbone trunk, 1184 x 1600 x 5
// views, 3 -> 8 -> 8 -> 16 with a 5x5 stride-2 tail: 133 MB, 19 GFLOP). Run as
// one launch per layer, every full-resolution intermediate goes to device
// memory and back: 606 MB for the trunk's two 8-channel maps, 4.5x the
// whole chain's bytes.
//
// Design: a block of two warpgroups owns a th x tw tile of the last layer's
// output and computes every earlier layer over the region the later layers
// read (the tile plus the sum of the later pads, doubled by a stride-2
// tail), padded to whole M blocks, so the halo is recomputed at the tile
// edges and nothing but the input is read. Each layer is conv_tc.cu's
// implicit GEMM (wgmma, A and B from shared memory, no swizzle): a buffer
// holds a layer's output as 16-byte rows [h][chunk of 8 channels][w
// parity][w / parity], so every K chunk of the next layer is one descriptor
// at a shifted start, and the epilogue (folded BN, ReLU, the skip read from
// its buffer, the bf16 rounding, zero outside the image, which is the next
// layer's padding) writes the accumulators straight into that layout. Only
// the last layer goes to device memory. A stride-1 layer to 8 channels
// computes two outputs along w per GEMM row (P = 2, N = 16: a window of k +
// 1 input columns, the weights of each output shifted by its column), so a
// row's address and bounds work and its A bytes serve twice the outputs;
// its input buffer splits w by parity, as a stride-2 layer's does. A buffer
// lives until its last reader (the next layer, or the layer that adds it as
// a skip) and its bytes then serve a later one; ops/cuda/conv_kernel.py
// chain_plan lays out the shared memory at the chain's tile and cuts a
// chain whose block would not fit two to an SM into launches of two layers
// or more, leaving a layer that starts none to the per-layer kernels (this
// file checks the plan it is given). A warpgroup takes two M blocks a pass,
// so a thread fits in 80 registers and three blocks of up to 75 KB share an
// SM: every step of a layer waits on shared memory or the tensor cores, and
// more warps hide more of that. The input tile is copied once: by 16-byte
// cp.async per 8-channel chunk, or, for a 3x3 head from Ci = 1 or 3 to 8
// channels (refine's depth,
// the trunk's RGB), as raw rows of 2 or 6 bytes a pixel from a 16-byte
// aligned w origin. Such a head runs on the tensor cores too: for each pass
// of M blocks the block gathers each row's 3 x 4 window x Ci values into a
// packed A of K = 16 (Ci = 1) or 48 (Ci = 3) and multiplies it by weights
// packed alike (conv_kernel.py pack_head_weight). Each generic-proxy store
// to shared memory that a wgmma reads next is followed by fence.proxy.async
// and a barrier. The layers' weights are all held in shared memory from the
// start.
//
// What it reaches (chip_smoke.py, PERF.md section 6): a position costs
// about what it costs in conv_tc.cu, so the recomputed halos decide; the
// written rule (conv_kernel.py CHAIN_FUSED) runs here only the chain it
// runs faster than the per-layer launches, the backbone trunk (its first
// two layers; the stride-2 tail on conv_tc.cu).

#include <string.h>

#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;       // two warpgroups
constexpr int kMaxLayers = 12;
constexpr int kHeaderInts = 18;
constexpr int kLayerInts = 35;
constexpr int kPlanBytes = 1792;    // the largest plan, copied into shared memory
// M blocks of 8 x 8 GEMM rows a warpgroup takes per pass, and blocks an SM
// holds: with two blocks a pass (32 accumulator registers) a block fits in 80
// registers a thread, so three blocks share an SM where their shared memory
// fits (24 warps an SM: the layers' steps wait on shared memory and the
// tensor cores, so more warps hide more of it)
constexpr int kMB = 2;
constexpr int kBlocksPerSm = 3;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

using mdf::cp_async16;
using mdf::descriptor;
using mdf::kFlush;
using mdf::smem_u32;
using mdf::Tile;
using mdf::Wgmma;

// A layer's output buffer in shared memory: byte offset, 8-channel chunks,
// rows per (h, chunk) (w), 1 or 2 (the w parity split), h rows.
struct Buf {
  int off, nch, wb, par, hb;
};

// One layer of a launch (conv_kernel.py _chain_segment writes these ints).
struct ChainLayer {
  int k, s, ci, co, n;  // taps a side, stride, channels in / out, N (P Co padded)
  int p;                // P: outputs along w a GEMM row computes (1 or 2)
  int q, q_real;        // K chunks of 8 (even), of which real
  int relu, res;        // ReLU; the earlier layer added after it, or -1
  Buf in, rb, out;      // A's buffer (the head: its packed A), the skip's, the output's
  int c;                // the region starts c before the layer's output tile origin
  int eh, ew, ph, pw;   // positions the later layers read; computed (8 x 8 blocks)
  int res_dc;           // the region's offset within the skip's region
  int w_smem, w_glob;   // B's shared-memory bytes offset; packed weights' element offset
  int so, tab;          // scale / offset index; first K-step descriptor
};

struct ChainPlan {
  int nl, th, tw;       // layers; the last layer's output tile
  int mx, cx;           // input tile origin: mx * tile origin - cx
  int head, ci0;        // a packed head (Ci = 1 or 3); the input's channels
  int x_off, x_nch, x_wb, x_par, x_hb, x_w, shift;  // input tile (raw: x_w pixels a row)
  int pack_off, smem, tab_entries, reserved;
  ChainLayer L[kMaxLayers];
};
static_assert(sizeof(ChainLayer) == kLayerInts * sizeof(int), "ChainLayer is the plan's record");
static_assert(sizeof(ChainPlan) == (kHeaderInts + kMaxLayers * kLayerInts) * sizeof(int),
              "ChainPlan is the plan's ints");
static_assert(sizeof(ChainPlan) <= kPlanBytes, "the plan fits its shared memory");

// Shared-memory bytes of a plan of nl layers (its header and records, to
// 128 bytes): the K-step descriptor table follows it, then the weights.
__host__ __device__ __forceinline__ int plan_bytes(int nl) {
  return (4 * (kHeaderInts + nl * kLayerInts) + 127) / 128 * 128;
}

struct ChainArgs {
  const __nv_bfloat16* x;  // (Nb, H, W, Ci)
  const __nv_bfloat16* w;  // each layer's packed (q_real, Co, 8) K chunks, one after another
  const float* scale;      // each layer's (Co), one after another
  const float* offset;
  void* y;                 // (Nb, Ho, Wo, Co of the last layer)
  int Nb, H, W, Ho, Wo;
  ChainPlan p;
};

// A buffer's geometry in registers: its rows per h, per chunk, the offset of
// the odd w parity and the parity shift (par 1: 0, par 2: 1), so a row costs
// no division.
struct Rows {
  int off, hrow, wb, odd, sh;
  __device__ __forceinline__ explicit Rows(const Buf& b)
      : off(b.off), hrow(b.nch * b.wb), wb(b.wb), odd(b.wb >> (b.par >> 1)), sh(b.par >> 1) {}
  // the 16-byte row of (h, chunk 0, w), as an index
  __device__ __forceinline__ int at(int h, int w) const {
    return h * hrow + (w & sh) * odd + (w >> sh);
  }
};

// 16-byte row of buffer b at (h, chunk c, w)
__device__ __forceinline__ int buf_row(const Buf& b, int h, int c, int w) {
  return Rows(b).at(h, w) + c * b.wb;
}

// Row of K chunk q of a buffer-fed layer, at output (0, 0): chunk order
// (kh, chunk, slot) over a window of k + P - 1 columns, the slots even
// columns first where the input splits w by parity (stride 2 or P = 2), as
// conv_kernel.py pack_chain_weight (and for P = 1 conv_tc.cu) orders them,
// so the rows rise along K.
__device__ __forceinline__ int chunk_row(int q, const ChainLayer& L) {
  const int nslot = L.k + L.p - 1, slot = q % nslot, t = q / nslot;
  const int c = t % L.in.nch, kh = t / L.in.nch;
  const int half = (nslot + 1) / 2;
  const int kw = L.in.par == 1 ? slot : (slot < half ? 2 * slot : 2 * (slot - half) + 1);
  return buf_row(L.in, kh, c, kw);
}

// Gather the packed head A of M blocks [b0, b0 + nblk) of layer L (K
// rows x K + P - 1 window columns, CI channels, Q chunks): per M block, per
// K chunk, 64 rows of 8 K values (kh * (K + P - 1) + kw') * CI + c, zero
// past the window. A thread takes whole rows (P outputs along w), its
// values at offsets known when compiling.
template <int CI, int K, int P>
__device__ __forceinline__ void pack_head(const ChainPlan& p, const ChainLayer& L, uint8_t* smem,
                                          int b0, int nblk) {
  constexpr int NS = K + P - 1, Q = (K * NS * CI + 15) / 16 * 2;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem + p.x_off);
  uint4* dst = reinterpret_cast<uint4*>(smem + p.pack_off);
  const int nbw = L.pw / (8 * P), rowpx = p.x_w * CI, s = L.s;
  // each kh row's K + P - 1 window columns are RUN consecutive values of a
  // raw input row; where every run starts on a 4-byte boundary (an even
  // shift: the trunk's) a row is gathered as 32-bit words
  constexpr int RUN = NS * CI;
  const bool words = RUN % 2 == 0 && p.shift * CI % 2 == 0;
  for (int u = threadIdx.x; u < nblk * 64; u += kThreads) {
    const int r = u % 64, bi = u / 64, b = b0 + bi;
    const int bh = b / nbw, h = 8 * bh + r / 8, g = 8 * (b - bh * nbw) + r % 8;
    const __nv_bfloat16* px = xs + (s * h) * rowpx + (p.shift + s * P * g) * CI;
    if (words) {
      uint32_t v[4 * Q];
#pragma unroll
      for (int e = 0; e < 4 * Q; ++e) {
        constexpr int kWords = K * RUN / 2;
        const int kh = e / (RUN / 2), m = e % (RUN / 2);
        v[e] = e < kWords ? reinterpret_cast<const uint32_t*>(px + kh * rowpx)[m] : 0u;
      }
#pragma unroll
      for (int kc = 0; kc < Q; ++kc)
        dst[(bi * Q + kc) * 64 + r] = make_uint4(v[4 * kc], v[4 * kc + 1], v[4 * kc + 2], v[4 * kc + 3]);
      continue;
    }
    __nv_bfloat16 vals[8 * Q];
#pragma unroll
    for (int kk = 0; kk < 8 * Q; ++kk) {
      constexpr int kValues = K * NS * CI;
      const int col = kk / CI, c = kk % CI;
      vals[kk] = kk < kValues ? px[(col / NS) * rowpx + (col % NS) * CI + c]
                              : __float2bfloat16_rn(0.0f);
    }
#pragma unroll
    for (int kc = 0; kc < Q; ++kc) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 pair;
        pair.x = vals[8 * kc + 2 * e];
        pair.y = vals[8 * kc + 2 * e + 1];
        v[e] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      dst[(bi * Q + kc) * 64 + r] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Two consecutive output channels, as TO.
__device__ __forceinline__ void store2(__nv_bfloat16* y, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store2(float* y, float v0, float v1) {
  *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
}

// One layer over every M block of its region, two warpgroups of MB blocks
// per pass (alternate blocks, so a pass of few blocks still gives both
// warpgroups work); the epilogue writes the layer's output buffer, or for the
// last layer the output (TO).
template <int N, int P, typename TO>
__device__ __forceinline__ void run_layer(const ChainArgs& a, const ChainPlan& p, int l,
                                          uint8_t* smem, const uint64_t* table, int t0h,
                                          int t0w, int n) {
  constexpr int MB = kMB;
  const ChainLayer& L = p.L[l];
  const uint32_t sbase = smem_u32(smem);
  const bool last = l == p.nl - 1, head = l == 0 && p.head;
  const int co = L.co, relu = L.relu, res = L.res;
  const int nbw = L.pw / (8 * P), nmb = (L.ph / 8) * nbw, steps = L.q / 2, tab = L.tab;
  const int a_hrow = L.s * L.in.nch * L.in.wb;
  const Rows out(L.out), rb(L.rb);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // the thread's part of the addresses of its two rows' outputs (positions
  // (2 warp + half, P (lane / 4) + pp) of a block, pp < P): the output
  // buffer's and the skip's rows (bytes, 4 bytes a channel pair folded in),
  // the output's elements (the last layer)
  int thr_o[2][2], thr_r[2][2], thr_y[2][2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int rh = 2 * warp + half, rw = P * (lane / 4) + pp;
      thr_o[half][pp] = out.off + 16 * out.at(rh, rw) + 4 * (lane % 4);
      thr_r[half][pp] = rb.off + 16 * rb.at(rh + L.res_dc, rw + L.res_dc) + 4 * (lane % 4);
      thr_y[half][pp] = (rh * a.Wo + rw) * co + 2 * (lane % 4);
    }
  // accumulator column group j (8 columns) is chunk cc of output pp of the
  // row: with P = 2 (N = 2 Co = 16) the second group is the second output
  auto output_of = [](int j) { return P == 2 && j >= N / 16 ? 1 : 0; };
  // the region's origin in the layer's output grid, and that grid
  const int mult = last ? 1 : p.mx;
  const int oh = mult * t0h - L.c, ow = mult * t0w - L.c;
  const int gh = last ? a.Ho : a.H, gw = last ? a.Wo : a.W;
  // this thread's channel pairs' folded BN
  float sc[N / 8][2], of[N / 8][2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * (j - output_of(j) * (N / 16)) + 2 * (lane % 4);
    const bool live = col < co;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[j][e] = live ? a.scale[L.so + col + e] : 0.0f;
      of[j][e] = live ? a.offset[L.so + col + e] : 0.0f;
    }
  }
  // B: core matrices of 8 output channels x 8 K values, N rows per K chunk
  const uint64_t desc_w = descriptor(sbase + L.w_smem, N, 8);
  for (int b0 = 0; b0 < nmb; b0 += 2 * MB) {
    // a head (3x3, to 8 channels, two outputs a row) runs in run_layer<16, 2>
    if (P == 2 && head) {
      if (b0) __syncthreads();  // both warpgroups are done with the last pass's A
      const int nblk = min(2 * MB, nmb - b0);
      if (p.ci0 == 3) pack_head<3, 3, P>(p, L, smem, b0, nblk);
      else pack_head<1, 3, P>(p, L, smem, b0, nblk);
      mdf::fence_proxy_async();
      __syncthreads();
    }
    // a block past the region's last (the last pass) runs on the last
    // block's rows and stores nothing: every wgmma runs on every path, none
    // is serialized behind a divergent branch
    uint32_t base[MB];
    int bh[MB], bw[MB];
    bool live[MB];
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int bi = 2 * i + wg, b = min(b0 + bi, nmb - 1);
      live[i] = b0 + bi < nmb;
      bh[i] = b / nbw;
      bw[i] = b - bh[i] * nbw;
      base[i] = head ? (uint32_t)((b - b0) * L.q * 64) : (uint32_t)(8 * bh[i] * a_hrow + 8 * bw[i]);
    }
    // every kFlush K steps the tensor cores' partial sums go into `total`;
    // a P = 2 layer (3x3 from 8 channels, or a head) has at most kFlush K
    // steps (plan_ok), so its sums stay in `acc`, 16 registers fewer
    constexpr bool kFlushes = P == 1;
    float acc[MB][N / 2], total[MB][N / 2];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[i][j] = total[i][j] = 0.0f;
    for (int s0 = 0; s0 < steps; s0 += kFlush) {
      const int s1 = min(s0 + kFlush, steps);
      mdf::wgmma_fence();
      for (int s = s0; s < s1; ++s) {
        const uint64_t da = table[tab + s];
        const uint64_t db = desc_w + (uint64_t)(2 * N * s);
#pragma unroll
        for (int i = 0; i < MB; ++i) Wgmma<N>::mma(acc[i], da + base[i], db, s > s0);
      }
      mdf::wgmma_commit_and_wait();
      if (kFlushes) {
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int j = 0; j < N / 2; ++j) total[i][j] += acc[i][j];
      }
    }
    // epilogue: thread t holds rows warp*16 + lane/4 (+8), i.e. GEMM rows
    // (2 warp + half, lane / 4) of an 8 x 8 block, each P outputs along w,
    // and channel pairs 8j + 2 (lane % 4) (output_of(j)'s chunk cc); each
    // address is the block's part plus the thread's (thr_*), and a block
    // that lies inside the image skips the per-output test
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      if (!live[i]) continue;
      const int hb = 8 * bh[i], wb = 8 * P * bw[i];
      const bool interior =
          oh + hb >= 0 && oh + hb + 8 <= gh && ow + wb >= 0 && ow + wb + 8 * P <= gw;
      const int oblk = hb * out.hrow + (wb >> out.sh), rblk = hb * rb.hrow + (wb >> rb.sh);
      TO* yblk = last ? static_cast<TO*>(a.y) + (((size_t)n * a.Ho + oh + hb) * a.Wo + ow + wb) * co
                      : nullptr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ih = oh + hb + 2 * warp + half;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int pj = output_of(j), cc = j - pj * (N / 16);
          if (8 * cc + 2 * (lane % 4) >= co) continue;
          const int iw = ow + wb + P * (lane / 4) + pj;
          const bool in = interior || (ih >= 0 && ih < gh && iw >= 0 && iw < gw);
          // selects, not an index: the arrays stay in registers
          const int to = pj ? thr_o[half][1] : thr_o[half][0];
          const int tr = pj ? thr_r[half][1] : thr_r[half][0];
          const int ty = pj ? thr_y[half][1] : thr_y[half][0];
          const uint8_t* rrow = smem + 16 * rblk + tr + 16 * cc * rb.wb;
          uint8_t* orow = smem + 16 * oblk + to + 16 * cc * out.wb;
          const int e = 4 * j + 2 * half;
          float v0 = (kFlushes ? total[i][e] : acc[i][e]) * sc[j][0] + of[j][0];
          float v1 = (kFlushes ? total[i][e + 1] : acc[i][e + 1]) * sc[j][1] + of[j][1];
          if (relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          if (res >= 0) {
            const float2 f =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rrow));
            v0 += f.x;
            v1 += f.y;
          }
          if (last) {
            if (in) store2(yblk + ty + 8 * cc, v0, v1);
          } else {
            // zero outside the image: the next layer's padding
            *reinterpret_cast<__nv_bfloat162*>(orow) =
                in ? __floats2bfloat162_rn(v0, v1) : __floats2bfloat162_rn(0.0f, 0.0f);
          }
        }
      }
    }
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) conv_chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  // the plan, from the parameters into shared memory (read by every thread)
  {
    const int* src = reinterpret_cast<const int*>(&a.p);
    int* dst = reinterpret_cast<int*>(smem);
    const int words = kHeaderInts + a.p.nl * kLayerInts;
    for (int i = threadIdx.x; i < words; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();
  const ChainPlan& p = *reinterpret_cast<const ChainPlan*>(smem);
  uint64_t* table = reinterpret_cast<uint64_t*>(smem + plan_bytes(p.nl));
  const uint32_t sbase = smem_u32(smem);
  const int t0w = blockIdx.x * p.tw, t0h = blockIdx.y * p.th, n = blockIdx.z;

  // 1. every layer's weights as B's core matrices, (Q, N, 8) rows of 16
  //    bytes; a row of a channel >= Co or of the zero pair is zero-filled
  for (int l = 0; l < p.nl; ++l) {
    const ChainLayer& L = p.L[l];
    const int nsh = __ffs(L.n) - 1;   // N is a power of 2
    const int cols = L.p * L.co;   // the packed weights' columns per K chunk
    for (int r = threadIdx.x; r < L.q * L.n; r += kThreads) {
      const int q = r >> nsh, col = r & (L.n - 1);
      const bool in = col < cols && q < L.q_real;
      cp_async16(sbase + L.w_smem + 16 * r,
                 in ? a.w + L.w_glob + ((size_t)q * cols + col) * 8 : a.w, in ? 16 : 0);
    }
  }
  // 2. the input tile; zero outside the image (the first layer's padding)
  const int oxh = p.mx * t0h - p.cx, oxw = p.mx * t0w - p.cx;
  const __nv_bfloat16* xb = a.x + (size_t)n * a.H * a.W * p.ci0;
  if (p.head && a.W % 8 == 0) {
    // raw rows of x_w pixels from oxw - shift, a multiple of 8: 16-byte
    // units, Ci of them per 8 pixels, each group wholly in or out
    const int upr = p.x_w * p.ci0 / 8, x0 = oxw - p.shift;
    for (int v = threadIdx.x; v < p.x_hb * upr; v += kThreads) {
      const int lh = v / upr, u = v % upr, px = x0 + 8 * (u / p.ci0);
      const int ih = oxh + lh;
      const bool in = ih >= 0 && ih < a.H && px >= 0 && px + 8 <= a.W;
      cp_async16(sbase + p.x_off + 16 * v,
                 in ? xb + ((size_t)ih * a.W + px) * p.ci0 + (u % p.ci0) * 8 : a.x, in ? 16 : 0);
    }
  } else if (p.head) {
    // rows not 16-byte aligned: element by element
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + p.x_off);
    const int row = p.x_w * p.ci0, x0 = oxw - p.shift;
    for (int e = threadIdx.x; e < p.x_hb * row; e += kThreads) {
      const int lh = e / row, px = x0 + (e % row) / p.ci0, c = e % p.ci0;
      const int ih = oxh + lh;
      const bool in = ih >= 0 && ih < a.H && px >= 0 && px < a.W;
      xs[e] = in ? xb[((size_t)ih * a.W + px) * p.ci0 + c] : __float2bfloat16_rn(0.0f);
    }
  } else {
    // a thread per pixel, its chunks in turn
    const Rows xt(Buf{p.x_off, p.x_nch, p.x_wb, p.x_par, p.x_hb});
    for (int v = threadIdx.x; v < p.x_hb * p.x_wb; v += kThreads) {
      const int lh = v / p.x_wb, lw = v - lh * p.x_wb;
      const int ih = oxh + lh, iw = oxw + lw;
      const bool in = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      const __nv_bfloat16* src = in ? xb + ((size_t)ih * a.W + iw) * p.ci0 : a.x;
      const uint32_t dst = sbase + p.x_off + 16 * xt.at(lh, lw);
      for (int c = 0; c < p.x_nch; ++c)
        cp_async16(dst + 16 * c * xt.wb, in ? src + 8 * c : a.x, in ? 16 : 0);
    }
  }
  // 3. one A descriptor per K step of every layer: two K chunks, the second
  //    LBO rows after the first (0 for the zero-weight pair); the head's
  //    packed A: 64 rows per chunk
  for (int l = 0; l < p.nl; ++l) {
    const ChainLayer& L = p.L[l];
    for (int s = threadIdx.x; s < L.q / 2; s += kThreads) {
      if (l == 0 && p.head) {
        table[L.tab + s] = descriptor(sbase + p.pack_off + 16 * 128 * s, 64, 8);
      } else {
        const int r0 = chunk_row(2 * s, L);
        const int r1 = 2 * s + 1 < L.q_real ? chunk_row(2 * s + 1, L) : r0;
        table[L.tab + s] =
            descriptor(sbase + L.in.off + 16 * r0, r1 - r0, L.s * L.in.nch * L.in.wb);
      }
    }
  }
  mdf::cp_async_wait_all();
  mdf::fence_proxy_async();
  __syncthreads();

  // 4. the layers; each one's stores are fenced for the next one's wgmma
  for (int l = 0; l < p.nl; ++l) {
    // N, and P (2 only at N = 16: two outputs of 8 channels; a head is 3x3)
    switch (p.L[l].n * p.L[l].p) {
      case 8: run_layer<8, 1, TO>(a, p, l, smem, table, t0h, t0w, n); break;
      case 16: run_layer<16, 1, TO>(a, p, l, smem, table, t0h, t0w, n); break;
      case 32:
        if (p.L[l].p == 2) run_layer<16, 2, TO>(a, p, l, smem, table, t0h, t0w, n);
        else run_layer<32, 1, TO>(a, p, l, smem, table, t0h, t0w, n);
        break;
    }
    mdf::fence_proxy_async();
    __syncthreads();
  }
}

// The plan's checks: every buffer a layer reads or writes lies inside its
// extents and the block's shared memory, so no plan reads or writes past
// them.
bool plan_ok(const ChainPlan& p, int smem_limit) {
  if (p.nl < 1 || p.nl > kMaxLayers || p.smem > smem_limit || p.th % 8 || p.tw % 8 ||
      p.th <= 0 || p.tw <= 0 || p.tab_entries < 0 ||
      (p.head && p.ci0 != 1 && p.ci0 != 3) || (!p.head && (p.ci0 % 8 || p.x_nch * 8 != p.ci0)))
    return false;
  auto inside = [&](const Buf& b, int h, int w) {
    return b.nch > 0 && b.par >= 1 && b.wb % b.par == 0 && h <= b.hb && w <= b.wb &&
           b.off >= plan_bytes(p.nl) + 8LL * p.tab_entries &&
           (long long)b.off + 16LL * b.hb * b.nch * b.wb <= p.smem;
  };
  long long wend = plan_bytes(p.nl) + 8LL * p.tab_entries;
  for (int l = 0; l < p.nl; ++l) {
    const ChainLayer& L = p.L[l];
    const bool last = l == p.nl - 1, head = l == 0 && p.head;
    if ((L.n != 8 && L.n != 16 && L.n != 32) || (L.p != 1 && L.p != 2) || L.p * L.co > L.n ||
        (L.p == 2 && (L.s != 1 || L.co != 8 || L.n != 16 || L.q / 2 > kFlush)) || L.co % 8 ||
        L.q % 2 ||
        L.q_real > L.q || L.q_real < L.q - 1 || L.ph % 8 || L.pw % (8 * L.p) || L.eh > L.ph ||
        L.ew > L.pw || (last && (L.eh != L.ph || L.ew != L.pw)) || (L.s != 1 && !last) ||
        L.tab + L.q / 2 > p.tab_entries || L.w_smem < wend ||
        (long long)L.w_smem + 16LL * L.q * L.n > p.smem)
      return false;
    wend = L.w_smem + 16LL * L.q * L.n;
    const int rh = L.s * (L.ph - 1) + L.k, rw = L.s * (L.pw - 1) + L.k;
    if (head) {
      if (L.k != 3 || L.p != 2 || L.q != (L.k * (L.k + L.p - 1) * p.ci0 + 15) / 16 * 2 ||
          rh > p.x_hb ||
          p.shift + rw > p.x_w ||
          (long long)p.x_off + 2LL * p.x_hb * p.x_w * p.ci0 > p.smem ||
          (long long)p.pack_off + 2LL * kMB * L.q * 64 * 16 > p.smem)
        return false;
    } else if (L.in.nch * 8 != L.ci || L.q_real != L.k * (L.k + L.p - 1) * L.in.nch ||
               L.in.par != L.s * L.p || !inside(L.in, rh, rw)) {
      return false;
    }
    if (L.res >= 0 &&
        (L.res >= l || L.rb.nch * 8 != L.co ||
         !inside(L.rb, L.ph + L.res_dc, L.pw + L.res_dc)))
      return false;
    if (!last && !inside(L.out, L.ph, L.pw)) return false;
  }
  return true;
}

// Once per kernel instantiation and device: allow the most shared memory a
// block may take (a launch still takes only the bytes it asks for).
template <typename TO>
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> opted_in[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && opted_in[device].load()) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      conv_chain_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  // all of the SM's 256 KB of L1 as shared memory, so that two blocks of up
  // to 113 KB share an SM (the registers allow two)
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_chain_kernel<TO>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && known) opted_in[device].store(true);
  return err;
}

template <typename TO>
cudaError_t launch(const ChainArgs& a, int device, cudaStream_t stream) {
  const cudaError_t err = allow_max_smem<TO>(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.Wo + a.p.tw - 1) / a.p.tw),
                  (unsigned)((a.Ho + a.p.th - 1) / a.p.th), (unsigned)a.Nb);
  conv_chain_kernel<TO><<<grid, kThreads, a.p.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``plan`` is a
// host array of ``plan_ints`` ints (conv_kernel.py _chain_segment's), copied
// into the kernel's parameters; (Ho, Wo) is the last layer's output grid;
// dtypes is MDF_BF16_BF16 or MDF_BF16_F32 (the last layer's output).
extern "C" int mdf_conv_chain(const void* x, const void* w, const void* scale, const void* offset,
                              void* y, const void* plan, int plan_ints, int Nb, int H, int W,
                              int Ho, int Wo, int dtypes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  ChainArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
              static_cast<const float*>(scale), static_cast<const float*>(offset), y, Nb, H, W,
              Ho, Wo, {}};
  const int nl = plan_ints > 0 ? static_cast<const int*>(plan)[0] : 0;
  if (nl < 1 || nl > kMaxLayers || plan_ints != kHeaderInts + nl * kLayerInts || Nb < 1 ||
      Nb > 65535 || H < 1 || W < 1 || Ho < 1 || Wo < 1)
    return cudaErrorInvalidValue;
  memcpy(&a.p, plan, sizeof(int) * plan_ints);
  // the last layer's stride is the input tile's multiplier; (Ho, Wo) its grid
  const int s = a.p.L[nl - 1].s;
  if (!plan_ok(a.p, kMaxSmem) || (s != 1 && s != 2) || a.p.mx != s || Ho != (H + s - 1) / s ||
      Wo != (W + s - 1) / s)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_BF16_BF16: return launch<__nv_bfloat16>(a, device, st);
    case MDF_BF16_F32: return launch<float>(a, device, st);
    default: return cudaErrorInvalidValue;
  }
}
