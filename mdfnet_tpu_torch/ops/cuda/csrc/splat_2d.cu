// Adjoint of the plane-sweep bilinear sample: the gradient splat (K7).
//
// Replaces: mdfnet_tpu/ops/pallas/splat_kernel.py:129 pallas_splat_2d
// (kernel body _splat_kernel, line 52), the backward of the training warp
// (mdfnet_tpu/ops/warp_dense.py:173 _planes_sample_bwd).
//
// d_img[b, yi, xi, c] = sum over the samples n of image b and their taps
// (xi, yi) of  g[b, n, c] * wy_tap * wx_tap,  with the taps and weights of
// K6 (common.cuh bilinear_taps), in f32.
//
// Exact for any camera and deterministic, with no sort and no float
// atomics. The TPU kernel gathers each output tile from a row band and an x
// window of the samples, a contract that a strongly rotated camera breaks
// (and its caller drops the coverage flag); float atomics would add in any
// order. Here every pixel adds its (sample, tap) terms in ascending sample
// order, acc + (v * wy) * wx non-contracted: the order and the rounding of
// the sort-based kernel this one replaced, so its bits.
//
// The plan (ops/cuda/splat_kernel.py splat_plan, its one source) cuts each
// image into 32 x TH tiles, TH = 8 * 32 / CPT for CPT channels a block (8,
// 16 or 32: the most of them that divide C), so that a block's sums take
// 32 registers a thread. A sample belongs to each tile that one of its
// in-image taps falls in (1, 2 or 4 tiles), but for a sample that
// bilinear_taps snaps to -1 along x or y: all its in-image terms have
// weight 0, which changes no sum unless its g value is not finite. The
// launches, in order:
//   1. splat_count_kernel: per chunk of samples (one block) and tile, how
//      many of the chunk's samples belong to the tile; it lists the snapped
//      samples whose g row holds an infinite or NaN value;
//   2. splat_scan_rows_kernel, splat_scan_tiles_kernel: exclusive scans
//      give each (tile, chunk) its first slot in the tile's bin;
//   3. splat_bin_kernel: each chunk writes its samples' flat indices into
//      their tiles' bins, ranked by warp ballots within a warp's run and by
//      per-warp counts across the block, so each bin holds its samples in
//      ascending order (a stable counting sort by tile);
//   4. splat_reduce_kernel: one block per (tile, CPT channels) walks its bin
//      in chunks of 256 RS samples (Rows). A chunk's samples are sorted
//      stably by their base tap (x0, y0) into the tile's 33 x (TH + 1)
//      cells (a base in the tile or one pixel left of or above it); a
//      pixel takes tap k from the cell of base pixel - (k & 1, k >> 1), so
//      its terms in sample order are the merge of 4 cells' runs, into which
//      each sample writes itself at its rank (binary searches in the 8
//      cells around its own). Each thread owns 32 / CPT pixels of a column
//      and sums their lists from shared memory, where the chunk's g rows
//      came by cp.async, into registers kept across chunks. Each tile of
//      out is written once;
//   5. splat_nan_kernel: the listed snapped samples' NaN terms.
//
// What bounds it on the H100: the bytes of g (each row read once from
// DRAM), of the coordinates (read by the count, the bin and the reduce
// pass) and of the bins (4 B a sample and tile, written once and read once
// a channel group), against a serial walk of each bin: one block sums a
// tile in sample order. So the reduce keeps the next chunk's indices and
// coordinates in flight in registers and the chunk's g rows in flight
// while it sorts the chunk, and a term costs shared-memory reads of its
// sample and tap, its weights and its CPT values.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBinThreads = 256;
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kBinRounds = 4;          // a bin block's chunk: 1024 samples
constexpr int kScanThreads = 256;
constexpr int kTileScanThreads = 1024;
constexpr int kThreads = 256;          // reduce
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 32;                // tile columns (one a lane)
constexpr int kCW = kTW + 1;           // cell columns
constexpr int kSW = 5;                 // log2(kTW)
constexpr size_t kReduceSmem = 72 * 1024;   // a reduce block's shared memory, at most

// The reduce's tile for CPT channels a block: 32 x TH pixels, PPT = TH / 8
// a thread (rows warp + 8 q of column lane), a chunk of P = 32 TH samples
// (PPT a lane), CELLS base cells.
template <int CPT>
struct Geo {
  static constexpr int PPT = 32 / CPT;
  static constexpr int TH = 8 * PPT;
  static constexpr int P = kTW * TH;
  static constexpr int CELLS = kCW * (TH + 1);
};

// A coordinate that bilinear_taps snaps to -1 (outside the image, or NaN):
// every in-image tap of its sample then has weight 0 along that axis, so
// the sample adds (v * wy) * 0 or (v * 0) * wx to each of its pixels: +-0
// where v is finite, which leaves a sum that starts at +0 as it is (a sum
// of such adds is never -0), and NaN where v is not.
__device__ __forceinline__ bool snapped(float x, float y, int H, int W) {
  return !(x > -1.0f && x < (float)W) || !(y > -1.0f && y < (float)H);
}

// The tiles that a sample's in-image taps fall in: slot 0 (ty0, tx0), slot
// 1 (ty0, tx1), slot 2 (ty1, tx0), slot 3 (ty1, tx1), bit k of `valid` where
// slot k is a tile of its own; none for a snapped sample, whose terms
// splat_nan_kernel applies. sh = log2(TH).
struct SampleTiles {
  int t[4];
  unsigned valid;
};

__device__ __forceinline__ SampleTiles sample_tiles(float x, float y, int H, int W, int sh,
                                                    int tiles_x) {
  const mdf::Taps tp = mdf::bilinear_taps(x, y, H, W);
  const int tx0 = max(tp.x0, 0) >> kSW, tx1 = min(tp.x0 + 1, W - 1) >> kSW;
  const int ty0 = max(tp.y0, 0) >> sh, ty1 = min(tp.y0 + 1, H - 1) >> sh;
  const bool dx = tx1 != tx0, dy = ty1 != ty0;
  SampleTiles s;
  s.t[0] = ty0 * tiles_x + tx0;
  s.t[1] = ty0 * tiles_x + tx1;
  s.t[2] = ty1 * tiles_x + tx0;
  s.t[3] = ty1 * tiles_x + tx1;
  s.valid = snapped(x, y, H, W) ? 0u
                                : 1u | (dx ? 2u : 0u) | (dy ? 4u : 0u) | (dx && dy ? 8u : 0u);
  return s;
}

// Whether any of the C values at p is infinite or NaN (p 16-byte aligned).
template <typename T>
__device__ __forceinline__ bool any_nonfinite(const T* p, int C) {
  bool bad = false;
  for (int c = 0; c < C; c += 8) {
    float v[8];
    mdf::load8(p + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) bad |= !isfinite(v[i]);
  }
  return bad;
}

// Calls on(X, m, hit, leader) once for each tile X that a lane's pending
// slots name, the lowest lane first: m has a bit for each lane that holds
// X, hit says whether this lane does, leader marks the lowest such lane.
// Every lane of the warp takes part (pending = 0 for a lane with no sample).
template <typename F>
__device__ __forceinline__ void for_each_tile(const SampleTiles& s, unsigned pending, F&& on) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    const unsigned active = __ballot_sync(kFull, pending != 0);
    if (!active) break;
    const int leader = __ffs(active) - 1;
    const int k0 = pending ? __ffs(pending) - 1 : 0;
    const int first = k0 == 0 ? s.t[0] : k0 == 1 ? s.t[1] : k0 == 2 ? s.t[2] : s.t[3];
    const int X = __shfl_sync(kFull, first, leader);
    unsigned hit = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((pending >> k & 1u) && s.t[k] == X) hit = 1u << k;
    const unsigned m = __ballot_sync(kFull, hit != 0);
    on(X, m, hit != 0, lane == leader);
    pending &= ~hit;
  }
}

// Exclusive prefix of v over the block (blockDim.x a multiple of 32);
// total gets the block's sum. ws: 32 ints of shared memory, which the
// caller must not write again before its next __syncthreads. Every thread
// of the block calls it.
__device__ int block_exclusive_scan(int v, int* ws, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    ws[lane] = s;
  }
  __syncthreads();
  total = ws[nwarps - 1];
  return x - v + (warp ? ws[warp - 1] : 0);
}

// Exclusive scan of a[0, n) in place by the whole block, each thread over a
// run of consecutive elements; returns the sum.
__device__ int block_scan_inplace(int* a, int n, int* ws) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int total;
  int run = block_exclusive_scan(s, ws, total);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  return total;
}

// counts[(b * tiles + t) * chunks + chunk]: the chunk's samples in tile t;
// a snapped sample whose g row holds an infinite or NaN value is appended
// to nan_list (nan_list[0] counts them; their order does not matter).
template <typename T>
__global__ void __launch_bounds__(kBinThreads) splat_count_kernel(
    const T* __restrict__ g, const float* __restrict__ xs, const float* __restrict__ ys,
    int* __restrict__ counts, int* __restrict__ nan_list, int N, int H, int W, int C, int sh,
    int tiles_x, int tiles, int chunks) {
  extern __shared__ int hist[];   // (tiles)
  constexpr int chunk = kBinThreads * kBinRounds;
  const int b = blockIdx.y, ck = blockIdx.x;
  for (int t = threadIdx.x; t < tiles; t += kBinThreads) hist[t] = 0;
  __syncthreads();
  const long long base = (long long)b * N;
  float xr[kBinRounds], yr[kBinRounds];
#pragma unroll
  for (int r = 0; r < kBinRounds; ++r) {
    const int s = ck * chunk + r * kBinThreads + threadIdx.x;
    xr[r] = s < N ? xs[base + s] : 0.0f;
    yr[r] = s < N ? ys[base + s] : 0.0f;
  }
  bool bad[kBinRounds];
#pragma unroll
  for (int r = 0; r < kBinRounds; ++r) {
    const int s = ck * chunk + r * kBinThreads + threadIdx.x;
    const SampleTiles st = sample_tiles(xr[r], yr[r], H, W, sh, tiles_x);
    bad[r] = false;
    if (s >= N) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (st.valid >> k & 1u) atomicAdd(&hist[st.t[k]], 1);   // an integer count
    bad[r] = !st.valid && any_nonfinite(g + (base + s) * C, C);
  }
#pragma unroll
  for (int r = 0; r < kBinRounds; ++r)
    if (bad[r])
      nan_list[1 + atomicAdd(nan_list, 1)] = (int)(base + ck * chunk + r * kBinThreads + threadIdx.x);
  __syncthreads();
  for (int t = threadIdx.x; t < tiles; t += kBinThreads)
    counts[((long long)b * tiles + t) * chunks + ck] = hist[t];
}

// Each (image, tile) row of counts -> its exclusive prefix; its sum -> starts.
__global__ void __launch_bounds__(kScanThreads) splat_scan_rows_kernel(
    int* __restrict__ counts, int* __restrict__ starts, int chunks) {
  __shared__ int ws[32];
  const int total = block_scan_inplace(counts + (long long)blockIdx.x * chunks, chunks, ws);
  if (threadIdx.x == 0) starts[blockIdx.x] = total;
}

// starts[0, n) -> each bin's first slot; starts[n] = the number of entries.
__global__ void __launch_bounds__(kTileScanThreads) splat_scan_tiles_kernel(
    int* __restrict__ starts, int n) {
  __shared__ int ws[32];
  const int total = block_scan_inplace(starts, n, ws);
  if (threadIdx.x == 0) starts[n] = total;
}

// Each warp of a block takes a run of 32 kBinRounds consecutive samples,
// 32 a round; a sample's rank in a tile's bin is the chunk's first slot
// there, plus the earlier warps' counts, plus the warp's earlier samples'
// (kept in registers from the counting walk to the writes).
__global__ void __launch_bounds__(kBinThreads) splat_bin_kernel(
    const float* __restrict__ xs, const float* __restrict__ ys, const int* __restrict__ counts,
    const int* __restrict__ starts, int* __restrict__ entries, int N, int H, int W, int sh,
    int tiles_x, int tiles, int chunks) {
  extern __shared__ int wslot[];   // (warps, tiles): a warp's count, then its first slot
  constexpr int chunk = kBinThreads * kBinRounds;
  const int b = blockIdx.y, ck = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int t = threadIdx.x; t < kBinWarps * tiles; t += kBinThreads) wslot[t] = 0;
  const long long base = (long long)b * N;
  const int s0 = ck * chunk + warp * 32 * kBinRounds;
  int* mine = wslot + warp * tiles;
  float xr[kBinRounds], yr[kBinRounds];
#pragma unroll
  for (int r = 0; r < kBinRounds; ++r) {
    const int si = s0 + r * 32 + lane;
    xr[r] = si < N ? xs[base + si] : 0.0f;
    yr[r] = si < N ? ys[base + si] : 0.0f;
  }
  __syncthreads();
  SampleTiles st[kBinRounds];
  int rank[kBinRounds][4];
#pragma unroll
  for (int r = 0; r < kBinRounds; ++r) {
    st[r] = sample_tiles(xr[r], yr[r], H, W, sh, tiles_x);
    if (s0 + r * 32 + lane >= N) st[r].valid = 0;
    for_each_tile(st[r], st[r].valid, [&](int X, unsigned m, bool hit, bool leader) {
      const int before = mine[X];
      __syncwarp();
      if (hit) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if ((st[r].valid >> k & 1u) && st[r].t[k] == X) rank[r][k] = before + __popc(m & lt);
      }
      if (leader) mine[X] = before + __popc(m);
      __syncwarp();
    });
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tiles; t += kBinThreads) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kBinWarps; ++w) total += wslot[w * tiles + t];
    if (total == 0) continue;
    const long long row = (long long)b * tiles + t;
    int run = starts[row] + counts[row * chunks + ck];
#pragma unroll
    for (int w = 0; w < kBinWarps; ++w) {
      const int c = wslot[w * tiles + t];
      wslot[w * tiles + t] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kBinRounds; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (st[r].valid >> k & 1u)
        entries[mine[st[r].t[k]] + rank[r][k]] = (int)(base + s0 + r * 32 + lane);
}

// The first of a[lo, hi) (ascending) that is >= v.
__device__ __forceinline__ int lower_bound(const unsigned short* a, int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Shared memory of a reduce block with RS samples a thread in a chunk (M =
// 256 RS) and g rows of `stride` bytes: the chunk's g rows, its weights
// (wx, wy) as float2, the cells' first slots (CELLS + 1), the pixels' first
// list slots (P + 1), the scan's 32 ints, each warp's count and then next
// slot per cell (u16), the chunk's samples in cell order (u16) and the
// pixels' lists of (sample << 2 | tap) (u16, 4 a sample at most).
template <int CPT>
__host__ __device__ constexpr size_t reduce_smem(int rs, int stride) {
  using G = Geo<CPT>;
  return (size_t)kThreads * rs * (stride + 8 + 2 + 8) +
         ((size_t)G::CELLS + 1 + G::P + 1 + 32) * 4 + (size_t)kWarps * G::CELLS * 2;
}

// A reduce block's chunk and g rows for dtype T: a row's stride in shared
// memory is an odd number of 16-byte units, so the 16-byte reads of a
// warp's lanes at any rows spread over the banks; RS samples a thread, as
// many (at most 4) as keep the block within kReduceSmem, so that 3 blocks
// share an SM (splat_kernel.REDUCE_SMEM, the plan's own copy).
template <typename T, int CPT>
struct Rows {
  static constexpr int BYTES = CPT * (int)sizeof(T);
  static constexpr int STRIDE = (BYTES / 16) % 2 ? CPT : CPT + 16 / (int)sizeof(T);
  static constexpr int RS = reduce_smem<CPT>(4, STRIDE * sizeof(T)) <= kReduceSmem   ? 4
                            : reduce_smem<CPT>(3, STRIDE * sizeof(T)) <= kReduceSmem ? 3
                            : reduce_smem<CPT>(2, STRIDE * sizeof(T)) <= kReduceSmem ? 2
                                                                                    : 1;
  static constexpr int M = kThreads * RS;
  static constexpr size_t SMEM = reduce_smem<CPT>(RS, STRIDE * sizeof(T));
  static_assert(SMEM <= kReduceSmem, "a reduce block must leave room for 3 an SM");
};

// Indices of a chunk's samples at bin slot k0: lane's j = (warp RS + r) 32
// + lane, -1 past the bin's end e1.
template <int RS>
__device__ __forceinline__ void load_idx(int* idx, const int* __restrict__ entries, int k0,
                                         int e1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = k0 + (warp * RS + r) * 32 + lane;
    idx[r] = k < e1 ? entries[k] : -1;
  }
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads, 3) splat_reduce_kernel(
    const T* __restrict__ g,              // (B*N, C) sample cotangents
    const float* __restrict__ xs,         // (B*N)
    const float* __restrict__ ys,         // (B*N)
    const int* __restrict__ entries,      // the bins: flat sample indices
    const int* __restrict__ starts,       // (B * tiles + 1) each bin's first entry
    float* __restrict__ out,              // (B, H, W, C)
    int H, int W, int C, int tiles_x, int tiles) {
  using G = Geo<CPT>;
  using S = Rows<T, CPT>;
  constexpr int R = G::PPT, TH = G::TH, P = G::P, CELLS = G::CELLS;
  constexpr int RS = S::RS, M = S::M, STRIDE = S::STRIDE;
  constexpr int kCopies = S::BYTES / 16;
  const int groups = C / CPT;
  const int bt = blockIdx.x / groups, cg = blockIdx.x % groups;
  const int b = bt / tiles, tile = bt % tiles;
  const int ox = (tile % tiles_x) * kTW, oy = (tile / tiles_x) * TH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;

  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);
  float2* wts = reinterpret_cast<float2*>(gs + M * STRIDE);   // (wx, wy)
  int* cstart = reinterpret_cast<int*>(wts + M);
  int* pstart = cstart + CELLS + 1;
  int* ws = pstart + P + 1;
  unsigned short* hist = reinterpret_cast<unsigned short*>(ws + 32);
  unsigned short* list = hist + kWarps * CELLS;
  unsigned short* terms = list + M;

  float acc[R][CPT];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[q][c] = 0.0f;
  for (int i = threadIdx.x; i < kWarps * CELLS; i += kThreads) hist[i] = 0;
  for (int c = threadIdx.x; c < CELLS; c += kThreads) cstart[c] = 0;
  const int e0 = starts[bt], e1 = starts[bt + 1];
  // in flight: this chunk's indices and coordinates, the next one's indices
  int idx[RS], idx_next[RS];
  float xr[RS], yr[RS];
  load_idx<RS>(idx, entries, e0, e1);
  load_idx<RS>(idx_next, entries, e0 + M, e1);
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    xr[r] = idx[r] >= 0 ? xs[idx[r]] : 0.0f;
    yr[r] = idx[r] >= 0 ? ys[idx[r]] : 0.0f;
  }
  __syncthreads();

  for (int k0 = e0; k0 < e1; k0 += M) {
    // 1. the chunk's g rows by cp.async; the next chunk's coordinates and
    //    the indices of the one after
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      if (idx[r] < 0) continue;
      const int j = (warp * RS + r) * 32 + lane;
      const T* src = g + (long long)idx[r] * C + cg * CPT;
#pragma unroll
      for (int q = 0; q < kCopies; ++q)
        mdf::cp_async16(mdf::smem_u32(gs + j * STRIDE) + q * 16, src + q * (16 / sizeof(T)), 16);
    }
    float xn[RS], yn[RS];
    int idx_after[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      xn[r] = idx_next[r] >= 0 ? xs[idx_next[r]] : 0.0f;
      yn[r] = idx_next[r] >= 0 ? ys[idx_next[r]] : 0.0f;
    }
    load_idx<RS>(idx_after, entries, k0 + 2 * M, e1);
    // 2. taps, base cell and weights of each sample; each warp's count per
    //    cell, and each cell's (in cstart, an integer sum)
    int cell[RS];
    unsigned peers[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int j = (warp * RS + r) * 32 + lane;
      cell[r] = CELLS;   // no sample
      if (idx[r] >= 0) {
        const mdf::Taps tp = mdf::bilinear_taps(xr[r], yr[r], H, W);
        cell[r] = (tp.y0 - oy + 1) * kCW + (tp.x0 - ox + 1);
        wts[j] = make_float2(tp.wx, tp.wy);
      }
      peers[r] = __match_any_sync(kFull, cell[r]);
      if (idx[r] >= 0 && (peers[r] & lt) == 0) {
        hist[warp * CELLS + cell[r]] += (unsigned short)__popc(peers[r]);
        atomicAdd(&cstart[cell[r]], __popc(peers[r]));
      }
      __syncwarp();
    }
    __syncthreads();
    // 3. one exclusive scan of two counts packed in 16 bits (each at most
    //    4 M <= 4096): over (cell, warp), each warp's first slot in each cell
    //    and cstart[c], cell c's first slot; over the pixels in thread order
    //    (this thread's rows warp + 8 q of column lane), pstart, each pixel's
    //    first list slot. A pixel's count is its 4 cells' c0 - 1, c0 (taps
    //    1, 0) and c0 - 34, c0 - 33 (taps 3, 2), read before the scan
    //    overwrites cstart.
    {
      constexpr int per = (CELLS + kThreads - 1) / kThreads;
      const int lo = min(CELLS, (int)threadIdx.x * per), hi = min(CELLS, lo + per);
      int n_cells = 0, n_pix = 0, pix[R];
      for (int c = lo; c < hi; ++c) n_cells += cstart[c];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int py = warp + 8 * q;
        const int c0 = (py + 1) * kCW + lane + 1;
        pix[q] = ox + lane < W && oy + py < H
                     ? cstart[c0 - 1] + cstart[c0] + cstart[c0 - kCW - 1] + cstart[c0 - kCW]
                     : 0;
        n_pix += pix[q];
      }
      int total;
      const int first = block_exclusive_scan(n_cells | n_pix << 16, ws, total);
      int run = first & 0xffff, prun = first >> 16;
      for (int c = lo; c < hi; ++c) {
        cstart[c] = run;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int v = hist[w * CELLS + c];
          hist[w * CELLS + c] = (unsigned short)run;
          run += v;
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        pstart[threadIdx.x * R + q] = prun;
        prun += pix[q];
      }
      if (threadIdx.x == 0) {
        cstart[CELLS] = total & 0xffff;
        pstart[P] = total >> 16;
      }
    }
    __syncthreads();
    // 4. the samples in cell order; each sample's rank in its cell
    int rank[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int j = (warp * RS + r) * 32 + lane;
      const bool lead = idx[r] >= 0 && (peers[r] & lt) == 0;
      const int slot = idx[r] >= 0 ? hist[warp * CELLS + cell[r]] + __popc(peers[r] & lt) : 0;
      __syncwarp();
      if (idx[r] >= 0) {
        list[slot] = (unsigned short)j;
        rank[r] = slot - cstart[cell[r]];
      }
      if (lead) hist[warp * CELLS + cell[r]] += (unsigned short)__popc(peers[r]);
      __syncwarp();
    }
    __syncthreads();
    // 5. each sample into the lists of its in-image taps' pixels, at its
    //    rank there: its rank in its own cell plus, in each of the pixel's
    //    other cells (of the 8 around its own), the samples before it
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      if (idx[r] < 0) continue;
      const int j = (warp * RS + r) * 32 + lane;
      const int c = cell[r];
      const int cx = c % kCW, cy = c / kCW;   // the base pixel is (cx - 1, cy - 1)
      // before[dy + 1][dx + 1]: the samples before j in cell c + dx + dy kCW
      int before[3][3];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int nx = cx + dx, ny = cy + dy;
          int n = 0;
          if ((dx || dy) && nx >= 0 && nx < kCW && ny >= 0 && ny <= TH) {
            const int cc = c + dx + dy * kCW;
            n = lower_bound(list, cstart[cc], cstart[cc + 1], j) - cstart[cc];
          }
          before[dy + 1][dx + 1] = n;
        }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int kx = k & 1, ky = k >> 1;
        const int px = cx - 1 + kx, py = cy - 1 + ky;
        if (px < 0 || px >= kTW || py < 0 || py >= TH || ox + px >= W || oy + py >= H) continue;
        // the pixel's cells are its own c0 and c0 - 1, c0 - 33, c0 - 34;
        // relative to c they are (kx - a, ky - b) for a, b in {0, 1}
        int at = rank[r];
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2)
          if (k2 != k) at += before[ky - (k2 >> 1) + 1][kx - (k2 & 1) + 1];
        terms[pstart[((py & 7) * kTW + px) * R + (py >> 3)] + at] = (unsigned short)(j << 2 | k);
      }
    }
    mdf::cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < kWarps * CELLS; i += kThreads) hist[i] = 0;   // the next chunk's
    for (int c = threadIdx.x; c < CELLS; c += kThreads) cstart[c] = 0;
    // 6. each pixel adds its terms in sample order
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int end = pstart[threadIdx.x * R + q + 1];
      int e = pstart[threadIdx.x * R + q];
      int jk = e < end ? terms[e] : 0;
      for (; e < end; ++e) {
        const int j = jk >> 2;
        const float2 wt = wts[j];
        const float fx = (jk & 1) ? wt.x : __fsub_rn(1.0f, wt.x);
        const float fy = (jk & 2) ? wt.y : __fsub_rn(1.0f, wt.y);
#pragma unroll
        for (int c8 = 0; c8 < CPT; c8 += 8) {
          float v[8];
          mdf::load8(gs + j * STRIDE + c8, v);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[q][c8 + c] = __fadd_rn(acc[q][c8 + c], __fmul_rn(__fmul_rn(v[c], fy), fx));
        }
        jk = e + 1 < end ? terms[e + 1] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      idx[r] = idx_next[r];
      idx_next[r] = idx_after[r];
      xr[r] = xn[r];
      yr[r] = yn[r];
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int gx = ox + lane, gy = oy + warp + 8 * q;
    if (gx < W && gy < H) {
      float* dst = out + (((long long)b * H + gy) * W + gx) * C + cg * CPT;
#pragma unroll
      for (int c8 = 0; c8 < CPT; c8 += 8) mdf::store8(dst + c8, acc[q] + c8);
    }
  }
}

// The snapped samples of nan_list (count first): each channel whose g value
// is infinite or NaN is NaN at the sample's in-image taps, as the term
// (v * wy) * 0 makes it; the other terms of such a sample are +-0.
template <typename T>
__global__ void __launch_bounds__(kThreads) splat_nan_kernel(
    const T* __restrict__ g, const float* __restrict__ xs, const float* __restrict__ ys,
    const int* __restrict__ nan_list, float* __restrict__ out, int N, int H, int W, int C) {
  const int count = nan_list[0];
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < count * C; e += gridDim.x * kThreads) {
    const int i = nan_list[1 + e / C], c = e % C;
    if (isfinite(mdf::to_f32(g[(long long)i * C + c]))) continue;
    const int b = i / N;
    const mdf::Taps tp = mdf::bilinear_taps(xs[i], ys[i], H, W);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = tp.x0 + (k & 1), yi = tp.y0 + (k >> 1);
      if (xi >= 0 && xi < W && yi >= 0 && yi < H)
        out[(((long long)b * H + yi) * W + xi) * C + c] = __int_as_float(0x7fffffff);
    }
  }
}

template <typename T, int CPT>
cudaError_t launch_reduce(const void* g, const float* x, const float* y, const int* entries,
                          const int* starts, float* out, int B, int H, int W, int C,
                          int tiles_x, int tiles, cudaStream_t st) {
  constexpr size_t smem = Rows<T, CPT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(splat_reduce_kernel<T, CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  splat_reduce_kernel<T, CPT><<<(unsigned)((long long)B * tiles * (C / CPT)), kThreads, smem,
                                st>>>(static_cast<const T*>(g), x, y, entries, starts, out, H, W,
                                      C, tiles_x, tiles);
  return cudaSuccess;
}

// The passes in order for g of dtype T (see the top of the file).
template <typename T>
cudaError_t splat(const void* gv, const float* x, const float* y, int* counts, int* starts,
                  int* entries, int* nan_list, float* out, int B, int N, int H, int W, int C,
                  int cpt, int tile_h, int reduce_chunk, int chunk, cudaStream_t st) {
  const T* g = static_cast<const T*>(gv);
  const int tiles_x = (W + kTW - 1) / kTW, tiles = tiles_x * ((H + tile_h - 1) / tile_h);
  const int sh = __builtin_ctz(tile_h);
  const int chunks = (N + chunk - 1) / chunk;
  const size_t bin_smem = (size_t)kBinWarps * tiles * 4;
  cudaError_t err = cudaFuncSetAttribute(
      splat_count_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(tiles * 4));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(splat_bin_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bin_smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(nan_list, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  if (chunks > 0)
    splat_count_kernel<T><<<dim3(chunks, B), kBinThreads, tiles * 4, st>>>(
        g, x, y, counts, nan_list, N, H, W, C, sh, tiles_x, tiles, chunks);
  splat_scan_rows_kernel<<<B * tiles, kScanThreads, 0, st>>>(counts, starts, chunks);
  splat_scan_tiles_kernel<<<1, kTileScanThreads, 0, st>>>(starts, B * tiles);
  if (chunks > 0)
    splat_bin_kernel<<<dim3(chunks, B), kBinThreads, bin_smem, st>>>(
        x, y, counts, starts, entries, N, H, W, sh, tiles_x, tiles, chunks);
  if (reduce_chunk != (cpt == 8    ? Rows<T, 8>::M
                       : cpt == 16 ? Rows<T, 16>::M
                                   : Rows<T, 32>::M))
    return cudaErrorInvalidValue;
  switch (cpt) {
    case 8:
      err = launch_reduce<T, 8>(g, x, y, entries, starts, out, B, H, W, C, tiles_x, tiles, st);
      break;
    case 16:
      err = launch_reduce<T, 16>(g, x, y, entries, starts, out, B, H, W, C, tiles_x, tiles, st);
      break;
    case 32:
      err = launch_reduce<T, 32>(g, x, y, entries, starts, out, B, H, W, C, tiles_x, tiles, st);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  splat_nan_kernel<T><<<32, kThreads, 0, st>>>(g, x, y, nan_list, out, N, H, W, C);
  return cudaSuccess;
}

}  // namespace

// The splat of g (B*N, C) at (x, y) (B*N) onto out (B, H, W, C), f32, on the
// plan of splat_kernel.splat_plan: cpt channels a reduce block (8, 16 or
// 32, dividing C) on tiles of 32 x tile_h pixels (tile_h = 256 / cpt),
// reduce chunks of reduce_chunk samples (Rows::M), bin chunks of `chunk`
// samples (a multiple of 256); counts (B * tiles *
// chunks), starts (B * tiles + 1), entries (4 B N) and nan_list (B N + 1)
// are its scratch. Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int mdf_splat_2d(const void* g, const void* x, const void* y, void* counts,
                            void* starts, void* entries, void* nan_list, void* out, int B, int N,
                            int H, int W, int C, int cpt, int tile_h, int reduce_chunk,
                            int chunk, int dtypes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int tiles = ((W + kTW - 1) / kTW) * ((H + tile_h - 1) / tile_h);
  if ((cpt != 8 && cpt != 16 && cpt != 32) || C % cpt != 0 || tile_h * cpt != 8 * 32 ||
      chunk != kBinThreads * kBinRounds || (size_t)kBinWarps * tiles * 4 > 200 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  int* cnt = static_cast<int*>(counts);
  int* sta = static_cast<int*>(starts);
  int* ent = static_cast<int*>(entries);
  int* nan = static_cast<int*>(nan_list);
  float* o = static_cast<float*>(out);
  switch (dtypes) {
    case MDF_F32_F32:
      err = splat<float>(g, xf, yf, cnt, sta, ent, nan, o, B, N, H, W, C, cpt, tile_h,
                         reduce_chunk, chunk, st);
      break;
    case MDF_BF16_F32:
      err = splat<__nv_bfloat16>(g, xf, yf, cnt, sta, ent, nan, o, B, N, H, W, C, cpt, tile_h,
                                 reduce_chunk, chunk, st);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
