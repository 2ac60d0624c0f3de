// Plane-sweep bilinear sampling with zero padding (K6).
//
// Replaces: mdfnet_tpu/ops/pallas/warp_kernel.py:143 pallas_sample_2d_multi
// (kernel body _warp_kernel, line 38), with its single-source wrapper
// pallas_sample_2d (:124), as homography_warp_pallas (:267) and
// homography_warp_pallas_multi (:304) call them: the forward of the
// training warp, and the eval warp of the variance aggregate and of the
// vector aggregate at C/G != 2.
//
// out[s, d, h, w, c] = bilinear sample of img[s] (Hs, Ws, C, channels-last)
// at the f32 pixel coordinates (x, y)[s, d, h, w], zero padding, f32
// arithmetic, stored in the image's dtype. The taps and weights are rounded
// as the plain gather (mdfnet_tpu_torch/ops/sample.py) rounds them, and the
// products and sums are non-contracted (__fmul_rn / __fadd_rn), so in f32
// the kernel reproduces the plain version's bits. A sample whose x or y lies
// outside the source (or is NaN) writes +0 and reads nothing: the plain
// version's arithmetic gives +0 there too for finite features (each of its
// terms is +0 or a finite value times a zero weight), but NaN for a NaN
// coordinate, and NaN where a zero-weight tap in the source's first row or
// column holds Inf or NaN.
//
// What bounds it on the H100: the bytes of its output (each sample writes C
// values; the bound counts the output, the f32 coordinates and the source
// once), and inside the SM the reads of its taps: four taps of C values a
// sample, four times the output's bytes through L1 or shared memory.
// Reading the card (store-only and load-only variants, and this kernel with
// one part of its work edited out; PERF.md): the
// output's stores alone run at the bound; the first design's loads alone
// (one thread a (sample, 8-channel chunk), its two coordinates and four
// 16-byte taps through L1) took 82% of its time; and a design that staged
// each plane's tile box in shared memory ran no faster, its time set by
// the skeleton around the taps: every plane re-read its tile's source box
// from L2, about the output's own bytes again.
//
// Design: a block of 256 threads takes a unit of work: a tile of one image
// (tile_h rows x tile_w columns, at most 256 R samples) on a run of up to
// kRun planes.
//   - Staged footprint: the block reduces the bounding box of the taps of
//     all the run's planes; where the box (rows x cols x C) fits the plan's
//     budget, it is copied into shared memory once, by 16-byte cp.async
//     (zeros where it lies past the source), and every plane of the run
//     reads its taps there without a test, else the unit reads them from
//     global memory (the global branch). Both branches run the same f32
//     arithmetic in the same order, so the kernel is exact for any camera;
//     no coverage contract. warp_kernel.stage_route says where staging
//     pays.
//   - Lane groups: on each plane a lane loads one sample's coordinates
//     (coalesced) and writes its taps and weights once into its warp's
//     table in shared memory; the L = C/8 lanes that interpolate a sample
//     (8 channels each) read them there.
//   - Overlap: up to three blocks an SM (launch bounds: 80 registers), one
//     box buffer each: while a block finds and copies its box, the others
//     sample; the next plane's coordinates load while a plane interpolates.
//     (Two buffers a block, copying the next unit's box during this one,
//     fit only two blocks an SM and ran slower at every launched shape; a
//     persistent grid walking the units ran no faster than a unit a block.)
//   - Outputs go out as 16-byte streaming stores (st.global.cs); the source
//     loads carry an L2 evict-last policy.
// warp_kernel.sample_plan gives the tile, the run and the budget; an
// optional counter buffer (null on the main path) counts the units of each
// branch.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;     // planes a unit of work at most
constexpr int kIdle = -2;   // a lane with no sample (past the tile or the plane)
constexpr int kDead = -1;   // a sample outside the source: writes +0

struct Args {
  const void* img;              // (S, Hs, Ws, C)
  const float* xs;              // (S, D, H, W)
  const float* ys;
  void* out;                    // (S, D, H, W, C)
  unsigned long long* counts;   // null, or [units staged, units on the global branch]
  int D, H, W, Hs, Ws, C;
  int tile_h, tile_w, tiles_h, tiles_w;
  int run, runs;                // planes a unit (<= kRun), runs of planes
  long long units;              // S * runs * tiles_h * tiles_w
  int budget;                   // elements a staged box may hold (0: never staged)
};

// A unit's tap bounding box (in the source, one pixel past it where a tap
// lies outside) and its branch.
struct Box {
  int x0, y0, w, h;
  bool staged;
};

// A unit of work: the tile (th, tw) of image s on planes d0 .. d0 + nd - 1.
struct Unit {
  int s, th, tw, d0, nd;
};

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// 16 bytes from src into shared memory, or zeros where ok is false (src
// is then not read)
__device__ __forceinline__ void cp_async16_last(uint32_t dst, const void* src, bool ok,
                                                uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0), "l"(pol)
               : "memory");
}

__device__ __forceinline__ uint4 ldg16_last(const void* p, uint64_t pol) {
  uint4 u;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p), "l"(pol));
  return u;
}

// A lane's 8 channels as 16-byte vectors: one for bf16 (8 consecutive
// channels), two for f32 (two runs of 4 channels, `half` elements apart,
// so that the group's lanes read and write each run as consecutive 16-byte
// pieces: whole 32-byte sectors)
template <typename T>
struct Raw8 {
  uint4 v[sizeof(T) / 2];
};

// the lane's 8 channels from p, in the staged box (shared memory) or the
// source (global memory); zeros where ok is false (nothing is read)
template <typename T, bool kStaged>
__device__ __forceinline__ Raw8<T> tap8(const T* p, int half, bool ok, uint64_t pol) {
  Raw8<T> r;
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 2); ++k) {
    const uint4* q = reinterpret_cast<const uint4*>(p + k * half);
    r.v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (ok) r.v[k] = kStaged ? *q : ldg16_last(q, pol);
  }
  return r;
}

// widened exactly, as __bfloat162float does
__device__ __forceinline__ void widen(const Raw8<__nv_bfloat16>& r, float* o) {
  const uint32_t w[4] = {r.v[0].x, r.v[0].y, r.v[0].z, r.v[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const Raw8<float>& r, float* o) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    o[4 * k] = __uint_as_float(r.v[k].x);
    o[4 * k + 1] = __uint_as_float(r.v[k].y);
    o[4 * k + 2] = __uint_as_float(r.v[k].z);
    o[4 * k + 3] = __uint_as_float(r.v[k].w);
  }
}

__device__ __forceinline__ void store8_cs(__nv_bfloat16* p, int, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ void store8_cs(float* p, int half, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p + half), make_float4(v[4], v[5], v[6], v[7]));
}

// units in the order (image, run of planes, tile row, tile column)
__device__ __forceinline__ Unit unit_at(const Args& a, long long u) {
  const int tw = (int)(u % a.tiles_w);
  u /= a.tiles_w;
  const int th = (int)(u % a.tiles_h);
  u /= a.tiles_h;
  const int run = (int)(u % a.runs), d0 = run * a.run;
  return Unit{(int)(u / a.runs), th, tw, d0, min(a.run, a.D - d0)};
}

// Round r of this warp covers the tile's samples (warp R + r) 32 + lane,
// row-major in the tile: a lane's offset in a plane (h * W + w), or kIdle
// past the tile or the plane's edge.
template <int R>
__device__ __forceinline__ void tile_offsets(const Args& a, const Unit& t, int (&off)[R]) {
  const int first = (threadIdx.x >> 5) * R * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = first + r * 32;
    const int row = i / a.tile_w, col = i - row * a.tile_w;
    const int h = t.th * a.tile_h + row, w = t.tw * a.tile_w + col;
    off[r] = row < a.tile_h && h < a.H && w < a.W ? h * a.W + w : kIdle;
  }
}

// the lanes' coordinates on plane d (0 past the tile); kLast: their last
// read (evict-first)
template <int R, bool kLast>
__device__ __forceinline__ void plane_coords(const Args& a, const Unit& t, int d,
                                             const int (&off)[R], float (&cx)[R],
                                             float (&cy)[R]) {
  const long long base = ((long long)t.s * a.D + d) * a.H * a.W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cx[r] = cy[r] = 0.0f;
    if (off[r] == kIdle) continue;
    cx[r] = kLast ? __ldcs(a.xs + base + off[r]) : __ldg(a.xs + base + off[r]);
    cy[r] = kLast ? __ldcs(a.ys + base + off[r]) : __ldg(a.ys + base + off[r]);
  }
}

// A sample's taps (mdf::bilinear_taps): its top-left tap (x0, y0), its
// weights, and whether it lies inside the source (snapped to -1 with a zero
// weight on either axis, it lies outside, or is NaN).
struct Taps {
  int x0, y0;
  float wx, wy;
  bool live;
};

__device__ __forceinline__ Taps sample_taps(const Args& a, float x, float y, int off) {
  const mdf::Taps b = mdf::bilinear_taps(x, y, a.Hs, a.Ws);
  const bool live = off != kIdle && !(b.x0 == -1 && b.wx == 0.0f) && !(b.y0 == -1 && b.wy == 0.0f);
  return Taps{b.x0, b.y0, b.wx, b.wy, live};
}

// The unit's tap bounding box: the box of the taps of every sample inside
// the source on any of its planes, taps outside the source included (one
// pixel past its edges), reduced over the warp and into the block's box
// cells (x lo, x hi, y lo, y hi). A sample lies inside where -1 < x < Ws
// and -1 < y < Hs (mdf::bilinear_taps keeps it there, and floor is
// monotonic, so the taps' box is floor of the coordinates' box, plus one
// at its far edges). The coordinates of kRun / R planes load at once.
template <int R>
__device__ __forceinline__ void unit_box(const Args& a, const Unit& t, const int (&off)[R],
                                         int* box) {
  constexpr int kPart = kRun / R;   // planes whose coordinates load at once
  float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
  const float ws = (float)a.Ws, hs = (float)a.Hs;
#pragma unroll 1
  for (int k0 = 0; k0 < t.nd; k0 += kPart) {
    float cx[kPart][R], cy[kPart][R];
#pragma unroll
    for (int k = 0; k < kPart; ++k)
      if (k0 + k < t.nd) plane_coords<R, false>(a, t, t.d0 + k0 + k, off, cx[k], cy[k]);
#pragma unroll
    for (int k = 0; k < kPart; ++k) {
      if (k0 + k >= t.nd) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = cx[k][r], y = cy[k][r];
        if (off[r] == kIdle || !(x > -1.0f && x < ws && y > -1.0f && y < hs)) continue;
        xmin = fminf(xmin, x);
        xmax = fmaxf(xmax, x);
        ymin = fminf(ymin, y);
        ymax = fmaxf(ymax, y);
      }
    }
  }
  const bool any = xmin <= xmax;
  const int xlo = __reduce_min_sync(0xffffffffu, any ? (int)floorf(xmin) : INT_MAX);
  const int xhi = __reduce_max_sync(0xffffffffu, any ? (int)floorf(xmax) + 1 : INT_MIN);
  const int ylo = __reduce_min_sync(0xffffffffu, any ? (int)floorf(ymin) : INT_MAX);
  const int yhi = __reduce_max_sync(0xffffffffu, any ? (int)floorf(ymax) + 1 : INT_MIN);
  if ((threadIdx.x & 31) == 0 && xlo <= xhi) {
    atomicMin(box, xlo);
    atomicMax(box + 1, xhi);
    atomicMin(box + 2, ylo);
    atomicMax(box + 3, yhi);
  }
}

__device__ __forceinline__ Box read_box(const Args& a, const int* box) {
  Box b{box[0], box[2], 0, 0, false};
  if (box[0] <= box[1]) {
    b.w = box[1] - box[0] + 1;
    b.h = box[3] - box[2] + 1;
  }
  b.staged = a.budget > 0 && (long long)b.w * b.h * a.C <= a.budget;
  if (a.counts != nullptr && threadIdx.x == 0) atomicAdd(a.counts + (b.staged ? 0 : 1), 1ull);
  return b;
}

// The box into buf, row after row (each b.w pixels of C values), by
// 16-byte copies: zeros where the box lies outside the source, so that
// every tap of a sample inside it reads its value or zero without a test.
template <typename T>
__device__ __forceinline__ void stage_box(const Args& a, const T* src, const Box& b, T* buf,
                                          uint64_t pol) {
  const int vpx = a.C * (int)sizeof(T) / 16;   // 16-byte vectors a pixel
  const int vrow = b.w * vpx, total = vrow * b.h;
  if (total == 0) return;
  // the vectors of a row inside the source: [klo, khi)
  const int klo = max(0, -b.x0) * vpx, khi = (min(b.x0 + b.w, a.Ws) - b.x0) * vpx;
  int ry = (int)threadIdx.x / vrow, k = (int)threadIdx.x - ry * vrow;
  const uint32_t dst = mdf::smem_u32(buf);
  for (int v = threadIdx.x; v < total; v += kThreads) {
    const int y = b.y0 + ry;
    const bool in = y >= 0 && y < a.Hs && k >= klo && k < khi;
    const T* row = src + (y * a.Ws + b.x0) * a.C;
    const void* from = in ? static_cast<const void*>(reinterpret_cast<const uint4*>(row) + k)
                          : static_cast<const void*>(src);
    cp_async16_last(dst + 16 * v, from, in, pol);
    k += kThreads;
    while (k >= vrow) {
      k -= vrow;
      ++ry;
    }
  }
}

// A lane's sample on one plane, as the lanes that interpolate it read it:
// code = the element offset of its (x0, y0) tap in the staged box, or
// (global branch) its packed taps (y0 + 1) << 16 | (x0 + 1); kDead /
// kIdle; its offset in the plane; its weights (0 unless it is live).
__device__ __forceinline__ int4 table_entry(const Args& a, const Taps& tp, int off,
                                            const Box& b, bool staged) {
  int code = off == kIdle ? kIdle : kDead;
  if (tp.live)
    code = staged ? ((tp.y0 - b.y0) * b.w + (tp.x0 - b.x0)) * a.C
                  : ((tp.y0 + 1) << 16) | (tp.x0 + 1);
  return make_int4(code, off, __float_as_int(tp.live ? tp.wx : 0.0f),
                   __float_as_int(tp.live ? tp.wy : 0.0f));
}

// One plane of the unit: lane k L + l of group k (G = 32 / L groups) takes
// sample j G + k of each round from the warp's table and interpolates its
// chunk l of 8 channels (and l + L, ... where C > 8 L; kOne: C <= 8 L,
// at most one chunk a lane, so that no loop stands between the rounds and
// the compiler may interleave them), reading the taps
// from the staged box (kStaged: every tap of a live sample lies in it) or
// from the source (each tap outside it reads zero). A sample that is not
// live reads nothing and writes +0; an idle one writes nothing.
template <typename T, int L, int R, bool kStaged, bool kOne>
__device__ __forceinline__ void interpolate(const Args& a, const T* src, const T* buf, T* out,
                                            const int4* table, const Box& b, uint64_t pol) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31, grp = lane / L, l = lane % L, chunks = a.C / 8;
  const int pitch = (kStaged ? b.w : a.Ws) * a.C;   // elements between tap rows
  // chunk ck of a lane: channels 8 ck .. 8 ck + 7 (bf16), or 4 ck .. 4 ck
  // + 3 and half further on (f32; Raw8)
  constexpr int kRunOf = 16 / (int)sizeof(T);
  const int half = a.C / 2;
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int4 en = table[r * 32 + j * G + grp];
      const int code = en.x;
      const float wx = __int_as_float(en.z), wy = __int_as_float(en.w);
      const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
      bool v00, v01, v10, v11;
      int e;
      if (kStaged) {
        v00 = v01 = v10 = v11 = code >= 0;
        e = max(code, 0);
      } else {
        const int x0 = (code & 0xffff) - 1, y0 = (code >> 16) - 1;
        const bool live = code >= 0, vx0 = x0 >= 0, vx1 = x0 + 1 < a.Ws;
        const bool vy0 = y0 >= 0, vy1 = y0 + 1 < a.Hs;
        v00 = live && vy0 && vx0;
        v01 = live && vy0 && vx1;
        v10 = live && vy1 && vx0;
        v11 = live && vy1 && vx1;
        e = (y0 * a.Ws + x0) * a.C;
      }
      const T* base = (kStaged ? buf : src) + e;
      T* o = out + en.y * a.C;
      auto chunk = [&](int ck) {
        const int c0 = ck * kRunOf;   // the chunk's first channel
        const T* q = base + c0;
        float f00[8], f01[8], f10[8], f11[8], res[8];
        widen(tap8<T, kStaged>(q, half, v00, pol), f00);
        widen(tap8<T, kStaged>(q + a.C, half, v01, pol), f01);
        widen(tap8<T, kStaged>(q + pitch, half, v10, pol), f10);
        widen(tap8<T, kStaged>(q + pitch + a.C, half, v11, pol), f11);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float top = __fadd_rn(__fmul_rn(f00[i], ux), __fmul_rn(f01[i], wx));
          const float bot = __fadd_rn(__fmul_rn(f10[i], ux), __fmul_rn(f11[i], wx));
          res[i] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
        }
        if (code != kIdle) store8_cs(o + c0, half, res);
      };
      if (kOne) {
        if (l < chunks) chunk(l);
      } else {
        for (int ck = l; ck < chunks; ck += L) chunk(ck);
      }
    }
  }
}

// Every plane of a unit: the lanes write their samples' table entries
// (their warp's own rows of the table), then interpolate; the next
// plane's coordinates load meanwhile.
template <typename T, int L, int R, bool kStaged, bool kOne>
__device__ __forceinline__ void sample_unit(const Args& a, const Unit& t, const Box& b,
                                            const T* buf, int4* table, uint64_t pol) {
  const T* src = static_cast<const T*>(a.img) + (long long)t.s * a.Hs * a.Ws * a.C;
  int4* mine = table + (threadIdx.x >> 5) * R * 32;
  int off[R];
  float cx[R], cy[R];
  tile_offsets<R>(a, t, off);
  plane_coords<R, true>(a, t, t.d0, off, cx, cy);
  for (int k = 0; k < t.nd; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      mine[r * 32 + (threadIdx.x & 31)] =
          table_entry(a, sample_taps(a, cx[r], cy[r], off[r]), off[r], b, kStaged);
    if (k + 1 < t.nd) plane_coords<R, true>(a, t, t.d0 + k + 1, off, cx, cy);
    __syncwarp();
    T* out = static_cast<T*>(a.out) + ((long long)t.s * a.D + t.d0 + k) * a.H * a.W * a.C;
    interpolate<T, L, R, kStaged, kOne>(a, src, buf, out, mine, b, pol);
    __syncwarp();
  }
}

// Block u takes unit u: the box of its taps is found and copied into
// shared memory (the SM's other blocks run meanwhile), then every plane of
// the unit samples.
template <typename T, int L, int R>
__global__ void __launch_bounds__(kThreads, 3) sample_2d_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int box[4];   // x lo, x hi, y lo, y hi
  int4* const table = reinterpret_cast<int4*>(smem);   // kWarps x R x 32 entries
  T* const buf = reinterpret_cast<T*>(smem + kWarps * R * 32 * sizeof(int4));
  const uint64_t pol = evict_last();
  const Unit t = unit_at(a, blockIdx.x);
  if (threadIdx.x < 4) box[threadIdx.x] = (threadIdx.x & 1) ? INT_MIN : INT_MAX;
  __syncthreads();
  if (a.budget > 0) {
    int off[R];
    tile_offsets<R>(a, t, off);
    unit_box<R>(a, t, off, box);
  }
  __syncthreads();   // the box complete
  const Box b = read_box(a, box);
  if (b.staged) {
    stage_box(a, static_cast<const T*>(a.img) + (long long)t.s * a.Hs * a.Ws * a.C, b, buf,
              pol);
    mdf::cp_async_wait_all();
  }
  __syncthreads();   // the box staged by every thread
  if (a.C <= 8 * L) {
    if (b.staged) sample_unit<T, L, R, true, true>(a, t, b, buf, table, pol);
    else sample_unit<T, L, R, false, true>(a, t, b, nullptr, table, pol);
  } else {
    if (b.staged) sample_unit<T, L, R, true, false>(a, t, b, buf, table, pol);
    else sample_unit<T, L, R, false, false>(a, t, b, nullptr, table, pol);
  }
}

template <typename T, int L, int R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = a.budget * (int)sizeof(T) + kWarps * R * 32 * (int)sizeof(int4);
  auto kernel = sample_2d_kernel<T, L, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)a.units, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_rounds(const Args& a, int rounds, cudaStream_t st) {
  switch (rounds) {
    case 1: return launch<T, L, 1>(a, st);
    case 2: return launch<T, L, 2>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_lanes(const Args& a, int lanes, int rounds, cudaStream_t st) {
  switch (lanes) {
    case 1: return launch_rounds<T, 1>(a, rounds, st);
    case 2: return launch_rounds<T, 2>(a, rounds, st);
    case 4: return launch_rounds<T, 4>(a, rounds, st);
    case 8: return launch_rounds<T, 8>(a, rounds, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). C % 8 == 0;
// the plan (warp_kernel.sample_plan) keeps tile_h tile_w <= 256 rounds,
// Hs, Ws < 2^15, Hs Ws C, H W C < 2^31 and the units < 2^31.
extern "C" int mdf_sample_2d(const void* img, const void* x, const void* y, void* out,
                             void* counts, int S, int D, int H, int W, int Hs, int Ws, int C,
                             int tile_h, int tile_w, int run, int lanes, int rounds, int budget,
                             int dtypes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C % 8 != 0 || tile_h * tile_w > 256 * rounds || Hs >= 32768 || Ws >= 32768 ||
      run < 1 || run > kRun)
    return cudaErrorInvalidValue;
  Args a;
  a.img = img;
  a.xs = static_cast<const float*>(x);
  a.ys = static_cast<const float*>(y);
  a.out = out;
  a.counts = static_cast<unsigned long long*>(counts);
  a.D = D; a.H = H; a.W = W; a.Hs = Hs; a.Ws = Ws; a.C = C;
  a.tile_h = tile_h; a.tile_w = tile_w;
  a.tiles_h = (H + tile_h - 1) / tile_h;
  a.tiles_w = (W + tile_w - 1) / tile_w;
  a.run = run;
  a.runs = (D + run - 1) / run;
  a.units = (long long)S * a.runs * a.tiles_h * a.tiles_w;
  a.budget = budget;
  if (a.units == 0) return cudaSuccess;
  if (a.units >= (1ll << 31)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case MDF_F32_F32: return launch_lanes<float>(a, lanes, rounds, st);
    case MDF_BF16_BF16: return launch_lanes<__nv_bfloat16>(a, lanes, rounds, st);
    default: return cudaErrorInvalidValue;
  }
}
