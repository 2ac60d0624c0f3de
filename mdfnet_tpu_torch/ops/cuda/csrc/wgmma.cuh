// The tensor-core GEMM core that the implicit-GEMM convolutions share
// (conv_tc.cu: K2, K3, K4; conv_chain.cu: K5): wgmma.m64nNk16 with bf16
// operands from shared memory in the no-swizzle K-major layout and f32
// accumulators, its matrix descriptors and fences, the M blocks a
// warpgroup owns by N, and the interval at which partial sums leave the
// tensor cores.
//
// Layout: a core matrix is 8 rows (M, or N for B) of 16 bytes (8 bf16 K
// values), the rows 16 bytes apart; a descriptor gives the first core
// matrix's address, the leading offset (LBO: to the core matrix of the next
// 8 K values) and the stride offset (SBO: to the next 8 rows), all in
// 16-byte units.
#pragma once

#include "common.cuh"

namespace mdf {

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

// wgmma matrix descriptor, no swizzle: start, LBO and SBO in 16-byte units
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo & 0x3FFF) << 16) |
         ((uint64_t)(sbo & 0x3FFF) << 32);
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Makes this thread's ordinary shared-memory stores (and completed
// cp.async copies) visible to the async proxy that wgmma reads through;
// a barrier must follow before another thread's wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace mdf
