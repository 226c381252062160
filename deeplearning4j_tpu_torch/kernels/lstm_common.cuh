// Shared pieces of the hand-written LSTM scan kernels (lstm_fwd.cu,
// lstm_bwd.cu) for Hopper (sm_90a): conversions, the card's nanosecond
// timer, the batch-group barrier of the persistent kernels (a release
// arrival and an acquire wait), the copy of row chunks into shared
// memory (cp.async), the bf16 forward's warp layout, and bf16 vector
// accesses.
//
// Layout shared by both sweeps: a block (bi, j) of the persistent grid
// owns batch rows [bi * BB, +BB) and hidden units [j * U, +U) for the
// whole sequence. The blocks of one batch group (same bi) exchange only
// through device memory, between steps, behind group_arrive and
// group_wait.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx_common.cuh"

namespace lstm {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;   // threads per block: 8 warps
constexpr int KC = 64;    // depth of one staged chunk of the product
constexpr int MAX_BB = 128;
constexpr int STAGES = 3;  // ring stages of the bf16 forward's h_{t-1} chunks (2 in flight)
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory row pads: bf16 rows stay 16-byte aligned for vector
// stores and ldmatrix, and 8 rows of a ldmatrix phase fall in distinct
// banks; f32 rows of the staged chunk keep 16-byte alignment too.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<bf16> { static constexpr int value = 8; };

template <typename T> __host__ __device__ constexpr int lda() { return KC + Pad<T>::value; }

// the card's nanosecond clock (the same on every SM)
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The barrier of one batch group (same bi), in two halves, with a release
// add and an acquire poll on the group's counter, so that a block can do
// work between its arrival and its wait. ``target`` is the count of
// arrivals the counter reaches at this meeting (it starts at 0 and only
// grows). group_arrive: the __syncthreads orders every thread's stores
// before it ahead of thread 0's add (a release is cumulative); stores
// after it are not ordered for the other blocks. group_wait: the
// __syncthreads after the poll orders every thread's later reads after
// it. The grid is co-resident (cooperative launch), so spinning cannot
// deadlock; a wait longer than four seconds is a fault and traps, which
// fails the launch instead of hanging the card.
__device__ __forceinline__ void group_arrive(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

__device__ __forceinline__ void group_wait(const unsigned int* counter, unsigned int target) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer();
    unsigned int seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      if (globaltimer() - t0 > 4000000000ull) __trap();
    }
  }
  __syncthreads();
}

// cp_async_wait<N> for a count known only at run time (0 .. 15; more
// waits for every group)
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    case 15: cp_async_wait<15>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// Starts copying a ROWS x COLS tile of a row-major matrix at src (row
// stride ld_src; perhaps written by other blocks of this launch: through
// L2, not L1) into shared memory of row stride LD, in 16-byte pieces;
// with FILL, rows at or past ``rows`` and columns at or past ``cols``
// become zeros (without, the whole tile is copied: the test cost the
// bf16 sweep 3.5% on an H100, PERF.md). The caller commits.
template <int ROWS, int LD, int COLS = KC, bool FILL = false, typename T>
__device__ __forceinline__ void issue_rows(T* dst, const T* src, size_t ld_src, int rows = ROWS,
                                           int cols = COLS) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = COLS / VEC;  // 16-byte pieces per row
  constexpr int PIECES = ROWS * CPR;
#pragma unroll
  for (int q = 0; q < (PIECES + NT - 1) / NT; ++q) {
    const int i = threadIdx.x + q * NT;
    if (PIECES % NT == 0 || i < PIECES) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      if constexpr (FILL) {
        const bool in = r < rows && c < cols;
        cp_async16(smem_addr(dst + r * LD + c), in ? src + (size_t)r * ld_src + c : src,
                   in ? 16 : 0);
      } else {
        cp_async16(smem_addr(dst + r * LD + c), src + (size_t)r * ld_src + c, 16);
      }
    }
  }
}

// ---------------------------------------------------------- the bf16 designs

// How the 8 warps of the bf16 forward's block of BB rows and U units share
// the product and the cell: RG row groups x UG unit groups (RG * UG <= 8
// warps take part; the rest only copy). Warp (rg, ug) owns MT 16-row
// tiles and UH 8-unit slices, so it holds all four gates of its (row,
// unit) pairs in 4 UH 8-column accumulator tiles per row tile: gate q's
// tile uh holds, at column 2c + p, unit 2 UH c + 2 uh + p of the warp's
// 8 UH units, so that the thread of lane c owns 2 UH neighbouring units
// (one vector of xg, h and each stream per row).
template <int BB, int U> struct WarpLayout {
  static constexpr int RG = BB / 16 < 4 ? BB / 16 : 4;
  static constexpr int UG = U / 8 < 8 / RG ? U / 8 : 8 / RG;
  static constexpr int WARPS = RG * UG;
  static constexpr int MT = BB / 16 / RG;
  static constexpr int UH = U / 8 / UG;
  static_assert(BB % 16 == 0 && U % 8 == 0 && WARPS <= NT / 32, "warp layout");
  static_assert(MT * RG * 16 == BB && UH * UG * 8 == U, "warp layout");
  // the column, among a gate's U columns in shared memory, of the unit
  // (within the block's U) at ``unit``
  __host__ __device__ static constexpr int col_at(int unit) {
    return unit / (8 * UH) * 8 * UH + 8 * (unit % (2 * UH) / 2) + 2 * (unit % (8 * UH) / (2 * UH)) +
           unit % 2;
  }
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// V 32-bit words (V bf16 pairs) from p (4 V-byte aligned, read-only for
// the launch) as one load, and to p as one store
template <int V> __device__ __forceinline__ void load_words(uint32_t (&w)[V], const void* p) {
  if constexpr (V == 4) {
    const uint4 x = __ldg(static_cast<const uint4*>(p));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (V == 2) {
    const uint2 x = __ldg(static_cast<const uint2*>(p));
    w[0] = x.x; w[1] = x.y;
  } else {
    static_assert(V == 1, "1, 2 or 4 words");
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  }
}

template <int V> __device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 2) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    static_assert(V == 1, "1, 2 or 4 words");
    *static_cast<uint32_t*>(p) = w[0];
  }
}

}  // namespace lstm
