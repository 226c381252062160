// Shared pieces of the hand-written LSTM scan kernels (lstm_fwd.cu,
// lstm_bwd.cu) for Hopper (sm_90a): conversions, the batch-group
// barrier of the persistent kernels, the double-buffered staging of row
// chunks through shared memory (cp.async), and the per-step block
// product on the tensor cores (bf16, WMMA 16x16x16 with f32
// accumulation) or the CUDA cores (f32); then the pieces of the bf16
// forward's mma.sync design (lstm_fwd.cu): the card's nanosecond timer,
// the batch-group barrier split into a release arrival and an acquire
// wait, the warp layout over a block's rows and units, and the copy of
// one chunk into a ring stage.
//
// Layout shared by both sweeps: a block (bi, j) of the persistent grid
// owns batch rows [bi * BB, +BB) and hidden units [j * U, +U) for the
// whole sequence. The blocks of one batch group (same bi) exchange only
// through device memory, between steps, behind group_barrier (or, in
// the bf16 forward, group_arrive and group_wait).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "ptx_common.cuh"

namespace lstm {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;   // threads per block: 8 warps
constexpr int KC = 64;    // depth of one staged chunk of the product
constexpr int MAX_BB = 128;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory row pads: bf16 rows stay 16-byte aligned for vector
// stores and WMMA tile origins 32-byte aligned; f32 rows of the staged
// chunk keep 16-byte alignment too.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<bf16> { static constexpr int value = 8; };

template <typename T> __host__ __device__ constexpr int lda() { return KC + Pad<T>::value; }

// All blocks of one batch group (same bi) meet here: the writes each
// made before the call are visible to all of them after it. ``target``
// is the count of arrivals the group's counter reaches at this meeting
// (the counter starts at 0 and only grows). The grid is co-resident
// (cooperative launch), so spinning cannot deadlock; a wait of seconds
// (a fault, not a slow step) traps, which fails the launch instead of
// hanging the card.
__device__ __forceinline__ void group_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned int spins = 0;
    while (*reinterpret_cast<volatile unsigned int*>(counter) < target) {
      __nanosleep(64);
      if (++spins == (1u << 27)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Starts copying rows [0, nrows) x columns [col0, col0 + KC) of a
// row-major matrix with row stride ``ld_src`` into shared memory with
// row stride ``ld_dst``; rows at or past ``valid`` become zeros. The
// 16-byte asynchronous copies go through L2 only (``.cg``): the rows may
// have been written by another block of this launch, which L1 would not
// see. The caller commits and waits.
template <typename T>
__device__ __forceinline__ void issue_chunk(T* dst, int ld_dst, const T* src, size_t ld_src,
                                            int col0, int nrows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = KC / VEC;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < nrows * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    T* d = dst + r * ld_dst + c;
    if (r < valid)
      cp_async16(smem_addr(d), src + (size_t)r * ld_src + col0 + c, 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Bytes of the two staging buffers of block_product (for BB rows).
template <typename T> __host__ __device__ constexpr size_t stage_bytes(int BB) {
  return 2 * round128(sizeof(T) * (size_t)BB * lda<T>());
}

// out[BB][NC] (f32, row stride ldo, shared memory) = A[BB][K] . B[K][NC],
// with A's rows read from device memory (row stride lda_g) through two
// staging buffers at ``stage`` (the next chunk is in flight while the
// current one is multiplied; ``out`` may alias them: it is written only
// after the last chunk is consumed) and B resident in shared memory:
// B(k, c) = W[k * ldw + c] (B_COL false) or W[c * ldw + k] (B_COL true).
// NC is 4U (the forward's gates) or U (the backward's units); BB <= MAXB,
// the rows the f32 path's per-thread arrays are sized for.
template <typename T, int NC, bool B_COL, int MAXB>
__device__ void block_product(float* out, int ldo, T* stage, const T* A, size_t lda_g,
                              const T* W, int ldw, int K, int BB) {
  constexpr int LDA = lda<T>();
  const size_t half = stage_bytes<T>(BB) / 2;
  // the staging buffer of chunk kc (no array: its index is not constant)
  auto buf = [&](int kc) {
    return reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stage) + (kc & 1) * half);
  };
  const int tid = threadIdx.x;
  const int nk = K / KC;
  issue_chunk<T>(buf(0), LDA, A, lda_g, 0, BB, BB);
  cp_async_commit();
  if constexpr (sizeof(T) == 2) {
    // warp w owns one 16-row tile and a run of 16-column tiles: the
    // row tiles (BB / 16, a divisor of 8) share the 8 warps evenly
    constexpr int CT = NC / 16;                 // column tiles
    const int warp = tid / 32;
    const int wpr = 8 / (BB / 16);              // warps per row tile
    const int rt = warp / wpr;
    const int cpw = (CT + wpr - 1) / wpr;       // column tiles per warp
    const int ct0 = (warp % wpr) * cpw;
    const int mine = max(0, min(cpw, CT - ct0));
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CT];
#pragma unroll
    for (int q = 0; q < CT; ++q) wmma::fill_fragment(acc[q], 0.f);
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) issue_chunk<T>(buf(kc + 1), LDA, A, lda_g, (kc + 1) * KC, BB, BB);
      cp_async_commit();
      cp_async_wait<1>();  // chunk kc has landed
      __syncthreads();
      const T* cur = buf(kc);
      const int k0 = kc * KC;
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, cur + rt * 16 * LDA + kk, LDA);
#pragma unroll
        for (int q = 0; q < CT; ++q) {
          if (q < mine) {
            const int ct = ct0 + q;
            if constexpr (B_COL) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
              wmma::load_matrix_sync(b, W + (size_t)ct * 16 * ldw + k0 + kk, ldw);
              wmma::mma_sync(acc[q], a, b, acc[q]);
            } else {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
              wmma::load_matrix_sync(b, W + (size_t)(k0 + kk) * ldw + ct * 16, ldw);
              wmma::mma_sync(acc[q], a, b, acc[q]);
            }
          }
        }
      }
      __syncthreads();  // everyone is done with this buffer before it refills
    }
    cp_async_wait<0>();
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      if (q < mine) {
        wmma::store_matrix_sync(out + rt * 16 * ldo + (ct0 + q) * 16, acc[q], ldo,
                                wmma::mem_row_major);
      }
    }
  } else {
    constexpr int RP = NT / NC;                 // rows per pass
    constexpr int RPT = (MAXB + RP - 1) / RP;   // rows per thread, at most
    const int c = tid % NC, rg = tid / NC;
    float acc[RPT];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) acc[rr] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) issue_chunk<T>(buf(kc + 1), LDA, A, lda_g, (kc + 1) * KC, BB, BB);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* cur = buf(kc);
      const int k0 = kc * KC;
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float b = B_COL ? W[(size_t)c * ldw + k0 + kk] : W[(size_t)(k0 + kk) * ldw + c];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          const int r = rg + rr * RP;
          if (r < BB) acc[rr] += to_f(cur[r * LDA + kk]) * b;
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int r = rg + rr * RP;
      if (r < BB) out[r * ldo + c] = acc[rr];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- the
// bf16 forward's mma.sync design (lstm_fwd.cu)

constexpr int STAGES = 3;  // ring stages of h_{t-1} chunks (2 in flight)

// the card's nanosecond clock (the same on every SM)
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// group_barrier in two halves, with a release add and an acquire poll on
// the group's counter instead of fences around a relaxed atomic and a
// sleeping poll, so that a block can do work between its arrival and its
// wait. group_arrive: the __syncthreads orders every thread's stores
// before it ahead of thread 0's add (a release is cumulative); stores
// after it are not ordered for the other blocks. group_wait: the
// __syncthreads after the poll orders every thread's later reads after
// it. A wait longer than four seconds is a fault and traps.
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

// How the 8 warps of a block of BB rows and U units share the product
// and the cell: RG row groups x UG unit groups (RG * UG <= 8 warps take
// part; the rest only copy). Warp (rg, ug) owns MT 16-row tiles and UH
// 8-unit slices, so it holds all four gates of its (row, unit) pairs in
// 4 UH 8-column accumulator tiles per row tile: gate q's tile uh holds,
// at column 2c + p, unit 2 UH c + 2 uh + p of the warp's 8 UH units, so
// that the thread of lane c owns 2 UH neighbouring units (one vector of
// xg, h and each stream per row).
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

// Starts copying BB rows x columns [col0, col0 + KC) of a row-major bf16
// matrix (row stride ld_src, written by other blocks of this launch:
// through L2, not L1) into a ring stage of row stride LD; the caller
// commits.
template <int BB, int LD>
__device__ __forceinline__ void issue_rows(bf16* dst, const bf16* src, int ld_src, int col0) {
  constexpr int CPR = KC / 8;  // 16-byte pieces per row
  constexpr int PIECES = BB * CPR;
#pragma unroll
  for (int q = 0; q < (PIECES + NT - 1) / NT; ++q) {
    const int i = threadIdx.x + q * NT;
    if (PIECES % NT == 0 || i < PIECES) {
      const int r = i / CPR, c = (i % CPR) * 8;
      cp_async16(smem_addr(dst + r * LD + c), src + (size_t)r * ld_src + col0 + c, 16);
    }
  }
}

}  // namespace lstm
