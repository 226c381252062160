// Shared pieces of the hand-written flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) for Hopper (sm_90a): the reference's constants, the q
// pre-scale, the reductions within the quad of threads that share an
// accumulator row, and the block size rule; then the warp- and
// block-level pieces built on the PTX helpers of ptx_common.cuh (cp.async,
// ldmatrix, mma.sync, bf16 packing): row copies into shared memory, the
// q pre-scale in place, named barriers, fragment loads and packing, and
// the coalesced epilogue store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF_SENTINEL = -1e30f;  // the reference's finite -inf
constexpr float LOG2E = 1.4426950408889634f;

// a bf16 pair times a bf16 scale, each product rounded once to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------- the f32 (SIMT) design

// The first design, on the CUDA cores through shared memory in f32, of
// flash_fwd.cu and flash_bwd.cu: every f32 head, and the bf16 heads of
// 1024 in the two backward kernels (the bf16 forward at every head, and
// the backward up to 512, run on the tensor cores).
// T is the element type in device memory: bf16 is widened to f32 on load,
// rounded back where the reference rounds (the q pre-scale, p and ds
// before their products) and narrowed on store.
constexpr int F32_NT = 128;  // threads per block: 4 warps
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

constexpr size_t round32(size_t n) { return (n + 31) / 32 * 32; }

// the tile of a head of D (rows and keys): 64 up to d = 128; 32 at 256,
// 16 at 512 and 8 at 1024, so that the f32 rows fit shared memory
__host__ __device__ constexpr int simt_tile(int D) { return D <= 128 ? 64 : 8192 / D; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
// x rounded to T's precision, as f32 (the reference's casts before a product)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Rows [row0, row0 + nrows) of a row-major [t, D] matrix, times mul and
// rounded to T (mul = 1 leaves a value as it is), into f32 shared memory
// with leading dimension LD; rows at or past t become zeros.
template <int D, int LD, typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, int row0, int t,
                                              int nrows, float mul) {
  for (int i = threadIdx.x; i < nrows * D; i += F32_NT) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = (row0 + r < t) ? round_to<T>(to_f(src[(size_t)(row0 + r) * D + c]) * mul)
                                     : 0.f;
  }
}

// The current device's SM count. Returns a cudaError_t.
inline int sm_count(int* sms) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  return 0;
}

// Rows per block of the bf16 kernels, for t rows (queries in flash_fwd
// and flash_dq, keys in flash_dkv) in each of bh heads: 128 (8 warps, so
// fewer re-reads of the other operand) where that grid still fills every
// SM twice, else 64 (4 warps: short sequences or few heads, more blocks
// in flight). Returns a cudaError_t.
inline int block_rows(int bh, int t, int* rows) {
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  *rows = t > 64 && (long long)bh * ((t + 127) / 128) >= 2LL * sms ? 128 : 64;
  return 0;
}

// A warp's 16 rows [row0, row0 + 16) of a row-major [t, D] bf16 matrix into
// its shared-memory rows (leading dimension LD), zeros at or past t.
template <int D, int LD>
__device__ __forceinline__ void load_warp_rows(bf16* dst, const bf16* src, int row0, int t,
                                               int lane) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, col = (i % CH) * 8;
    const bool in = row0 + r < t;
    cp_async16(smem_addr(dst + r * LD + col), in ? src + (size_t)(row0 + r) * D + col : src,
               in ? 16 : 0);
  }
}

// Rows [row0, row0 + ROWS) of two row-major [t, D] bf16 matrices a and b
// (K and V, or q and dO) into the shared tiles a_dst and b_dst (leading
// dimension LD), zeros at or past t, by the block's NT threads.
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_tile_pair(bf16* a_dst, bf16* b_dst, const bf16* a,
                                               const bf16* b, int row0, int t) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, col = (i % CH) * 8;
    const bool in = row0 + r < t;
    const size_t off = in ? (size_t)(row0 + r) * D + col : 0;
    cp_async16(smem_addr(a_dst + r * LD + col), a + off, in ? 16 : 0);
    cp_async16(smem_addr(b_dst + r * LD + col), b + off, in ? 16 : 0);
  }
}

// The q pre-scale in place: each 16-byte chunk of the ROWS x D bf16 rows
// at `rows` (leading dimension LD) that this thread copied by
// load_tile_pair<D, LD, ROWS, NT> (the same walk of the chunks), times
// scale, each product rounded once to bf16 (scale_pair). Call it once
// this thread's copies have landed; a barrier then shows every chunk to
// every warp.
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void scale_rows(bf16* rows, float scale) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    uint4* p = reinterpret_cast<uint4*>(rows + (i / CH) * LD + (i % CH) * 8);
    uint4 x = *p;
    x.x = scale_pair(x.x, scale);
    x.y = scale_pair(x.y, scale);
    x.z = scale_pair(x.z, scale);
    x.w = scale_pair(x.w, scale);
    *p = x;
  }
}

// barrier of the `n` threads (whole warps) that meet at barrier `id` (0 is
// __syncthreads()'s)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4): the
// accumulator holds rows g (registers 0, 1) and g + 8 (2, 3) at columns
// 2c and 2c + 1 of its 8-column tile, which is also where the A fragment
// of a 16 x 16 block keeps the same rows' columns 2c, 2c + 1 (registers
// 0, 1) and 8 + 2c, 8 + 2c + 1 (2, 3): two accumulator tiles x0 (columns
// 0 .. 7) and x1 (8 .. 15), rounded to bf16 pairs, are one A fragment.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x0)[4],
                                       const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

// A fragment of a 16 x 16 block at `base` (16 rows, columns 16 kk ..):
// rows (lane % 16), columns 16 kk + 8 (lane / 16)
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base, int kk, int lane) {
  ldmatrix_x4(a, smem_addr(base + (lane % 16) * LD + 16 * kk + 8 * (lane / 16)));
}

// B fragments of x^T for two 8-column tiles, x row-major in shared memory
// (rows: the product's columns, as K is in S = Q K^T): rows 16 j + (lane %
// 8) + 8 (lane / 16), columns 16 kk + 8 ((lane / 8) % 2); registers 0, 1
// for rows 16 j .. 16 j + 7, registers 2, 3 for the next 8
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* x, int j, int kk, int lane) {
  ldmatrix_x4(b, smem_addr(x + (16 * j + lane % 8 + 8 * (lane / 16)) * LD + 16 * kk
                           + 8 * ((lane / 8) % 2)));
}

// B fragments of the 16 rows at x themselves (the product's depth, as V
// is in P V) for the 8-column tiles 2 np and 2 np + 1: ldmatrix.trans of
// rows (lane % 16), columns 16 np + 8 (lane / 16)
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* x, int np, int lane) {
  ldmatrix_x4_trans(b, smem_addr(x + (lane % 16) * LD + 16 * np + 8 * (lane / 16)));
}

// Epilogue of a warp's 16 x D f32 accumulators (fragment layout): each
// value x of row g + 8 h becomes bf16(f(x, h)) in the warp's own rows of
// shared memory at `stage` (which its lanes have finished reading), then
// 16-byte coalesced stores of the rows < t to dst, whose rows are LDG
// elements apart (D, or the whole head where the warp owns D of its
// columns).
template <int D, int LD, int LDG = D, typename F>
__device__ __forceinline__ void store_warp_rows(bf16* dst, bf16* stage,
                                                const float (&acc)[D / 8][4], F f, int row0,
                                                int t, int lane) {
  constexpr int CH = D / 8;
  const int g = lane / 4, c = lane % 4;
  __syncwarp();  // every lane is done reading the rows it overwrites
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * h) * LD + 8 * n + 2 * c) =
          pack_bf16(f(acc[n][2 * h], h), f(acc[n][2 * h + 1], h));
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, col = (i % CH) * 8;
    if (row0 + r < t) {
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * LDG + col) =
          *reinterpret_cast<const uint4*>(stage + r * LD + col);
    }
  }
}

}  // namespace
