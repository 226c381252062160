// Shared pieces of the hand-written flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) for Hopper (sm_90a): the reference's constants, the q
// pre-scale, the reductions within the quad of threads that share an
// accumulator row, and the block size rule; then the warp- and
// block-level pieces built on the PTX helpers of ptx_common.cuh (cp.async,
// ldmatrix, mma.sync, bf16 packing): row copies into shared memory, the
// q pre-scale in place, named barriers, fragment loads and packing, and
// the coalesced epilogue store; then the 3xTF32 pieces of the f32 kernels
// on the tensor cores (the TF32 split, mma.sync m16n8k8, fragments of f32
// rows and the f32 epilogue); then the f32 kernels' scores, each one fma
// chain in the forward's order on the CUDA cores (chain_columns,
// score_chain), and their gather into the accumulator layout.

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

constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

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

// Rows per block of the kernels at heads of 1024 that take two tilings
// (flash_fwd's, bf16 flash_dq's), for t rows in each of bh heads: 32 (the
// other axis read from L2 once per 32 rows) where that grid fills every
// SM, else 16 (twice the blocks in flight: short sequences or few heads).
// Returns a cudaError_t.
inline int rows_1024(int bh, int t, int* rows) {
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  *rows = (long long)bh * ((t + 31) / 32) >= sms ? 32 : 16;
  return 0;
}

// A warp's 16 rows [row0, row0 + 16) of a row-major [t, D] matrix (bf16 or
// f32) into its shared-memory rows (leading dimension LD), zeros at or
// past t.
template <int D, int LD, typename T>
__device__ __forceinline__ void load_warp_rows(T* dst, const T* src, int row0, int t,
                                               int lane) {
  constexpr int EL = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = D / EL;          // 16-byte chunks per row
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, col = (i % CH) * EL;
    const bool in = row0 + r < t;
    cp_async16(smem_addr(dst + r * LD + col), in ? src + (size_t)(row0 + r) * D + col : src,
               in ? 16 : 0);
  }
}

// Rows [row0, row0 + ROWS) of two row-major [t, D] matrices a and b (K
// and V, or q and dO; bf16 or f32) into the shared tiles a_dst and b_dst
// (leading dimension LD), zeros at or past t, by the block's NT threads.
template <int D, int LD, int ROWS, int NT, typename T>
__device__ __forceinline__ void load_tile_pair(T* a_dst, T* b_dst, const T* a, const T* b,
                                               int row0, int t) {
  constexpr int EL = 16 / sizeof(T);
  constexpr int CH = D / EL;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, col = (i % CH) * EL;
    const bool in = row0 + r < t;
    const size_t off = in ? (size_t)(row0 + r) * D + col : 0;
    cp_async16(smem_addr(a_dst + r * LD + col), a + off, in ? 16 : 0);
    cp_async16(smem_addr(b_dst + r * LD + col), b + off, in ? 16 : 0);
  }
}

// Columns [c0, c0 + C) of rows [row0, row0 + ROWS) of a row-major [t, D]
// matrix (bf16 or f32) into the shared rows dst (leading dimension LD),
// zeros at or past t, by the block's NT threads; with C = D the walk of
// the chunks is load_tile_pair's.
template <int D, int C, int LD, int ROWS, int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int t, int c0) {
  constexpr int EL = 16 / sizeof(T);
  constexpr int CH = C / EL;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, col = (i % CH) * EL;
    const bool in = row0 + r < t;
    cp_async16(smem_addr(dst + r * LD + col), in ? src + (size_t)(row0 + r) * D + c0 + col : src,
               in ? 16 : 0);
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

// B fragments of x^T for one 8-column tile, x 8 rows in shared memory (the
// product's columns), at the two depth steps 2 kk2 and 2 kk2 + 1: rows
// lane % 8, columns 32 kk2 + 8 (lane / 8); registers 0, 1 for step 2 kk2,
// 2, 3 for 2 kk2 + 1
template <int LD>
__device__ __forceinline__ void load_bt8(uint32_t (&b)[4], const bf16* x, int kk2, int lane) {
  ldmatrix_x4(b, smem_addr(x + (lane % 8) * LD + 32 * kk2 + 8 * (lane / 8)));
}

// B fragments of m16n8k8 of the 8 rows at x themselves (the product's
// depth) for the four 8-column tiles 4 n4 .. 4 n4 + 3: ldmatrix.trans of
// rows lane % 8, columns 32 n4 + 8 (lane / 8); register i for tile 4 n4 + i
template <int LD>
__device__ __forceinline__ void load_b8(uint32_t (&b)[4], const bf16* x, int n4, int lane) {
  ldmatrix_x4_trans(b, smem_addr(x + (lane % 8) * LD + 32 * n4 + 8 * (lane / 8)));
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

// ------------------------------------------------------------ 3xTF32
//
// The f32 kernels on the tensor cores: each f32 operand x is the pair big
// = x rounded to TF32 (10 mantissa bits, nearest, ties away from zero:
// the bits cvt.rna.tf32.f32 gives) and small = x - big (exact in f32),
// and each product a b is a_small b_big + a_big b_small + a_big b_big,
// three mma.sync m16n8k8 TF32 products into one f32 accumulator. The
// tensor cores read a TF32 operand's top 19 bits, so small enters
// truncated to 11 significant bits: with |small| <= 2^-11 |x| that is
// under 2^-21 |x|, and the dropped a_small b_small about 2^-22 of the
// product. big is rounded by an integer add and mask (2 instructions)
// rather than cvt.rna (4 on sm_90a: a finiteness test, the add, the mask
// and a select): with small's own cvt.rna the split took 9 instructions,
// and the kernels were bound by issuing them (in a trial on the H100
// that split made the backward a third slower, with errors no smaller).
// A NaN still propagates through small.
//
// Fragment layout of mma.m16n8k8 TF32 (g = lane / 4, c = lane % 4): A
// (16 x 8) holds (row g, col c), (g + 8, c), (g, c + 4), (g + 8, c + 4) in
// registers 0-3; B (8 x 8) holds (k c, n g) and (k c + 4, n g); the
// accumulator (16 x 8) holds rows g (registers 0, 1) and g + 8 (2, 3) at
// columns 2c and 2c + 1, as m16n8k16's does. An f32 element is a pair of
// 16-bit halves, so ldmatrix (non-transposed) of 8 rows x 4 words hands
// thread t the word (t / 4, t % 4): the A fragment and the B fragment of
// rows that are the product's columns (K in S = qs K^T) come by
// ldmatrix; there is no transposed 32-bit ldmatrix, so a B operand whose
// depth runs along the rows (K in dq = ds K) is read by scalar loads.

struct FragA {  // a split A fragment
  uint32_t big[4], small[4];
};
struct FragB {  // a split B fragment
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small terms first, then big times big
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// The A fragment of the 16 x 8 block at `base` (f32 rows, leading
// dimension LD; columns 8 kk ..), split: rows lane % 16, words 8 kk + 4
// (lane / 16)
template <int LD>
__device__ __forceinline__ void load_a_tf32(FragA& f, const float* base, int kk, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, smem_addr(base + (lane % 16) * LD + 8 * kk + 4 * (lane / 16)));
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), f.big[i], f.small[i]);
}

// B fragments of x^T for the two 8-column tiles 2 j and 2 j + 1, x f32
// rows (the product's columns, as K is in S = qs K^T), depth columns 8 kk
// ..: rows 16 j + lane % 8 + 8 (lane / 16), words 8 kk + 4 ((lane / 8) % 2)
template <int LD>
__device__ __forceinline__ void load_bt_tf32(FragB (&f)[2], const float* x, int j, int kk,
                                             int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, smem_addr(x + (16 * j + lane % 8 + 8 * (lane / 16)) * LD + 8 * kk
                           + 4 * ((lane / 8) % 2)));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(__uint_as_float(r[i]), f[i / 2].big[i % 2], f[i / 2].small[i % 2]);
}

// B fragments of x^T for one 8-column tile, x 8 f32 rows (the product's
// columns), at the two depth steps kk and kk + 1 (columns 8 kk ..): rows
// lane % 8, words 8 kk + 4 (lane / 8); f[0] is step kk's, f[1] kk + 1's
template <int LD>
__device__ __forceinline__ void load_bt8_tf32(FragB (&f)[2], const float* x, int kk, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, smem_addr(x + (lane % 8) * LD + 8 * kk + 4 * (lane / 8)));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(__uint_as_float(r[i]), f[i / 2].big[i % 2], f[i / 2].small[i % 2]);
}

// A 16 x 8 accumulator tile x as the A fragment of a product over its 8
// columns, split, with its columns permuted: the product's depth index c
// is column 2c and c + 4 is column 2c + 1, so that each thread's own
// accumulator registers are its A registers (no shuffles). The B operand
// of that product must read its depth rows in the same order
// (load_b_perm_tf32).
__device__ __forceinline__ void c_to_a_tf32(FragA& f, const float (&x)[4]) {
  split_tf32(x[0], f.big[0], f.small[0]);
  split_tf32(x[2], f.big[1], f.small[1]);
  split_tf32(x[1], f.big[2], f.small[2]);
  split_tf32(x[3], f.big[3], f.small[3]);
}

// The B fragment, split, of the 8 f32 rows at x (the product's depth, in
// c_to_a_tf32's order: depth c is row 2c, c + 4 is row 2c + 1) and the 8
// columns n0 ..: scalar loads of rows 2c and 2c + 1 at column n0 + g.
// With LD = 4 (mod 32) words the 32 lanes hit 32 banks.
template <int LD>
__device__ __forceinline__ void load_b_perm_tf32(FragB& f, const float* x, int n0, int lane) {
  const int g = lane / 4, c = lane % 4;
  split_tf32(x[(2 * c) * LD + n0 + g], f.big[0], f.small[0]);
  split_tf32(x[(2 * c + 1) * LD + n0 + g], f.big[1], f.small[1]);
}

// The q pre-scale in place for f32 rows: each 16-byte chunk of the ROWS x
// D rows at `rows` (leading dimension LD) that thread `tid` of NT copied
// (the walk of load_tile_pair<D, LD, ROWS, NT>; ROWS = 16 and NT = 32 are
// load_warp_rows' walk by lane), times scale, each product rounded once.
// Call it once this thread's copies have landed.
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void scale_rows_f32(float* rows, float scale, int tid) {
  constexpr int CH = D / 4;
  for (int i = tid; i < ROWS * CH; i += NT) {
    float4* p = reinterpret_cast<float4*>(rows + (i / CH) * LD + (i % CH) * 4);
    float4 x = *p;
    x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
    *p = x;
  }
}

// Epilogue of a warp's 16 x D f32 accumulators (fragment layout): each
// value times mul into the warp's own f32 rows at `stage` (which its
// lanes have finished reading), then 16-byte coalesced stores of the rows
// < t to dst, whose rows are LDG elements apart (D, or the whole head
// where the warp owns D of its columns).
template <int D, int LD, int LDG = D>
__device__ __forceinline__ void store_warp_rows_f32(float* dst, float* stage,
                                                    const float (&acc)[D / 8][4], float mul,
                                                    int row0, int t, int lane) {
  constexpr int CH = D / 4;
  const int g = lane / 4, c = lane % 4;
  __syncwarp();  // every lane is done reading the rows it overwrites
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(stage + (g + 8 * h) * LD + 8 * n + 2 * c) =
          make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, col = (i % CH) * 4;
    if (row0 + r < t) {
      *reinterpret_cast<float4*>(dst + (size_t)(row0 + r) * LDG + col) =
          *reinterpret_cast<const float4*>(stage + r * LD + col);
    }
  }
}

// ------------------------------- the f32 scores, in the forward's order
//
// Every f32 kernel takes its scores s = qs k^T on the CUDA cores, each
// score one fma chain over the head's columns 0 .. D - 1 in order, from
// 0, on the pre-scaled q (q times the scale, one rounding); at 1024 the
// sum in column order of one such chain over each quarter of the head
// (score_chain_cols).
// The forward takes lse from these scores and the backward rebuilds p =
// exp(s - lse) from the same bits, so s - lse holds no rounding of s that
// lse does not hold too, as in the reference, whose two passes compute s
// alike. A score taken otherwise (on the tensor cores, or even exactly)
// differs from the forward's by the forward's own roundings, and at
// scores of ±60 the exponential carries that to several times the
// reference's error (ROADMAP C3, C4; scripts/scale4_emulation.py). The
// bits depend on each score's own chain alone (fmaf(a, b, s) is
// fmaf(b, a, s)), so a thread may take any tile of scores.

// The columns of one chain of a score at a head of D: the whole head up
// to 512; at 1024 each quarter of it (256 columns), the four chains each
// from 0 and their sums added in column order, ((c0 + c1) + c2) + c3
// (the f32 forward's chain_columns over its 256-column chunks, and the
// 3xTF32 backward's chain_chunk). At scores of ±60 one chain over 1024 columns
// carries about twice the reference's f32 error (o 2.35x, dv 2.08x in
// scripts/scale4_emulation.py, and alike in a trial on the card), the
// quarters 0.5-1x.
__host__ __device__ constexpr int score_chain_cols(int D) { return D < 1024 ? D : 256; }

// The stride in words of a row of T staged scores (score_chain): at
// least T and 8 (mod 32)
__host__ __device__ constexpr int score_stride(int T) { return (T + 31) / 32 * 32 + 8; }

// The forward's order by a warp's tile (every f32 kernel: the forward
// and the 3xTF32 backward at every head): the 4 RB x 8 CB scores of
// rows a (4 RB rows) against rows b (8 CB rows), each one fma chain over
// the columns 0 .. D - 1 from 0. Lane l takes rows l / 8 + 4 u (u < RB)
// and columns l % 8 + 8 w (w < CB), a register tile of RB x CB chains:
// per 4 columns it reads RB + CB float4 for 4 RB CB fmas, and the 4 rows
// and 8 columns a read touches lie 4 banks apart (leading dimensions 4
// mod 32), so the lanes that share a row share its read. chain_columns
// moves each chain on over C columns (a chain may stop after any column
// and go on from its sum: the same fmas in the same order), and
// store_scores writes the tile to St (leading dimension LS = 8 mod 32,
// score_stride: the warp's 32 stores of one score hit 32 banks), whence
// gather_scores takes the scores in the accumulator layout.
template <int C, int LDA, int LDB, int RB, int CB>
__device__ __forceinline__ void chain_columns(float (&s)[RB][CB], const float* a, const float* b,
                                              int lane) {
  static_assert(LDA % 32 == 4 && LDB % 32 == 4, "chain_columns' strides");
  const int r = lane / 8, col = lane % 8;
#pragma unroll 2
  for (int i = 0; i < C; i += 4) {
    float4 x[RB], y[CB];
#pragma unroll
    for (int u = 0; u < RB; ++u) x[u] = *reinterpret_cast<const float4*>(a + (r + 4 * u) * LDA + i);
#pragma unroll
    for (int w = 0; w < CB; ++w) y[w] = *reinterpret_cast<const float4*>(b + (col + 8 * w) * LDB + i);
#pragma unroll
    for (int u = 0; u < RB; ++u) {
#pragma unroll
      for (int w = 0; w < CB; ++w) {
        s[u][w] = fmaf(x[u].x, y[w].x, s[u][w]);
        s[u][w] = fmaf(x[u].y, y[w].y, s[u][w]);
        s[u][w] = fmaf(x[u].z, y[w].z, s[u][w]);
        s[u][w] = fmaf(x[u].w, y[w].w, s[u][w]);
      }
    }
  }
}

template <int RB, int CB, int LS>
__device__ __forceinline__ void store_scores(float* St, const float (&s)[RB][CB], int lane) {
  static_assert(LS % 32 == 8, "store_scores' stride");
  const int r = lane / 8, col = lane % 8;
#pragma unroll
  for (int u = 0; u < RB; ++u) {
#pragma unroll
    for (int w = 0; w < CB; ++w) St[(r + 4 * u) * LS + col + 8 * w] = s[u][w];
  }
}

// The whole chains over D columns from 0 (leading dimension LD), to St.
// Call it once every lane of the warp (and any other reader) is done with
// St's last scores.
template <int D, int LD, int RB, int CB, int LS>
__device__ __forceinline__ void score_chain(float* St, const float* a, const float* b, int lane) {
  float s[RB][CB] = {};
  chain_columns<D, LD, LD, RB, CB>(s, a, b, lane);
  store_scores<RB, CB, LS>(St, s, lane);
}

// A warp's NT8 accumulator tiles of the 16 x 8 NT8 scores at St (leading
// dimension LS): rows g and g + 8, columns 8 n + 2 c and 8 n + 2 c + 1,
// read as pairs (two wavefronts a read, the least for 256 bytes).
template <int NT8, int LS>
__device__ __forceinline__ void gather_scores(float (&s)[NT8][4], const float* St, int lane) {
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = *reinterpret_cast<const float2*>(St + (g + 8 * h) * LS + 8 * n + 2 * c);
      s[n][2 * h] = x.x, s[n][2 * h + 1] = x.y;
    }
  }
}

}  // namespace
