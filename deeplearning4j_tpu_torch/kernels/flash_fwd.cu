// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/flash_attention.py
// `_flash_fwd_impl` -> `_fwd_kernel`: blocked online-softmax attention over
// q, k, v [bh, t, d], q scaled by 1/sqrt(d) rounded to q's dtype, causal
// mask with offset = tk - tq (masked scores at the reference's -1e30, keys
// past tk a true -inf), key tiles wholly above the diagonal skipped,
// softmax statistics and the output accumulated in f32, the probabilities
// rounded to bf16 before P.V. Emits o [bh, tq, d] in q's dtype and
// lse = m + log(max(l, 1e-30)) [bh, tq] in f32.
//
// What bounds it on the H100: at the GPT prefill shape ([64, 64, 64] bf16
// causal) the least time is 0.00063 ms, set by bytes, so a call is bound by
// launch latency and one wave of 64 blocks; at the training shape
// ([128, 1024, 64] bf16 causal) it is bound by bytes at d = 64 (0.0202 ms,
// against 0.0174 ms of tensor-core operations), so a kernel near the bound
// has to keep both the tensor cores and the copies busy at once.
//
// The bf16 kernel (every main path: GPT prefill and training are bf16) is
// the FlashAttention-2 structure on Hopper's warp-level tensor cores:
// - a warp owns 16 query rows for the whole key loop; a block is 8 warps
//   (BQ = 128: K and V are re-read from L2 once per 128 query rows) where
//   that grid still fills every SM twice, else 4 (BQ = 64: the prefill's
//   64 rows, or few heads); the q-tiles with the most key tiles go first;
// - Q is read once, scaled (q * scale rounded to bf16, bit for bit the
//   reference's pre-scale, so no separate launch scales q) and kept in
//   registers as ldmatrix-loaded A fragments;
// - K and V tiles of 64 keys come through a ring of shared-memory stages
//   (three at d = 64, two at d = 128) filled by 16-byte cp.async.cg
//   copies: the next tiles are in flight while the current one is
//   multiplied, with one __syncthreads() per key tile (the old kernel
//   loaded synchronously and met 4 barriers);
// - both products are mma.sync m16n8k16 (bf16 in, f32 accumulate), B
//   fragments from ldmatrix (K) and ldmatrix.trans (V); rows are padded
//   by 16 bytes so the 8 rows an ldmatrix phase reads hit distinct banks;
// - S, P and O never touch shared memory (the old kernel staged S in f32,
//   P and O through it): the softmax runs on the S accumulators, a row's
//   max and sum take two shuffles within the quad of threads that share
//   the row, the correction scales the O accumulators in registers, and
//   the S accumulators, rounded to bf16 pairs, are the A fragments of P.V;
// - only tiles on the diagonal or past tk evaluate the masks;
// - the epilogue divides by max(l, 1e-30), stages O through the warp's own
//   Q rows of shared memory and writes 16-byte coalesced stores; lse is
//   written once per row; rows at or past tq are neither read nor written.
// Shared memory per block: (BQ + 2 * STAGES * 64) * (d + 8) * 2 bytes: at
// d = 64, 63 KB for 4 warps and 72 KB for 8 (the old kernel took 72 KB for
// 4). At d = 64 the kernel keeps to 128 registers, so two 8-warp blocks
// (16 warps) share an SM, where the old kernel's blocks left 12.
//
// The wide bf16 kernel (flash_fwd_kernel_wide) runs the bf16 heads of
// 256, 512 and 1024 (129-256, 257-512 and 513-1024 are zero-padded to
// them) on the same tensor-core tools. The kernel above cannot: a warp
// there keeps Q as A fragments (d / 4 registers) and O as accumulators
// (d / 2), 192 + 32 of S at d = 256 and more than 255 at 512. So:
// - Q is not held in registers: the block's rows are copied once by
//   cp.async, scaled in place (each thread the chunks it copied) and read
//   as A fragments by ldmatrix at each 16-column step of every key tile;
// - each warp owns 256 of the head's columns, so O takes 128 f32
//   registers and S 8 per 8-key tile, within 255 without spills; the
//   warps of a row group of 16 query rows split the head between them:
//   one at d = 256 (64 rows, 4 warps a block), two at 512 (64 rows, 8
//   warps) and four at 1024 (32 rows in two row groups, 8 warps: 8 warps
//   of ~240 registers are what an SM's 65,536 hold; or 16 rows, 4 warps,
//   where a grid of 32-row blocks would not fill every SM: twice the
//   blocks in flight, at twice the reads of K and V from L2);
// - where a row group has more than one warp, each contracts S over its
//   own 256 columns of d, and the partials (16 x 8 f32 a warp and 8-key
//   tile) are exchanged through shared memory under the row group's
//   named barrier (bar.sync 1 + row group, 32 x WPR threads); every warp
//   of the group sums them in the order of their columns, so all hold
//   bitwise the same S and compute the same m, l and P, then each
//   multiplies P by its own columns of V (no product is computed twice);
// - K and V tiles come through two cp.async.cg stages with rows padded by
//   16 bytes, one __syncthreads() per key tile (which also orders the
//   partials' reuse): 32 keys at 256 and 512, 16 at 1024, where two
//   stages of 32 would not fit beside Q; S and P stay in registers, the
//   softmax, masks, epilogue and the order of the q-tiles are the kernel
//   above's;
// - shared memory: 99 KB at d = 256, so two blocks share an SM (8
//   warps), 211 KB at 512 (one 8-warp block: Q 65 KB, two stages of K and
//   V 130 KB, the partials 16 KB) and 202 KB at 1024 (Q 64.5 KB for 32
//   rows, two stages of 16-key K and V 129 KB, the partials 8 KB; 165 KB
//   for 16 rows): one block an SM.
// What bounds it at [32, 1024, 256] bf16 causal: bytes, 0.0201 ms,
// against 0.0174 ms of tensor-core operations (the same at [16, 1024,
// 512] and [8, 1024, 1024]). Each warp reads 40 KB of shared memory by
// ldmatrix per 32-key tile for 128 mma.sync (Q 8, K 16, V 16); at 1024
// 24 KB per 16-key tile for 64 (Q 8, K 8, V 8) and the exchange's 1 KB
// written and 3 KB read. So shared-memory reads, not the tensor cores,
// are its likely limit. K and V come from L2 once per 64 query rows; at
// 1024 once per 32 (or 16), 554 MB a call at [8, 1024, 1024] causal, so
// there L2's bandwidth is a second likely limit.
//
// The f32 kernel (flash_fwd_kernel_tf32x3) runs the f32 heads of 64,
// 128, 256, 512 and 1024 (1-1024 zero-padded to them). Its scores must be
// bit for bit the f32 backward's (flash_bwd.cu), which rebuilds p = exp(s
// - lse) from lse: s - lse cancels the rounding of s only where both
// passes computed s alike (at scores of ±60 a score taken otherwise
// carries several times the reference's error; ROADMAP C3, C4). So each
// score is one fma chain over the head's columns 0 .. D - 1 from 0 on the
// CUDA cores (score_chain, flash_common.cuh), at 1024 the sum in column
// order of one chain over each quarter of the head (score_chain_cols:
// one chain over 1024 columns carries twice the reference's error
// there), the order the backward kernels take, and only P V runs on the
// tensor cores, in 3xTF32 (each f32 operand split into a TF32 value and
// the rest, three mma.sync m16n8k8 products). What bounds it at [128,
// 1024, 64] f32 causal: 4 d flops per live pair, 0.257 ms at 67 TFLOP/s
// on the CUDA cores; the chains' 2 d of them alone take 0.128 ms (the
// same at [32, 1024, 256], [16, 1024, 512] and [8, 1024, 1024]), P V in
// 3xTF32 (three TF32 products each) 0.052 ms at 495 TFLOP/s. So the
// chains are the kernel's floor, and its design keeps them fed:
// - 8 warps a block; a row group of 16 query rows has WP = 1 warp at 64
//   and 128, 2 at 256, 4 at 512 and 8 or 4 at 1024, each owning DW = 64
//   or 128 of the head's columns of O (32 or 64 accumulator registers;
//   at 1024 32 or 64 columns of each 256-column quarter); 128 rows a
//   block up to 128, 64 at 256, 32 at 512, 16 or 32 at 1024 (32 where
//   that grid fills every SM); the q-tiles with the most key tiles
//   first;
// - qs resident in shared memory (copied once, scaled in place: q *
//   scale, one rounding, the backward's pre-scale), f32 rows 4 words
//   (mod 32) apart; up to 256 K and V through a cp.async ring of T-key
//   tiles (64 keys in three stages at 64, 32 in three at 128, 32 in two
//   at 256); at 512 K in 256-column chunks of 32-key tiles (two stages)
//   and V in whole tiles (one stage), since two stages of whole 32-key
//   tiles would not fit beside qs; at 1024 K's and then V's 256-column
//   chunks of 64-key (16 rows) or 32-key (32 rows) tiles alike through
//   two stages: 172-205 KB, one block an SM;
// - per tile the row group's 16 x T scores are chained by one warp of
//   the group up to 256 (each lane a 4 x 8 tile of chains at 64, 4 x 4
//   at 128 and 256), by two at 512 (4 x 2 each, every chain carried from
//   one chunk of K to the next) and at 1024 by four (16 rows: 2 x 4
//   each) or two (32 rows: 4 x 2), a chain a chunk, the chaining warps on
//   different schedulers: a larger tile
//   reads fewer bytes of shared memory per fma, and those reads bound the
//   chains; staged in shared memory and read by every warp of the group
//   in the accumulator layout after the group's barrier (a named barrier
//   at 256, the block's at 512 and 1024), so that all of them hold the
//   same s, m, l and p;
// - online softmax in f32 on the accumulators (expf, logf, the -1e30
//   sentinel and the 1e-30 floor of the plain version), masks only on
//   tiles that cross tk or the group's diagonal, tiles wholly above it
//   skipped;
// - O += P V over the warp's columns with P's accumulators as A
//   fragments (their depth permuted, flash_common.cuh) and V's rows read
//   in that order; each 8-column tile of O sums a tile in a zeroed
//   partial, added to O corr with one rounded fma (the tensor cores'
//   accumulation truncates, and a chain over the whole sequence would
//   carry that);
// - the epilogue divides by max(l, 1e-30), stages each warp's O through
//   its columns of its group's qs rows and writes 16-byte stores; lse is
//   written once per row.
// At 1024 a second limit is L2: K and V come from it once per block of
// 16 query rows, 2.2 GB a call at [8, 1024, 1024] causal; in a trial on
// the H100 the kernel with its chains and products taken out (copies,
// barriers and the epilogue alone) took about half of its time there,
// so a full grid takes blocks of 32 rows, which halve those reads.
//
// The PTX helpers (cp.async, ldmatrix, mma.sync, bf16 packing, the q
// pre-scale, quad reductions) and the pieces built on them (row copies,
// the pre-scale of copied rows, named barriers, fragment loads and
// packing, the epilogue store) live in flash_common.cuh, shared with the
// backward kernels of flash_bwd.cu (whose wide kernels take this wide
// kernel's structure).
//
// Exposed as a plain C function so that no PyTorch header is compiled.

#include "flash_common.cuh"

namespace {

constexpr int BK = 64;  // keys per tile

// -------------------------------------------------------- the bf16 kernel

// The masks of a warp's S accumulators (NS 8-key tiles from key k0, rows
// r0 + g and r0 + g + 8), evaluated only where the tile reaches past tk
// or above the warp's diagonal: a key past tk is not in the row (-inf),
// a key above the diagonal takes the reference's sentinel.
template <int NS>
__device__ __forceinline__ void mask_scores(float (&s)[NS][4], int k0, int r0, int tk,
                                            int offset, int causal, int lane) {
  if (k0 + 8 * NS <= tk && !(causal && k0 + 8 * NS - 1 > r0 + offset)) return;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + 8 * n + 2 * c + (j % 2);
      const int row = r0 + g + 8 * (j / 2);
      if (col >= tk) s[n][j] = -INFINITY;
      else if (causal && row + offset < col) s[n][j] = NEG_INF_SENTINEL;
    }
  }
}

// One key tile of the online softmax on the accumulators (h = 0: row g,
// h = 1: row g + 8): the row's max m and this thread's share of its sum l
// move on, the O accumulators take the correction, and s becomes p.
template <int NS, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4], float (&acc)[NO][4],
                                               float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    const float m_new = quad_max(mx);
    // (x - m) * log2(e), not fma(x, log2(e), -m log2(e)): a sentinel
    // score against a sentinel max must give exactly exp(0)
    const float corr = exp2f((m[h] - m_new) * LOG2E);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 2 * h; j < 2 * h + 2; ++j) {
        s[n][j] = exp2f((s[n][j] - m_new) * LOG2E);
        sum += s[n][j];
      }
    }
    l[h] = corr * l[h] + sum;
    m[h] = m_new;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][2 * h] *= corr;
      acc[n][2 * h + 1] *= corr;
    }
  }
}

template <int D, int BQ>
struct Bf16Tiles {
  // K/V ring depth: three stages at d = 64; at d = 128 a third stage
  // would leave one 4-warp block per SM (122 KB of shared memory)
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int LD = D + 8;  // row stride in elements: 16 bytes of padding
  static constexpr size_t bytes = sizeof(bf16) * (size_t)(BQ + 2 * STAGES * BK) * LD;
  // d = 64: at most 128 registers, so 512 threads (two 8-warp blocks) fit an SM
  static constexpr int MIN_BLOCKS = D == 64 ? 512 / (2 * BQ) : 1;
};

// Two S accumulator tiles are one P fragment (pack_a, flash_common.cuh).
template <int D, int BQ>
__global__ void __launch_bounds__(BQ * 2, Bf16Tiles<D, BQ>::MIN_BLOCKS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int bh, int tq, int tk, int n_qtiles, int causal, float scale) {
  constexpr int NT = BQ * 2;      // BQ / 16 warps
  constexpr int LD = Bf16Tiles<D, BQ>::LD;
  constexpr int STAGES = Bf16Tiles<D, BQ>::STAGES;
  constexpr int NS = BK / 8;      // S accumulator tiles (8 keys each)
  constexpr int NO = D / 8;       // O accumulator tiles (8 columns each)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;            // STAGES tiles of BK rows
  bf16* Vs = Ks + STAGES * BK * LD;   // STAGES tiles of BK rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  // the q-tiles with the most key tiles (the last ones, under the causal
  // mask) first, so the last wave of blocks is not the longest
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);
  const int b = blockIdx.x % bh;
  const int q0 = qt * BQ;
  const int r0 = q0 + 16 * warp;  // this warp's first query row
  const int offset = tk - tq;
  const bf16* qb = q + (size_t)b * tq * D;
  const bf16* kb = k + (size_t)b * tk * D;
  const bf16* vb = v + (size_t)b * tk * D;
  bf16* Qw = Qs + 16 * warp * LD;  // this warp's rows: Q, later its O

  // this warp's 16 Q rows (zeros past tq): copy group 0
  load_warp_rows<D, LD>(Qw, qb, r0, tq, lane);
  cp_async_commit();

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  // key tile kt (zeros past tk) into ring stage kt % STAGES
  auto load_kv = [&](int kt) {
    const int st = kt % STAGES;
    load_tile_pair<D, LD, BK, NT>(Ks + st * BK * LD, Vs + st * BK * LD, kb, vb, kt * BK, tk);
  };
  // groups 1 .. STAGES - 1: the first tiles (empty groups past the last)
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_kv(s);
    cp_async_commit();
  }

  // Q as A fragments, scaled: rows (lane % 16), columns 16 kk + 8 (lane / 16)
  cp_async_wait<STAGES - 1>();  // group 0 (this thread's Q copies) landed
  __syncwarp();                 // ... and the other lanes' too
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<LD>(qa[kk], Qw, kk, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) qa[kk][j] = scale_pair(qa[kk][j], scale);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF_SENTINEL, NEG_INF_SENTINEL};  // rows g, g + 8
  float l[2] = {0.f, 0.f};                            // this thread's share

  for (int kt = 0; kt < n_kt; ++kt) {
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose stage the next copy refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_kt) load_kv(kt + STAGES - 1);
    cp_async_commit();

    const bf16* Kt = Ks + (kt % STAGES) * BK * LD;
    const bf16* Vt = Vs + (kt % STAGES) * BK * LD;
    const int k0 = kt * BK;

    // S = Q K^T: two 8-key tiles per ldmatrix
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bfr[4];
        load_bt<LD>(bfr, Kt, np, kk, lane);
        mma_bf16(s[2 * np], qa[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bfr[2], bfr[3]);
      }
    }

    mask_scores(s, k0, r0, tk, offset, causal, lane);
    online_softmax(s, acc, m, l);

    // O += P V: P from the S accumulators; B fragments by ldmatrix.trans
    // of keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bfr[4];
        load_b<LD>(bfr, Vt + 16 * kk * LD, np, lane);
        mma_bf16(acc[2 * np], pa, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], pa, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // epilogue: lse once per row; O / max(l, 1e-30) into this warp's Q rows,
  // then coalesced 16-byte stores
  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] = fmaxf(quad_sum(l[h]), 1e-30f);
    const int row = r0 + g + 8 * h;
    if (c == 0 && row < tq) lse[(size_t)b * tq + row] = m[h] + logf(denom[h]);
  }
  store_warp_rows<D, LD>(o + (size_t)b * tq * D, Qw, acc,
                         [=](float x, int h) { return x / denom[h]; }, r0, tq, lane);
}

template <int D, int BQ>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                int bh, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Bf16Tiles<D, BQ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + BQ - 1) / BQ;
  flash_fwd_kernel<D, BQ><<<bh * n_qtiles, BQ * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, bh, tq, tk, n_qtiles, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the wide bf16 kernel

// Heads of 256, 512 and 1024: a block of BQ query rows in row groups of
// 16, WPR warps to a row group, each owning DW = 256 of the head's
// columns (its share of the contraction for S, and its columns of O).
// BQ: 64 (four row groups) at 256 and 512; 32 or 16 at 1024, so that the
// block stays within 8 warps of up to 255 registers.
template <int D, int BQ>
struct WideTiles {
  static constexpr int WPR = D / 256;  // warps per row group
  static constexpr int DW = D / WPR;   // head columns per warp
  // keys per tile: 16 at 1024, so that two stages of K and V fit beside Q
  static constexpr int BKW = WPR == 4 ? 16 : 32;
  static constexpr int NT = BQ / 16 * WPR * 32;
  static constexpr int STAGES = 2;
  static constexpr int LD = D + 8;  // row stride in elements: 16 bytes of padding
  static constexpr int NS = BKW / 8;  // S accumulator tiles (8 keys each)
  static constexpr size_t tile_bytes = sizeof(bf16) * (size_t)(BQ + 2 * STAGES * BKW) * LD;
  // WPR > 1: each warp's partial S (NS tiles of 4 floats a thread)
  static constexpr size_t bytes = tile_bytes + (WPR > 1 ? sizeof(float) * NT * NS * 4 : 0);
  // d = 256: two 4-warp blocks an SM (2 x 99 KB of shared memory); every
  // layout leaves 255 registers a thread
  static constexpr int MIN_BLOCKS = WPR == 1 ? 2 : 1;
  static_assert(DW == 256 && (WPR == 1 || WPR == 2 || WPR == 4),
                "wide heads are 256, 512 or 1024");
  static_assert(WPR == 4 ? BQ == 32 || BQ == 16 : BQ == 64, "wide rows per block");
  static_assert(bytes <= SMEM_LIMIT, "flash_fwd wide layout exceeds shared memory");
};

template <int D, int BQ>
__global__ void __launch_bounds__(WideTiles<D, BQ>::NT, WideTiles<D, BQ>::MIN_BLOCKS)
flash_fwd_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int bh, int tq, int tk, int n_qtiles,
                      int causal, float scale) {
  using Tl = WideTiles<D, BQ>;
  constexpr int BKW = Tl::BKW, WPR = Tl::WPR, DW = Tl::DW, NT = Tl::NT;
  constexpr int LD = Tl::LD, STAGES = Tl::STAGES, NS = Tl::NS;
  constexpr int NO = DW / 8;  // O accumulator tiles (8 columns each)
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;             // STAGES tiles of BKW rows
  bf16* Vs = Ks + STAGES * BKW * LD;   // STAGES tiles of BKW rows
  float4* X = reinterpret_cast<float4*>(smem + Tl::tile_bytes);  // partial S (WPR > 1)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int rg = warp / WPR, part = warp % WPR;  // row group, share of the columns
  // the q-tiles with the most key tiles first, as flash_fwd_kernel
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);
  const int b = blockIdx.x % bh;
  const int q0 = qt * BQ;
  const int r0 = q0 + 16 * rg;  // this warp's first query row
  const int offset = tk - tq;
  const bf16* qb = q + (size_t)b * tq * D;
  const bf16* kb = k + (size_t)b * tk * D;
  const bf16* vb = v + (size_t)b * tk * D;
  // this warp's rows and columns of Q; the only ones it reads, later its O
  bf16* Qw = Qs + 16 * rg * LD + part * DW;

  // the block's Q rows (zeros past tq): copy group 0
  for (int i = threadIdx.x; i < BQ * CH; i += NT) {
    const int r = i / CH, col = (i % CH) * 8;
    const bool in = q0 + r < tq;
    cp_async16(smem_addr(Qs + r * LD + col), in ? qb + (size_t)(q0 + r) * D + col : qb,
               in ? 16 : 0);
  }
  cp_async_commit();

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_kt = k_end > 0 ? (k_end + BKW - 1) / BKW : 0;

  // key tile kt (zeros past tk) into ring stage kt % STAGES
  auto load_kv = [&](int kt) {
    const int st = kt % STAGES;
    load_tile_pair<D, LD, BKW, NT>(Ks + st * BKW * LD, Vs + st * BKW * LD, kb, vb, kt * BKW, tk);
  };
  // groups 1 .. STAGES - 1: the first tiles (empty groups past the last)
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_kv(s);
    cp_async_commit();
  }

  // Q scaled in place (q * scale rounded to bf16, the reference's
  // pre-scale): each thread the chunks it copied, once group 0 landed;
  // then the block's barrier, after which every warp reads its A
  // fragments by ldmatrix at each key tile
  cp_async_wait<STAGES - 1>();
  scale_rows<D, LD, BQ, NT>(Qs, scale);
  __syncthreads();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF_SENTINEL, NEG_INF_SENTINEL};  // rows g, g + 8
  float l[2] = {0.f, 0.f};                            // this thread's share

  for (int kt = 0; kt < n_kt; ++kt) {
    // tile kt has landed for every thread, every warp is done with tile
    // kt - 1 (whose stage the next copy refills) and with its row group's
    // partials of S of tile kt - 1
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_kt) load_kv(kt + STAGES - 1);
    cp_async_commit();

    const bf16* Kt = Ks + (kt % STAGES) * BKW * LD + part * DW;
    const bf16* Vt = Vs + (kt % STAGES) * BKW * LD + part * DW;
    const int k0 = kt * BKW;

    // S = Q K^T over this warp's columns: A fragments of Q by ldmatrix
    // (Q stays in shared memory), two 8-key tiles per ldmatrix of K
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DW / 16; ++kk) {
      uint32_t qa[4];
      load_a<LD>(qa, Qw, kk, lane);
#pragma unroll
      for (int np = 0; np < BKW / 16; ++np) {
        uint32_t bfr[4];
        load_bt<LD>(bfr, Kt, np, kk, lane);
        mma_bf16(s[2 * np], qa, bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qa, bfr[2], bfr[3]);
      }
    }

    if constexpr (WPR > 1) {
      // S over the whole head: the row group's WPR partials (each over
      // its warp's columns of d), exchanged through shared memory under
      // the group's own barrier and summed by every warp of the group in
      // the order of their columns (its own from registers), so that all
      // of them hold bitwise the same S and compute the same m, l and P
      // (at WPR = 2 that is own + other, as a + b == b + a)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        X[(warp * NS + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      bar_sync(1 + rg, 32 * WPR);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float4 own = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        float4 y = part == 0 ? own : X[(rg * WPR * NS + n) * 32 + lane];
#pragma unroll
        for (int i = 1; i < WPR; ++i) {
          const float4 z = i == part ? own : X[((rg * WPR + i) * NS + n) * 32 + lane];
          y.x += z.x, y.y += z.y, y.z += z.z, y.w += z.w;
        }
        s[n][0] = y.x, s[n][1] = y.y, s[n][2] = y.z, s[n][3] = y.w;
      }
    }

    mask_scores(s, k0, r0, tk, offset, causal, lane);
    online_softmax(s, acc, m, l);

    // O += P V over this warp's columns: P from the S accumulators; B
    // fragments by ldmatrix.trans of keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < BKW / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        uint32_t bfr[4];
        load_b<LD>(bfr, Vt + 16 * kk * LD, np, lane);
        mma_bf16(acc[2 * np], pa, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], pa, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // epilogue: lse once per row (by the row group's first warp); O /
  // max(l, 1e-30) into this warp's rows and columns of Q, then coalesced
  // 16-byte stores of its columns
  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] = fmaxf(quad_sum(l[h]), 1e-30f);
    const int row = r0 + g + 8 * h;
    if (part == 0 && c == 0 && row < tq) lse[(size_t)b * tq + row] = m[h] + logf(denom[h]);
  }
  store_warp_rows<DW, LD, D>(o + (size_t)b * tq * D + part * DW, Qw, acc,
                             [=](float x, int h) { return x / denom[h]; }, r0, tq, lane);
}

template <int D, int BQ = 64>
int launch_wide(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                int tq, int tk, int causal, float scale, cudaStream_t stream) {
  using Tl = WideTiles<D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_wide<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + BQ - 1) / BQ;
  flash_fwd_kernel_wide<D, BQ><<<bh * n_qtiles, Tl::NT, Tl::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, bh, tq, tk, n_qtiles, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------ the f32 kernel (3xTF32)

// Heads of 64, 128, 256, 512 and 1024 in f32: a block of ROWS query rows
// in row groups of 16, WP warps to a row group, each owning DW of the
// head's columns of O (the whole head up to 128, 128 at 256 and 512, at
// 1024 128 or 256: 64 or 128 accumulator registers). CW warps of the row
// group take its 16 x T scores of a key tile, one fma chain each over
// the whole head (at 1024 one over each quarter, score_chain_cols), each
// lane an RB x CB tile of them (chain_columns, flash_common.cuh); every
// warp of the group then runs the online softmax on all of them and P V
// over its own columns. qs stays resident in shared memory, f32 rows 4
// words (mod 32) apart.
//
// The tiles: a lane's RB x CB chains read RB + CB floats of shared memory
// per column for RB CB fmas, and a warp's shared-memory reads deliver one
// float a lane a cycle to the SM while its four schedulers issue four
// warps' fmas, so the chains want large register tiles, spread over the
// schedulers, and so many scores a block-tile. Up to 256, K and V come
// through a cp.async ring of T-key tiles (64 keys in three stages at 64,
// 32 in three at 128, 32 in two at 256), and one warp a row group chains
// (4 x 8 at 64, 4 x 4 at 128 and 256; at 256 the chaining warps are 0, 2,
// 5 and 7, one a scheduler, warp % 4). At 512, 32 rows of qs and two
// stages of 32-key K and V tiles would not fit (264 KB), and 16-key
// tiles leave 2 scores a lane, so K comes in chunks of KC = 256 columns
// (two a tile, in two stages) and each chain goes on from its sum at the
// next chunk (the same fmas in the same order), V in whole tiles (one
// stage, loaded while the tile's last chunk is chained): two warps a row
// group chain 4 x 2 each (warps 0, 1, 6 and 7). 172-205 KB: one block an
// SM.
//
// At 1024 V too comes in 256-column chunks (VC): K's four chunks of a
// tile, then V's four, alike through a ring of two stages, and each warp
// owns PW columns of every chunk of O (NP = 4 pieces), so that all eight
// multiply in each V step. K and V come from L2 once per block of rows
// (2.2 GB a call at [8, 1024, 1024] causal in blocks of 16 rows), which
// bounds the kernel on a full grid, so BQ, the rows a block, is 32 where
// that grid fills every SM (two row groups of four warps of 256 columns,
// 32-key tiles, warps 0, 1, 6 and 7 chaining 4 x 2 as at 512: half the
// reads from L2; 199 KB) and 16 where it would not (one row group of
// eight warps of 128 columns, 64-key tiles, warps 0-3 chaining 2 x 4:
// twice the blocks in flight; 199 KB). In trials on the H100 those two
// were the fastest of seven layouts on their grids, against 32-key tiles
// of 16 rows in a ring of four stages (2 x 2 a lane, or two warps 4 x
// 2), 64-key tiles of 128-column chunks in four, two warps 4 x 4, and
// 16-key tiles with V whole (the 512 layout).
template <int D, int BQ = D <= 128 ? 128 : D == 256 ? 64 : D == 512 ? 32 : 16>
struct FwdTf32Tiles {
  static constexpr bool VC = D == 1024;              // V in chunks too
  static constexpr int ROWS = BQ;                    // query rows a block
  static constexpr int WP = 128 / BQ;                // warps to a row group
  static constexpr int DW = D / WP;                  // head columns a warp
  static constexpr int NT = 256;                     // 8 warps
  static constexpr int T = D == 64 || (VC && WP == 8) ? 64 : 32;  // keys a tile
  static constexpr int KC = D >= 512 ? 256 : D;      // columns of a K (or V) chunk
  static constexpr int NCH = D / KC;                 // K chunks a tile
  static constexpr int STAGES = D <= 128 ? 3 : 2;    // the ring (NCH = 1, or VC)
  static constexpr int NT8 = T / 8;                  // 8-key accumulator tiles
  static constexpr int CW = WP == 8 ? 4 : NCH > 1 ? 2 : 1;  // warps a row group that chain
  static constexpr int RB = WP == 8 ? 2 : 4;         // a lane's tile of score chains:
  static constexpr int CB = 16 * T / (32 * CW * RB);  // RB rows x CB keys
  static constexpr int KH = T / (8 * CB);            // chaining warps along the keys
  static constexpr int CPC = score_chain_cols(D) / KC;  // K chunks a chain (NCH > 1)
  static constexpr int NP = VC ? NCH : 1;            // pieces of a warp's columns of O
  static constexpr int PW = DW / NP;                 // columns a piece
  static constexpr int LD = D + 4;       // f32 row stride in words: 4 (mod 32)
  static constexpr int LDK = KC + 4;     // a chunk's row stride
  static constexpr int LS = score_stride(T);  // a score row's stride
  // qs, then the ring (STAGES tiles of K and of V; two K chunks and one V
  // tile; or, VC, STAGES chunks of K or V), then each row group's scores
  static constexpr size_t ring_floats =
      VC ? (size_t)STAGES * T * LDK
      : NCH == 1 ? (size_t)2 * STAGES * T * LD : (size_t)2 * T * LDK + (size_t)T * LD;
  static constexpr size_t rows_bytes = sizeof(float) * ((size_t)ROWS * LD + ring_floats);
  static constexpr size_t bytes = rows_bytes + sizeof(float) * (size_t)ROWS * LS;
  static_assert(D == 64 || D == 128 || D == 256 || D == 512 || D == 1024,
                "the 3xTF32 forward takes heads of 64, 128, 256, 512 and 1024");
  static_assert(VC ? BQ == 16 || BQ == 32 : WP == (D <= 128 ? 1 : D / 128),
                "rows a block: 16 or 32 at 1024, else one warp a row group per 128 columns");
  static_assert(!VC || (2 * NCH) % STAGES == 0, "VC: a tile's steps start at stage 0");
  static_assert(CW * 32 * RB * CB == 16 * T, "every score of the row group once");
  static_assert(NCH == 1 || score_chain_cols(D) % KC == 0, "whole chunks a chain");
  static_assert(bytes <= SMEM_LIMIT, "flash_fwd 3xTF32 layout exceeds shared memory");
  // which share of row group rg's scores warp `part` of it chains (rows
  // 4 RB (h / KH) .., keys 8 CB (h % KH) ..), or -1: one warp a
  // scheduler (warp % 4)
  __device__ static constexpr int chainer(int rg, int part) {
    return WP == 8   ? (part < CW ? part : -1)
           : WP == 4 ? (part - 2 * rg == 0 || part - 2 * rg == 1 ? part - 2 * rg : -1)
           : WP == 2 ? (part == (rg / 2) % 2 ? 0 : -1)
                     : 0;
  }
};

// One key tile of the online softmax in f32 on the score accumulators
// (h = 0: row g, h = 1: row g + 8), as the plain version takes it: expf of
// s - m (a masked score at the sentinel against a sentinel max gives
// exp(0)); the row's max m and this thread's share of its sum l move on,
// s becomes p, and corr[h] = exp(m_old - m_new) is the factor for O.
template <int NS>
__device__ __forceinline__ void online_softmax_f32(float (&s)[NS][4], float (&m)[2],
                                                   float (&l)[2], float (&corr)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    const float m_new = quad_max(mx);
    corr[h] = expf(m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 2 * h; j < 2 * h + 2; ++j) {
        s[n][j] = expf(s[n][j] - m_new);
        sum += s[n][j];
      }
    }
    l[h] = corr[h] * l[h] + sum;
    m[h] = m_new;
  }
}

// O = O corr + P V over PW columns of O (acc, 8 columns a tile): P the
// tile's NT8 accumulator tiles of probabilities as A fragments
// (c_to_a_tf32: the depth permuted), Vt the first of these columns of the
// tile's V rows (leading dimension LDV) read in that order
// (load_b_perm_tf32), each 8-column tile summed over the tile in a zeroed
// partial (the 8-key steps outer, so that consecutive mma.sync go to
// different partials) added with one rounded fma (the tensor cores'
// accumulation is not rounded to nearest).
template <int NT8, int PW, int LDV>
__device__ __forceinline__ void pv_tf32x3(float (&acc)[PW / 8][4], const float (&p)[NT8][4],
                                          const float* Vt, const float (&corr)[2], int lane) {
  float part_o[PW / 8][4] = {};
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    FragA pa;
    c_to_a_tf32(pa, p[n]);
#pragma unroll
    for (int nd = 0; nd < PW / 8; ++nd) {
      FragB bv;
      load_b_perm_tf32<LDV>(bv, Vt + 8 * n * LDV, 8 * nd, lane);
      mma_tf32x3(part_o[nd], pa, bv);
    }
  }
#pragma unroll
  for (int nd = 0; nd < PW / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(acc[nd][e], corr[e / 2], part_o[nd][e]);
  }
}

// Per key tile: the row group's scores (the forward's order, by its
// chaining warps into the group's rows of Ss), then, once a barrier shows
// them to the group, every warp the masks and the online softmax on all
// 16 x T, and O = O corr + P V over its own columns (pv_tf32x3).
template <int D, int BQ>
__global__ void __launch_bounds__(FwdTf32Tiles<D, BQ>::NT, 1)
flash_fwd_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int bh, int tq, int tk, int n_qtiles,
                        int causal, float scale) {
  using Tl = FwdTf32Tiles<D, BQ>;
  constexpr int ROWS = Tl::ROWS, NT = Tl::NT, T = Tl::T, STAGES = Tl::STAGES, NCH = Tl::NCH;
  constexpr int WP = Tl::WP, DW = Tl::DW, NT8 = Tl::NT8, RB = Tl::RB, CB = Tl::CB;
  constexpr int KC = Tl::KC, LD = Tl::LD, LDK = Tl::LDK, LS = Tl::LS;
  constexpr int NP = Tl::NP, PW = Tl::PW, CPC = Tl::CPC;
  constexpr bool VC = Tl::VC;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Rs = Qs + ROWS * LD;  // the ring
  float* Ss = reinterpret_cast<float*>(smem + Tl::rows_bytes);  // each row group's scores

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / WP, part = warp % WP;  // row group, share of the columns
  const int h = Tl::chainer(rg, part);         // the scores this warp chains, or -1
  const int h_row = 4 * RB * (h / Tl::KH), h_key = 8 * CB * (h % Tl::KH);
  // the q-tiles with the most key tiles (the last ones, under the causal
  // mask) first, so the last wave of blocks is not the longest
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);
  const int b = blockIdx.x % bh;
  const int q0 = qt * ROWS;
  const int r0 = q0 + 16 * rg;  // this row group's first query row
  const int offset = tk - tq;
  const float* kb = k + (size_t)b * tk * D;
  const float* vb = v + (size_t)b * tk * D;
  const float* Qg = Qs + 16 * rg * LD;  // the row group's rows of qs
  float* Sg = Ss + 16 * rg * LS;        // and of the scores

  // the block's q rows (zeros past tq): copy group 0
  load_tile<D, D, LD, ROWS, NT>(Qs, q + (size_t)b * tq * D, q0, tq, 0);
  cp_async_commit();

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + ROWS, tq) + offset);
  const int n_kt = k_end > 0 ? (k_end + T - 1) / T : 0;

  // this warp's columns of O: NP pieces of PW, piece i at columns i D /
  // NP + part PW
  float acc[NP][PW / 8][4];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int n = 0; n < PW / 8; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  }
  float m[2] = {NEG_INF_SENTINEL, NEG_INF_SENTINEL};  // rows g, g + 8
  float l[2] = {0.f, 0.f};                            // this thread's share

  // the tile's scores in Sg, seen by the group: masks and the online
  // softmax, sc becoming p
  auto softmax = [&](float (&sc)[NT8][4], float (&corr)[2], int k0) {
    gather_scores<NT8, LS>(sc, Sg, lane);
    mask_scores(sc, k0, r0, tk, offset, causal, lane);
    online_softmax_f32(sc, m, l, corr);
  };
  // K chunk j of the chaining warp's scores (NCH > 1): each chain over
  // CPC chunks (score_chain_cols), carried from chunk to chunk in cc, and
  // the chains' sums added in column order in cs, then staged in Sg
  float cs[RB][CB], cc[RB][CB];
  auto chain_chunk = [&](int j, const float* Kc) {
    if (j % CPC == 0) {
#pragma unroll
      for (int x = 0; x < RB; ++x) {
#pragma unroll
        for (int y = 0; y < CB; ++y) cc[x][y] = 0.f;
      }
    }
    chain_columns<KC, LD, LDK, RB, CB>(cc, Qg + h_row * LD + j * KC, Kc + h_key * LDK, lane);
    if (j % CPC == CPC - 1) {
#pragma unroll
      for (int x = 0; x < RB; ++x) {
#pragma unroll
        for (int y = 0; y < CB; ++y) cs[x][y] = j == CPC - 1 ? cc[x][y] : cs[x][y] + cc[x][y];
      }
    }
    if (j == NCH - 1) store_scores<RB, CB, LS>(Sg + h_row * LS + h_key, cs, lane);
  };

  if constexpr (NCH == 1) {
    float* Ks = Rs;                    // STAGES tiles of T rows
    float* Vs = Rs + STAGES * T * LD;  // STAGES tiles of T rows
    // key tile kt (zeros past tk) into ring stage kt % STAGES
    auto load_kv = [&](int kt) {
      const int st = kt % STAGES;
      load_tile_pair<D, LD, T, NT>(Ks + st * T * LD, Vs + st * T * LD, kb, vb, kt * T, tk);
    };
    // groups 1 .. STAGES - 1: the first tiles (empty groups past the last)
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_kt) load_kv(s);
      cp_async_commit();
    }
    // q scaled in place (q * scale, one rounding: the backward's qs),
    // each thread the chunks it copied once group 0 landed; then the
    // block's barrier, after which every warp reads its group's rows
    cp_async_wait<STAGES - 1>();
    scale_rows_f32<D, LD, ROWS, NT>(Qs, scale, threadIdx.x);
    __syncthreads();

    for (int kt = 0; kt < n_kt; ++kt) {
      // tile kt has landed for every thread, and every warp is done with
      // tile kt - 1 (whose stage the next copy refills) and with its row
      // group's scores of tile kt - 1
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (kt + STAGES - 1 < n_kt) load_kv(kt + STAGES - 1);
      cp_async_commit();
      if (r0 >= tq) continue;  // this row group's rows are all past tq
      // keys k0 .. k0 + T - 1 (k0 < tk): wholly above this row group's
      // diagonal, p = 0 throughout
      const int k0 = kt * T;
      if (causal && k0 > r0 + 15 + offset) continue;
      if (h == 0) score_chain<D, LD, RB, CB, LS>(Sg, Qg, Ks + (kt % STAGES) * T * LD, lane);
      if constexpr (WP > 1) {
        bar_sync(1 + rg, 32 * WP);
      } else {
        __syncwarp();
      }
      float sc[NT8][4], corr[2];
      softmax(sc, corr, k0);
      pv_tf32x3<NT8, PW, LD>(acc[0], sc, Vs + (kt % STAGES) * T * LD + part * DW, corr, lane);
    }
  } else if constexpr (!VC) {
    // a ring of steps: step u is chunk u % (NCH + 1) of K tile u / (NCH +
    // 1), or (the last of a tile) its V tile; K chunks in two stages, V in
    // one, each step's copy issued a step ahead (its buffer's last reader
    // was two steps back, or the V of the last tile, NCH steps back)
    float* Kc = Rs;                  // two chunks of T rows of KC columns
    float* Vs = Rs + 2 * T * LDK;    // one tile of T rows
    const int n_steps = n_kt * (NCH + 1);
    auto load_step = [&](int u) {
      const int kt = u / (NCH + 1), j = u % (NCH + 1);
      if (j < NCH) {
        load_tile<D, KC, LDK, T, NT>(Kc + ((kt * NCH + j) % 2) * T * LDK, kb, kt * T, tk, j * KC);
      } else {
        load_tile<D, D, LD, T, NT>(Vs, vb, kt * T, tk, 0);
      }
    };
    if (n_steps > 0) load_step(0);
    cp_async_commit();
    cp_async_wait<1>();
    scale_rows_f32<D, LD, ROWS, NT>(Qs, scale, threadIdx.x);
    __syncthreads();

    for (int u = 0; u < n_steps; ++u) {
      // step u has landed for every thread, and every warp is done with
      // step u - 1
      cp_async_wait<0>();
      __syncthreads();
      if (u + 1 < n_steps) load_step(u + 1);
      cp_async_commit();
      const int kt = u / (NCH + 1), j = u % (NCH + 1);
      if (r0 >= tq) continue;
      const int k0 = kt * T;
      if (causal && k0 > r0 + 15 + offset) continue;
      if (j < NCH) {
        if (h >= 0) chain_chunk(j, Kc + ((kt * NCH + j) % 2) * T * LDK);
        continue;
      }
      // the V step: the tile's scores are in Sg (the barrier above)
      float sc[NT8][4], corr[2];
      softmax(sc, corr, k0);
      pv_tf32x3<NT8, PW, LD>(acc[0], sc, Vs + part * DW, corr, lane);
    }
  } else {
    // K's and V's chunks alike through one ring of STAGES: step j of a
    // tile (2 NCH of them) brings K's columns j KC .. (j < NCH) or V's
    // (j - NCH) KC .., into stage j % STAGES, issued STAGES - 1 steps
    // ahead (into the stage of the step before this one, which every
    // warp is done with).
    float* Cs = Rs;  // STAGES chunks of T rows of KC columns
    const int n_steps = n_kt * 2 * NCH;
    auto load_step = [&](int u) {
      const int kt = u / (2 * NCH), j = u % (2 * NCH);
      load_tile<D, KC, LDK, T, NT>(Cs + (u % STAGES) * T * LDK, j < NCH ? kb : vb, kt * T, tk,
                                   (j % NCH) * KC);
    };
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_steps) load_step(s);
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();
    scale_rows_f32<D, LD, ROWS, NT>(Qs, scale, threadIdx.x);
    __syncthreads();

    float sc[NT8][4], corr[2];  // the tile's p, kept over its V steps
    for (int kt = 0; kt < n_kt; ++kt) {
#pragma unroll
      for (int j = 0; j < 2 * NCH; ++j) {
        const int u = kt * 2 * NCH + j;
        // step u has landed for every thread, and every warp is done with
        // step u - 1
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (u + STAGES - 1 < n_steps) load_step(u + STAGES - 1);
        cp_async_commit();
        const float* C = Cs + (j % STAGES) * T * LDK;
        // this row group's rows all past tq, or keys wholly above its diagonal
        if (r0 >= tq || (causal && kt * T > r0 + 15 + offset)) continue;
        if (j < NCH) {
          if (h >= 0) chain_chunk(j, C);
          continue;
        }
        // a V step: at the first the tile's scores are in Sg
        if (j == NCH) softmax(sc, corr, kt * T);
        pv_tf32x3<NT8, PW, LDK>(acc[j - NCH], sc, C + part * PW, corr, lane);
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // epilogue: lse once per row (by the row group's first warp); O /
  // max(l, 1e-30) staged through this warp's columns of its group's qs
  // rows (after the tile loop no warp reads them), then coalesced 16-byte
  // stores of its columns
  const int g = lane / 4, c = lane % 4;
  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    denom[i] = fmaxf(quad_sum(l[i]), 1e-30f);
    const int row = r0 + g + 8 * i;
    if (part == 0 && c == 0 && row < tq) lse[(size_t)b * tq + row] = m[i] + logf(denom[i]);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int n = 0; n < PW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] /= denom[e / 2];
    }
    const int col = i * (D / NP) + part * PW;
    store_warp_rows_f32<PW, LD, D>(o + (size_t)b * tq * D + col, Qs + 16 * rg * LD + col,
                                   acc[i], 1.f, r0, tq, lane);
  }
}

template <int D, int BQ = FwdTf32Tiles<D>::ROWS>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int tq, int tk, int causal, float scale, cudaStream_t stream) {
  using Tl = FwdTf32Tiles<D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_tf32x3<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + Tl::ROWS - 1) / Tl::ROWS;
  flash_fwd_kernel_tf32x3<D, BQ><<<bh * n_qtiles, Tl::NT, Tl::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, bh, tq, tk, n_qtiles, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [bh, t, d], 16-byte aligned; lse: contiguous f32
// [bh, tq]; q unscaled, scale = 1/sqrt(d) rounded to q's dtype. dtype: 0 =
// float32, 1 = bfloat16; d: 64, 128, 256, 512 or 1024. block_q (bf16 d 64
// and 128: 64 or 128; d 1024: 16 or 32): query rows per block, or 0 to
// choose by tq and bh (every other head takes only 0).
// Returns a cudaError_t (0 on success); an unsupported head size or block
// returns cudaErrorInvalidValue.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int bh, int tq, int tk, int d, int causal, int dtype,
                              float scale, int block_q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && d <= 128) {
    // 8 warps where the grid still fills every SM twice (fewer re-reads
    // of K and V), else 4 (short queries such as the prefill's 64 rows,
    // or few heads: more blocks in flight)
    if (block_q == 0) {
      if (int err = block_rows(bh, tq, &block_q)) return err;
    }
    if (d == 64 && block_q == 64) return launch_bf16<64, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 64 && block_q == 128) return launch_bf16<64, 128>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 128 && block_q == 64) return launch_bf16<128, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 128 && block_q == 128) return launch_bf16<128, 128>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (d == 1024) {
    // 32 rows a block (K and V read from L2 once per 32 query rows) where
    // that grid fills every SM, else 16 (twice the blocks in flight:
    // short sequences or few heads)
    if (block_q == 0) {
      if (int err = rows_1024(bh, tq, &block_q)) return err;
    }
    if (dtype == 1 && block_q == 32) return launch_wide<1024, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (dtype == 1 && block_q == 16) return launch_wide<1024, 16>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (dtype == 0 && block_q == 32) return launch_tf32x3<1024, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (dtype == 0 && block_q == 16) return launch_tf32x3<1024, 16>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (block_q != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {  // the wide heads on the tensor cores
    if (d == 256) return launch_wide<256>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 512) return launch_wide<512>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
  } else if (dtype == 0) {  // scores on the CUDA cores, P V in 3xTF32
    if (d == 64) return launch_tf32x3<64>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 128) return launch_tf32x3<128>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 256) return launch_tf32x3<256>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 512) return launch_tf32x3<512>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
