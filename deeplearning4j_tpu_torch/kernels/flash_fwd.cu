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
// 128, 256 and 512 (1-512 zero-padded to them). Its scores must be bit
// for bit the f32 backward's (flash_bwd.cu), which rebuilds p = exp(s -
// lse) from lse: s - lse cancels the rounding of s only where both passes
// computed s alike (at scores of ±60 a score taken otherwise carries
// several times the reference's error; ROADMAP C3, C4). So each score is
// one fma chain over the head's columns 0 .. D - 1 from 0 on the CUDA
// cores (score_chain, flash_common.cuh), the order the backward kernels
// take, and only P V runs on the tensor cores, in 3xTF32 (each f32
// operand split into a TF32 value and the rest, three mma.sync m16n8k8
// products). What bounds it at [128, 1024, 64] f32 causal: 4 d flops per
// live pair, 0.257 ms at 67 TFLOP/s on the CUDA cores; the chains' 2 d of
// them alone take 0.128 ms (the same at [32, 1024, 256] and [16, 1024,
// 512]), P V in 3xTF32 (three TF32 products each) 0.052 ms at 495
// TFLOP/s. So the chains are the kernel's floor, and its design keeps
// them fed:
// - 8 warps a block; a row group of 16 query rows has WP = 1 warp at 64
//   and 128, 2 at 256 and 4 at 512, each owning DW = 64 or 128 of the
//   head's columns of O (32 or 64 accumulator registers); 128 rows a
//   block up to 128, 64 at 256, 32 at 512; the q-tiles with the most key
//   tiles first;
// - qs resident in shared memory (copied once, scaled in place: q *
//   scale, one rounding, the backward's pre-scale), f32 rows 4 words
//   (mod 32) apart; up to 256 K and V through a cp.async ring of T-key
//   tiles (64 keys in three stages at 64, 32 in three at 128, 32 in two
//   at 256); at 512 K in 256-column chunks of 32-key tiles (two stages)
//   and V in whole tiles (one stage), since two stages of whole 32-key
//   tiles would not fit beside qs: 172-205 KB, one block an SM;
// - per tile the row group's 16 x T scores are chained by one warp of
//   the group up to 256 (each lane a 4 x 8 tile of chains at 64, 4 x 4
//   at 128 and 256) and by two at 512 (4 x 2 each, every chain carried
//   from one chunk of K to the next), the chaining warps on different
//   schedulers: a larger tile reads fewer bytes of shared memory per
//   fma, and those reads bound the chains;
//   staged in shared memory and read by every warp of the group in the
//   accumulator layout after the group's barrier (a named barrier at
//   256, the block's at 512), so that all of them hold the same s, m, l
//   and p;
// - online softmax in f32 on the accumulators (expf, logf, the -1e30
//   sentinel and the 1e-30 floor of the SIMT kernel), masks only on
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
//
// The SIMT kernel (flash_fwd_kernel_f32) runs the f32 heads of 513-1024,
// zero-padded to 1024, in the first design: CUDA-core FMAs through
// shared memory in f32 (full f32 precision, no TF32), 8 x 8 tiles
// (simt_tile, flash_common.cuh; ~129 KB of shared memory), taking the
// unscaled q and the scale like the other kernels; its scores are one
// fma chain each in the same order, so the SIMT backward at 1024 rebuilds
// p from the same bits. Its global loads and stores are templated on the
// element type, though only f32 runs it. A correct, slow first kernel:
// nothing was tuned.
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

// Heads of 64, 128, 256 and 512 in f32: a block of ROWS query rows in row
// groups of 16, WP warps to a row group, each owning DW of the head's
// columns of O (the whole head up to 128, else 128: 64 accumulator
// registers). CW warps of the row group take its 16 x T scores of a key
// tile, one fma chain each over the whole head, each lane a 4 x CB tile
// of them (chain_columns, flash_common.cuh); every warp of the group then
// runs the online softmax on all of them and P V over its own columns.
// qs stays resident in shared memory, f32 rows 4 words (mod 32) apart.
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
template <int D>
struct FwdTf32Tiles {
  static constexpr int WP = D <= 128 ? 1 : D / 128;  // warps to a row group
  static constexpr int DW = D / WP;                  // head columns a warp
  static constexpr int NT = 256;                     // 8 warps
  static constexpr int ROWS = 16 * (8 / WP);         // query rows a block
  static constexpr int T = D == 64 ? 64 : 32;        // keys a tile
  static constexpr int KC = D == 512 ? 256 : D;      // columns of a K chunk
  static constexpr int NCH = D / KC;                 // K chunks a tile
  static constexpr int STAGES = D <= 128 ? 3 : 2;    // the K and V ring (NCH = 1)
  static constexpr int NT8 = T / 8;                  // 8-key accumulator tiles
  static constexpr int CW = NCH > 1 ? 2 : 1;         // warps a row group that chain
  static constexpr int CB = T / 8 / CW;  // a lane's tile of score chains: 4 rows x CB keys
  static constexpr int LD = D + 4;       // f32 row stride in words: 4 (mod 32)
  static constexpr int LDK = KC + 4;     // a K chunk's row stride
  static constexpr int LS = score_stride(T);  // a score row's stride
  // qs, then the ring (STAGES tiles of K and of V; or two K chunks and one
  // V tile), then each row group's scores
  static constexpr size_t ring_floats =
      NCH == 1 ? (size_t)2 * STAGES * T * LD : (size_t)2 * T * LDK + (size_t)T * LD;
  static constexpr size_t rows_bytes = sizeof(float) * ((size_t)ROWS * LD + ring_floats);
  static constexpr size_t bytes = rows_bytes + sizeof(float) * (size_t)ROWS * LS;
  static_assert(D == 64 || D == 128 || D == 256 || D == 512,
                "the 3xTF32 forward takes heads of 64, 128, 256 and 512");
  static_assert(bytes <= SMEM_LIMIT, "flash_fwd 3xTF32 layout exceeds shared memory");
  // which share of row group rg's keys warp `part` of it chains (keys
  // 8 CB h ..), or -1: one warp a scheduler (warp % 4)
  __device__ static constexpr int chain_half(int rg, int part) {
    return WP == 4 ? (part - 2 * rg == 0 || part - 2 * rg == 1 ? part - 2 * rg : -1)
           : WP == 2 ? (part == (rg / 2) % 2 ? 0 : -1)
                     : 0;
  }
};

// One key tile of the online softmax in f32 on the score accumulators
// (h = 0: row g, h = 1: row g + 8), as the SIMT kernel takes it: expf of
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

// Per key tile: the row group's scores (the forward's order, by its
// chaining warps into the group's rows of Ss), then, once a barrier shows
// them to the group, every warp the masks and the online softmax on all
// 16 x T, and O = O corr + P V over its own columns: P from the
// accumulators as A fragments (c_to_a_tf32: the depth permuted), V's rows
// read in that order (load_b_perm_tf32), each 8-column tile of O summed
// over the tile in a zeroed partial (the 8-key steps outer, so that
// consecutive mma.sync go to different partials) added with one rounded
// fma (the tensor cores' accumulation is not rounded to nearest).
template <int D>
__global__ void __launch_bounds__(FwdTf32Tiles<D>::NT, 1)
flash_fwd_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int bh, int tq, int tk, int n_qtiles,
                        int causal, float scale) {
  using Tl = FwdTf32Tiles<D>;
  constexpr int ROWS = Tl::ROWS, NT = Tl::NT, T = Tl::T, STAGES = Tl::STAGES, NCH = Tl::NCH;
  constexpr int WP = Tl::WP, DW = Tl::DW, NT8 = Tl::NT8, CB = Tl::CB;
  constexpr int KC = Tl::KC, LD = Tl::LD, LDK = Tl::LDK, LS = Tl::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Rs = Qs + ROWS * LD;  // the ring
  float* Ss = reinterpret_cast<float*>(smem + Tl::rows_bytes);  // each row group's scores

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / WP, part = warp % WP;  // row group, share of the columns
  const int half = Tl::chain_half(rg, part);   // the keys this warp chains, or -1
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
  // this warp's columns of its group's qs rows, later its O
  float* Ow = Qs + 16 * rg * LD + part * DW;

  // the block's q rows (zeros past tq): copy group 0
  load_tile<D, D, LD, ROWS, NT>(Qs, q + (size_t)b * tq * D, q0, tq, 0);
  cp_async_commit();

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + ROWS, tq) + offset);
  const int n_kt = k_end > 0 ? (k_end + T - 1) / T : 0;

  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF_SENTINEL, NEG_INF_SENTINEL};  // rows g, g + 8
  float l[2] = {0.f, 0.f};                            // this thread's share

  // the tile's scores in Sg, seen by the group: masks, softmax, O += P V
  // with Vt this warp's columns of the tile's V rows
  auto softmax_pv = [&](const float* Vt, int k0) {
    float sc[NT8][4];
    gather_scores<NT8, LS>(sc, Sg, lane);
    mask_scores(sc, k0, r0, tk, offset, causal, lane);
    float corr[2];
    online_softmax_f32(sc, m, l, corr);
    float part_o[DW / 8][4] = {};
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      FragA pa;
      c_to_a_tf32(pa, sc[n]);
#pragma unroll
      for (int nd = 0; nd < DW / 8; ++nd) {
        FragB bv;
        load_b_perm_tf32<LD>(bv, Vt + 8 * n * LD, 8 * nd, lane);
        mma_tf32x3(part_o[nd], pa, bv);
      }
    }
#pragma unroll
    for (int nd = 0; nd < DW / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(acc[nd][e], corr[e / 2], part_o[nd][e]);
    }
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
      if (half == 0) score_chain<D, LD, 4, CB, LS>(Sg, Qg, Ks + (kt % STAGES) * T * LD, lane);
      if constexpr (WP > 1) {
        bar_sync(1 + rg, 32 * WP);
      } else {
        __syncwarp();
      }
      softmax_pv(Vs + (kt % STAGES) * T * LD + part * DW, k0);
    }
  } else {
    // a ring of steps: step u is chunk u % (NCH + 1) of K tile u / (NCH +
    // 1), or (the last of a tile) its V tile; K chunks in two stages, V in
    // one, each step's copy issued a step ahead (its buffer's last reader
    // was two steps back, or at 512 the V of the last tile, NCH steps back)
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

    float cs[4][CB];  // a chaining warp's sums, carried from chunk to chunk
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
        if (half >= 0) {
          if (j == 0) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
#pragma unroll
              for (int y = 0; y < CB; ++y) cs[x][y] = 0.f;
            }
          }
          chain_columns<KC, LD, LDK, 4, CB>(
              cs, Qg + j * KC, Kc + ((kt * NCH + j) % 2) * T * LDK + 8 * CB * half * LDK, lane);
          if (j == NCH - 1) store_scores<4, CB, LS>(Sg + 8 * CB * half, cs, lane);
        }
        continue;
      }
      // the V step: the tile's scores are in Sg (the barrier above)
      softmax_pv(Vs + part * DW, k0);
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
  for (int h = 0; h < 2; ++h) {
    denom[h] = fmaxf(quad_sum(l[h]), 1e-30f);
    const int row = r0 + g + 8 * h;
    if (part == 0 && c == 0 && row < tq) lse[(size_t)b * tq + row] = m[h] + logf(denom[h]);
  }
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= denom[e / 2];
  }
  store_warp_rows_f32<DW, LD, D>(o + (size_t)b * tq * D + part * DW, Ow, acc, 1.f, r0, tq,
                                 lane);
}

template <int D>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int tq, int tk, int causal, float scale, cudaStream_t stream) {
  using Tl = FwdTf32Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_tf32x3<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + Tl::ROWS - 1) / Tl::ROWS;
  flash_fwd_kernel_tf32x3<D><<<bh * n_qtiles, Tl::NT, Tl::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, bh, tq, tk, n_qtiles, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the f32 (SIMT) design

// Shared-memory layout of a block of BQ query rows over key tiles of BKT
// keys, all in f32.
template <int D, int BQ, int BKT>
struct F32Layout {
  static constexpr int LDT = D + 1;    // q, k, v rows (bank spread)
  static constexpr int LDS = BKT + 1;  // scores, then probabilities
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + round32(sizeof(float) * BQ * LDT);
  static constexpr size_t v_off = k_off + round32(sizeof(float) * BKT * LDT);
  static constexpr size_t s_off = v_off + round32(sizeof(float) * BKT * LDT);
  static constexpr size_t o_off = s_off + round32(sizeof(float) * BQ * LDS);
  static constexpr size_t m_off = o_off + round32(sizeof(float) * BQ * D);
  static constexpr size_t l_off = m_off + round32(sizeof(float) * BQ);
  static constexpr size_t c_off = l_off + round32(sizeof(float) * BQ);
  static constexpr size_t bytes = c_off + round32(sizeof(float) * BQ);
  static_assert(bytes <= SMEM_LIMIT, "flash_fwd f32 layout exceeds shared memory");
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, int BQ, int BKT>
__global__ void __launch_bounds__(F32_NT)
flash_fwd_kernel_f32(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int tq, int tk, int n_qtiles, int causal, float scale) {
  using Lay = F32Layout<D, BQ, BKT>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS;
  constexpr int RPW = BQ / (F32_NT / 32);  // softmax rows per warp
  constexpr int CPL = (BKT + 31) / 32;     // softmax columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Lay::q_off);
  float* Ks = reinterpret_cast<float*>(smem + Lay::k_off);
  float* Vs = reinterpret_cast<float*>(smem + Lay::v_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  float* Os = reinterpret_cast<float*>(smem + Lay::o_off);
  float* m_s = reinterpret_cast<float*>(smem + Lay::m_off);
  float* l_s = reinterpret_cast<float*>(smem + Lay::l_off);
  float* c_s = reinterpret_cast<float*>(smem + Lay::c_off);

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int offset = tk - tq;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  load_rows_f32<D, LDT>(Qs, q + (size_t)bh * tq * D, q0, tq, BQ, scale);
  for (int i = threadIdx.x; i < BQ * D; i += F32_NT) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += F32_NT) {
    m_s[i] = NEG_INF_SENTINEL;
    l_s[i] = 0.f;
  }

  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_ktiles = k_end > 0 ? (k_end + BKT - 1) / BKT : 0;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * BKT;
    load_rows_f32<D, LDT>(Ks, kb, k0, tk, BKT, 1.f);
    load_rows_f32<D, LDT>(Vs, vb, k0, tk, BKT, 1.f);
    __syncthreads();

    for (int i = threadIdx.x; i < BQ * BKT; i += F32_NT) {
      const int r = i / BKT, col = i % BKT;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += Qs[r * LDT + d] * Ks[col * LDT + d];
      Ss[r * LDS + col] = s;
    }
    __syncthreads();

    // online softmax: each warp walks its RPW rows, each lane CPL columns
    // (lanes past BKT hold none)
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = RPW * warp + rr;
      const int qrow = q0 + r;
      float s[CPL];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = lane + 32 * j;
        const int kcol = k0 + col;
        // past the tile or the last key: not in the row at all
        float x = -INFINITY;
        if (col < BKT && kcol < tk)
          x = causal && qrow + offset < kcol ? NEG_INF_SENTINEL : Ss[r * LDS + col];
        s[j] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = lane + 32 * j;
        const float p = expf(s[j] - m_new);
        sum += p;
        // P.V takes p rounded to v's dtype; l sums it unrounded
        if (col < BKT) Ss[r * LDS + col] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = corr * l_s[r] + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // O = O * corr + P V
    for (int i = threadIdx.x; i < BQ * D; i += F32_NT) {
      const int r = i / D, col = i % D;
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < BKT; ++j) a += Ss[r * LDS + j] * Vs[j * LDT + col];
      Os[r * D + col] = Os[r * D + col] * c_s[r] + a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * D; i += F32_NT) {
    const int r = i / D, col = i % D;
    if (q0 + r < tq) {
      const float denom = fmaxf(l_s[r], 1e-30f);
      o[((size_t)bh * tq + q0 + r) * D + col] = from_f<T>(Os[r * D + col] / denom);
    }
  }
  for (int r = threadIdx.x; r < BQ; r += F32_NT) {
    if (q0 + r < tq) lse[(size_t)bh * tq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
               int bh, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  constexpr int TILE = simt_tile(D);
  constexpr size_t smem = F32Layout<D, TILE, TILE>::bytes;
  auto kernel = flash_fwd_kernel_f32<T, D, TILE, TILE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + TILE - 1) / TILE;
  kernel<<<bh * n_qtiles, F32_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, tq, tk, n_qtiles, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [bh, t, d], 16-byte aligned; lse: contiguous f32
// [bh, tq]; q unscaled, scale = 1/sqrt(d) rounded to q's dtype. dtype: 0 =
// float32, 1 = bfloat16; d: 64, 128, 256, 512 or 1024. block_q (bf16 d 64
// and 128: 64 or 128; bf16 d 1024: 16 or 32): query rows per block, or 0
// to choose by tq and bh (every other head takes only 0).
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
  if (dtype == 1 && d == 1024) {
    // 32 rows a block (K and V read from L2 once per 32 query rows) where
    // that grid fills every SM, else 16 (twice the blocks in flight:
    // short sequences or few heads)
    if (block_q == 0) {
      int sms = 0;
      if (int err = sm_count(&sms)) return err;
      block_q = (long long)bh * ((tq + 31) / 32) >= sms ? 32 : 16;
    }
    if (block_q == 32) return launch_wide<1024, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (block_q == 16) return launch_wide<1024, 16>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (block_q != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {  // the wide heads on the tensor cores
    if (d == 256) return launch_wide<256>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 512) return launch_wide<512>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
  } else if (dtype == 0) {  // scores on the CUDA cores, P V in 3xTF32; 1024 the SIMT kernel
    if (d == 64) return launch_tf32x3<64>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 128) return launch_tf32x3<128>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 256) return launch_tf32x3<256>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 512) return launch_tf32x3<512>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 1024) return launch_f32<float, 1024>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
