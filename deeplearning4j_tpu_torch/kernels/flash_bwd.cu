// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// the dq kernel and the dk/dv kernel.
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/flash_attention.py
// `_flash_bwd_impl` -> `_dq_kernel` and `_dkv_kernel` (shared `_bwd_block`).
// Inputs are the unscaled q, k, v, the forward's output O and dO [bh, t,
// d], and its lse in f32 [bh, tq]. flash_dq computes delta = rowsum(dO *
// O) in f32 for its rows, uses it and writes it out [bh, tq]; flash_dkv,
// launched after it on the same stream, reads it (the reference computes
// delta in XLA outside its kernels: here that pass, two casts, a product
// and a sum over [bh, tq, d] in f32, is gone). Both kernels pre-scale q themselves as
// they load it (qs = q * q_scale, rounded to q's dtype: bit for bit the
// reference's `(q * scale).astype(q.dtype)`, so no launch pre-scales q).
// The probabilities are rebuilt tile by tile from (qs, k, lse), so the
// [t, t] matrix never exists in device memory:
//
//   s  = qs k^T      p = exp(s - lse)      dP = dO v^T
//   ds = p * (dP - delta), rounded to the operand dtype
//   dq = scale * sum_j ds_ij k_j      (flash_dq; scale the exact f32 1/sqrt(d))
//   dv = sum_i p_ij dO_i, p rounded to v's dtype;  dk = sum_i ds_ij qs_i  (flash_dkv)
//
// The causal mask keeps the reference's offset = tk - tq (a masked score's
// p, exp(-1e30 - lse), is an exact 0); key tiles above the diagonal are
// skipped; keys past tk and query rows past tq contribute an exact zero.
// Each block owns its output rows and loops over the other axis (the TPU
// kernels' sequential grid axis), so no two blocks write one element: no
// atomics, and the result is deterministic.
//
// What bounds it on the H100: at the training shape [128, 1024, 64] bf16
// causal the work is operations, 6 d flops per live (q, k) pair in dq
// (0.0261 ms at 989 TFLOP/s) and 8 d in dk/dv (0.0348 ms), against a few
// MB moved. The bf16 kernels of heads up to 128 (every main path:
// flash_dq_kernel, flash_dkv_kernel) are the structure of the
// forward (flash_fwd.cu) on the warp-level tensor cores, so that the
// products, not the copies or shared-memory round trips, take the time:
// - flash_dkv: a warp owns 16 key rows for the whole query loop; a block
//   holds 128 keys (8 warps) where that grid still fills every SM twice,
//   else 64 (4 warps); the key tiles with the most query tiles (the low
//   ones, under the causal mask) go first. Tiles of 64 queries (q, dO,
//   and their lse and delta) come through a ring of shared-memory stages
//   (three at d = 64, two at d = 128) filled by cp.async (zeros past tq),
//   with one __syncthreads() per tile; each thread pre-scales the q
//   chunks it copied before that barrier. Per 16-query step a warp
//   computes s^T = K qs^T and dP^T = V dO^T with mma.sync m16n8k16 (A:
//   its own K and V rows, by ldmatrix from shared memory; B: qs and dO
//   rows by ldmatrix), forms p^T and ds^T in the
//   accumulators (lse and delta indexed by the accumulator's column, the
//   query), packs them to bf16 A fragments in place, and adds p^T dO to
//   dv and ds^T qs to dk with B from ldmatrix.trans of the same stage.
// - flash_dq: the forward's structure with two more products: a warp owns
//   16 query rows; a block is 128 rows (8 warps) or 64 (4) by the same
//   grid-size rule; the query tiles with the most key tiles go first. Its
//   qs and dO rows are read once and held as A fragments, lse and delta
//   of its rows in registers (delta summed from its dO rows and O read
//   once from device memory); tiles of 64 keys and values come through
//   the cp.async ring; per 16-key step S = qs K^T and dP = dO V^T (B from
//   ldmatrix of K and V), ds in registers packed to bf16 A fragments, and
//   dq += ds K with B from ldmatrix.trans of the same K stage.
// - dk, dv and dq accumulate in f32 registers (never in shared memory);
//   the epilogue stages each warp's rows, in bf16, through its own rows of
//   shared memory and writes 16-byte coalesced stores; dq takes its scale
//   once there;
// - masks are evaluated only on steps that cross the diagonal, tq or tk;
//   a warp skips the 16-wide steps that lie wholly above its diagonal.
// Registers: every bf16 instantiation must compile without spills (the
// build check of chip_smoke.py enforces it). At d = 64 both kernels keep
// to 128 registers, so two 8-warp blocks share an SM: flash_dkv reads its
// K and V fragments from shared memory at every step for that (holding
// them as registers took 175-190 registers, one block per SM, and was
// 6 % slower at the training shape); at d = 128 dk and dv alone take 128
// registers, and one block runs per SM.
//
// The wide bf16 kernels (flash_dq_kernel_wide, flash_dkv_kernel_wide) run
// the bf16 heads of 256, 512 and 1024 (129-256, 257-512 and 513-1024 are
// zero-padded to them) on the same tensor-core tools, with the structure
// of the wide forward (flash_fwd.cu). The kernels above cannot: a warp
// there holds a 16 x d f32 accumulator (d / 2 registers; flash_dkv two of
// them) and its qs and dO rows as A fragments (d / 4 each), past 255
// registers at 256. What bounds them at [32, 1024, 256] bf16 causal, and
// at [16, 1024, 512] and [8, 1024, 1024] (the same bh x d): 0.0301 ms of
// bytes for flash_dq (0.0261 of operations) and 0.0348 ms of operations
// for flash_dkv. So:
// - a warp owns at most 256 of the head's columns of dq (128 f32
//   registers) or 128 of dk and of dv (64 + 64); its operand rows stay
//   in shared memory and are read by ldmatrix at every step, as the
//   wide forward reads Q; every warp contracts its share of S and dP
//   over 256 columns (at 1024 one quarter of the head);
// - flash_dq_kernel_wide<D, BQ>: 8 warps a block. At d = 256 one warp
//   owns 16 query rows and all 256 columns: 128 rows a block, so K and V
//   come from L2 once per 128 rows (q and dO 132 KB, two cp.async stages
//   of 32-key K/V tiles 66 KB, one block an SM); a warp's step is the
//   whole tile, so it reads its qs and dO fragments once per 32 keys (on
//   the H100 at [32, 1024, 256] causal 1.16x faster than 16-key steps;
//   243 registers). At d = 512 two warps share 16 rows (64 a block), each
//   with 256 columns of dq, and contract S = qs K^T and dP = dO V^T over
//   their own half of d; the pair sums its 16 x 16 partials of both
//   through shared memory under its named barrier. q and dO of 64 rows
//   take 130 KB, so K/V tiles are 16 keys (two stages, 65 KB): one
//   exchange a tile, whose buffer's reuse the block barrier orders. Each
//   warp of a pair sums delta over the whole row alike; the first writes
//   it. At d = 1024 the streamed K and V take the time (at [8, 1024,
//   1024] a 16-row block reads 66 KB of them per 16 keys, about 1.1 GB a
//   call from L2), so 32 rows a block where that grid fills every SM: four
//   warps share 16 rows as at 512, each owning 256 columns, their four
//   partials summed in column order, and the K/V tiles are 8 keys (two
//   stages of 16 would not fit beside 32 resident rows), so that dq +=
//   ds K runs on m16n8k8; elsewhere (short sequences, few heads) 16 rows:
//   all eight warps share them, four taking the quarters of S and four
//   those of dP, one mma chain each, every warp owning 128 columns of dq,
//   with 16-key tiles (in trials on the H100 each tiling beat the f32
//   kernels' ring of 256-column chunks, at 16 rows and at 32, where it
//   is kept). Either way every warp of a row group sums the
//   quarters of S in column order, ((S0 + S1) + S2) + S3, each one mma
//   chain from 0 over its 16 depth steps: the bits of
//   flash_fwd_kernel_wide<1024, 16 or 32>'s S, so that s - lse cancels
//   the forward's rounding of s, as in the reference. At 1024 the warps
//   split delta's columns and sum their partials in warp order;
// - flash_dkv_kernel_wide: 8 warps a block. A key group of 16 keys has
//   WPK = d / 128 warps, each owning 128 columns of dk and dv: two at
//   d = 256 (64 keys a block; query tiles of 32, a warp's step, in
//   three cp.async stages: on the H100 at [32, 1024, 256] causal 1.10x
//   faster than 16-query steps; 242 registers) and four at 512 (32 keys
//   a block, query tiles of 16). K and V of the block stay resident.
//   Each warp contracts S^T = K qs^T and dP^T = V dO^T over its own
//   columns; the group writes its partials to shared memory, meets at
//   its named barrier, and every warp sums the WPK partials in the
//   order of their columns, so all hold the same p^T and ds^T; each then
//   adds p^T dO and ds^T qs into its own columns, B from ldmatrix.trans
//   of the query stage. At 1024 the block is one key group of 16 keys
//   and eight warps (dk and dv of 32 keys would take 256 accumulator
//   registers a lane), query tiles of 16 in two stages (198 KB with K and
//   V), and the contraction is split as flash_dq's at 16 rows: four warps
//   chain the quarters of S^T, four those of dP^T, and every warp sums
//   each in column order, the forward's bits again;
// - the numbers are those of the kernels above (q pre-scaled as it
//   lands, p from exp2 of the rescaled score, ds and p rounded to bf16
//   before their products, dq scaled once at the end), each block owns
//   its output rows (no atomics: deterministic), the causal tiles with
//   the most work go first, and masks are evaluated only on steps that
//   cross the diagonal, tq or tk; 0 spills (chip_smoke.py phase 1).
//
// The f32 kernels of heads up to 128 (flash_dq_kernel_tf32x3,
// flash_dkv_kernel_tf32x3; 1-128 zero-padded to 64 or 128) take their
// scores on the CUDA cores in the forward's order (score_chain,
// flash_common.cuh: each score one fma chain over the head from 0, the
// bits of flash_fwd_kernel_tf32x3's, from which lse came) and run every
// other product on the tensor cores in 3xTF32 (flash_common.cuh): each
// f32 operand is split into a TF32 value and the rest, and each product
// is three mma.sync m16n8k8 TF32 products, small terms first, into an
// f32 accumulator. What bounds them at [128, 1024, 64] f32 causal: 6 d
// flops per live pair in dq and 8 d in dk/dv, three times over at the
// dense TF32 rate (0.156 and 0.208 ms at 495 TFLOP/s; 0.385 and 0.513 ms
// of f32 on the CUDA cores); the scores' 2 d flops on the CUDA cores
// alone take 0.128 ms of them. With S on the tensor cores, as first
// designed, their errors at scores of ±60 read 6-22x the reference's
// (ROADMAP C4). Their structure is the bf16 kernels' (a warp owns 16 rows, the
// causal tiles with the most work first, masks only on steps that cross
// the diagonal, tq or tk, no atomics, 16-byte stores), in f32:
// - 8 warps and 128 resident rows a block (q and dO in dq, K and V in
//   dkv), the other axis through a cp.async ring (tiles of 64 rows in
//   three stages at d = 64, 32 rows in two at 128: 176 and 203 KB, one
//   block an SM); f32 rows 4 words (mod 32) apart;
// - the operand of a product whose rows are the product's rows or
//   columns (qs, dO, K, V in S and dP) comes by ldmatrix, which moves an
//   f32 element as two 16-bit halves, split as it is read: the
//   resident rows stay in shared memory (held split, a warp's qs and dO
//   alone would take 128 registers at d = 64);
// - TF32 m16n8k8's accumulator (rows g, g + 8; columns 2c, 2c + 1) is
//   not its A fragment (columns c, c + 4), so the products over the
//   accumulator's columns (dq += ds K, dv += p^T dO, dk += ds^T qs) take
//   their depth in a permuted order, column 2c as c and 2c + 1 as c + 4,
//   and read their B operand's rows in that order by scalar loads (there
//   is no transposed 32-bit ldmatrix), which the 4-word row padding
//   spreads over the 32 banks;
// - each 8-column tile of dq, dk and dv sums a step in a zeroed partial,
//   added to its f32 accumulator with a rounded add: the tensor cores'
//   accumulation is not rounded to nearest, and a chain over the whole
//   sequence carries that error;
// - p = expf(s - lse), as the plain version;
//   registers 147-254, 0 spills (chip_smoke.py phase 1).
//
// The f32 kernels of heads 256, 512 and 1024 (flash_dq_kernel_wide_tf32x3,
// flash_dkv_kernel_wide_tf32x3; 129-1024 zero-padded to them) take the
// wide bf16 kernels' structure in f32, with the 3xTF32 tools of the
// kernels above, which do not stretch to these heads: 128 resident f32
// rows of two matrices take 266 KB at d = 256, and a warp owning all
// the columns of dq would hold 128 accumulator registers on top of the
// ~140 that d = 128 takes. What bounds them at [32, 1024, 256] f32
// causal: the same work as [128, 1024, 64], 0.156 ms (dq) and 0.208 ms
// (dk/dv) in 3xTF32 at 495 TFLOP/s; at [8, 1024, 1024] the same. So:
// - 8 warps a block; a row group (dq) or key group (dkv) of 16 rows has
//   WP = d / 128 warps, each owning 128 of the head's columns (64
//   accumulator registers of dq, 64 + 64 of dk and dv); 64 resident rows
//   a block at 256, 32 at 512 and 16 at 1024 (130 KB), ring tiles of 16
//   rows at 256 and 8 at 512 in two cp.async stages (65 KB); one block
//   an SM;
// - the scores are not taken on the tensor cores: each is one fma chain
//   over the head's columns in order on the CUDA cores (at 1024 one over
//   each 256-column quarter, the four sums added in order), bit for bit
//   the score of flash_fwd_kernel_tf32x3 from which lse came, so that s -
//   lse cancels the forward's rounding of s as in the reference, whose
//   two passes compute s alike. At scores of ±60 (ROADMAP C3) a score
//   from the tensor cores, even an exact one, differs from the forward's
//   by the forward's own roundings, and the exponential carries that to
//   several times the reference's error. A group's chaining warps take
//   its 16 x T scores in register tiles (chain_columns: 2 x 2 chains a
//   lane on both warps of a group at 256, 1 x 1 on all four at 512) and
//   leave them in shared memory;
// - dP is a product over the warp's own columns in 3xTF32 (A by ldmatrix
//   of the resident rows, B by ldmatrix of the ring tile), each four
//   depth steps of it in a zeroed partial added with a rounded add; the
//   group's partials meet in shared memory under its named barrier, and
//   every warp sums them in the order of the warps, so all hold the same
//   dP (no atomics: deterministic); one exchange a tile, whose buffers'
//   reuse the block's barrier of the next tile orders;
// - dq += ds K, dv += p^T dO and dk += ds^T qs over the warp's columns in
//   3xTF32, with the accumulators as A fragments (the permuted depth of
//   the kernels above), each 8-column tile summed over the ring tile in
//   a zeroed partial added with one rounded add;
// - at 1024 (16 resident rows: 131 KB) two stages of whole tiles of two
//   matrices do not fit beside the resident rows, so the ring brings
//   256-column chunks of 32-row tiles (67 KB in two stages), and a tile
//   takes twelve steps: the chunks of the scores' operand (dq: K; dkv: q,
//   pre-scaled in place by the thread that copied it, all its loads
//   first), on which four warps chain the quarters of the tile's 16 x 32
//   scores, 2 x 2 a lane, each quarter's sum added to the last's in
//   order; the chunks of dP's operand (V; dO), on which every warp sums
//   its partial of dP over its 32 columns of the chunk (dkv: and adds p^T
//   dO to its columns of dv there); and the first operand's chunks
//   again, on which every warp adds ds K or ds^T qs to its columns of the
//   chunk. A warp owns 32 columns of each chunk of dq, dk and dv, so
//   every warp works at every step; dq reads K, and dkv q, twice from
//   L2. In trials on the H100 this layout beat 8-row tiles with the other
//   matrix held whole (K in dq, q in dkv, each step bringing one chunk of
//   both: one chain a lane, latency-bound), 16-row tiles in three or four
//   stages, two chaining warps of 4 x 2 or eight of 2 x 1, heads grouped
//   so that the blocks in flight share their K and V in L2, and the steps
//   unrolled by template (dkv then spilled). The partial products take
//   their 8-row steps outer (consecutive mma.sync into different
//   partials), and the pre-scale of a chunk issues all its loads first:
//   done one load after another before the barrier, it showed in dkv's
//   time;
// - every warp of a row group sums delta over the whole row alike, and
//   the first writes it; the causal tiles with the most work go first;
//   masks are evaluated only on tiles that cross the diagonal, tq or
//   tk; 0 spills (chip_smoke.py phase 1).
//
// Exposed as plain C functions so that no PyTorch header is compiled.

#include "flash_common.cuh"

namespace {

constexpr int TILE = 64;  // keys per flash_dq tile, queries per flash_dkv tile

// 4 bytes global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// ----------------------------------------------------- the bf16 flash_dq

template <int D, int BQ>
struct DqTiles {
  // K/V ring depth, as flash_fwd's
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int LD = D + 8;  // row stride in elements: 16 bytes of padding
  // q and dO rows of the block, then STAGES tiles of K and of V
  static constexpr size_t bytes = sizeof(bf16) * (size_t)(2 * BQ + 2 * STAGES * TILE) * LD;
  // d = 64: at most 128 registers, so 512 threads (two 8-warp blocks) fit an SM
  static constexpr int MIN_BLOCKS = D == 64 ? 512 / (2 * BQ) : 1;
};

template <int D, int BQ>
__global__ void __launch_bounds__(BQ * 2, DqTiles<D, BQ>::MIN_BLOCKS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, bf16* __restrict__ dq, int bh, int tq, int tk,
                int n_qtiles, int causal, float q_scale, float scale) {
  constexpr int NT = BQ * 2;  // BQ / 16 warps
  constexpr int LD = DqTiles<D, BQ>::LD;
  constexpr int STAGES = DqTiles<D, BQ>::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;            // STAGES tiles of TILE rows
  bf16* Vs = Ks + STAGES * TILE * LD;  // STAGES tiles of TILE rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  // the q-tiles with the most key tiles (the last ones, under the causal
  // mask) first, so the last wave of blocks is not the longest
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);
  const int b = blockIdx.x % bh;
  const int q0 = qt * BQ;
  const int r0 = q0 + 16 * warp;  // this warp's first query row
  const int offset = tk - tq;
  const bf16* kb = k + (size_t)b * tk * D;
  const bf16* vb = v + (size_t)b * tk * D;
  bf16* Qw = Qs + 16 * warp * LD;    // this warp's rows: q, later its dq
  bf16* dOw = dOs + 16 * warp * LD;

  // this warp's q and dO rows: copy group 0
  load_warp_rows<D, LD>(Qw, q + (size_t)b * tq * D, r0, tq, lane);
  load_warp_rows<D, LD>(dOw, dout + (size_t)b * tq * D, r0, tq, lane);
  cp_async_commit();

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_kt = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;

  // key tile kt (zeros past tk) into ring stage kt % STAGES
  auto load_kv = [&](int kt) {
    const int st = kt % STAGES;
    load_tile_pair<D, LD, TILE, NT>(Ks + st * TILE * LD, Vs + st * TILE * LD, kb, vb,
                                    kt * TILE, tk);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_kv(s);
    cp_async_commit();
  }

  // lse (times log2 e) of rows g and g + 8; zeros past tq
  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    lse2[h] = row < tq ? lse[(size_t)b * tq + row] * LOG2E : 0.f;
  }

  cp_async_wait<STAGES - 1>();  // group 0 (this thread's copies) landed
  __syncwarp();                 // ... and the other lanes' too

  // delta = rowsum(dO O) in f32: lanes l and l + 16 sum the two halves of
  // row r0 + l % 16 (O read once, straight from device memory; zero past
  // tq), written once per row for flash_dkv; then rows g and g + 8
  float part = 0.f;
  if (r0 + lane % 16 < tq) {
    const int r = lane % 16, c0 = (lane / 16) * (D / 2);
    const bf16* orow = o + ((size_t)b * tq + r0 + r) * D + c0;
#pragma unroll
    for (int i = 0; i < D / 2; i += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + i);
      const uint4 dv = *reinterpret_cast<const uint4*>(dOw + r * LD + c0 + i);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(o2[e]), y = __bfloat1622float2(d2[e]);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
      }
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 16);
  if (lane < 16 && r0 + lane < tq) delta[(size_t)b * tq + r0 + lane] = part;
  const float dlt[2] = {__shfl_sync(0xffffffffu, part, g), __shfl_sync(0xffffffffu, part, g + 8)};

  // qs (scaled as loaded) and dO as A fragments
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<LD>(qa[kk], Qw, kk, lane);
    load_a<LD>(da[kk], dOw, kk, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) qa[kk][j] = scale_pair(qa[kk][j], q_scale);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose stage the next copy refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_kt) load_kv(kt + STAGES - 1);
    cp_async_commit();
    if (r0 >= tq) continue;  // this warp's rows are all past tq

    const bf16* Kt = Ks + (kt % STAGES) * TILE * LD;
    const bf16* Vt = Vs + (kt % STAGES) * TILE * LD;
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {  // keys kc0 .. kc0 + 15
      const int kc0 = kt * TILE + 16 * j;
      // wholly above this warp's diagonal, or past tk: p = 0 throughout
      if (kc0 >= tk || (causal && kc0 > r0 + 15 + offset)) continue;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4], bv[4];
        load_bt<LD>(bk, Kt, j, kk, lane);
        load_bt<LD>(bv, Vt, j, kk, lane);
        mma_bf16(s[0], qa[kk], bk[0], bk[1]);
        mma_bf16(s[1], qa[kk], bk[2], bk[3]);
        mma_bf16(dp[0], da[kk], bv[0], bv[1]);
        mma_bf16(dp[1], da[kk], bv[2], bv[3]);
      }
      // ds = p (dP - delta); masks only where the step crosses tk or
      // this warp's diagonal
      const bool edge = kc0 + 16 > tk || (causal && kc0 + 15 > r0 + offset);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[n][e], LOG2E, -lse2[e / 2]));
          if (edge) {
            const int col = kc0 + 8 * n + 2 * c + (e % 2);
            const int row = r0 + g + 8 * (e / 2);
            if (col >= tk || (causal && row + offset < col)) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - dlt[e / 2]);
        }
      }
      uint32_t dsa[4];
      pack_a(dsa, s[0], s[1]);
      // dq += ds K: B by ldmatrix.trans of the same K rows
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bfr[4];
        load_b<LD>(bfr, Kt + 16 * j * LD, np, lane);
        mma_bf16(acc[2 * np], dsa, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], dsa, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  store_warp_rows<D, LD>(dq + (size_t)b * tq * D, Qw, acc,
                         [=](float x, int) { return x * scale; }, r0, tq, lane);
}

template <int D, int BQ>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* delta, void* dq, int bh, int tq, int tk, int causal,
              float q_scale, float scale, cudaStream_t stream) {
  constexpr size_t smem = DqTiles<D, BQ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + BQ - 1) / BQ;
  flash_dq_kernel<D, BQ><<<bh * n_qtiles, BQ * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), bh, tq, tk, n_qtiles, causal, q_scale, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- the bf16 flash_dkv

template <int D, int BKB>
struct DkvTiles {
  // q/dO ring depth: three stages at d = 64, two at d = 128
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int LD = D + 8;
  // d = 64, 8 warps: at most 128 registers, so two blocks fit an SM
  static constexpr int MIN_BLOCKS = D == 64 && BKB == 128 ? 2 : 1;
  // K and V rows of the block, then STAGES tiles of qs and of dO, then
  // STAGES tiles of lse and of delta (f32)
  static constexpr size_t stage_elems = (size_t)2 * TILE * LD;
  static constexpr size_t rows_bytes = sizeof(bf16) * (2 * (size_t)BKB * LD + STAGES * stage_elems);
  static constexpr size_t bytes = rows_bytes + sizeof(float) * 2 * STAGES * TILE;
};

template <int D, int BKB>
__global__ void __launch_bounds__(BKB * 2, DkvTiles<D, BKB>::MIN_BLOCKS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int bh, int tq, int tk,
                 int causal, float q_scale) {
  using Tiles = DkvTiles<D, BKB>;
  constexpr int NT = BKB * 2;  // BKB / 16 warps
  constexpr int LD = Tiles::LD;
  constexpr int STAGES = Tiles::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKB * LD;
  bf16* Rs = Vs + BKB * LD;  // stage st: qs rows at st * stage_elems, dO rows TILE * LD on
  float* Ls = reinterpret_cast<float*>(smem + Tiles::rows_bytes);  // stage st: lse, then delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  // the key tiles with the most query tiles (the first ones, under the
  // causal mask) first
  const int k0 = (int)(blockIdx.x / bh) * BKB;
  const int b = blockIdx.x % bh;
  const int kw0 = k0 + 16 * warp;  // this warp's first key row
  const int offset = tk - tq;
  const bf16* qb = q + (size_t)b * tq * D;
  const bf16* db = dout + (size_t)b * tq * D;
  bf16* Kw = Ks + 16 * warp * LD;  // this warp's rows: K, later its dk
  bf16* Vw = Vs + 16 * warp * LD;  // V, later dv

  // this warp's K and V rows: copy group 0
  load_warp_rows<D, LD>(Kw, k + (size_t)b * tk * D, kw0, tk, lane);
  load_warp_rows<D, LD>(Vw, v + (size_t)b * tk * D, kw0, tk, lane);
  cp_async_commit();

  // causal: the first query row that sees any key of this block (< tq,
  // since k0 - offset <= tq - 1)
  const int qt0 = (causal ? max(0, k0 - offset) : 0) / TILE;
  const int n_qt = (tq + TILE - 1) / TILE - qt0;

  // query tile qt0 + t (zeros past tq) into ring stage t % STAGES
  auto load_q = [&](int t) {
    const int q0 = (qt0 + t) * TILE, st = t % STAGES;
    bf16* qd = Rs + st * Tiles::stage_elems;
    load_tile_pair<D, LD, TILE, NT>(qd, qd + TILE * LD, qb, db, q0, tq);
    for (int i = threadIdx.x; i < 2 * TILE; i += NT) {
      const int r = i % TILE;
      const bool in = q0 + r < tq;
      const size_t off = in ? (size_t)b * tq + q0 + r : 0;
      cp_async4(smem_addr(Ls + (2 * st + i / TILE) * TILE + r), (i < TILE ? lse : delta) + off,
                in ? 4 : 0);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_qt) load_q(s);
    cp_async_commit();
  }

  cp_async_wait<STAGES - 1>();  // group 0 (this thread's K and V) landed
  __syncwarp();                 // ... and the other lanes' too

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int t = 0; t < n_qt; ++t) {
    const int st = t % STAGES;
    bf16* Qt = Rs + st * Tiles::stage_elems;
    const bf16* dOt = Qt + TILE * LD;
    const float* Lt = Ls + 2 * st * TILE;  // lse, then delta
    // tile t has landed for this thread: pre-scale the q chunks it copied
    cp_async_wait<STAGES - 2>();
    scale_rows<D, LD, TILE, NT>(Qt, q_scale);
    // every thread's share of tile t is in place, and every warp is done
    // with tile t - 1, whose stage the next copy refills
    __syncthreads();
    if (t + STAGES - 1 < n_qt) load_q(t + STAGES - 1);
    cp_async_commit();

    const int q0 = (qt0 + t) * TILE;
    if (kw0 >= tk) continue;  // this warp's rows are all past tk
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {  // queries qc0 .. qc0 + 15
      const int qc0 = q0 + 16 * j;
      // past tq, or wholly below this warp's keys under the mask: p = 0
      if (qc0 >= tq || (causal && qc0 + 15 + offset < kw0)) continue;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // (this order of the loads keeps d = 64 within 128 registers
        // without spills; K and V first spilled 20 bytes)
        uint32_t bq[4], bd[4];
        load_bt<LD>(bq, Qt, j, kk, lane);
        load_bt<LD>(bd, dOt, j, kk, lane);
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Kw, kk, lane);
        load_a<LD>(va, Vw, kk, lane);
        mma_bf16(s[0], ka, bq[0], bq[1]);
        mma_bf16(s[1], ka, bq[2], bq[3]);
        mma_bf16(dp[0], va, bd[0], bd[1]);
        mma_bf16(dp[1], va, bd[2], bd[3]);
      }
      // p^T and ds^T in the accumulators: row (key) kw0 + g + 8 (e / 2),
      // column (query) qc0 + 8 n + 2 c + (e % 2); masks only where the
      // step crosses tq or this warp's diagonal
      const bool edge = qc0 + 16 > tq || (causal && qc0 + offset < kw0 + 15);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * j + 8 * n + 2 * c;  // in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(Lt + TILE + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[n][e], LOG2E, -(e % 2 ? l2.y : l2.x) * LOG2E));
          if (edge) {
            const int qi = q0 + col + (e % 2);
            const int ki = kw0 + g + 8 * (e / 2);
            if (qi >= tq || (causal && qi + offset < ki)) p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - (e % 2 ? d2.y : d2.x));
        }
      }
      uint32_t pa[4], dsa[4];
      pack_a(pa, s[0], s[1]);
      pack_a(dsa, dp[0], dp[1]);
      // dv += p^T dO, dk += ds^T qs: B by ldmatrix.trans of the same rows
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bd[4], bq[4];
        load_b<LD>(bd, dOt + 16 * j * LD, np, lane);
        load_b<LD>(bq, Qt + 16 * j * LD, np, lane);
        mma_bf16(dva[2 * np], pa, bd[0], bd[1]);
        mma_bf16(dva[2 * np + 1], pa, bd[2], bd[3]);
        mma_bf16(dka[2 * np], dsa, bq[0], bq[1]);
        mma_bf16(dka[2 * np + 1], dsa, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  const auto same = [](float x, int) { return x; };
  store_warp_rows<D, LD>(dk + (size_t)b * tk * D, Kw, dka, same, kw0, tk, lane);
  store_warp_rows<D, LD>(dv + (size_t)b * tk * D, Vw, dva, same, kw0, tk, lane);
}

template <int D, int BKB>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int bh, int tq, int tk, int causal,
               float q_scale, cudaStream_t stream) {
  constexpr size_t smem = DkvTiles<D, BKB>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<D, BKB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (tk + BKB - 1) / BKB;
  flash_dkv_kernel<D, BKB><<<bh * n_ktiles, BKB * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      bh, tq, tk, causal, q_scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- the wide bf16 kernels

// Heads of 256, 512 and 1024: flash_dq_kernel_wide<D, BQ>. A block of BQ
// query rows in row groups of 16, WPR warps to a row group, each owning
// DW of the head's columns of dq; K and V tiles of BKW keys through a
// cp.async ring, one step of each warp a tile. Every warp contracts its
// share of S = qs K^T and dP = dO V^T over CW = 256 columns:
// - 256 (BQ 128): one warp a row group, the whole head, 32-key tiles;
// - 512 (BQ 64) and 1024 at BQ = 32: WPR = D / 256 warps share a row
//   group, each owning 256 columns, over which it contracts both S and
//   dP; every warp of the group sums their partials in column order, as
//   flash_fwd_kernel_wide sums its S. Tiles of 16 keys at 512; at 1024, 8
//   keys (two stages of 16 would not fit beside 32 resident rows), dq
//   += ds K then on m16n8k8;
// - 1024 at BQ = 16 (SPLIT): all eight warps share one row group, each
//   owning DW = 128 columns of dq: warps 0-3 take the four 256-column
//   quarters of S, one mma chain each, warps 4-7 those of dP, and every
//   warp sums the four partials of each in column order. 16-key tiles.
// At 1024 each quarter of S is one mma chain from 0 over its 16 depth
// steps, and the four are added ((S0 + S1) + S2) + S3: the order of
// flash_fwd_kernel_wide<1024, 16 or 32>, whose lse the backward takes, so
// that s - lse cancels the forward's rounding of s (a score's chain does
// not depend on which other scores share its mma.sync). The launcher
// takes 32 rows where that grid fills every SM, as the forward does.
template <int D, int BQ>
struct WideDqTiles {
  static constexpr bool SPLIT = D == 1024 && BQ == 16;
  static constexpr int WPR = SPLIT ? 8 : D / 256;  // warps per row group
  static constexpr int DW = D / WPR;               // columns of dq per warp
  static constexpr int CW = 256;                   // contracted per warp
  static constexpr int NT = BQ / 16 * WPR * 32;    // 8 warps at every width
  static constexpr int BKW = WPR == 1 ? 32 : WPR == 4 ? 8 : 16;  // keys per K/V tile
  static constexpr int NS = BKW / 8;               // 8-key accumulator tiles a tile
  static constexpr int STAGES = 2;
  static constexpr int LD = D + 8;  // row stride in elements: 16 bytes of padding
  // q and dO rows of the block, then STAGES tiles of K and of V
  static constexpr size_t tile_bytes =
      sizeof(bf16) * (size_t)(2 * BQ + 2 * STAGES * BKW) * LD;
  // the exchanged partials: WPR = 2 or 4 each warp's S and dP, SPLIT its
  // S or dP; WPR >= 4 also each warp's partial delta of its 16 rows
  static constexpr size_t x_bytes = sizeof(float4) * NT * (WPR == 1 ? 0 : SPLIT ? NS : 2 * NS);
  static constexpr size_t bytes = tile_bytes + x_bytes + (WPR >= 4 ? sizeof(float) * NT / 2 : 0);
  static_assert(NT == 256 && (SPLIT ? DW == 128 && CW * 4 == D : DW == CW),
                "wide dq: 256 (128 rows a block), 512 (64), 1024 (16 or 32)");
  static_assert(bytes <= SMEM_LIMIT, "flash_dq wide layout exceeds shared memory");
};

template <int D, int BQ>
__global__ void __launch_bounds__(WideDqTiles<D, BQ>::NT, 1)
flash_dq_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     float* __restrict__ delta, bf16* __restrict__ dq, int bh, int tq,
                     int tk, int n_qtiles, int causal, float q_scale, float scale) {
  using Tl = WideDqTiles<D, BQ>;
  constexpr int BKW = Tl::BKW, NS = Tl::NS, CW = Tl::CW;
  constexpr int WPR = Tl::WPR, DW = Tl::DW, NT = Tl::NT, LD = Tl::LD, STAGES = Tl::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;            // STAGES tiles of BKW rows
  bf16* Vs = Ks + STAGES * BKW * LD;   // STAGES tiles of BKW rows
  float4* X = reinterpret_cast<float4*>(smem + Tl::tile_bytes);  // partials (WPR > 1)
  float* Dp = reinterpret_cast<float*>(smem + Tl::tile_bytes + Tl::x_bytes);  // delta's

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int rg = warp / WPR, part = warp % WPR;  // row group, share of the columns
  // the q-tiles with the most key tiles (the last ones, under the causal
  // mask) first, so the last wave of blocks is not the longest
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);
  const int b = blockIdx.x % bh;
  const int q0 = qt * BQ;
  const int r0 = q0 + 16 * rg;  // this warp's first query row
  const int offset = tk - tq;
  const bf16* kb = k + (size_t)b * tk * D;
  const bf16* vb = v + (size_t)b * tk * D;
  // this warp's rows and columns of q (later its dq) and of dO
  bf16* Qw = Qs + 16 * rg * LD + part * DW;
  const bf16* dOw = dOs + 16 * rg * LD + part * DW;

  // the block's q and dO rows (zeros past tq): copy group 0
  load_tile_pair<D, LD, BQ, NT>(Qs, dOs, q + (size_t)b * tq * D, dout + (size_t)b * tq * D,
                                q0, tq);
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
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_kv(s);
    cp_async_commit();
  }

  // lse (times log2 e) of rows g and g + 8; zeros past tq
  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    lse2[h] = row < tq ? lse[(size_t)b * tq + row] * LOG2E : 0.f;
  }

  // q scaled in place (each thread the chunks it copied, once group 0
  // landed), then the block's barrier: every warp reads its q and dO
  // fragments by ldmatrix at each step
  cp_async_wait<STAGES - 1>();
  scale_rows<D, LD, BQ, NT>(Qs, q_scale);
  __syncthreads();

  // delta = rowsum(dO O) in f32: lanes l and l + 16 sum the two halves
  // of row r0 + l % 16 (O read straight from device memory; zero past
  // tq) over DC columns: the whole head at 256 and 512 (both warps of a
  // pair alike); at 1024 each warp its own DW, the group's partials then
  // summed in warp order by every warp of it; written once per row for
  // flash_dkv; then rows g and g + 8
  constexpr int DC = WPR >= 4 ? DW : D;
  float dsum = 0.f;
  if (r0 + lane % 16 < tq) {
    const int r = lane % 16, c0 = (WPR >= 4 ? part * DW : 0) + (lane / 16) * (DC / 2);
    const bf16* orow = o + ((size_t)b * tq + r0 + r) * D + c0;
    const bf16* drow = dOs + (16 * rg + r) * LD + c0;
#pragma unroll 4
    for (int i = 0; i < DC / 2; i += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + i);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + i);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(o2[e]), y = __bfloat1622float2(d2[e]);
        dsum = fmaf(x.x, y.x, dsum);
        dsum = fmaf(x.y, y.y, dsum);
      }
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 16);
  if constexpr (WPR >= 4) {
    if (lane < 16) Dp[warp * 16 + lane] = dsum;
    __syncthreads();
    dsum = Dp[rg * WPR * 16 + lane % 16];
#pragma unroll
    for (int w = 1; w < WPR; ++w) dsum += Dp[(rg * WPR + w) * 16 + lane % 16];
  }
  if (part == 0 && lane < 16 && r0 + lane < tq) delta[(size_t)b * tq + r0 + lane] = dsum;
  const float dlt[2] = {__shfl_sync(0xffffffffu, dsum, g), __shfl_sync(0xffffffffu, dsum, g + 8)};

  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    // tile kt has landed for every thread, every warp is done with tile
    // kt - 1 (whose stage the next copy refills) and with its group's
    // partials of tile kt - 1
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_kt) load_kv(kt + STAGES - 1);
    cp_async_commit();
    if (r0 >= tq) continue;  // this row group's rows are all past tq

    // keys kc0 .. kc0 + BKW - 1 (kc0 < tk): wholly above this row group's
    // diagonal, p = 0 throughout
    const int kc0 = kt * BKW;
    if (causal && kc0 > r0 + 15 + offset) continue;
    const bf16* Kt = Ks + (kt % STAGES) * BKW * LD + part * DW;
    const bf16* Vt = Vs + (kt % STAGES) * BKW * LD + part * DW;
    float s[NS][4] = {}, dp[NS][4] = {};
    if constexpr (Tl::SPLIT) {
      // warp `part` < 4: quarter `part` of S, warp 4 + i: quarter i of dP,
      // A by ldmatrix of the resident rows, B of the tile's
      const bool is_s = part < 4;
      const int qc = (part % 4) * CW;
      const bf16* A = (is_s ? Qs : dOs) + 16 * rg * LD + qc;
      const bf16* B = (is_s ? Ks : Vs) + (kt % STAGES) * BKW * LD + qc;
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk) {
        uint32_t xa[4];
        load_a<LD>(xa, A, kk, lane);
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          uint32_t bx[4];
          load_bt<LD>(bx, B, j, kk, lane);
          mma_bf16(s[2 * j], xa, bx[0], bx[1]);
          mma_bf16(s[2 * j + 1], xa, bx[2], bx[3]);
        }
      }
      // the whole head, through shared memory under the group's barrier
      // (the block's barrier of the next tile orders the buffer's reuse):
      // S from warps 0-3, dP from 4-7, each in column order
#pragma unroll
      for (int n = 0; n < NS; ++n)
        X[(warp * NS + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      bar_sync(1 + rg, 32 * WPR);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float4 y = X[(WPR * rg * NS + n) * 32 + lane];
        float4 z = X[((WPR * rg + 4) * NS + n) * 32 + lane];
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          const float4 ys = X[((WPR * rg + i) * NS + n) * 32 + lane];
          const float4 zs = X[((WPR * rg + 4 + i) * NS + n) * 32 + lane];
          y.x += ys.x, y.y += ys.y, y.z += ys.z, y.w += ys.w;
          z.x += zs.x, z.y += zs.y, z.z += zs.z, z.w += zs.w;
        }
        s[n][0] = y.x, s[n][1] = y.y, s[n][2] = y.z, s[n][3] = y.w;
        dp[n][0] = z.x, dp[n][1] = z.y, dp[n][2] = z.z, dp[n][3] = z.w;
      }
    } else {
      // S and dP over this warp's columns: A fragments of qs and dO by
      // ldmatrix (they stay in shared memory), B of K and V two 8-key
      // tiles per ldmatrix (NS = 1: one tile at two depth steps)
      if constexpr (NS == 1) {
#pragma unroll
        for (int kk2 = 0; kk2 < CW / 32; ++kk2) {
          uint32_t qa0[4], qa1[4], da0[4], da1[4], bk[4], bv[4];
          load_a<LD>(qa0, Qw, 2 * kk2, lane);
          load_a<LD>(qa1, Qw, 2 * kk2 + 1, lane);
          load_a<LD>(da0, dOw, 2 * kk2, lane);
          load_a<LD>(da1, dOw, 2 * kk2 + 1, lane);
          load_bt8<LD>(bk, Kt, kk2, lane);
          load_bt8<LD>(bv, Vt, kk2, lane);
          mma_bf16(s[0], qa0, bk[0], bk[1]);
          mma_bf16(dp[0], da0, bv[0], bv[1]);
          mma_bf16(s[0], qa1, bk[2], bk[3]);
          mma_bf16(dp[0], da1, bv[2], bv[3]);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk) {
          uint32_t qa[4], da[4];
          load_a<LD>(qa, Qw, kk, lane);
          load_a<LD>(da, dOw, kk, lane);
#pragma unroll
          for (int j = 0; j < NS / 2; ++j) {
            uint32_t bk[4], bv[4];
            load_bt<LD>(bk, Kt, j, kk, lane);
            load_bt<LD>(bv, Vt, j, kk, lane);
            mma_bf16(s[2 * j], qa, bk[0], bk[1]);
            mma_bf16(s[2 * j + 1], qa, bk[2], bk[3]);
            mma_bf16(dp[2 * j], da, bv[0], bv[1]);
            mma_bf16(dp[2 * j + 1], da, bv[2], bv[3]);
          }
        }
      }
      if constexpr (WPR > 1) {
        // S and dP over the whole head: the group's WPR partials through
        // shared memory under its barrier (the block's barrier of the
        // next tile orders the buffer's reuse), summed by every warp in
        // column order, so that all hold the same p and ds (at WPR = 2
        // each warp adds its partner's to its own: a + b == b + a)
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          X[(warp * 2 * NS + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
          X[(warp * 2 * NS + NS + n) * 32 + lane] =
              make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
        }
        bar_sync(1 + rg, 32 * WPR);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          if constexpr (WPR == 2) {
            const float4 y = X[((warp ^ 1) * 2 * NS + n) * 32 + lane];
            const float4 z = X[((warp ^ 1) * 2 * NS + NS + n) * 32 + lane];
            s[n][0] += y.x, s[n][1] += y.y, s[n][2] += y.z, s[n][3] += y.w;
            dp[n][0] += z.x, dp[n][1] += z.y, dp[n][2] += z.z, dp[n][3] += z.w;
          } else {
            float4 y = X[(rg * WPR * 2 * NS + n) * 32 + lane];
            float4 z = X[(rg * WPR * 2 * NS + NS + n) * 32 + lane];
#pragma unroll
            for (int i = 1; i < WPR; ++i) {
              const float4 ys = X[((rg * WPR + i) * 2 * NS + n) * 32 + lane];
              const float4 zs = X[((rg * WPR + i) * 2 * NS + NS + n) * 32 + lane];
              y.x += ys.x, y.y += ys.y, y.z += ys.z, y.w += ys.w;
              z.x += zs.x, z.y += zs.y, z.z += zs.z, z.w += zs.w;
            }
            s[n][0] = y.x, s[n][1] = y.y, s[n][2] = y.z, s[n][3] = y.w;
            dp[n][0] = z.x, dp[n][1] = z.y, dp[n][2] = z.z, dp[n][3] = z.w;
          }
        }
      }
    }
    // ds = p (dP - delta) in the S accumulators; masks only where the tile
    // crosses tk or this row group's diagonal
    const bool edge = kc0 + BKW > tk || (causal && kc0 + BKW - 1 > r0 + offset);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], LOG2E, -lse2[e / 2]));
        if (edge) {
          const int col = kc0 + 8 * n + 2 * c + (e % 2);
          const int row = r0 + g + 8 * (e / 2);
          if (col >= tk || (causal && row + offset < col)) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - dlt[e / 2]);
      }
    }
    // dq += ds K over this warp's columns: B by ldmatrix.trans of the same
    // K rows (NS = 1: m16n8k8 over the tile's 8 keys, four 8-column tiles
    // a load)
    if constexpr (NS == 1) {
      const uint32_t a0 = pack_bf16(s[0][0], s[0][1]), a1 = pack_bf16(s[0][2], s[0][3]);
#pragma unroll
      for (int n4 = 0; n4 < DW / 32; ++n4) {
        uint32_t bfr[4];
        load_b8<LD>(bfr, Kt, n4, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16_k8(acc[4 * n4 + i], a0, a1, bfr[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t dsa[4];
        pack_a(dsa, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int np = 0; np < DW / 16; ++np) {
          uint32_t bfr[4];
          load_b<LD>(bfr, Kt + 16 * j * LD, np, lane);
          mma_bf16(acc[2 * np], dsa, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np + 1], dsa, bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // dq times its scale, staged through this warp's rows and columns of q
  // (after the group's last barrier no warp reads them)
  store_warp_rows<DW, LD, D>(dq + (size_t)b * tq * D + part * DW, Qw, acc,
                             [=](float x, int) { return x * scale; }, r0, tq, lane);
}

template <int D, int BQ>
int launch_dq_wide(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, int bh, int tq,
                   int tk, int causal, float q_scale, float scale, cudaStream_t stream) {
  using Tl = WideDqTiles<D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel_wide<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + BQ - 1) / BQ;
  flash_dq_kernel_wide<D, BQ><<<bh * n_qtiles, Tl::NT, Tl::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), bh, tq, tk, n_qtiles, causal, q_scale, scale);
  return (int)cudaGetLastError();
}

// Heads of 256, 512 and 1024: flash_dkv_kernel_wide. A block of BKB keys
// in key groups of 16, WPK warps to a key group, each owning DW = 128 of
// the head's columns of dk and dv; query tiles of QT rows through a
// cp.async ring, one step of each warp a tile. At 256 and 512 a warp
// contracts S^T and dP^T over its own columns. At 1024 (SPLIT) one key
// group of 16 keys has all eight warps: warps 0-3 take the four
// 256-column quarters (CW) of S^T, one mma chain each, and warps 4-7
// those of dP^T, and every warp sums the four partials of each in column
// order, as flash_fwd_kernel_wide<1024> sums its S.
template <int D>
struct WideDkvTiles {
  static constexpr bool SPLIT = D == 1024;
  static constexpr int WPK = SPLIT ? 8 : D / 128;  // warps per key group
  static constexpr int DW = D / WPK;               // columns of dk and dv per warp
  static constexpr int CW = SPLIT ? score_chain_cols(D) : DW;  // contracted per warp
  static constexpr int BKB = WPK == 2 ? 64 : WPK == 4 ? 32 : 16;  // keys per block
  static constexpr int NT = BKB / 16 * WPK * 32;   // 8 warps at every width
  static constexpr int QT = WPK == 2 ? 32 : 16;    // queries per ring tile
  static constexpr int NQ = QT / 16;               // 16-query blocks per tile
  static constexpr int STAGES = SPLIT ? 2 : 3;     // at 1024 two fit beside K and V
  static constexpr int LD = D + 8;
  // K and V rows of the block, then STAGES tiles of qs and of dO, then
  // the partials (4 NQ accumulator tiles a thread; SPLIT 2 NQ), then
  // STAGES tiles of lse and of delta (f32)
  static constexpr size_t stage_elems = (size_t)2 * QT * LD;
  static constexpr size_t rows_bytes =
      sizeof(bf16) * (2 * (size_t)BKB * LD + STAGES * stage_elems);
  static constexpr size_t x_bytes = sizeof(float4) * NT * (SPLIT ? 2 : 4) * NQ;
  static constexpr size_t bytes = rows_bytes + x_bytes + sizeof(float) * 2 * STAGES * QT;
  static_assert(DW == 128 && (WPK == 2 || WPK == 4 || (SPLIT && CW * 4 == D)),
                "wide heads are 256, 512 or 1024");
  static_assert(bytes <= SMEM_LIMIT, "flash_dkv wide layout exceeds shared memory");
};

template <int D>
__global__ void __launch_bounds__(WideDkvTiles<D>::NT, 1)
flash_dkv_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int bh, int tq, int tk,
                      int causal, float q_scale) {
  using Tl = WideDkvTiles<D>;
  constexpr int BKB = Tl::BKB, QT = Tl::QT, NQ = Tl::NQ, WPK = Tl::WPK, DW = Tl::DW;
  constexpr int NT = Tl::NT, LD = Tl::LD, STAGES = Tl::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKB * LD;
  bf16* Rs = Vs + BKB * LD;  // stage st: qs rows at st * stage_elems, dO rows QT * LD on
  float4* X = reinterpret_cast<float4*>(smem + Tl::rows_bytes);  // partials
  float* Ls = reinterpret_cast<float*>(smem + Tl::rows_bytes + Tl::x_bytes);  // lse, delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int kg = warp / WPK, part = warp % WPK;  // key group, share of the columns
  // the key tiles with the most query tiles (the first ones, under the
  // causal mask) first
  const int k0 = (int)(blockIdx.x / bh) * BKB;
  const int b = blockIdx.x % bh;
  const int kw0 = k0 + 16 * kg;  // this warp's first key row
  const int offset = tk - tq;
  const bf16* qb = q + (size_t)b * tq * D;
  const bf16* db = dout + (size_t)b * tq * D;
  // this warp's rows and columns of K (later its dk) and of V (later dv)
  bf16* Kw = Ks + 16 * kg * LD + part * DW;
  bf16* Vw = Vs + 16 * kg * LD + part * DW;

  // the block's K and V rows (zeros past tk): copy group 0
  load_tile_pair<D, LD, BKB, NT>(Ks, Vs, k + (size_t)b * tk * D, v + (size_t)b * tk * D, k0,
                                 tk);
  cp_async_commit();

  // causal: the first query row that sees any key of this block (< tq,
  // since k0 - offset <= tq - 1)
  const int qt0 = (causal ? max(0, k0 - offset) : 0) / QT;
  const int n_qt = (tq + QT - 1) / QT - qt0;

  // query tile qt0 + t (zeros past tq) into ring stage t % STAGES
  auto load_q = [&](int t) {
    const int q0 = (qt0 + t) * QT, st = t % STAGES;
    bf16* qd = Rs + st * Tl::stage_elems;
    load_tile_pair<D, LD, QT, NT>(qd, qd + QT * LD, qb, db, q0, tq);
    for (int i = threadIdx.x; i < 2 * QT; i += NT) {
      const int r = i % QT;
      const bool in = q0 + r < tq;
      const size_t off = in ? (size_t)b * tq + q0 + r : 0;
      cp_async4(smem_addr(Ls + (2 * st + i / QT) * QT + r), (i < QT ? lse : delta) + off,
                in ? 4 : 0);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_qt) load_q(s);
    cp_async_commit();
  }

  float dka[DW / 8][4], dva[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int t = 0; t < n_qt; ++t) {
    const int st = t % STAGES;
    bf16* Qt = Rs + st * Tl::stage_elems;
    const float* Lt = Ls + 2 * st * QT;  // lse, then delta
    // tile t (and, at t = 0, K and V) has landed for this thread:
    // pre-scale the q chunks it copied
    cp_async_wait<STAGES - 2>();
    scale_rows<D, LD, QT, NT>(Qt, q_scale);
    // every thread's share of tile t is in place, and every warp is done
    // with tile t - 1 (whose stage the next copy refills) and with its
    // group's partials of tile t - 1
    __syncthreads();
    if (t + STAGES - 1 < n_qt) load_q(t + STAGES - 1);
    cp_async_commit();

    // queries q0 .. q0 + QT - 1: past tq, or wholly below this key
    // group's keys under the mask, p = 0 throughout (q0 < tq always)
    const int q0 = (qt0 + t) * QT;
    if (kw0 >= tk || (causal && q0 + QT - 1 + offset < kw0)) continue;
    const bf16* Qp = Qt + part * DW;  // this warp's columns of qs and dO
    const bf16* dOp = Qp + QT * LD;
    float s[2 * NQ][4] = {}, dp[2 * NQ][4] = {};
    if constexpr (Tl::SPLIT) {
      // warp `part` < 4: quarter `part` of S^T = K qs^T, warp 4 + i:
      // quarter i of dP^T = V dO^T, each one mma chain from 0 over its 16
      // depth steps (A by ldmatrix of the resident rows, B of the stage's
      // rows); then over the whole head, through shared memory under the
      // group's barrier: ((S0 + S1) + S2) + S3, the partials of
      // flash_fwd_kernel_wide<1024> added in its order (a score's chain
      // does not depend on which operand is the row), so that s is the
      // forward's bits; dP^T alike (the block's barrier of the next tile
      // orders the buffer's reuse)
      const bool is_s = part < 4;
      const int qc = (part % 4) * Tl::CW;
      const bf16* A = (is_s ? Ks : Vs) + 16 * kg * LD + qc;
      const bf16* B = (is_s ? Qt : Qt + QT * LD) + qc;
#pragma unroll
      for (int kk = 0; kk < Tl::CW / 16; ++kk) {
        uint32_t xa[4];
        load_a<LD>(xa, A, kk, lane);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          uint32_t bx[4];
          load_bt<LD>(bx, B, j, kk, lane);
          mma_bf16(s[2 * j], xa, bx[0], bx[1]);
          mma_bf16(s[2 * j + 1], xa, bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * NQ; ++n)
        X[(warp * 2 * NQ + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      bar_sync(1 + kg, 32 * WPK);
#pragma unroll
      for (int n = 0; n < 2 * NQ; ++n) {
        float4 y = X[(WPK * kg * 2 * NQ + n) * 32 + lane];
        float4 z = X[((WPK * kg + 4) * 2 * NQ + n) * 32 + lane];
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          const float4 ys = X[((WPK * kg + i) * 2 * NQ + n) * 32 + lane];
          const float4 zs = X[((WPK * kg + 4 + i) * 2 * NQ + n) * 32 + lane];
          y.x += ys.x, y.y += ys.y, y.z += ys.z, y.w += ys.w;
          z.x += zs.x, z.y += zs.y, z.z += zs.z, z.w += zs.w;
        }
        s[n][0] = y.x, s[n][1] = y.y, s[n][2] = y.z, s[n][3] = y.w;
        dp[n][0] = z.x, dp[n][1] = z.y, dp[n][2] = z.z, dp[n][3] = z.w;
      }
    } else {
      // S^T = K qs^T and dP^T = V dO^T over this warp's columns: A of K
      // and V by ldmatrix from the resident rows, B of qs and dO
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Kw, kk, lane);
        load_a<LD>(va, Vw, kk, lane);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          uint32_t bq[4], bd[4];
          load_bt<LD>(bq, Qp, j, kk, lane);
          load_bt<LD>(bd, dOp, j, kk, lane);
          mma_bf16(s[2 * j], ka, bq[0], bq[1]);
          mma_bf16(s[2 * j + 1], ka, bq[2], bq[3]);
          mma_bf16(dp[2 * j], va, bd[0], bd[1]);
          mma_bf16(dp[2 * j + 1], va, bd[2], bd[3]);
        }
      }
      // over the whole head: the key group's WPK partials, summed by every
      // warp of the group in the order of their columns, so that all of
      // them hold the same p^T and ds^T (the block's barrier of the next
      // tile orders the buffer's reuse)
#pragma unroll
      for (int n = 0; n < 2 * NQ; ++n) {
        X[(warp * 4 * NQ + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        X[(warp * 4 * NQ + 2 * NQ + n) * 32 + lane] =
            make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
      }
      bar_sync(1 + kg, 32 * WPK);
      const auto group_sum = [&](int n, float (&x)[4]) {
        float4 y = X[(kg * WPK * 4 * NQ + n) * 32 + lane];
#pragma unroll
        for (int i = 1; i < WPK; ++i) {
          const float4 z = X[((kg * WPK + i) * 4 * NQ + n) * 32 + lane];
          y.x += z.x, y.y += z.y, y.z += z.z, y.w += z.w;
        }
        x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
      };
#pragma unroll
      for (int n = 0; n < 2 * NQ; ++n) {
        group_sum(n, s[n]);
        group_sum(2 * NQ + n, dp[n]);
      }
    }
    // p^T and ds^T in the accumulators: row (key) kw0 + g + 8 (e / 2),
    // column (query) q0 + 8 n + 2 c + (e % 2); masks only where the tile
    // crosses tq or this key group's diagonal
    const bool edge = q0 + QT > tq || (causal && q0 + offset < kw0 + 15);
#pragma unroll
    for (int n = 0; n < 2 * NQ; ++n) {
      const int col = 8 * n + 2 * c;  // in the tile
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
      const float2 d2 = *reinterpret_cast<const float2*>(Lt + QT + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], LOG2E, -(e % 2 ? l2.y : l2.x) * LOG2E));
        if (edge) {
          const int qi = q0 + col + (e % 2);
          const int ki = kw0 + g + 8 * (e / 2);
          if (qi >= tq || (causal && qi + offset < ki)) p = 0.f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - (e % 2 ? d2.y : d2.x));
      }
    }
    // dv += p^T dO, dk += ds^T qs over this warp's columns: B by
    // ldmatrix.trans of the same rows
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t pa[4], dsa[4];
      pack_a(pa, s[2 * j], s[2 * j + 1]);
      pack_a(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        uint32_t bd[4], bq[4];
        load_b<LD>(bd, dOp + 16 * j * LD, np, lane);
        load_b<LD>(bq, Qp + 16 * j * LD, np, lane);
        mma_bf16(dva[2 * np], pa, bd[0], bd[1]);
        mma_bf16(dva[2 * np + 1], pa, bd[2], bd[3]);
        mma_bf16(dka[2 * np], dsa, bq[0], bq[1]);
        mma_bf16(dka[2 * np + 1], dsa, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // dk and dv staged through this warp's rows and columns of K and V
  const auto same = [](float x, int) { return x; };
  store_warp_rows<DW, LD, D>(dk + (size_t)b * tk * D + part * DW, Kw, dka, same, kw0, tk, lane);
  store_warp_rows<DW, LD, D>(dv + (size_t)b * tk * D + part * DW, Vw, dva, same, kw0, tk, lane);
}

template <int D>
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int bh, int tq,
                    int tk, int causal, float q_scale, cudaStream_t stream) {
  using Tl = WideDkvTiles<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel_wide<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (tk + Tl::BKB - 1) / Tl::BKB;
  flash_dkv_kernel_wide<D><<<bh * n_ktiles, Tl::NT, Tl::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      bh, tq, tk, causal, q_scale);
  return (int)cudaGetLastError();
}

// ------------------------------------ the f32 kernels at heads <= 128

// flash_dq_kernel_tf32x3 and flash_dkv_kernel_tf32x3: the bf16 kernels'
// structure in f32, the scores in the forward's order on the CUDA cores
// (score_chain, flash_common.cuh) and every other product on the tensor
// cores in 3xTF32. A block owns ROWS = 128 rows (query rows in flash_dq,
// keys in flash_dkv), 16 a warp, resident in shared memory; the other
// axis comes through a cp.async ring of T-row tiles. f32 rows are twice
// bf16's bytes, so at d = 128 the tiles are 32 rows in two stages, at
// d = 64 64 rows in three; each warp stages its 16 x NS scores of a step
// (40 words a row): 190-219 KB, one block an SM.
template <int D>
struct Tf32Tiles {
  static constexpr int ROWS = 128;              // query rows or keys a block
  static constexpr int NT = ROWS * 2;           // 8 warps
  static constexpr int T = D == 64 ? 64 : 32;   // rows a ring tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int NS_DQ = 32;              // keys a flash_dq step
  static constexpr int NS_DKV = D == 64 ? 32 : 16;  // queries a flash_dkv step
  // f32 row stride in words: 4 (mod 32), so that ldmatrix, the score
  // chains' reads and the permuted scalar reads of B (load_b_perm_tf32)
  // are free of conflicts
  static constexpr int LD = D + 4;
  // the resident rows (two matrices), then STAGES tiles of two
  static constexpr size_t rows_bytes = sizeof(float) * (size_t)(2 * ROWS + 2 * STAGES * T) * LD;
  // flash_dq: then each warp's scores of a step
  static constexpr size_t dq_bytes = rows_bytes + sizeof(float) * ROWS * score_stride(NS_DQ);
  // flash_dkv: then STAGES tiles of lse and of delta, then each warp's
  // scores of a step
  static constexpr size_t ls_bytes = sizeof(float) * 2 * STAGES * T;
  static constexpr size_t dkv_bytes =
      rows_bytes + ls_bytes + sizeof(float) * ROWS * score_stride(NS_DKV);
  static_assert(D == 64 || D == 128, "the 3xTF32 kernels take heads of 64 and 128");
  static_assert(dq_bytes <= SMEM_LIMIT && dkv_bytes <= SMEM_LIMIT,
                "3xTF32 layout exceeds shared memory");
};

// flash_dq in f32: a warp owns 16 query rows (qs and dO resident, read by
// ldmatrix at each step and split as read); steps of NS = 32 keys: S = qs
// K^T in the forward's order on the CUDA cores (each lane a 4 x 4 tile of
// chains, staged through the warp's rows of Ss into the accumulator
// layout) and dP = dO V^T in 3xTF32 (B by ldmatrix of the V stage), ds
// in the S accumulators, then dq += ds K with ds's accumulators as A
// fragments (c_to_a_tf32) and K's rows read in the same permuted order. Each
// 8-column tile of dq sums a step in a zeroed partial that is then added
// to the f32 accumulator with one rounded add: the tensor cores'
// accumulation is not rounded to nearest, and a chain of mma.sync over
// the whole sequence would carry that error along.
template <int D>
__global__ void __launch_bounds__(Tf32Tiles<D>::NT, 1)
flash_dq_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ o,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ dq, int bh, int tq,
                       int tk, int n_qtiles, int causal, float q_scale, float scale) {
  using Tl = Tf32Tiles<D>;
  constexpr int BQ = Tl::ROWS, NT = Tl::NT, TK = Tl::T, STAGES = Tl::STAGES, LD = Tl::LD;
  constexpr int NS = Tl::NS_DQ, LS = score_stride(NS);  // keys a step; a score row's stride
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;           // STAGES tiles of TK rows
  float* Vs = Ks + STAGES * TK * LD;   // STAGES tiles of TK rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  // the q-tiles with the most key tiles (the last ones, under the causal
  // mask) first
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);
  const int b = blockIdx.x % bh;
  const int q0 = qt * BQ;
  const int r0 = q0 + 16 * warp;  // this warp's first query row
  const int offset = tk - tq;
  const float* kb = k + (size_t)b * tk * D;
  const float* vb = v + (size_t)b * tk * D;
  float* Qw = Qs + 16 * warp * LD;  // this warp's rows: q, later its dq
  float* dOw = dOs + 16 * warp * LD;
  float* Sw = reinterpret_cast<float*>(smem + Tl::rows_bytes) + 16 * warp * LS;  // its scores

  // this warp's q and dO rows: copy group 0
  load_warp_rows<D, LD>(Qw, q + (size_t)b * tq * D, r0, tq, lane);
  load_warp_rows<D, LD>(dOw, dout + (size_t)b * tq * D, r0, tq, lane);
  cp_async_commit();

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_kt = k_end > 0 ? (k_end + TK - 1) / TK : 0;

  auto load_kv = [&](int kt) {  // key tile kt (zeros past tk) into stage kt % STAGES
    const int st = kt % STAGES;
    load_tile_pair<D, LD, TK, NT>(Ks + st * TK * LD, Vs + st * TK * LD, kb, vb, kt * TK, tk);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_kv(s);
    cp_async_commit();
  }

  float lse_r[2];  // lse of rows g and g + 8; zeros past tq
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    lse_r[h] = row < tq ? lse[(size_t)b * tq + row] : 0.f;
  }

  cp_async_wait<STAGES - 1>();  // group 0 (this lane's copies) landed:
  scale_rows_f32<D, LD, 16, 32>(Qw, q_scale, lane);  // pre-scale them
  __syncwarp();                 // ... and every lane's

  // delta = rowsum(dO O) in f32: lanes l and l + 16 sum the two halves of
  // row r0 + l % 16 (O read once from device memory; zero past tq),
  // written once per row for flash_dkv; then rows g and g + 8
  float part = 0.f;
  if (r0 + lane % 16 < tq) {
    const int r = lane % 16, c0 = (lane / 16) * (D / 2);
    const float* orow = o + ((size_t)b * tq + r0 + r) * D + c0;
#pragma unroll 4
    for (int i = 0; i < D / 2; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(orow + i);
      const float4 y = *reinterpret_cast<const float4*>(dOw + r * LD + c0 + i);
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
      part = fmaf(x.z, y.z, part);
      part = fmaf(x.w, y.w, part);
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 16);
  if (lane < 16 && r0 + lane < tq) delta[(size_t)b * tq + r0 + lane] = part;
  const float dlt[2] = {__shfl_sync(0xffffffffu, part, g), __shfl_sync(0xffffffffu, part, g + 8)};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose stage the next copy refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_kt) load_kv(kt + STAGES - 1);
    cp_async_commit();
    if (r0 >= tq) continue;  // this warp's rows are all past tq

#pragma unroll 1
    for (int j = 0; j < TK / NS; ++j) {  // keys kc0 .. kc0 + NS - 1
      const int kc0 = kt * TK + NS * j;
      // wholly above this warp's diagonal, or past tk: p = 0 throughout
      if (kc0 >= tk || (causal && kc0 > r0 + 15 + offset)) continue;
      const float* Kt = Ks + (kt % STAGES) * TK * LD + NS * j * LD;
      const float* Vt = Vs + (kt % STAGES) * TK * LD + NS * j * LD;
      // S in the forward's order, through this warp's rows of Ss (whose
      // last scores every lane has read)
      __syncwarp();
      score_chain<D, LD, 4, NS / 8, LS>(Sw, Qw, Kt, lane);
      float s[NS / 8][4], dp[NS / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA da;
        load_a_tf32<LD>(da, dOw, kk, lane);
#pragma unroll
        for (int jj = 0; jj < NS / 16; ++jj) {
          FragB bv[2];
          load_bt_tf32<LD>(bv, Vt, jj, kk, lane);
          mma_tf32x3(dp[2 * jj], da, bv[0]);
          mma_tf32x3(dp[2 * jj + 1], da, bv[1]);
        }
      }
      __syncwarp();
      gather_scores<NS / 8, LS>(s, Sw, lane);
      // ds = p (dP - delta); masks only where the step crosses tk or this
      // warp's diagonal
      const bool edge = kc0 + NS > tk || (causal && kc0 + NS - 1 > r0 + offset);
      FragA dsa[NS / 8];
#pragma unroll
      for (int n = 0; n < NS / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(s[n][e] - lse_r[e / 2]);
          if (edge) {
            const int col = kc0 + 8 * n + 2 * c + (e % 2);
            const int row = r0 + g + 8 * (e / 2);
            if (col >= tk || (causal && row + offset < col)) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - dlt[e / 2]);
        }
        c_to_a_tf32(dsa[n], s[n]);
      }
      // dq += ds K, one 8-column tile of dq at a time: B of K's rows in
      // c_to_a_tf32's order, summed over the step in a zeroed partial
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        float part_dq[4] = {};
#pragma unroll
        for (int n = 0; n < NS / 8; ++n) {
          FragB bk;
          load_b_perm_tf32<LD>(bk, Kt + 8 * n * LD, 8 * nd, lane);
          mma_tf32x3(part_dq, dsa[n], bk);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += part_dq[e];
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // dq times its scale, staged through this warp's rows of q
  store_warp_rows_f32<D, LD>(dq + (size_t)b * tq * D, Qw, acc, scale, r0, tq, lane);
}

template <int D>
int launch_dq_tf32x3(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, int bh, int tq,
                     int tk, int causal, float q_scale, float scale, cudaStream_t stream) {
  using Tl = Tf32Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel_tf32x3<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::dq_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + Tl::ROWS - 1) / Tl::ROWS;
  flash_dq_kernel_tf32x3<D><<<bh * n_qtiles, Tl::NT, Tl::dq_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), bh, tq, tk, n_qtiles, causal, q_scale, scale);
  return (int)cudaGetLastError();
}

// flash_dkv in f32: a warp owns 16 keys (K and V resident, read by
// ldmatrix at each step and split as read) for the whole query loop;
// query tiles (q, dO, lse, delta) through the ring, q pre-scaled in place
// by the thread that copied it; steps of NS queries (32 at d = 64, 16 at
// 128: dk and dv take D f32 registers): S^T = K qs^T in the forward's
// order on the CUDA cores (a lane's 4 x NS / 8 tile of chains, staged
// through the warp's rows of Ss) and dP^T = V dO^T in 3xTF32 (B by
// ldmatrix of the stage), p^T and ds^T in the accumulators (lse
// and delta indexed by the accumulator's column, the query), then dv +=
// p^T dO and dk += ds^T qs with the accumulators as A fragments and the
// stage's rows read in the same permuted order, each 8-column tile summed
// over the step in zeroed partials (as flash_dq's).
template <int D>
__global__ void __launch_bounds__(Tf32Tiles<D>::NT, 1)
flash_dkv_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int bh, int tq, int tk,
                        int causal, float q_scale) {
  using Tl = Tf32Tiles<D>;
  constexpr int BKB = Tl::ROWS, NT = Tl::NT, QT = Tl::T, STAGES = Tl::STAGES, LD = Tl::LD;
  constexpr int NS = Tl::NS_DKV, LS = score_stride(NS);  // queries a step; a score row's stride
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BKB * LD;
  float* Rs = Vs + BKB * LD;  // stage st: qs rows at 2 st QT LD, dO rows QT LD on
  float* Ls = reinterpret_cast<float*>(smem + Tl::rows_bytes);  // stage st: lse, then delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  // the key tiles with the most query tiles (the first ones, under the
  // causal mask) first
  const int k0 = (int)(blockIdx.x / bh) * BKB;
  const int b = blockIdx.x % bh;
  const int kw0 = k0 + 16 * warp;  // this warp's first key row
  const int offset = tk - tq;
  const float* qb = q + (size_t)b * tq * D;
  const float* db = dout + (size_t)b * tq * D;
  float* Kw = Ks + 16 * warp * LD;  // this warp's rows: K, later its dk
  float* Vw = Vs + 16 * warp * LD;  // V, later dv
  float* Sw = reinterpret_cast<float*>(smem + Tl::rows_bytes + Tl::ls_bytes)
              + 16 * warp * LS;  // its scores

  // this warp's K and V rows: copy group 0
  load_warp_rows<D, LD>(Kw, k + (size_t)b * tk * D, kw0, tk, lane);
  load_warp_rows<D, LD>(Vw, v + (size_t)b * tk * D, kw0, tk, lane);
  cp_async_commit();

  // causal: the first query row that sees any key of this block (< tq,
  // since k0 - offset <= tq - 1)
  const int qt0 = (causal ? max(0, k0 - offset) : 0) / QT;
  const int n_qt = (tq + QT - 1) / QT - qt0;

  auto load_q = [&](int t) {  // query tile qt0 + t (zeros past tq) into stage t % STAGES
    const int q0 = (qt0 + t) * QT, st = t % STAGES;
    float* qd = Rs + st * 2 * QT * LD;
    load_tile_pair<D, LD, QT, NT>(qd, qd + QT * LD, qb, db, q0, tq);
    for (int i = threadIdx.x; i < 2 * QT; i += NT) {
      const int r = i % QT;
      const bool in = q0 + r < tq;
      const size_t off = in ? (size_t)b * tq + q0 + r : 0;
      cp_async4(smem_addr(Ls + (2 * st + i / QT) * QT + r), (i < QT ? lse : delta) + off,
                in ? 4 : 0);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_qt) load_q(s);
    cp_async_commit();
  }

  cp_async_wait<STAGES - 1>();  // group 0 (this warp's K and V) landed
  __syncwarp();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int t = 0; t < n_qt; ++t) {
    const int st = t % STAGES;
    float* Qt = Rs + st * 2 * QT * LD;
    const float* dOt = Qt + QT * LD;
    const float* Lt = Ls + 2 * st * QT;  // lse, then delta
    // tile t has landed for this thread: pre-scale the q chunks it copied
    cp_async_wait<STAGES - 2>();
    scale_rows_f32<D, LD, QT, NT>(Qt, q_scale, threadIdx.x);
    // every thread's share of tile t is in place, and every warp is done
    // with tile t - 1, whose stage the next copy refills
    __syncthreads();
    if (t + STAGES - 1 < n_qt) load_q(t + STAGES - 1);
    cp_async_commit();

    const int q0 = (qt0 + t) * QT;
    if (kw0 >= tk) continue;  // this warp's keys are all past tk
#pragma unroll 1
    for (int j = 0; j < QT / NS; ++j) {  // queries qc0 .. qc0 + NS - 1
      const int qc0 = q0 + NS * j;
      // past tq, or wholly below this warp's keys under the mask: p = 0
      if (qc0 >= tq || (causal && qc0 + NS - 1 + offset < kw0)) continue;
      const float* Qj = Qt + NS * j * LD;
      const float* dOj = dOt + NS * j * LD;
      // S^T in the forward's order, through this warp's rows of Ss (whose
      // last scores every lane has read)
      __syncwarp();
      score_chain<D, LD, 4, NS / 8, LS>(Sw, Kw, Qj, lane);
      float s[NS / 8][4], dp[NS / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA va;
        load_a_tf32<LD>(va, Vw, kk, lane);
#pragma unroll
        for (int jj = 0; jj < NS / 16; ++jj) {
          FragB bd[2];
          load_bt_tf32<LD>(bd, dOj, jj, kk, lane);
          mma_tf32x3(dp[2 * jj], va, bd[0]);
          mma_tf32x3(dp[2 * jj + 1], va, bd[1]);
        }
      }
      __syncwarp();
      gather_scores<NS / 8, LS>(s, Sw, lane);
      // p^T and ds^T in the accumulators: row (key) kw0 + g + 8 (e / 2),
      // column (query) qc0 + 8 n + 2 c + (e % 2); masks only where the
      // step crosses tq or this warp's diagonal
      const bool edge = qc0 + NS > tq || (causal && qc0 + offset < kw0 + 15);
      FragA pa[NS / 8], dsa[NS / 8];
#pragma unroll
      for (int n = 0; n < NS / 8; ++n) {
        const int col = NS * j + 8 * n + 2 * c;  // in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(Lt + QT + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(s[n][e] - (e % 2 ? l2.y : l2.x));
          if (edge) {
            const int qi = q0 + col + (e % 2);
            const int ki = kw0 + g + 8 * (e / 2);
            if (qi >= tq || (causal && qi + offset < ki)) p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - (e % 2 ? d2.y : d2.x));
        }
        c_to_a_tf32(pa[n], s[n]);
        c_to_a_tf32(dsa[n], dp[n]);
      }
      // dv += p^T dO, dk += ds^T qs, one 8-column tile at a time: B of the
      // stage's rows in c_to_a_tf32's order, summed over the step in
      // zeroed partials
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        float part_dv[4] = {}, part_dk[4] = {};
#pragma unroll
        for (int n = 0; n < NS / 8; ++n) {
          FragB bd, bq;
          load_b_perm_tf32<LD>(bd, dOj + 8 * n * LD, 8 * nd, lane);
          load_b_perm_tf32<LD>(bq, Qj + 8 * n * LD, 8 * nd, lane);
          mma_tf32x3(part_dv, pa[n], bd);
          mma_tf32x3(part_dk, dsa[n], bq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[nd][e] += part_dv[e];
          dka[nd][e] += part_dk[e];
        }
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // dk and dv staged through this warp's rows of K and V
  store_warp_rows_f32<D, LD>(dk + (size_t)b * tk * D, Kw, dka, 1.f, kw0, tk, lane);
  store_warp_rows_f32<D, LD>(dv + (size_t)b * tk * D, Vw, dva, 1.f, kw0, tk, lane);
}

template <int D>
int launch_dkv_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int bh, int tq,
                      int tk, int causal, float q_scale, cudaStream_t stream) {
  using Tl = Tf32Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel_tf32x3<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (tk + Tl::ROWS - 1) / Tl::ROWS;
  flash_dkv_kernel_tf32x3<D><<<bh * n_ktiles, Tl::NT, Tl::dkv_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), bh, tq, tk, causal, q_scale);
  return (int)cudaGetLastError();
}

// ------------------------- the f32 kernels at heads 256, 512 and 1024

// flash_dq_kernel_wide_tf32x3 and flash_dkv_kernel_wide_tf32x3: the wide
// bf16 kernels' structure (warps that share rows split the head's
// columns) in f32. 8 warps a block; a row group (dq: 16 query rows) or
// key group (dkv: 16 keys) has WP = D / 128 warps, each owning DW = 128
// of the head's columns of dq, or of dk and dv (64 or 128 accumulator
// registers). 128 rows of f32 would not fit shared memory at 256 (266
// KB), so a block holds 64 resident rows at 256, 32 at 512 and 16 at
// 1024 (two matrices, 130 KB), and the ring's tiles are 16 rows at 256
// and 8 at 512 and 1024, in two stages. The scores are score_chain's
// (the forward's order), each chaining lane an RB x CB tile of chains
// (chain_columns, flash_common.cuh): 2 x 2 on both warps of a group at
// 256, 1 x 1 on its four at 512.
//
// At 1024 the resident rows are 16 (131 KB), and two stages of whole
// ring tiles of two matrices would not fit beside them (8 rows: 131 KB),
// so the ring (CH) brings 256-column chunks (CK, one chain's columns) of
// T = 32 rows in CS = 2 stages (67 KB), and a tile of the other axis
// takes 3 NCH steps: the chunks of its scores' operand (dq: K; dkv: q,
// each pre-scaled by the thread that copied it), on which four warps
// chain the scores, each lane 2 x 2 of them, quarter j at step j from 0
// and the quarters' sums added in order (score_chain_cols); then
// the chunks of dP's operand (dq: V; dkv: dO), on which every warp sums
// its partial of dP over its PW = 32 columns of the chunk (dkv: and adds
// p^T dO to its columns of dv there); then the first operand's chunks
// again, on which every warp adds ds K (dq) or ds^T qs (dk) to its
// columns of the chunk. A warp owns PW columns of each chunk (NP = NCH
// pieces) of dq, or of dk and dv, so all eight work at every step.
template <int D>
struct WideTf32Tiles {
  static constexpr bool CH = D == 1024;       // the ring in chunks
  static constexpr int WP = D / 128;          // warps to a row or key group
  static constexpr int DW = 128;              // head columns a warp
  static constexpr int NT = 256;              // 8 warps
  static constexpr int ROWS = 16 * (8 / WP);  // resident rows a block: 64, 32, 16
  // rows a ring tile: keys (dq), queries (dkv)
  static constexpr int T = WP == 2 ? 16 : WP == 4 ? 8 : 32;
  static constexpr int NT8 = T / 8;           // 8-row tiles in it
  static constexpr int STAGES = 2;            // whole tiles in the ring; of lse and delta
  static constexpr int KC = 4;  // depth steps of 8 columns a zeroed partial of dP sums
  static constexpr int LD = D + 4;  // f32 row stride in words: 4 (mod 32), as Tf32Tiles'
  // the scores: each chaining lane an RB x CB tile, CW chaining warps a
  // group, warp `part` taking rows 4 RB (part % RH) .. and keys 8 CB (part
  // / RH) .., staged with stride LS
  static constexpr int RB = WP == 4 ? 1 : 2, CB = RB;
  static constexpr int CW = 16 * T / (32 * RB * CB), RH = 16 / (4 * RB);
  static constexpr int LS = score_stride(T);
  // CH: chunks of CK columns (a chain's), NCH a row, CS of them in the
  // ring, PW columns of each a warp's; steps a tile
  static constexpr int CK = score_chain_cols(D), NCH = D / CK, LDC = CK + 4;
  static constexpr int CS = 2, PW = CK / 8, STEPS = CH ? 3 * NCH : 1;
  // a warp's columns of dq, dk and dv in NP pieces of PWV (CH: one a chunk)
  static constexpr int NP = CH ? NCH : 1, PWV = DW / NP;
  // the resident rows (two matrices), then STAGES whole tiles of two (CH:
  // CS chunks)
  static constexpr size_t ring_floats =
      CH ? (size_t)CS * T * LDC : (size_t)2 * STAGES * T * LD;
  static constexpr size_t rows_bytes = sizeof(float) * ((size_t)2 * ROWS * LD + ring_floats);
  // then each group's 16 x T scores and each thread's partial dP
  static constexpr size_t s_bytes = sizeof(float) * (size_t)ROWS * LS;
  static constexpr size_t dq_bytes = rows_bytes + s_bytes + sizeof(float4) * NT * NT8;
  // flash_dkv: then STAGES tiles of lse and of delta
  static constexpr size_t dkv_bytes = dq_bytes + sizeof(float) * 2 * STAGES * T;
  static_assert(D == 256 || D == 512 || D == 1024,
                "the wide 3xTF32 kernels take heads of 256, 512 and 1024");
  static_assert(CW <= WP && CW * 32 * RB * CB == 16 * T && (CW - 1) / RH * 8 * CB < T,
                "every score of a group once");
  static_assert(!CH || (WP == 8 && PW == PWV && PW * 8 == CK && CS >= 2),
                "CH: one group of 8 warps, each owning a piece of every chunk");
  static_assert(dkv_bytes <= SMEM_LIMIT, "wide 3xTF32 layout exceeds shared memory");
};

// x = a b^T over DW head columns in 3xTF32: a a warp's 16 rows (A by
// ldmatrix, split as read; leading dimension LDA), b the 8 NT8 rows of
// the tile (B by ldmatrix, LDB, two 8-row tiles at a time; at NT8 = 1
// one ldmatrix serves two depth steps). Each KC depth steps sum in a
// zeroed partial, added to x with rounded adds (to x as it was, with
// ZERO false).
template <int LDA, int LDB, int DW, int NT8, int KC, bool ZERO = true>
__device__ __forceinline__ void product_tf32x3(float (&x)[NT8][4], const float* a,
                                               const float* b, int lane) {
  if constexpr (ZERO) {
#pragma unroll
    for (int n = 0; n < NT8; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
  }
#pragma unroll
  for (int k0 = 0; k0 < DW / 8; k0 += KC) {
    float part[NT8][4] = {};
#pragma unroll
    for (int kk = k0; kk < k0 + KC; kk += 2) {
      FragA fa[2];
      load_a_tf32<LDA>(fa[0], a, kk, lane);
      load_a_tf32<LDA>(fa[1], a, kk + 1, lane);
      if constexpr (NT8 % 2 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int jj = 0; jj < NT8 / 2; ++jj) {
            FragB fb[2];
            load_bt_tf32<LDB>(fb, b, jj, kk + h, lane);
            mma_tf32x3(part[2 * jj], fa[h], fb[0]);
            mma_tf32x3(part[2 * jj + 1], fa[h], fb[1]);
          }
        }
      } else {
        FragB fb[2];
        load_bt8_tf32<LDB>(fb, b, kk, lane);
        mma_tf32x3(part[0], fa[0], fb[0]);
        mma_tf32x3(part[0], fa[1], fb[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] += part[n][e];
    }
  }
}

// The group's WP partials of dP (X, one float4 per 8-row tile and thread,
// warp-major), after the group's barrier, summed in the order of the
// warps, so that every warp of the group holds the same dP (accumulator
// layout: rows g, g + 8, columns 8 n + 2 c, + 1).
template <int NT8, int WP>
__device__ __forceinline__ void sum_partials(float (&dp)[NT8][4], const float4* X, int group,
                                             int lane) {
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    float4 y = X[(group * WP * NT8 + n) * 32 + lane];
#pragma unroll
    for (int i = 1; i < WP; ++i) {
      const float4 z = X[((group * WP + i) * NT8 + n) * 32 + lane];
      y.x += z.x, y.y += z.y, y.z += z.z, y.w += z.w;
    }
    dp[n][0] = y.x, dp[n][1] = y.y, dp[n][2] = y.z, dp[n][3] = y.w;
  }
}

// The q pre-scale in place of a ring chunk at 1024 (CH): the walk of
// load_tile<.., C, LD, ROWS, NT> by thread tid (the 16-byte pieces it
// copied), all its loads first, then the products (one rounding each)
// and the stores. Call it once this thread's copies have landed.
template <int C, int LD, int ROWS, int NT>
__device__ __forceinline__ void scale_chunk_f32(float* rows, float scale, int tid) {
  constexpr int CH = C / 4, N = ROWS * CH / NT;
  static_assert(ROWS * CH % NT == 0, "every thread the same number of pieces");
  float4 x[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = tid + it * NT;
    x[it] = *reinterpret_cast<const float4*>(rows + (i / CH) * LD + (i % CH) * 4);
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = tid + it * NT;
    x[it].x *= scale, x[it].y *= scale, x[it].z *= scale, x[it].w *= scale;
    *reinterpret_cast<float4*>(rows + (i / CH) * LD + (i % CH) * 4) = x[it];
  }
}

// Chunk j of a chaining lane's RB x CB scores at 1024 (CH): one chain a
// score over the chunk's CK columns (rows a, leading dimension LDA;
// rows b, LDB) from 0, added to the sums of the earlier chunks in order
// (((c0 + c1) + c2) + c3, score_chain_cols: the f32 forward's bits);
// after the last chunk the scores go to Sc (leading dimension LS).
template <int CK, int NCH, int LDA, int LDB, int RB, int CB, int LS>
__device__ __forceinline__ void chain_chunk(float (&cs)[RB][CB], float* Sc, const float* a,
                                            const float* b, int j, int lane) {
  float cc[RB][CB] = {};
  chain_columns<CK, LDA, LDB, RB, CB>(cc, a, b, lane);
#pragma unroll
  for (int x = 0; x < RB; ++x) {
#pragma unroll
    for (int y = 0; y < CB; ++y) cs[x][y] = j == 0 ? cc[x][y] : cs[x][y] + cc[x][y];
  }
  if (j == NCH - 1) store_scores<RB, CB, LS>(Sc, cs, lane);
}

// x += a b in 3xTF32 over N columns: a the NT8 16 x 8 accumulator tiles
// of ds, or of p^T, each taken as an A fragment (c_to_a_tf32: the depth
// permuted) as it is used, b the 8 NT8 rows of the product's depth
// (leading dimension LDB) read in that order (load_b_perm_tf32), each
// 8-column tile of x summed over the depth in a zeroed partial added
// with one rounded add. The 8-row steps are outer, so that consecutive
// mma.sync go to different partials.
template <int LDB, int N, int NT8>
__device__ __forceinline__ void add_product_tf32x3(float (&x)[N / 8][4], const float (&a)[NT8][4],
                                                   const float* b, int lane) {
  float part[N / 8][4] = {};
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    FragA fa;
    c_to_a_tf32(fa, a[n]);
#pragma unroll
    for (int nd = 0; nd < N / 8; ++nd) {
      FragB fb;
      load_b_perm_tf32<LDB>(fb, b + 8 * n * LDB, 8 * nd, lane);
      mma_tf32x3(part[nd], fa, fb);
    }
  }
#pragma unroll
  for (int nd = 0; nd < N / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nd][e] += part[nd][e];
  }
}

// flash_dq at f32 heads of 256, 512 and 1024: a row group of 16 query
// rows, its qs and dO resident; per key tile (TK keys) S on the CUDA
// cores in the forward's order (its CW chaining warps), each warp's dP
// over its columns in 3xTF32, the exchange, ds in the accumulators, then
// dq += ds K over the warp's columns with ds's accumulators as A
// fragments (c_to_a_tf32) and K's rows in the same permuted order, each
// 8-column tile of dq summed over the tile in a zeroed partial added with
// one rounded add. At 1024 the tile comes in STEPS chunks (K's, V's, K's
// again: WideTf32Tiles).
template <int D>
__global__ void __launch_bounds__(WideTf32Tiles<D>::NT, 1)
flash_dq_kernel_wide_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ o,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            float* __restrict__ delta, float* __restrict__ dq, int bh, int tq,
                            int tk, int n_qtiles, int causal, float q_scale, float scale) {
  using Tl = WideTf32Tiles<D>;
  constexpr int BQ = Tl::ROWS, TK = Tl::T, NT8 = Tl::NT8, WP = Tl::WP, DW = Tl::DW;
  constexpr int NT = Tl::NT, LD = Tl::LD, STAGES = Tl::STAGES, LS = Tl::LS;
  constexpr int RB = Tl::RB, CB = Tl::CB, RH = Tl::RH;
  constexpr int CK = Tl::CK, NCH = Tl::NCH, LDC = Tl::LDC, CS = Tl::CS, PW = Tl::PW;
  constexpr int NP = Tl::NP, PWV = Tl::PWV, STEPS = Tl::STEPS;
  // steps a copy is issued ahead
  constexpr int AHEAD = Tl::CH ? CS - 1 : STAGES - 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;           // STAGES tiles of TK rows (CH: CS chunks)
  float* Vs = Ks + STAGES * TK * LD;   // STAGES tiles of TK rows
  float* Ss = reinterpret_cast<float*>(smem + Tl::rows_bytes);  // each row group's scores
  float4* X = reinterpret_cast<float4*>(smem + Tl::rows_bytes + Tl::s_bytes);  // partial dP

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int rg = warp / WP, part = warp % WP;  // row group, share of the columns
  // the q-tiles with the most key tiles (the last ones, under the causal
  // mask) first
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);
  const int b = blockIdx.x % bh;
  const int q0 = qt * BQ;
  const int r0 = q0 + 16 * rg;  // this row group's first query row
  const int offset = tk - tq;
  const float* kb = k + (size_t)b * tk * D;
  const float* vb = v + (size_t)b * tk * D;
  const float* dOg = dOs + 16 * rg * LD;  // the row group's rows of dO
  float* St = Ss + 16 * rg * LS;          // and of the scores
  // the first column of this warp's piece i of dq (CH: in chunk i)
  auto dq_col = [&](int i) { return Tl::CH ? i * CK + part * PW : part * DW; };
  // the scores this warp chains (if part < CW): its rows of qs and of
  // the scores, and its first key of the tile
  const int h_row = 4 * RB * (part % RH), h_key = 8 * CB * (part / RH);
  const float* Qc = Qs + (16 * rg + h_row) * LD;
  float* Sc = St + h_row * LS + h_key;

  // the block's q and dO rows (zeros past tq): copy group 0
  load_tile_pair<D, LD, BQ, NT>(Qs, dOs, q + (size_t)b * tq * D, dout + (size_t)b * tq * D,
                                q0, tq);
  cp_async_commit();

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_kt = k_end > 0 ? (k_end + TK - 1) / TK : 0;
  const int n_steps = n_kt * STEPS;

  // step u (zeros past tk): key tile u into stage u % STAGES, or (CH)
  // step j of key tile u / STEPS into chunk stage u % CS: K's columns j CK
  // .. (j < NCH), V's (j - NCH) CK .. (j < 2 NCH), K's (j - 2 NCH) CK ..
  auto load_step = [&](int u) {
    if constexpr (Tl::CH) {
      const int kt = u / STEPS, j = u % STEPS;
      load_tile<D, CK, LDC, TK, NT>(Ks + (u % CS) * TK * LDC, j / NCH == 1 ? vb : kb, kt * TK,
                                    tk, (j % NCH) * CK);
    } else {
      const int st = u % STAGES;
      load_tile_pair<D, LD, TK, NT>(Ks + st * TK * LD, Vs + st * TK * LD, kb, vb, u * TK, tk);
    }
  };
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }

  float lse_r[2];  // lse of rows g and g + 8; zeros past tq
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    lse_r[h] = row < tq ? lse[(size_t)b * tq + row] : 0.f;
  }

  // q scaled in place (each thread the chunks it copied, once group 0
  // landed), then the block's barrier: the rows are read at every tile
  cp_async_wait<AHEAD>();
  scale_rows_f32<D, LD, BQ, NT>(Qs, q_scale, threadIdx.x);
  __syncthreads();

  // delta = rowsum(dO O) in f32 over the whole head (every warp of a
  // group sums it alike): lanes l and l + 16 sum the two halves of row
  // r0 + l % 16 (O read once a warp from device memory; zero past tq),
  // written once per row for flash_dkv; then rows g and g + 8
  float dsum = 0.f;
  if (r0 + lane % 16 < tq) {
    const int r = lane % 16, c0 = (lane / 16) * (D / 2);
    const float* orow = o + ((size_t)b * tq + r0 + r) * D + c0;
    const float* drow = dOg + r * LD + c0;
#pragma unroll 4
    for (int i = 0; i < D / 2; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(orow + i);
      const float4 y = *reinterpret_cast<const float4*>(drow + i);
      dsum = fmaf(x.x, y.x, dsum);
      dsum = fmaf(x.y, y.y, dsum);
      dsum = fmaf(x.z, y.z, dsum);
      dsum = fmaf(x.w, y.w, dsum);
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 16);
  if (part == 0 && lane < 16 && r0 + lane < tq) delta[(size_t)b * tq + r0 + lane] = dsum;
  const float dlt[2] = {__shfl_sync(0xffffffffu, dsum, g), __shfl_sync(0xffffffffu, dsum, g + 8)};

  float acc[NP][PWV / 8][4];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int n = 0; n < PWV / 8; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  }

  // once the tile's scores are in St and this warp's partial of dP in dp:
  // the exchange, then ds = p (dP - delta) in dp (masks only where the
  // tile crosses tk or this row group's diagonal)
  auto tile_ds = [&](float (&dp)[NT8][4], int kc0) {
#pragma unroll
    for (int n = 0; n < NT8; ++n)
      X[(warp * NT8 + n) * 32 + lane] = make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
    bar_sync(1 + rg, 32 * WP);
    float s[NT8][4];
    gather_scores<NT8, LS>(s, St, lane);
    sum_partials<NT8, WP>(dp, X, rg, lane);
    const bool edge = kc0 + TK > tk || (causal && kc0 + TK - 1 > r0 + offset);
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[n][e] - lse_r[e / 2]);
        if (edge) {
          const int col = kc0 + 8 * n + 2 * c + (e % 2);
          const int row = r0 + g + 8 * (e / 2);
          if (col >= tk || (causal && row + offset < col)) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dlt[e / 2]);
      }
    }
  };

  if constexpr (!Tl::CH) {
    for (int kt = 0; kt < n_kt; ++kt) {
      // tile kt has landed for every thread, every warp is done with tile
      // kt - 1 (whose stage the next copy refills) and with its group's
      // scores and partials of tile kt - 1
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (kt + STAGES - 1 < n_kt) load_step(kt + STAGES - 1);
      cp_async_commit();
      if (r0 >= tq) continue;  // this row group's rows are all past tq

      // keys kc0 .. kc0 + TK - 1 (kc0 < tk): wholly above this row group's
      // diagonal, p = 0 throughout
      const int kc0 = kt * TK;
      if (causal && kc0 > r0 + 15 + offset) continue;
      const float* Kt = Ks + (kt % STAGES) * TK * LD;
      const float* Vt = Vs + (kt % STAGES) * TK * LD;
      if (part < Tl::CW) score_chain<D, LD, RB, CB, LS>(Sc, Qc, Kt + h_key * LD, lane);
      float dp[NT8][4];
      product_tf32x3<LD, LD, DW, NT8, Tl::KC>(dp, dOg + part * DW, Vt + part * DW, lane);
      tile_ds(dp, kc0);
      // dq += ds K over this warp's columns: B of K's rows in
      // c_to_a_tf32's order, each 8-column tile summed over the tile in a
      // zeroed partial
      FragA dsa[NT8];
#pragma unroll
      for (int n = 0; n < NT8; ++n) c_to_a_tf32(dsa[n], dp[n]);
#pragma unroll
      for (int nd = 0; nd < DW / 8; ++nd) {
        float part_dq[4] = {};
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          FragB bk;
          load_b_perm_tf32<LD>(bk, Kt + 8 * n * LD + part * DW, 8 * nd, lane);
          mma_tf32x3(part_dq, dsa[n], bk);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nd][e] += part_dq[e];
      }
    }
  } else {
    // this lane's scores (a chaining warp's), this warp's partial of dP
    // (then ds)
    float cs[RB][CB] = {}, dp[NT8][4] = {};
    for (int kt = 0; kt < n_kt; ++kt) {
      const int kc0 = kt * TK;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int u = kt * STEPS + j;
        // step u has landed for every thread, and every warp is done with
        // step u - 1, whose stage the next copy refills
        cp_async_wait<CS - 2>();
        __syncthreads();
        if (u + CS - 1 < n_steps) load_step(u + CS - 1);
        cp_async_commit();
        if (r0 >= tq || (causal && kc0 > r0 + 15 + offset)) continue;
        const float* C = Ks + (u % CS) * TK * LDC;  // the step's chunk
        if (j < NCH) {  // K's chunk j: the scores
          if (part < Tl::CW)
            chain_chunk<CK, NCH, LD, LDC, RB, CB, LS>(cs, Sc, Qc + j * CK, C + h_key * LDC, j,
                                                      lane);
        } else if (j < 2 * NCH) {  // V's chunk jv: this warp's partial of dP
          const int jv = j - NCH;
          if (jv == 0) {
            product_tf32x3<LD, LDC, PW, NT8, Tl::KC>(dp, dOg + part * PW, C + part * PW, lane);
          } else {
            product_tf32x3<LD, LDC, PW, NT8, Tl::KC, false>(dp, dOg + jv * CK + part * PW,
                                                            C + part * PW, lane);
          }
          if (jv == NCH - 1) tile_ds(dp, kc0);
        } else {  // K's chunk jk again: dq += ds K over this warp's columns of it
          add_product_tf32x3<LDC, PW, NT8>(acc[j - 2 * NCH], dp, C + part * PW, lane);
        }
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // dq times its scale, staged through this warp's rows and columns of qs
  // (after the group's last barrier no warp reads them)
#pragma unroll
  for (int i = 0; i < NP; ++i)
    store_warp_rows_f32<PWV, LD, D>(dq + (size_t)b * tq * D + dq_col(i),
                                    Qs + 16 * rg * LD + dq_col(i), acc[i], scale, r0, tq, lane);
}

template <int D>
int launch_dq_wide_tf32x3(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, void* dq, int bh,
                          int tq, int tk, int causal, float q_scale, float scale,
                          cudaStream_t stream) {
  using Tl = WideTf32Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel_wide_tf32x3<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::dq_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + Tl::ROWS - 1) / Tl::ROWS;
  flash_dq_kernel_wide_tf32x3<D><<<bh * n_qtiles, Tl::NT, Tl::dq_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), bh, tq, tk, n_qtiles, causal, q_scale, scale);
  return (int)cudaGetLastError();
}

// flash_dkv at f32 heads of 256, 512 and 1024: a key group of 16 keys, K
// and V of the block resident; query tiles (q, dO, lse, delta) through
// the ring, q pre-scaled in place by the thread that copied it; per tile
// S^T on the CUDA cores in the forward's order (its CW chaining warps: a
// score's chain does not depend on which operand is the row), each warp's
// dP^T = V dO^T over its columns in 3xTF32, the exchange, p^T and ds^T in
// the accumulators, then dv += p^T dO and dk += ds^T qs over the warp's
// columns, each 8-column tile summed over the tile in zeroed partials. At
// 1024 the tile comes in STEPS chunks (q's, dO's, q's again:
// WideTf32Tiles), dv added on each of dO's.
template <int D>
__global__ void __launch_bounds__(WideTf32Tiles<D>::NT, 1)
flash_dkv_kernel_wide_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int bh, int tq,
                             int tk, int causal, float q_scale) {
  using Tl = WideTf32Tiles<D>;
  constexpr int BKB = Tl::ROWS, QT = Tl::T, NT8 = Tl::NT8, WP = Tl::WP, DW = Tl::DW;
  constexpr int NT = Tl::NT, LD = Tl::LD, STAGES = Tl::STAGES, LS = Tl::LS;
  constexpr int RB = Tl::RB, CB = Tl::CB, RH = Tl::RH;
  constexpr int CK = Tl::CK, NCH = Tl::NCH, LDC = Tl::LDC, CS = Tl::CS, PW = Tl::PW;
  constexpr int NP = Tl::NP, PWV = Tl::PWV, STEPS = Tl::STEPS;
  constexpr int AHEAD = Tl::CH ? CS - 1 : STAGES - 1;  // steps a copy is issued ahead
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BKB * LD;
  // the ring: stage st's qs rows at 2 st QT LD, its dO rows QT LD on (CH:
  // CS chunks)
  float* Rs = Vs + BKB * LD;
  float* Ss = reinterpret_cast<float*>(smem + Tl::rows_bytes);  // each key group's scores
  float4* X = reinterpret_cast<float4*>(smem + Tl::rows_bytes + Tl::s_bytes);  // partial dP^T
  float* Ls = reinterpret_cast<float*>(smem + Tl::dq_bytes);  // stage st: lse, then delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int kg = warp / WP, part = warp % WP;  // key group, share of the columns
  // the key tiles with the most query tiles (the first ones, under the
  // causal mask) first
  const int k0 = (int)(blockIdx.x / bh) * BKB;
  const int b = blockIdx.x % bh;
  const int kw0 = k0 + 16 * kg;  // this key group's first key
  const int offset = tk - tq;
  const float* qb = q + (size_t)b * tq * D;
  const float* db = dout + (size_t)b * tq * D;
  float* St = Ss + 16 * kg * LS;
  float* Kg = Ks + 16 * kg * LD;  // the key group's rows of K (later dk) and V (later dv)
  float* Vg = Vs + 16 * kg * LD;
  // the first column of this warp's piece i of dk and of dv (CH: in chunk i)
  auto d_col = [&](int i) { return Tl::CH ? i * CK + part * PW : part * DW; };
  // the scores this warp chains (if part < CW): its rows of K and of the
  // scores, and its first query of the tile
  const int h_row = 4 * RB * (part % RH), h_key = 8 * CB * (part / RH);
  const float* Kc = Kg + h_row * LD;
  float* Sc = St + h_row * LS + h_key;

  // the block's K and V rows (zeros past tk): copy group 0
  load_tile_pair<D, LD, BKB, NT>(Ks, Vs, k + (size_t)b * tk * D, v + (size_t)b * tk * D, k0,
                                 tk);
  cp_async_commit();

  // causal: the first query row that sees any key of this block (< tq,
  // since k0 - offset <= tq - 1)
  const int qt0 = (causal ? max(0, k0 - offset) : 0) / QT;
  const int n_qt = (tq + QT - 1) / QT - qt0;
  const int n_steps = n_qt * STEPS;

  // lse and delta of query tile qt0 + t (zeros past tq) into stage t % STAGES
  auto load_ld = [&](int t) {
    const int q0 = (qt0 + t) * QT, st = t % STAGES;
    for (int i = threadIdx.x; i < 2 * QT; i += NT) {
      const int r = i % QT;
      const bool in = q0 + r < tq;
      const size_t off = in ? (size_t)b * tq + q0 + r : 0;
      cp_async4(smem_addr(Ls + (2 * st + i / QT) * QT + r), (i < QT ? lse : delta) + off,
                in ? 4 : 0);
    }
  };
  // step u (zeros past tq): query tile u into stage u % STAGES, or (CH)
  // step j of query tile t = u / STEPS into chunk stage u % CS: q's
  // columns j CK .. (j < NCH; at j = 0 with the tile's lse and delta),
  // dO's (j - NCH) CK .. (j < 2 NCH), q's (j - 2 NCH) CK ..
  auto load_step = [&](int u) {
    if constexpr (Tl::CH) {
      const int t = u / STEPS, j = u % STEPS;
      load_tile<D, CK, LDC, QT, NT>(Rs + (u % CS) * QT * LDC, j / NCH == 1 ? db : qb,
                                    (qt0 + t) * QT, tq, (j % NCH) * CK);
      if (j == 0) load_ld(t);
    } else {
      float* qd = Rs + (u % STAGES) * 2 * QT * LD;
      load_tile_pair<D, LD, QT, NT>(qd, qd + QT * LD, qb, db, (qt0 + u) * QT, tq);
      load_ld(u);
    }
  };
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }

  float dka[NP][PWV / 8][4], dva[NP][PWV / 8][4];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int n = 0; n < PWV / 8; ++n) {
      dka[i][n][0] = dka[i][n][1] = dka[i][n][2] = dka[i][n][3] = 0.f;
      dva[i][n][0] = dva[i][n][1] = dva[i][n][2] = dva[i][n][3] = 0.f;
    }
  }

  if constexpr (!Tl::CH) {
    for (int t = 0; t < n_qt; ++t) {
      const int st = t % STAGES;
      float* Qt = Rs + st * 2 * QT * LD;
      const float* dOt = Qt + QT * LD;
      const float* Lt = Ls + 2 * st * QT;  // lse, then delta
      // tile t (and, at t = 0, K and V) has landed for this thread:
      // pre-scale the q chunks it copied
      cp_async_wait<STAGES - 2>();
      scale_rows_f32<D, LD, QT, NT>(Qt, q_scale, threadIdx.x);
      // every thread's share of tile t is in place, and every warp is done
      // with tile t - 1 (whose stage the next copy refills) and with its
      // group's scores and partials of tile t - 1
      __syncthreads();
      if (t + STAGES - 1 < n_qt) load_step(t + STAGES - 1);
      cp_async_commit();

      // queries q0 .. q0 + QT - 1: past tq, or wholly below this key
      // group's keys under the mask, p = 0 throughout (q0 < tq always)
      const int q0 = (qt0 + t) * QT;
      if (kw0 >= tk || (causal && q0 + QT - 1 + offset < kw0)) continue;
      if (part < Tl::CW) score_chain<D, LD, RB, CB, LS>(Sc, Kc, Qt + h_key * LD, lane);
      float s[NT8][4], dp[NT8][4];
      product_tf32x3<LD, LD, DW, NT8, Tl::KC>(dp, Vg + part * DW, dOt + part * DW, lane);
#pragma unroll
      for (int n = 0; n < NT8; ++n)
        X[(warp * NT8 + n) * 32 + lane] = make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
      bar_sync(1 + kg, 32 * WP);
      gather_scores<NT8, LS>(s, St, lane);
      sum_partials<NT8, WP>(dp, X, kg, lane);
      // p^T and ds^T in the accumulators: row (key) kw0 + g + 8 (e / 2),
      // column (query) q0 + 8 n + 2 c + (e % 2); masks only where the tile
      // crosses tq or this key group's diagonal
      const bool edge = q0 + QT > tq || (causal && q0 + offset < kw0 + 15);
      FragA pa[NT8], dsa[NT8];
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        const int col = 8 * n + 2 * c;  // in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(Lt + QT + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(s[n][e] - (e % 2 ? l2.y : l2.x));
          if (edge) {
            const int qi = q0 + col + (e % 2);
            const int ki = kw0 + g + 8 * (e / 2);
            if (qi >= tq || (causal && qi + offset < ki)) p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - (e % 2 ? d2.y : d2.x));
        }
        c_to_a_tf32(pa[n], s[n]);
        c_to_a_tf32(dsa[n], dp[n]);
      }
      // dv += p^T dO, dk += ds^T qs over this warp's columns, one 8-column
      // tile at a time: B of the stage's rows in c_to_a_tf32's order, summed
      // over the tile in zeroed partials
#pragma unroll
      for (int nd = 0; nd < DW / 8; ++nd) {
        float part_dv[4] = {}, part_dk[4] = {};
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          FragB bd, bq;
          load_b_perm_tf32<LD>(bd, dOt + 8 * n * LD + part * DW, 8 * nd, lane);
          load_b_perm_tf32<LD>(bq, Qt + 8 * n * LD + part * DW, 8 * nd, lane);
          mma_tf32x3(part_dv, pa[n], bd);
          mma_tf32x3(part_dk, dsa[n], bq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[0][nd][e] += part_dv[e];
          dka[0][nd][e] += part_dk[e];
        }
      }
    }
  } else {
    // this lane's scores (a chaining warp's), the tile's p^T, this warp's
    // partial of dP^T (then ds^T)
    float cs[RB][CB] = {}, p[NT8][4] = {}, dp[NT8][4] = {};
    for (int t = 0; t < n_qt; ++t) {
      const int q0 = (qt0 + t) * QT;
      const float* Lt = Ls + 2 * (t % STAGES) * QT;  // lse, then delta
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int u = t * STEPS + j;
        float* C = Rs + (u % CS) * QT * LDC;  // the step's chunk
        // step u has landed for this thread: pre-scale the chunk of q it
        // copied; then every thread's share of it is in place, and every
        // warp is done with step u - 1, whose stage the next copy refills
        cp_async_wait<CS - 2>();
        if (j / NCH != 1) scale_chunk_f32<CK, LDC, QT, NT>(C, q_scale, threadIdx.x);
        __syncthreads();
        if (u + CS - 1 < n_steps) load_step(u + CS - 1);
        cp_async_commit();
        if (kw0 >= tk || (causal && q0 + QT - 1 + offset < kw0)) continue;
        if (j < NCH) {  // q's chunk j: the scores
          if (part < Tl::CW)
            chain_chunk<CK, NCH, LD, LDC, RB, CB, LS>(cs, Sc, Kc + j * CK, C + h_key * LDC, j,
                                                      lane);
        } else if (j < 2 * NCH) {  // dO's chunk jo
          const int jo = j - NCH;
          if (jo == 0) {
            // the tile's scores are in St (the barrier above): p^T, masked
            // only where the tile crosses tq or this key group's diagonal
            gather_scores<NT8, LS>(p, St, lane);
            const bool edge = q0 + QT > tq || (causal && q0 + offset < kw0 + 15);
#pragma unroll
            for (int n = 0; n < NT8; ++n) {
              const int col = 8 * n + 2 * c;  // in the tile
              const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                p[n][e] = expf(p[n][e] - (e % 2 ? l2.y : l2.x));
                if (edge) {
                  const int qi = q0 + col + (e % 2);
                  const int ki = kw0 + g + 8 * (e / 2);
                  if (qi >= tq || (causal && qi + offset < ki)) p[n][e] = 0.f;
                }
              }
            }
          }
          // dv += p^T dO over this warp's columns of the chunk, and its
          // partial of dP^T over them
          add_product_tf32x3<LDC, PW, NT8>(dva[jo], p, C + part * PW, lane);
          if (jo == 0) {
            product_tf32x3<LD, LDC, PW, NT8, Tl::KC>(dp, Vg + part * PW, C + part * PW, lane);
          } else {
            product_tf32x3<LD, LDC, PW, NT8, Tl::KC, false>(dp, Vg + jo * CK + part * PW,
                                                            C + part * PW, lane);
          }
          if (jo < NCH - 1) continue;
          // the exchange, then ds^T = p^T (dP^T - delta)
#pragma unroll
          for (int n = 0; n < NT8; ++n)
            X[(warp * NT8 + n) * 32 + lane] = make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
          bar_sync(1, NT);
          sum_partials<NT8, WP>(dp, X, 0, lane);
#pragma unroll
          for (int n = 0; n < NT8; ++n) {
            const float2 d2 = *reinterpret_cast<const float2*>(Lt + QT + 8 * n + 2 * c);
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[n][e] = p[n][e] * (dp[n][e] - (e % 2 ? d2.y : d2.x));
          }
        } else {  // q's chunk jq again: dk += ds^T qs over this warp's columns of it
          add_product_tf32x3<LDC, PW, NT8>(dka[j - 2 * NCH], dp, C + part * PW, lane);
        }
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // dk and dv staged through this warp's rows and columns of K and V
  // (after the group's last barrier no warp reads them)
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    store_warp_rows_f32<PWV, LD, D>(dk + (size_t)b * tk * D + d_col(i), Kg + d_col(i), dka[i],
                                    1.f, kw0, tk, lane);
    store_warp_rows_f32<PWV, LD, D>(dv + (size_t)b * tk * D + d_col(i), Vg + d_col(i), dva[i],
                                    1.f, kw0, tk, lane);
  }
}

template <int D>
int launch_dkv_wide_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv, int bh,
                           int tq, int tk, int causal, float q_scale, cudaStream_t stream) {
  using Tl = WideTf32Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel_wide_tf32x3<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tl::dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (tk + Tl::ROWS - 1) / Tl::ROWS;
  flash_dkv_kernel_wide_tf32x3<D><<<bh * n_ktiles, Tl::NT, Tl::dkv_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), bh, tq, tk, causal, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq: contiguous [bh, t, d], 16-byte aligned; lse and
// delta (an output here): contiguous f32 [bh, tq]. q is unscaled: q_scale
// is 1/sqrt(d) rounded to q's dtype (the pre-scale), scale the f32
// 1/sqrt(d) that multiplies the dq sum. dtype: 0 = float32, 1 = bfloat16.
// block_q (bf16 d 1024 only, for measurements): 16 or 32 query rows a
// block, or 0: 32 where that grid fills every SM, else 16 (rows_1024).
// Returns a cudaError_t (0 on success); an unsupported head size or
// block_q returns cudaErrorInvalidValue.
extern "C" int dl4j_flash_dq(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq, int bh,
                             int tq, int tk, int d, int causal, int dtype, float q_scale,
                             float scale, int block_q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && d == 1024) {
    if (block_q == 0) {
      if (int err = rows_1024(bh, tq, &block_q)) return err;
    }
    if (block_q == 32) return launch_dq_wide<1024, 32>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (block_q == 16) return launch_dq_wide<1024, 16>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (block_q != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    int rows = 0;
    if (int err = block_rows(bh, tq, &rows)) return err;
    if (d == 64 && rows == 64) return launch_dq<64, 64>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 64 && rows == 128) return launch_dq<64, 128>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 128 && rows == 64) return launch_dq<128, 64>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 128 && rows == 128) return launch_dq<128, 128>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 256) return launch_dq_wide<256, 128>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 512) return launch_dq_wide<512, 64>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
  } else if (dtype == 0) {
    if (d == 64) return launch_dq_tf32x3<64>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 128) return launch_dq_tf32x3<128>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 256) return launch_dq_wide_tf32x3<256>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 512) return launch_dq_wide_tf32x3<512>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 1024) return launch_dq_wide_tf32x3<1024>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Inputs as dl4j_flash_dq's (no o, no dq scale), delta as dl4j_flash_dq
// wrote it, earlier on the same stream; dk, dv: contiguous [bh, tk, d].
extern "C" int dl4j_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int bh,
                              int tq, int tk, int d, int causal, int dtype, float q_scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    int rows = 0;
    if (int err = block_rows(bh, tk, &rows)) return err;
    if (d == 64 && rows == 64) return launch_dkv<64, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 64 && rows == 128) return launch_dkv<64, 128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 128 && rows == 64) return launch_dkv<128, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 128 && rows == 128) return launch_dkv<128, 128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 256) return launch_dkv_wide<256>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 512) return launch_dkv_wide<512>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 1024) return launch_dkv_wide<1024>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
  } else if (dtype == 0) {
    if (d == 64) return launch_dkv_tf32x3<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 128) return launch_dkv_tf32x3<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 256) return launch_dkv_wide_tf32x3<256>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 512) return launch_dkv_wide_tf32x3<512>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 1024) return launch_dkv_wide_tf32x3<1024>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
