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
// MB moved. The bf16 kernels (every main path) are the structure of the
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
// The SIMT kernels (flash_dq_kernel_f32, flash_dkv_kernel_f32) are on no
// main path and were not redesigned: the first version's CUDA-core FMAs
// through shared memory in f32 (full f32 precision, no TF32), taking the
// unscaled q and multiplying it by the scale as they load it (one
// rounding, the torch product), and, in flash_dq, computing and writing
// delta as the bf16 kernel does. They run every f32 head and the bf16
// heads of 256 and 512 (wider than the mma.sync kernels' registers hold;
// 129-256 and 257-512 are zero-padded to them). Their tiles are template
// parameters (simt_tile, flash_common.cuh): flash_dq 64 x 64 up to d =
// 128, 32 x 32 at 256, 16 x 16 at 512 (~177 and ~168 KB of shared
// memory); flash_dkv 64 keys and 32-query steps up to 128, 32 and 16 at
// 256, 16 and 8 at 512 (~173 and ~167 KB). Their global loads and stores
// are templated on the element type: bf16 is widened on load, and p and
// ds are rounded to bf16 before their products, as the reference rounds
// them. Correct, slow first kernels for those heads: nothing was tuned.
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
  constexpr int CH = D / 8;
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
    for (int i = threadIdx.x; i < TILE * CH; i += NT) {
      uint4* p = reinterpret_cast<uint4*>(Qt + (i / CH) * LD + (i % CH) * 8);
      uint4 x = *p;
      x.x = scale_pair(x.x, q_scale);
      x.y = scale_pair(x.y, q_scale);
      x.z = scale_pair(x.z, q_scale);
      x.w = scale_pair(x.w, q_scale);
      *p = x;
    }
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

// ------------------------------------------------ the f32 (SIMT) design

constexpr int LDS_PAD = 1;  // f32 rows padded by one element (bank spread)

// C[M, N] = A[M, K] . B[N, K]^T, A and B row-major in shared memory.
template <int M, int N, int K>
__device__ __forceinline__ void mm_abt(float* C, int ldc, const float* A, int lda,
                                       const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += F32_NT) {
    const int r = i / N, c = i % N;
    float s = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < K; ++kk) s += A[r * lda + kk] * B[c * ldb + kk];
    C[r * ldc + c] = s;
  }
}

// C[M, N] += A[M, K] . B[K, N], A and B row-major in shared memory.
template <int M, int N, int K>
__device__ __forceinline__ void mm_ab_acc(float* C, int ldc, const float* A, int lda,
                                          const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += F32_NT) {
    const int r = i / N, c = i % N;
    float s = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < K; ++kk) s += A[r * lda + kk] * B[kk * ldb + c];
    C[r * ldc + c] += s;
  }
}

// p for query row qrow and key column kcol, from the raw score s
__device__ __forceinline__ float prob(float s, float lse, int qrow, int kcol, int tq, int tk,
                                      int offset, int causal) {
  if (qrow >= tq || kcol >= tk) return 0.f;  // ragged edge: not in the problem at all
  if (causal && qrow + offset < kcol) s = NEG_INF_SENTINEL;
  return expf(s - lse);
}

// flash_dq: a block of BQ query rows over key tiles of BK keys
template <int D, int BQ, int BK>
struct DqLayoutF32 {
  static constexpr int LDT = D + LDS_PAD;   // qs, dO, k, v rows
  static constexpr int LDS = BK + LDS_PAD;  // s, dP, ds tiles
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + round32(sizeof(float) * BQ * LDT);
  static constexpr size_t k_off = do_off + round32(sizeof(float) * BQ * LDT);
  static constexpr size_t v_off = k_off + round32(sizeof(float) * BK * LDT);
  static constexpr size_t s_off = v_off + round32(sizeof(float) * BK * LDT);
  static constexpr size_t dp_off = s_off + round32(sizeof(float) * BQ * LDS);
  static constexpr size_t ds_off = dp_off + round32(sizeof(float) * BQ * LDS);
  static constexpr size_t acc_off = ds_off + round32(sizeof(float) * BQ * LDS);
  static constexpr size_t lse_off = acc_off + round32(sizeof(float) * BQ * LDT);
  static constexpr size_t dl_off = lse_off + round32(sizeof(float) * BQ);
  static constexpr size_t bytes = dl_off + round32(sizeof(float) * BQ);
  static_assert(bytes <= SMEM_LIMIT, "flash_dq f32 layout exceeds shared memory");
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(F32_NT)
flash_dq_kernel_f32(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int tq, int tk,
                    int n_qtiles, int causal, float q_scale, float scale) {
  using Lay = DqLayoutF32<D, BQ, BK>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Lay::q_off);
  float* dOs = reinterpret_cast<float*>(smem + Lay::do_off);
  float* Ks = reinterpret_cast<float*>(smem + Lay::k_off);
  float* Vs = reinterpret_cast<float*>(smem + Lay::v_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  float* dPs = reinterpret_cast<float*>(smem + Lay::dp_off);
  float* dSs = reinterpret_cast<float*>(smem + Lay::ds_off);
  float* Acc = reinterpret_cast<float*>(smem + Lay::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + Lay::dl_off);

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int offset = tk - tq;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  load_rows_f32<D, LDT>(Qs, q + (size_t)bh * tq * D, q0, tq, BQ, q_scale);
  load_rows_f32<D, LDT>(dOs, dout + (size_t)bh * tq * D, q0, tq, BQ, 1.f);
  for (int r = threadIdx.x; r < BQ; r += F32_NT) {
    lse_s[r] = q0 + r < tq ? lse[(size_t)bh * tq + q0 + r] : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * LDT; i += F32_NT) Acc[i] = 0.f;
  // delta = rowsum(dO O), warp w summing rows w, w + 4, ..., written once
  // per row for flash_dkv (zero past tq)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += F32_NT / 32) {
    const bool ok = q0 + r < tq;
    const size_t at = ((size_t)bh * tq + q0 + r) * D;
    float part = 0.f;
    if (ok) {
      for (int c = lane; c < D; c += 32) part = fmaf(to_f(dout[at + c]), to_f(o[at + c]), part);
    }
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      dl_s[r] = part;
      if (ok) delta[(size_t)bh * tq + q0 + r] = part;
    }
  }

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_ktiles = (k_end + BK - 1) / BK;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * BK;
    load_rows_f32<D, LDT>(Ks, kb, k0, tk, BK, 1.f);
    load_rows_f32<D, LDT>(Vs, vb, k0, tk, BK, 1.f);
    __syncthreads();
    mm_abt<BQ, BK, D>(Ss, LDS, Qs, LDT, Ks, LDT);    // s = qs k^T
    mm_abt<BQ, BK, D>(dPs, LDS, dOs, LDT, Vs, LDT);  // dP = dO v^T
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += F32_NT) {
      const int r = i / BK, c = i % BK;
      const float p = prob(Ss[r * LDS + c], lse_s[r], q0 + r, k0 + c, tq, tk, offset, causal);
      dSs[r * LDS + c] = round_to<T>(p * (dPs[r * LDS + c] - dl_s[r]));
    }
    __syncthreads();
    mm_ab_acc<BQ, D, BK>(Acc, LDT, dSs, LDS, Ks, LDT);  // acc += ds k
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * D; i += F32_NT) {
    const int r = i / D, c = i % D;
    if (q0 + r < tq) dq[((size_t)bh * tq + q0 + r) * D + c] = from_f<T>(Acc[r * LDT + c] * scale);
  }
}

// flash_dkv: a block of BK keys over query tiles of BQT rows
template <int D, int BK, int BQT>
struct DkvLayoutF32 {
  static constexpr int LDT = D + LDS_PAD;    // k, v, qs, dO rows
  static constexpr int LDS = BQT + LDS_PAD;  // s^T, dP^T, p^T, ds^T tiles [BK, BQT]
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + round32(sizeof(float) * BK * LDT);
  static constexpr size_t q_off = v_off + round32(sizeof(float) * BK * LDT);
  static constexpr size_t do_off = q_off + round32(sizeof(float) * BQT * LDT);
  static constexpr size_t s_off = do_off + round32(sizeof(float) * BQT * LDT);
  static constexpr size_t dp_off = s_off + round32(sizeof(float) * BK * LDS);
  static constexpr size_t p_off = dp_off + round32(sizeof(float) * BK * LDS);
  static constexpr size_t ds_off = p_off + round32(sizeof(float) * BK * LDS);
  static constexpr size_t dk_off = ds_off + round32(sizeof(float) * BK * LDS);
  static constexpr size_t dv_off = dk_off + round32(sizeof(float) * BK * LDT);
  static constexpr size_t lse_off = dv_off + round32(sizeof(float) * BK * LDT);
  static constexpr size_t dl_off = lse_off + round32(sizeof(float) * BQT);
  static constexpr size_t bytes = dl_off + round32(sizeof(float) * BQT);
  static_assert(bytes <= SMEM_LIMIT, "flash_dkv f32 layout exceeds shared memory");
};

template <typename T, int D, int BK, int BQT>
__global__ void __launch_bounds__(F32_NT)
flash_dkv_kernel_f32(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
                     int n_ktiles, int causal, float q_scale) {
  using Lay = DkvLayoutF32<D, BK, BQT>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + Lay::k_off);
  float* Vs = reinterpret_cast<float*>(smem + Lay::v_off);
  float* Qs = reinterpret_cast<float*>(smem + Lay::q_off);
  float* dOs = reinterpret_cast<float*>(smem + Lay::do_off);
  float* St = reinterpret_cast<float*>(smem + Lay::s_off);
  float* dPt = reinterpret_cast<float*>(smem + Lay::dp_off);
  float* Pt = reinterpret_cast<float*>(smem + Lay::p_off);
  float* dSt = reinterpret_cast<float*>(smem + Lay::ds_off);
  float* dKa = reinterpret_cast<float*>(smem + Lay::dk_off);
  float* dVa = reinterpret_cast<float*>(smem + Lay::dv_off);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + Lay::dl_off);

  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * BK;
  const int offset = tk - tq;
  const T* qb = q + (size_t)bh * tq * D;
  const T* db = dout + (size_t)bh * tq * D;

  load_rows_f32<D, LDT>(Ks, k + (size_t)bh * tk * D, k0, tk, BK, 1.f);
  load_rows_f32<D, LDT>(Vs, v + (size_t)bh * tk * D, k0, tk, BK, 1.f);
  for (int i = threadIdx.x; i < BK * LDT; i += F32_NT) {
    dKa[i] = 0.f;
    dVa[i] = 0.f;
  }

  // causal: the first query row that sees any key of this tile (< tq,
  // since k0 - offset <= tq - 1)
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  const int n_qtiles = (tq + BQT - 1) / BQT;

  for (int qt = q_begin / BQT; qt < n_qtiles; ++qt) {
    const int q0 = qt * BQT;
    load_rows_f32<D, LDT>(Qs, qb, q0, tq, BQT, q_scale);
    load_rows_f32<D, LDT>(dOs, db, q0, tq, BQT, 1.f);
    for (int c = threadIdx.x; c < BQT; c += F32_NT) {
      const bool ok = q0 + c < tq;
      lse_s[c] = ok ? lse[(size_t)bh * tq + q0 + c] : 0.f;
      dl_s[c] = ok ? delta[(size_t)bh * tq + q0 + c] : 0.f;
    }
    __syncthreads();
    mm_abt<BK, BQT, D>(St, LDS, Ks, LDT, Qs, LDT);    // s^T = k qs^T
    mm_abt<BK, BQT, D>(dPt, LDS, Vs, LDT, dOs, LDT);  // dP^T = v dO^T
    __syncthreads();
    for (int i = threadIdx.x; i < BK * BQT; i += F32_NT) {
      const int r = i / BQT, c = i % BQT;  // r: key, c: query
      const float p = prob(St[r * LDS + c], lse_s[c], q0 + c, k0 + r, tq, tk, offset, causal);
      // p and ds rounded to the operand dtype before their products
      Pt[r * LDS + c] = round_to<T>(p);
      dSt[r * LDS + c] = round_to<T>(p * (dPt[r * LDS + c] - dl_s[c]));
    }
    __syncthreads();
    mm_ab_acc<BK, D, BQT>(dVa, LDT, Pt, LDS, dOs, LDT);  // dv += p^T dO
    mm_ab_acc<BK, D, BQT>(dKa, LDT, dSt, LDS, Qs, LDT);  // dk += ds^T qs
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BK * D; i += F32_NT) {
    const int r = i / D, c = i % D;
    if (k0 + r < tk) {
      const size_t at = ((size_t)bh * tk + k0 + r) * D + c;
      dk[at] = from_f<T>(dKa[r * LDT + c]);
      dv[at] = from_f<T>(dVa[r * LDT + c]);
    }
  }
}

template <typename T, int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, int bh, int tq, int tk,
                  int causal, float q_scale, float scale, cudaStream_t stream) {
  constexpr int TILE = simt_tile(D);
  constexpr size_t smem = DqLayoutF32<D, TILE, TILE>::bytes;
  auto kernel = flash_dq_kernel_f32<T, D, TILE, TILE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + TILE - 1) / TILE;
  kernel<<<bh * n_qtiles, F32_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), tq, tk, n_qtiles, causal, q_scale, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int bh, int tq,
                   int tk, int causal, float q_scale, cudaStream_t stream) {
  // keys per block as flash_dq's tile, query rows per step half of it
  constexpr int BK = simt_tile(D), BQT = BK / 2;
  constexpr size_t smem = DkvLayoutF32<D, BK, BQT>::bytes;
  auto kernel = flash_dkv_kernel_f32<T, D, BK, BQT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (tk + BK - 1) / BK;
  kernel<<<bh * n_ktiles, F32_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), tq,
      tk, n_ktiles, causal, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq: contiguous [bh, t, d], 16-byte aligned; lse and
// delta (an output here): contiguous f32 [bh, tq]. q is unscaled: q_scale
// is 1/sqrt(d) rounded to q's dtype (the pre-scale), scale the f32
// 1/sqrt(d) that multiplies the dq sum. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 on success); an unsupported head size returns
// cudaErrorInvalidValue.
extern "C" int dl4j_flash_dq(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq, int bh,
                             int tq, int tk, int d, int causal, int dtype, float q_scale,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    int rows = 0;
    if (int err = block_rows(bh, tq, &rows)) return err;
    if (d == 64 && rows == 64) return launch_dq<64, 64>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 64 && rows == 128) return launch_dq<64, 128>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 128 && rows == 64) return launch_dq<128, 64>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 128 && rows == 128) return launch_dq<128, 128>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 256) return launch_dq_f32<bf16, 256>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 512) return launch_dq_f32<bf16, 512>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
  } else if (dtype == 0) {
    if (d == 64) return launch_dq_f32<float, 64>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 128) return launch_dq_f32<float, 128>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 256) return launch_dq_f32<float, 256>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
    if (d == 512) return launch_dq_f32<float, 512>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk, causal, q_scale, scale, s);
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
    if (d == 256) return launch_dkv_f32<bf16, 256>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 512) return launch_dkv_f32<bf16, 512>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
  } else if (dtype == 0) {
    if (d == 64) return launch_dkv_f32<float, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 128) return launch_dkv_f32<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 256) return launch_dkv_f32<float, 256>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
    if (d == 512) return launch_dkv_f32<float, 512>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, q_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
