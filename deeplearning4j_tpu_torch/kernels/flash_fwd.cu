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
// The SIMT kernel (flash_fwd_kernel_f32) is on no main path and was not
// redesigned: the first version's CUDA-core FMAs through shared memory
// in f32 (full f32 precision, no TF32), taking the unscaled q and the
// scale like the bf16 kernel. It runs every f32 head and the bf16 heads
// of 256 and 512 (a wider head than the mma.sync kernel's registers
// hold; 129-256 and 257-512 are zero-padded to them): its tiles are
// template parameters, 64 x 64 up to d = 128, 32 x 32 at 256 and 16 x 16
// at 512 (simt_tile, flash_common.cuh), so that the f32 rows fit shared
// memory (~136 KB at 256, ~133 KB at 512), and its global loads and
// stores are templated on the element type: bf16 is widened on load,
// and p is rounded to bf16 before P.V, as the reference rounds it. A
// correct, slow first kernel for those heads: nothing was tuned.
//
// The PTX helpers (cp.async, ldmatrix, mma.sync, bf16 packing, the q
// pre-scale, quad reductions) and the pieces built on them (row copies,
// fragment loads and packing, the epilogue store) live in
// flash_common.cuh, shared with the backward kernels of flash_bwd.cu.
//
// Exposed as a plain C function so that no PyTorch header is compiled.

#include "flash_common.cuh"

namespace {

constexpr int BK = 64;  // keys per tile

// -------------------------------------------------------- the bf16 kernel

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

    // masks only where the tile reaches past tk or above this warp's diagonal
    if (k0 + BK > tk || (causal && k0 + BK - 1 > r0 + offset)) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + 8 * n + 2 * c + (j % 2);
          const int row = r0 + g + 8 * (j / 2);
          if (col >= tk) s[n][j] = -INFINITY;  // past the last key: not in the row
          else if (causal && row + offset < col) s[n][j] = NEG_INF_SENTINEL;
        }
      }
    }

    // online softmax on the accumulators; h = 0: row g, h = 1: row g + 8
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
// float32, 1 = bfloat16; d: 64, 128, 256 or 512. block_q (bf16 d 64 and
// 128 only): 64 or 128 query rows per block, or 0 to choose by tq. Returns a cudaError_t (0 on success); an
// unsupported head size or block returns cudaErrorInvalidValue.
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
  if (block_q != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {  // the wide heads: the SIMT design
    if (d == 256) return launch_f32<bf16, 256>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 512) return launch_f32<bf16, 512>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
  } else if (dtype == 0) {
    if (d == 64) return launch_f32<float, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 128) return launch_f32<float, 128>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 256) return launch_f32<float, 256>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    if (d == 512) return launch_f32<float, 512>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
