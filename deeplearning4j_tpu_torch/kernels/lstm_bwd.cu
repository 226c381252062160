// Graves-LSTM scan backward (BPTT) for Hopper (sm_90a), hand-written
// CUDA C++: two kernels that together replace the Pallas TPU kernel
// deeplearning4j_tpu/ops/lstm_kernel.py `_bwd_pallas` -> `_bwd_kernel`
// (gate chain `_bptt_gates`).
//
// `lstm_bwd`, the reverse-time sweep. From the forward's residuals i, f,
// o, blk, c [t, b, n] (xg's dtype) and gout = dL/dh_seq with dL/dh_T
// folded into the last step (the residual dtype), per step from t - 1
// down to 0:
//   dh = gout_t + dg_{t+1} . Wr^T       (dg rounded to Wr's dtype, f32 sum)
//   (da_i, da_f, da_o, da_g, dc) = the gate chain on c_prev (c0 at t = 0)
//   dg_t = [da_i, da_f, da_o, da_g]     (written in the residual dtype)
// ending with dh0 = dg_0 . Wr^T and dc0 (f32); the dc carry starts at
// dL/dc_T. The layout is the forward's: block (bi, j) owns batch rows
// [bi BB, +BB) and hidden units [j U, +U), keeps Wr's U rows for its
// units ([U, 4n], about 128 KB) resident in shared memory and its slice
// of the dc carry on chip, and meets the other blocks of its batch group at
// a counter barrier after every step, since dh for its units needs all
// 4n columns of dg_{t+1}. Two by-products leave the sweep: h_prev =
// o_{t-1} tanh(c_{t-1}) (h0 at t = 0), rounded to Wr's dtype, for the
// weight gradient (tanh(c_t) is at hand in the step that computes the
// chain), and per-block partial sums of the peephole gradients over its
// rows, accumulated over time from the f32 da, as the TPU kernel sums
// them.
//
// The bf16 sweep (the training path; sweep_mma): mma.sync m16n8k16 with
// the gate chain applied on the accumulators.
// - Warp w of the BB / 16 that compute owns rows [16 w, +16) and all U
//   units, and multiplies the full depth 4n: each A fragment (dg) is read
//   from shared memory once per step, by the one warp whose rows it holds.
//   A fragments come by ldmatrix from a ring of 3 stages of 64-deep
//   dg_{t+1} chunks (cp.async.cg, since other blocks wrote dg, 2 in
//   flight, one __syncthreads per chunk); B fragments by ldmatrix from the
//   resident W, whose rows are ordered (bwd_unit_of) so that the thread of
//   lane c holds 2 U / 8 neighbouring units in its accumulators.
// - The thread that holds dh[r, u] runs the gate chain for (r, u). Its dc
//   carry and peephole sums live in its own slots of shared memory
//   (conflict-free, [value][thread]), which keeps the U = 32 kernels off
//   the 255-register cap (in registers they spilled 8-20 bytes).
// - The six streams a step reads (i, f, o, blk, gout and c_{t-1}) come
//   into registers as 8- or 16-byte vectors of neighbouring units,
//   issued a step ahead (between the barrier's arrival and its wait, so
//   they land under the wait and the product); c_t is the step before's
//   c_{t-1}. dg and h_prev leave as vectors of bf16 pairs.
// - The barrier is a release add after the dg stores and an acquire poll
//   before the next step's chunks (group_arrive, group_wait); h_prev
//   stores and the prefetch sit between the two.
// The f32 sweep (sweep_simt) keeps the first design: the product on the
// CUDA cores into an f32 buffer in shared memory (block_product), then
// the chain per (row, unit).
//
// `lstm_dw`, the weight gradients. The TPU kernel accumulates
// dWr += h_prev^T . dg in a VMEM buffer shared by the batch blocks,
// which on Hopper would take atomics on the result. The bf16 kernel
// (dw_mma) is a tiled tensor-core GEMM over the m = t bp rows: a block
// owns a 128 x 256 tile of dWr [n, 4n] (8 warps of 64 x 64, each A and B
// fragment feeding 8 or 4 mma.sync) and a contiguous range of m, fed by a
// 3-stage cp.async ring of 64-row chunks of h_prev and dg, both m-major,
// so both operands come by ldmatrix.trans. Where the tiles alone leave
// most SMs idle (n 512: 32 tiles) m is split so that the grid is about
// one wave; each split writes its f32 partial tile to a workspace, and
// the last split of a tile to finish (a counter per tile) sums the
// partials in split order and writes dWr: no atomics on the result, so
// it is bitwise the same on every run. The f32 kernel (dw_simt) keeps
// the first design: 64 x 64 tiles on the CUDA cores. The block that
// writes a tile of the first column of tiles also adds up the sweep's
// peephole partials of its units, in a fixed order.
//
// What bounds it: at the training shape (b 1024, t 128, n 512, bf16)
// the sweep moves ~1.3 GB (residuals in, dg out) against 275 GFLOP of
// recurrent product, so bytes (0.44 ms); but every block reads its
// batch group's whole dg_{t+1} rows each step (512 KB; the 16 blocks of
// a group read the same rows, ~64 MB of L2 reads per step), and that
// copy is the floor of this design: on an H100 (PERF.md) the step
// takes ~22 us, of which the dg chunks ~15.6, which take 12.7 with the
// products left out (~5.2 TB/s from L2 over the card) and 9.6 with the
// copies left out; only a cluster multicast of dg would lower it. A
// split of each chunk's depth over warp pairs (each B fragment read half
// as often) saved 0.6 us of the 15.6 and was not kept. lstm_dw does 275
// GFLOP on ~0.8 GB, so operations (0.28 ms); its tiles re-read h_prev 8
// times and dg 4 times from L2 (~3 GB), and it runs at ~0.93 ms.
//
// Exposed as plain C functions so that no PyTorch header is compiled.

#include "lstm_common.cuh"

namespace {

using namespace lstm;

constexpr int BWD_STAGES = 3;  // ring stages of the bf16 sweep's dg chunks (2 in flight)

struct BwdArgs {
  const void* res[5];   // i, f, o, blk, c: [t, bp, n]
  const void* gout;     // [t, bp, n], the residual dtype
  const void* wr;       // [n, 4n], the residual dtype
  const float* wci;     // [n] each
  const float* wcf;
  const float* wco;
  const void* h0;       // [bp, n], the residual dtype
  const float* c0;      // [bp, n]
  const float* gclast;  // [bp, n]: dL/dc_T
  void* dg;             // [t, bp, 4n]
  void* hp;             // [t, bp, n]: h_prev rounded to Wr's dtype
  float* dh0;           // [bp, n]
  float* dc0;           // [bp, n]
  float* partial;       // [bp / BB, 3, n]: peephole sums per batch block
  unsigned int* counter;  // [bp / BB] zeros
  unsigned long long* stamps;  // [grid, t, 4] (timed variant)
  int t, bp, n, BB;
};

template <typename T> __host__ __device__ int ldr(int n) { return 4 * n + (sizeof(T) == 2 ? 8 : 1); }

template <typename T, int U>
size_t sweep_smem(int n, int BB) {
  const size_t w = round128(sizeof(T) * (size_t)U * ldr<T>(n));
  if (sizeof(T) == 2)  // W, the ring, the block's peephole weights and each thread's sums
    return w + BWD_STAGES * round128(sizeof(bf16) * (size_t)BB * lda<bf16>()) +
           round128(sizeof(float) * 3 * U) + sizeof(float) * 5 * (U / 4) * NT;
  size_t rest = sizeof(float) * (size_t)BB * (U + 4);
  const size_t stage = stage_bytes(BB);
  if (stage > rest) rest = stage;
  return w + round128(rest);
}

// The f32 design (see the header); BB <= MAXB.
template <int U, int MAXB>
__device__ void sweep_simt(const BwdArgs& a, unsigned char* smem) {
  using T = float;
  constexpr int LDO = U + 4;
  // (row, unit) pairs a thread owns, at most, and how many are worked on
  // together
  constexpr int PAIRS = (MAXB * U + NT - 1) / NT, QB = PAIRS < 2 ? PAIRS : 2;
  const int n = a.n, BB = a.BB, bp = a.bp, G = 4 * n, LDR = ldr<T>(n);
  T* W = reinterpret_cast<T*>(smem);
  unsigned char* rest = smem + round128(sizeof(T) * (size_t)U * LDR);
  float* out = reinterpret_cast<float*>(rest);
  float* stage = reinterpret_cast<float*>(rest);

  const int nj = n / U;
  const int bi = blockIdx.x / nj, j = blockIdx.x % nj;
  const int b0 = bi * BB, u0 = j * U;
  const int tid = threadIdx.x;

  // resident: W[u][k] = Wr[u0 + u][k], the rows of this block's units
  {
    const T* wr = static_cast<const T*>(a.wr) + (size_t)u0 * G;
    for (int i = tid; i < U * G; i += NT) W[(size_t)(i / G) * LDR + i % G] = wr[i];
  }
  float dc[PAIRS], pi[PAIRS], pf[PAIRS], po[PAIRS];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = tid + q * NT;
    dc[q] = p < BB * U ? a.gclast[(size_t)(b0 + p / U) * n + u0 + p % U] : 0.f;
    pi[q] = pf[q] = po[q] = 0.f;
  }
  __syncthreads();

  const T *ri = static_cast<const T*>(a.res[0]), *rf = static_cast<const T*>(a.res[1]),
          *ro = static_cast<const T*>(a.res[2]), *rb = static_cast<const T*>(a.res[3]),
          *rc = static_cast<const T*>(a.res[4]), *gout = static_cast<const T*>(a.gout),
          *h0 = static_cast<const T*>(a.h0);
  T* dg = static_cast<T*>(a.dg);
  T* hp = static_cast<T*>(a.hp);
  for (int s = 0; s < a.t; ++s) {
    const int tt = a.t - 1 - s;
    const bool has_next = tt + 1 < a.t;
    if (has_next)
      block_product<U, true, MAXB>(out, LDO, stage, dg + ((size_t)(tt + 1) * bp + b0) * G, G, W,
                                   LDR, G, BB);
    // the chain, QB (row, unit) pairs at a time: their loads of the
    // residuals and gout (streamed from device memory) in flight together
#pragma unroll
    for (int q0 = 0; q0 < PAIRS; q0 += QB) {
      float v[QB][7];  // i, f, o, blk, c, c_prev, gout
#pragma unroll
      for (int jj = 0; jj < QB; ++jj) {
        const int p = tid + (q0 + jj) * NT;
        if (p < BB * U) {
          const size_t at = ((size_t)tt * bp + b0 + p / U) * n + u0 + p % U;
          v[jj][0] = ri[at];
          v[jj][1] = rf[at];
          v[jj][2] = ro[at];
          v[jj][3] = rb[at];
          v[jj][4] = rc[at];
          v[jj][5] = tt > 0 ? rc[at - (size_t)bp * n] : a.c0[(size_t)(b0 + p / U) * n + u0 + p % U];
          v[jj][6] = gout[at];
        }
      }
#pragma unroll
      for (int jj = 0; jj < QB; ++jj) {
        const int q = q0 + jj, p = tid + q * NT;
        if (p < BB * U) {
          const int r = p / U, u = p % U;
          const size_t row = (size_t)tt * bp + b0 + r;
          const size_t at = row * n + u0 + u;
          const float it = v[jj][0], ft = v[jj][1], ot = v[jj][2], bt = v[jj][3];
          const float ct = v[jj][4], cp = v[jj][5];
          const float th = tanhf(ct);
          const float dh = v[jj][6] + (has_next ? out[r * LDO + u] : 0.f);
          // the gate chain (`_bptt_gates`)
          const float dout = dh * th;
          const float da_o = dout * ot * (1.f - ot);
          const float dcc = dh * ot * (1.f - th * th) + dc[q] + da_o * a.wco[u0 + u];
          const float da_g = dcc * it * (1.f - bt * bt);
          const float da_i = dcc * bt * it * (1.f - it);
          const float da_f = dcc * cp * ft * (1.f - ft);
          dc[q] = dcc * ft + da_i * a.wci[u0 + u] + da_f * a.wcf[u0 + u];
          T* d = dg + row * G + u0 + u;
          d[0] = da_i;
          d[n] = da_f;
          d[2 * n] = da_o;
          d[3 * n] = da_g;
          pi[q] += da_i * cp;
          pf[q] += da_f * cp;
          po[q] += da_o * ct;
          if (has_next) hp[at + (size_t)bp * n] = ot * th;
          if (tt == 0) hp[at] = h0[at];
        }
      }
    }
    group_arrive(a.counter + bi);
    group_wait(a.counter + bi, (unsigned int)((s + 1) * nj));
  }

  // dh0 = dg_0 . Wr^T and dc0
  block_product<U, true, MAXB>(out, LDO, stage, dg + (size_t)b0 * G, G, W, LDR, G, BB);
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = tid + q * NT;
    if (p < BB * U) {
      const int r = p / U, u = p % U;
      const size_t at = (size_t)(b0 + r) * n + u0 + u;
      a.dh0[at] = out[r * LDO + u];
      a.dc0[at] = dc[q];
    }
  }
  // peephole partials of this block: sums over its rows, in row order
  float* red = out;
  for (int g = 0; g < 3; ++g) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const int p = tid + q * NT;
      if (p < BB * U) red[p] = g == 0 ? pi[q] : (g == 1 ? pf[q] : po[q]);
    }
    __syncthreads();
    if (tid < U) {
      float acc = 0.f;
      for (int r = 0; r < BB; ++r) acc += red[r * U + tid];
      a.partial[((size_t)bi * 3 + g) * n + u0 + tid] = acc;
    }
  }
}

// The unit (within the block's U) whose Wr row the bf16 sweep keeps at
// row j of its resident W. Column j = 8 nt + 2 c + p of the product lands
// in accumulator tile nt at column 2c + p of the lanes with c = lane % 4,
// so this puts units [2 NTL c, 2 NTL (c + 1)) (NTL = U / 8 tiles) in lane
// c's accumulators, tile nt holding the pair 2 nt, 2 nt + 1 of them.
template <int U> __host__ __device__ constexpr int bwd_unit_of(int j) {
  return 2 * (U / 8) * (j % 8 / 2) + 2 * (j / 8) + j % 2;
}

// acc[NTL][4] = the BB rows at A (row stride G, written by other blocks
// of this launch) times W^T over the full depth G, warp w < BB / 16 on
// rows [16 w, +16); every thread copies. TIMED stamps the landing of the
// last chunk into *landed (thread 0).
template <int U, int BB, bool TIMED>
__device__ __forceinline__ void dh_product(float (&acc)[U / 8][4], bf16* ring, const bf16* W,
                                           int LDR, const bf16* A, int G,
                                           unsigned long long* landed) {
  constexpr int NTL = U / 8, LDA = lda<bf16>(), STAGE = BB * LDA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nk = G / KC;
  const bool active = warp < BB / 16;  // the same for every lane of a warp
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  auto fetch = [&](int kc) {  // chunk kc into its ring stage
    issue_rows<BB, LDA>(ring + (kc % BWD_STAGES) * STAGE, A + kc * KC, G);
  };
  // chunks 0 .. BWD_STAGES - 2 in flight at once; each iteration waits
  // for its chunk, then refills the stage the iteration before read (one
  // group committed per chunk, empty past the last)
#pragma unroll
  for (int q = 0; q < BWD_STAGES - 1; ++q) {
    if (q < nk) fetch(q);
    cp_async_commit();
  }
  // A: rows (lane % 16), columns 8 (lane / 16); B (two 8-unit tiles per
  // ldmatrix): W rows (lane % 8) + 8 (lane / 16), columns 8 ((lane / 8) % 2)
  const int a_off = (16 * warp + lane % 16) * LDA + 8 * (lane / 16);
  const bf16* B = W + (size_t)(lane % 8 + 8 * (lane / 16)) * LDR + 8 * (lane / 8 % 2);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<BWD_STAGES - 2>();  // this thread's copies of chunk kc landed
    __syncthreads();                  // everyone's did; chunk kc - 1 is read
    if (TIMED && kc + 1 == nk && tid == 0) *landed = globaltimer();
    if (kc + BWD_STAGES - 1 < nk) fetch(kc + BWD_STAGES - 1);
    cp_async_commit();
    if (active) {
      const bf16* Ak = ring + (kc % BWD_STAGES) * STAGE + a_off;
      const bf16* Bk = B + kc * KC;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_addr(Ak + 16 * kk));
#pragma unroll
        for (int jp = 0; jp < NTL / 2; ++jp) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, smem_addr(Bk + (size_t)16 * jp * LDR + 16 * kk));
          mma_bf16(acc[2 * jp], af, bfr[0], bfr[1]);
          mma_bf16(acc[2 * jp + 1], af, bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups
}

// The bf16 design (see the header): a block of exactly BB rows. TIMED
// stamps the globaltimer per step (thread 0, each after a __syncthreads)
// after the barrier, after the last dg chunk landed, after the product
// and after the chain, its stores and the next step's prefetch.
template <int U, int BB, bool TIMED>
__device__ void sweep_mma(const BwdArgs& a, unsigned char* smem) {
  constexpr int NTL = U / 8;  // accumulator tiles; also words per stream vector
  constexpr int E = 2 * NTL;  // units per thread
  static_assert(U % 16 == 0 && BB % 16 == 0 && BB / 16 <= NT / 32, "bf16 sweep layout");
  const int n = a.n, bp = a.bp, G = 4 * n, LDR = ldr<bf16>(n);
  bf16* W = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + round128(sizeof(bf16) * (size_t)U * LDR));
  // after the ring: wci, wcf, wco of the block's units (pw[q U + u]), then
  // each thread's own slots ([value][thread], conflict-free): the
  // peephole sums of its units over its rows and the steps so far
  // (ps[(q E + e) NT]) and its dc carry per row half and unit
  // (dcs[(h E + e) NT])
  float* pw = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(ring) +
      BWD_STAGES * round128(sizeof(bf16) * (size_t)BB * lda<bf16>()));
  float* ps = pw + round128(sizeof(float) * 3 * U) / sizeof(float) + threadIdx.x;
  float* dcs = ps + 3 * E * NT;

  const int nj = n / U;
  const int bi = blockIdx.x / nj, j = blockIdx.x % nj;
  const int b0 = bi * BB, u0 = j * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const bool active = warp < BB / 16;
  const int unit = u0 + E * c;  // this thread's units: unit + [0, E)

  // resident: W[jr][k] = Wr[u0 + bwd_unit_of(jr)][k], in 16-byte pieces
  {
    const bf16* wr = static_cast<const bf16*>(a.wr);
    const int cpr = G / 8;
    for (int i = tid; i < U * cpr; i += NT) {
      const int jr = i / cpr, k = (i % cpr) * 8;
      *reinterpret_cast<uint4*>(W + (size_t)jr * LDR + k) =
          *reinterpret_cast<const uint4*>(wr + (size_t)(u0 + bwd_unit_of<U>(jr)) * G + k);
    }
  }

  const bf16 *rc = static_cast<const bf16*>(a.res[4]), *gout = static_cast<const bf16*>(a.gout);
  bf16* dg = static_cast<bf16*>(a.dg);
  bf16* hp = static_cast<bf16*>(a.hp);
  auto row_of = [&](int h) { return 16 * warp + g + 8 * h; };  // in the block
  auto at_of = [&](int tt, int h) { return ((size_t)tt * bp + b0 + row_of(h)) * n + unit; };
  // per row half h: the streams of the coming step (i, f, o, blk, gout,
  // c_{t-1}, as bf16 pairs) and its c_t
  uint32_t nxt[6][2][NTL], cw[2][NTL];
  auto prefetch = [&](int tt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = at_of(tt, h);
#pragma unroll
      for (int q = 0; q < 4; ++q) load_words<NTL>(nxt[q][h], static_cast<const bf16*>(a.res[q]) + at);
      load_words<NTL>(nxt[4][h], gout + at);
      if (tt > 0) load_words<NTL>(nxt[5][h], rc + at - (size_t)bp * n);
    }
  };
  for (int i = tid; i < 3 * U; i += NT) {
    const float* w = i < U ? a.wci : (i < 2 * U ? a.wcf : a.wco);
    pw[i] = w[u0 + i % U];
  }
#pragma unroll
  for (int q = 0; q < 3 * E; ++q) ps[q * NT] = 0.f;
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dcs[(h * E + e) * NT] = a.gclast[(size_t)(b0 + row_of(h)) * n + unit + e];
      load_words<NTL>(cw[h], rc + at_of(a.t - 1, h));
    }
    prefetch(a.t - 1);
  }
  __syncthreads();

  for (int s = 0; s < a.t; ++s) {
    const int tt = a.t - 1 - s;
    const bool has_next = tt + 1 < a.t;
    unsigned long long* st = TIMED ? a.stamps + ((size_t)blockIdx.x * a.t + s) * 4 : nullptr;
    if (TIMED && tid == 0) st[0] = st[1] = globaltimer();
    float acc[NTL][4];
    if (has_next) {
      dh_product<U, BB, TIMED>(acc, ring, W, LDR, dg + ((size_t)(tt + 1) * bp + b0) * G, G,
                               TIMED ? st + 1 : nullptr);
    } else {
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
    if (TIMED) {
      __syncthreads();
      if (tid == 0) st[2] = globaltimer();
    }
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t dw[4][NTL], hw[NTL];  // dg_t; h_prev of step tt + 1, o_t tanh(c_t)
#pragma unroll
        for (int wv = 0; wv < NTL; ++wv) {
          const float2 iv = unpack_bf16(nxt[0][h][wv]), fv = unpack_bf16(nxt[1][h][wv]);
          const float2 ov = unpack_bf16(nxt[2][h][wv]), bv = unpack_bf16(nxt[3][h][wv]);
          const float2 gv = unpack_bf16(nxt[4][h][wv]), cv = unpack_bf16(cw[h][wv]);
          const float2 pv = tt > 0 ? unpack_bf16(nxt[5][h][wv])
                                   : *reinterpret_cast<const float2*>(
                                         a.c0 + (size_t)(b0 + row_of(h)) * n + unit + 2 * wv);
          float da[4][2], hv[2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int e = 2 * wv + p;
            const float it = p ? iv.y : iv.x, ft = p ? fv.y : fv.x, ot = p ? ov.y : ov.x;
            const float bt = p ? bv.y : bv.x, ct = p ? cv.y : cv.x, cp = p ? pv.y : pv.x;
            const float th = tanhf(ct);
            const float dh = (p ? gv.y : gv.x) + acc[wv][2 * h + p];
            // the gate chain (`_bptt_gates`)
            const float dout = dh * th;
            const float da_o = dout * ot * (1.f - ot);
            const float* pu = pw + unit - u0 + e;  // this unit's wci (pu[U]: wcf, pu[2U]: wco)
            const float dcc = dh * ot * (1.f - th * th) + dcs[(h * E + e) * NT] + da_o * pu[2 * U];
            const float da_g = dcc * it * (1.f - bt * bt);
            const float da_i = dcc * bt * it * (1.f - it);
            const float da_f = dcc * cp * ft * (1.f - ft);
            dcs[(h * E + e) * NT] = dcc * ft + da_i * pu[0] + da_f * pu[U];
            ps[e * NT] += da_i * cp;
            ps[(E + e) * NT] += da_f * cp;
            ps[(2 * E + e) * NT] += da_o * ct;
            da[0][p] = da_i;
            da[1][p] = da_f;
            da[2][p] = da_o;
            da[3][p] = da_g;
            hv[p] = ot * th;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) dw[q][wv] = pack_bf16(da[q][0], da[q][1]);
          hw[wv] = pack_bf16(hv[0], hv[1]);
        }
        const size_t row = (size_t)tt * bp + b0 + row_of(h);
#pragma unroll
        for (int q = 0; q < 4; ++q) store_words<NTL>(dg + row * G + q * n + unit, dw[q]);
        if (has_next) store_words<NTL>(hp + at_of(tt + 1, h), hw);
      }
    }
    group_arrive(a.counter + bi);  // dg_t is out: the other blocks wait for it
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tt == 0) {
          uint32_t w[NTL];
          const size_t at = (size_t)(b0 + row_of(h)) * n + unit;
          load_words<NTL>(w, static_cast<const bf16*>(a.h0) + at);
          store_words<NTL>(hp + at, w);
        }
      }
      if (tt > 0) {  // the next step's c_t, then its streams
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int wv = 0; wv < NTL; ++wv) cw[h][wv] = nxt[5][h][wv];
        prefetch(tt - 1);
      }
    }
    if (TIMED) {
      __syncthreads();
      if (tid == 0) st[3] = globaltimer();
    }
    group_wait(a.counter + bi, (unsigned int)((s + 1) * nj));
  }

  // dh0 = dg_0 . Wr^T and dc0
  float acc[NTL][4];
  dh_product<U, BB, false>(acc, ring, W, LDR, dg + (size_t)b0 * G, G, nullptr);
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = (size_t)(b0 + row_of(h)) * n + unit;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        a.dh0[at + e] = acc[e / 2][2 * h + e % 2];
        a.dc0[at + e] = dcs[(h * E + e) * NT];
      }
    }
  }
  // peephole partials of this block: each unit's sums over the lanes of
  // its rows (g), then over the warps in order
  float psum[3][E];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      psum[q][e] = ps[(q * E + e) * NT];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        psum[q][e] += __shfl_xor_sync(0xffffffffu, psum[q][e], off);
    }
  float* red = reinterpret_cast<float*>(ring);  // [BB / 16][3][U]
  __syncthreads();  // the last product's reads of the ring are done
  if (active && g == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < E; ++e) red[(warp * 3 + q) * U + unit - u0 + e] = psum[q][e];
  }
  __syncthreads();
  for (int i = tid; i < 3 * U; i += NT) {
    const int q = i / U, u = i % U;
    float sum = 0.f;
    for (int w = 0; w < BB / 16; ++w) sum += red[(w * 3 + q) * U + u];
    a.partial[((size_t)bi * 3 + q) * n + u0 + u] = sum;
  }
}

// One kernel for both designs: T float (MAXB: the most rows a block may
// own) or bf16 (MAXB: exactly the rows it owns).
template <typename T, int U, int MAXB, bool TIMED = false>
__global__ void __launch_bounds__(NT, 1) lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 2) {
    sweep_mma<U, MAXB, TIMED>(a, smem);
  } else {
    static_assert(!TIMED, "the timer is built for the bf16 design");
    sweep_simt<U, MAXB>(a, smem);
  }
}

template <typename T, int U, int MAXB, bool TIMED = false>
int launch_sweep(const BwdArgs& args, cudaStream_t stream) {
  const size_t smem = sweep_smem<T, U>(args.n, args.BB);
  if (smem > SMEM_LIMIT || args.BB > MAXB || (sizeof(T) == 2 && args.BB != MAXB))
    return (int)cudaErrorInvalidValue;
  auto kernel = lstm_bwd_kernel<T, U, MAXB, TIMED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args.bp / args.BB) * (args.n / U));
  BwdArgs copy = args;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(NT), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the bf16 instantiation for the block's rows BB and units u
template <bool TIMED>
int launch_sweep_bf16(const BwdArgs& a, int u, cudaStream_t s) {
  switch (u * 1000 + a.BB) {
    case 32128: return launch_sweep<bf16, 32, 128, TIMED>(a, s);
    case 16128: return launch_sweep<bf16, 16, 128, TIMED>(a, s);
  }
  if constexpr (!TIMED) {  // the timer is built for 128-row blocks
    switch (u * 1000 + a.BB) {
      case 32064: return launch_sweep<bf16, 32, 64>(a, s);
      case 32032: return launch_sweep<bf16, 32, 32>(a, s);
      case 32016: return launch_sweep<bf16, 32, 16>(a, s);
      case 16064: return launch_sweep<bf16, 16, 64>(a, s);
      case 16032: return launch_sweep<bf16, 16, 32>(a, s);
      case 16016: return launch_sweep<bf16, 16, 16>(a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------- lstm_dw

struct DwArgs {
  const void* hp;        // [m, n]
  const void* dg;        // [m, 4n]
  const float* partial;  // [nb, 3, n]
  float* dwr;            // [n, 4n]
  float* dwci;           // [n] each
  float* dwcf;
  float* dwco;
  float* ws;             // [splits, n, 4n] (bf16, splits > 1): the splits' partial tiles
  unsigned int* tiles_done;  // [tiles] zeros (bf16, splits > 1)
  int m, n, nb, splits;
};

// dwci, dwcf, dwco of units [u0, u0 + count): the sweep's partials summed
// over the batch blocks in order
__device__ __forceinline__ void peephole_sums(const DwArgs& a, int u0, int count) {
  for (int i = threadIdx.x; i < 3 * count; i += NT) {
    const int g = i / count, u = u0 + i % count;
    if (u < a.n) {
      float acc = 0.f;
      for (int b = 0; b < a.nb; ++b) acc += a.partial[((size_t)b * 3 + g) * a.n + u];
      (g == 0 ? a.dwci : (g == 1 ? a.dwcf : a.dwco))[u] = acc;
    }
  }
}

// the bf16 GEMM (see the header): tiles of DW_TM units x DW_TN gate columns
constexpr int DW_TM = 128, DW_TN = 256, DW_STAGES = 3;
constexpr int DW_LDA = DW_TM + 8, DW_LDB = DW_TN + 8;  // bf16 row strides
constexpr size_t DW_STAGE_A = round128(sizeof(bf16) * (size_t)KC * DW_LDA);
constexpr size_t DW_STAGE_B = round128(sizeof(bf16) * (size_t)KC * DW_LDB);
constexpr size_t DW_MMA_SMEM = DW_STAGES * (DW_STAGE_A + DW_STAGE_B) + 128;

__device__ void dw_mma(const DwArgs& a, unsigned char* smem) {
  const int n = a.n, G = 4 * n, ntn = G / DW_TN;
  const int tiles = (n + DW_TM - 1) / DW_TM * ntn;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int r0 = tile / ntn * DW_TM, c0 = tile % ntn * DW_TN;
  const int nk = (a.m + KC - 1) / KC;
  const int k_begin = (int)((long long)split * nk / a.splits);
  const int k_end = (int)((long long)(split + 1) * nk / a.splits);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // the warp's 64 x 64: rows 64 wm, columns 64 wn
  const bf16* hp = static_cast<const bf16*>(a.hp);
  const bf16* dg = static_cast<const bf16*>(a.dg);
  auto As = [&](int st) { return reinterpret_cast<bf16*>(smem + st * DW_STAGE_A); };
  auto Bs = [&](int st) {
    return reinterpret_cast<bf16*>(smem + DW_STAGES * DW_STAGE_A + st * DW_STAGE_B);
  };
  auto fetch = [&](int kc) {  // rows [kc KC, +KC) of h_prev's and dg's tile columns
    const int m0 = kc * KC, st = (kc - k_begin) % DW_STAGES, rows = a.m - m0;
    issue_rows<KC, DW_LDA, DW_TM, true>(As(st), hp + (size_t)m0 * n + r0, n, rows, n - r0);
    issue_rows<KC, DW_LDB, DW_TN, true>(Bs(st), dg + (size_t)m0 * G + c0, G, rows, G - c0);
  };
#pragma unroll
  for (int q = 0; q < DW_STAGES - 1; ++q) {
    if (k_begin + q < k_end) fetch(k_begin + q);
    cp_async_commit();
  }
  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  // A = h_prev^T by ldmatrix.trans of the m-major chunk: rows (m) (lane %
  // 8) + 8 (lane / 16), columns (units) 8 ((lane / 8) % 2); B = dg by
  // ldmatrix.trans: rows (lane % 16), columns 8 (lane / 16)
  const int a_off = (lane % 8 + 8 * (lane / 16)) * DW_LDA + 64 * wm + 8 * (lane / 8 % 2);
  const int b_off = (lane % 16) * DW_LDB + 64 * wn + 8 * (lane / 16);
  for (int kc = k_begin; kc < k_end; ++kc) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();
    if (kc + DW_STAGES - 1 < k_end) fetch(kc + DW_STAGES - 1);
    cp_async_commit();
    const int st = (kc - k_begin) % DW_STAGES;
    const bf16* A = As(st) + a_off;
    const bf16* B = Bs(st) + b_off;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t af[4][4], bfr[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4_trans(af[mt], smem_addr(A + 16 * kk * DW_LDA + 16 * mt));
#pragma unroll
      for (int np = 0; np < 4; ++np) ldmatrix_x4_trans(bfr[np], smem_addr(B + 16 * kk * DW_LDB + 16 * np));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt / 2][2 * (nt % 2)], bfr[nt / 2][2 * (nt % 2) + 1]);
    }
  }
  cp_async_wait<0>();

  // the tile: row r0 + 64 wm + 16 mt + g + 8 h, column c0 + 64 wn + 8 nt + 2c
  auto store = [&](float* dst, auto value) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 64 * wm + 16 * mt + g + 8 * h;
        if (row < n) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const size_t at = (size_t)row * G + c0 + 64 * wn + 8 * nt + 2 * c;
            *reinterpret_cast<float2*>(dst + at) = value(mt, nt, h, at);
          }
        }
      }
  };
  const auto mine = [&](int mt, int nt, int h, size_t) {
    return make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  };
  if (a.splits > 1) {
    // the partial tile out; the last split of the tile to arrive sums
    // them all in split order (its own from registers)
    store(a.ws + (size_t)split * n * G, mine);
    __threadfence();
    __syncthreads();
    unsigned int* last = reinterpret_cast<unsigned int*>(smem + DW_MMA_SMEM - 128);
    if (tid == 0) *last = atomicAdd(a.tiles_done + tile, 1u) == (unsigned int)a.splits - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    store(a.dwr, [&](int mt, int nt, int h, size_t at) {
      float2 sum = make_float2(0.f, 0.f);
      for (int sp = 0; sp < a.splits; ++sp) {
        const float2 v = sp == split ? mine(mt, nt, h, at)
                                     : __ldcg(reinterpret_cast<const float2*>(
                                           a.ws + (size_t)sp * n * G + at));
        sum.x += v.x;
        sum.y += v.y;
      }
      return sum;
    });
  } else {
    store(a.dwr, mine);
  }
  if (tile % ntn == 0) peephole_sums(a, r0, DW_TM);
}

// the f32 design: one 64 x 64 tile of dWr per block on the CUDA cores
constexpr int DW_TILE = 64;
constexpr int DW_LDS = DW_TILE + 4;  // f32 row stride of both chunk tiles
constexpr size_t DW_CHUNK = round128(sizeof(float) * (size_t)KC * DW_LDS);
constexpr size_t DW_SIMT_SMEM = 4 * DW_CHUNK;  // two A, two B chunks

__device__ void dw_simt(const DwArgs& a, unsigned char* smem) {
  // chunk buffers: A = h_prev [KC rows][TILE units], B = dg [KC rows][TILE
  // gate columns]; the next pair is in flight while one is multiplied
  float* As[2] = {reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem + DW_CHUNK)};
  float* Bs[2] = {reinterpret_cast<float*>(smem + 2 * DW_CHUNK),
                  reinterpret_cast<float*>(smem + 3 * DW_CHUNK)};
  const int n = a.n, G = 4 * n, ncol = G / DW_TILE;
  const int rt = blockIdx.x / ncol, ct = blockIdx.x % ncol;
  const int r0 = rt * DW_TILE, c0 = ct * DW_TILE;
  const int tid = threadIdx.x;
  const float* hp = static_cast<const float*>(a.hp);
  const float* dg = static_cast<const float*>(a.dg);
  const int nk = (a.m + KC - 1) / KC;
  auto issue = [&](int kc) {
    const int m0 = kc * KC;
    issue_rows<KC, DW_LDS, DW_TILE, true>(As[kc & 1], hp + (size_t)m0 * n + r0, n, a.m - m0);
    issue_rows<KC, DW_LDS, DW_TILE, true>(Bs[kc & 1], dg + (size_t)m0 * G + c0, G, a.m - m0);
  };
  issue(0);
  cp_async_commit();
  const int tr = tid / 16, tc = tid % 16;  // a 4 x 4 micro tile each
  float acc[4][4] = {};
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) issue(kc + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* A = As[kc & 1];
    const float* Bm = Bs[kc & 1];
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = A[k * DW_LDS + tr * 4 + i];
        y[i] = Bm[k * DW_LDS + tc * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += x[i] * y[jj];
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      a.dwr[(size_t)(r0 + tr * 4 + i) * G + c0 + tc * 4 + jj] = acc[i][jj];
  if (ct == 0) peephole_sums(a, r0, DW_TILE);
}

// No minimum of blocks per SM: with one asked for, the f32 kernel took
// 103 registers and ran 7-10% slower than at 60 on an H100 (PERF.md).
template <typename T>
__global__ void __launch_bounds__(NT) lstm_dw_kernel(DwArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 2)
    dw_mma(a, smem);
  else
    dw_simt(a, smem);
}

template <typename T>
int launch_dw(const DwArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_dw_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lstm_dw_kernel<T><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

BwdArgs make_args(const void* i, const void* f, const void* o, const void* blk, const void* c,
                  const void* gout, const void* wr, const float* wci, const float* wcf,
                  const float* wco, const void* h0, const float* c0, const float* gclast,
                  void* dg, void* hp, float* dh0, float* dc0, float* partial,
                  unsigned int* counter, int t, int bp, int n, int bb) {
  BwdArgs a = {};
  a.res[0] = i; a.res[1] = f; a.res[2] = o; a.res[3] = blk; a.res[4] = c;
  a.gout = gout; a.wr = wr; a.wci = wci; a.wcf = wcf; a.wco = wco; a.h0 = h0; a.c0 = c0;
  a.gclast = gclast; a.dg = dg; a.hp = hp; a.dh0 = dh0; a.dc0 = dc0; a.partial = partial;
  a.counter = counter; a.t = t; a.bp = bp; a.n = n; a.BB = bb;
  return a;
}

bool shape_ok(const BwdArgs& a) {
  return a.t >= 1 && a.n % 64 == 0 && a.n <= 1024 && a.BB % 16 == 0 && a.BB >= 16 &&
         a.BB <= MAX_BB && a.bp % a.BB == 0 && a.counter != nullptr;
}

}  // namespace

// The sweep. All tensors contiguous and 16-byte aligned, batch padded
// to bp (a multiple of bb); bb rows and u units per block; dtype 0 =
// float32, 1 = bfloat16 (residuals, gout, wr, h0, dg, hp). Returns a
// cudaError_t (0 on success); a shape or layout the kernel is not built
// for returns cudaErrorInvalidValue, a grid that cannot be co-resident
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int dl4j_lstm_bwd(const void* i, const void* f, const void* o, const void* blk,
                             const void* c, const void* gout, const void* wr, const float* wci,
                             const float* wcf, const float* wco, const void* h0, const float* c0,
                             const float* gclast, void* dg, void* hp, float* dh0, float* dc0,
                             float* partial, unsigned int* counter, int t, int bp, int n, int bb,
                             int u, int dtype, void* stream) {
  const BwdArgs a = make_args(i, f, o, blk, c, gout, wr, wci, wcf, wco, h0, c0, gclast, dg, hp,
                              dh0, dc0, partial, counter, t, bp, n, bb);
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_sweep_bf16<false>(a, u, s);  // U >= 16: 8-unit tile pairs
  if (dtype == 0) {  // f32: the per-thread row arrays sized by BB
    const bool small = bb <= 32;
    if (u == 32) return small ? launch_sweep<float, 32, 32>(a, s) : launch_sweep<float, 32, MAX_BB>(a, s);
    if (u == 16) return small ? launch_sweep<float, 16, 32>(a, s) : launch_sweep<float, 16, MAX_BB>(a, s);
    if (u == 8) return small ? launch_sweep<float, 8, 32>(a, s) : launch_sweep<float, 8, MAX_BB>(a, s);
    if (u == 4) return small ? launch_sweep<float, 4, 32>(a, s) : launch_sweep<float, 4, MAX_BB>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dl4j_lstm_bwd's bf16 sweep with its step timer (bb 128 only): per
// block and step, the globaltimer (ns) after the barrier, after the last
// dg chunk landed, after the product and after the chain, its stores and
// the next step's prefetch, into stamps [grid, t, 4] (grid = (bp / bb) *
// (n / u)).
extern "C" int dl4j_lstm_bwd_timed(const void* i, const void* f, const void* o,
                                   const void* blk, const void* c, const void* gout,
                                   const void* wr, const float* wci, const float* wcf,
                                   const float* wco, const void* h0, const float* c0,
                                   const float* gclast, void* dg, void* hp, float* dh0,
                                   float* dc0, float* partial, unsigned int* counter,
                                   unsigned long long* stamps, int t, int bp, int n, int bb,
                                   int u, int dtype, void* stream) {
  BwdArgs a = make_args(i, f, o, blk, c, gout, wr, wci, wcf, wco, h0, c0, gclast, dg, hp, dh0,
                        dc0, partial, counter, t, bp, n, bb);
  a.stamps = stamps;
  if (dtype != 1 || stamps == nullptr || !shape_ok(a)) return (int)cudaErrorInvalidValue;
  return launch_sweep_bf16<true>(a, u, static_cast<cudaStream_t>(stream));
}

// The weight gradients: dwr [n, 4n] f32 from hp [m, n] and dg [m, 4n]
// (m = t * bp rows, the sweep's outputs), and the peephole gradients
// from the sweep's partials [nb, 3, n]. bf16: ``splits`` ranges of m
// (the caller's choice, about the card's SMs over the tiles), ws [splits,
// n, 4n] f32 and tiles_done [ceil(n / 128) * (4n / 256)] zeros where
// splits > 1; f32: splits 1 (ws and tiles_done unused).
extern "C" int dl4j_lstm_dw(const void* hp, const void* dg, const float* partial, float* dwr,
                            float* dwci, float* dwcf, float* dwco, float* ws,
                            unsigned int* tiles_done, int m, int n, int nb, int splits,
                            int dtype, void* stream) {
  if (m < 1 || n % 64 || n > 1024 || nb < 1 || splits < 1 || splits > (m + KC - 1) / KC)
    return (int)cudaErrorInvalidValue;
  DwArgs a = {hp, dg, partial, dwr, dwci, dwcf, dwco, ws, tiles_done, m, n, nb, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (splits > 1 && (ws == nullptr || tiles_done == nullptr)) return (int)cudaErrorInvalidValue;
    const int tiles = (n + DW_TM - 1) / DW_TM * (4 * n / DW_TN);
    return launch_dw<bf16>(a, dim3(tiles * splits), DW_MMA_SMEM, s);
  }
  if (dtype == 0 && splits == 1)
    return launch_dw<float>(a, dim3((n / DW_TILE) * (4 * n / DW_TILE)), DW_SIMT_SMEM, s);
  return (int)cudaErrorInvalidValue;
}
