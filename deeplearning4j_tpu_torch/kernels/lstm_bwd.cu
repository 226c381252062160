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
// The f32 sweep (sweep_simt; the char-RNN example's f32 training at b 64,
// n 256, and phase 2b's b 32, n 512): full f32 FMAs on the CUDA cores, no
// TF32. The first design did as the bf16 one, each block pulling its
// group's whole dg_{t+1} [BB][4n] through 64-deep chunks for its U rows of
// Wr: 32 dependent rounds a step at n 512, 93 % of a 47 us step on an H100
// (PERF.md).
// This one turns the product around, as the f32 forward keeps Wr:
// - Block j keeps Wr's 4U columns of its own units resident, transposed
//   (Wt [4U][n]), runs the chain for its (row, unit) pairs, and then
//   multiplies the dg_t it has just computed ([BB][4U], in shared memory)
//   by Wt: a [BB][n] partial of dh_{t-1} for every unit, depth 4U, in
//   8 x 8 register tiles fed by 16-byte shared loads (SweepF32). It stores
//   each owner's [BB][U] share of it and arrives at the barrier.
// - After the barrier, a block sums the nj partials of its own units (the
//   batch group's, in block order, by groups of threads, then the groups
//   in order: the same bits every call) into dh for its chain.
// - Per step a block moves 2 BB n floats (64 KB out and 64 KB in at BB 32,
//   n 512) instead of BB 4n in (256 KB), with one barrier per step; the
//   dg stores leave the critical path (only lstm_dw reads them).
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
// it is bitwise the same on every run. The f32 kernel (dw_simt) is the
// same GEMM on the CUDA cores: 128 x 128 tiles, an 8 x 8 register tile a
// thread fed by 16-byte shared loads, m split and summed as bf16's. The
// block that
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
// In f32 (b 32, t 128, n 512) both kernels are bound by their 8.6 GFLOP
// (0.128 ms at 67 TFLOP/s). The sweep's step takes ~6.45 us on an H100
// (PERF.md): the product with the partials' stores ~2.95 (its FMAs ~1),
// the barrier ~1.8 (its release waits for the 8 MB of stores over the
// card), the sums ~1.4, the chain ~0.3; summing the partials within a
// cluster first is the next step. lstm_dw runs at ~0.21 ms.
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
  float* dhp;           // f32: [2][bp / BB][nj][nj][BB][U], the dh partials
  unsigned long long* stamps;  // [grid, t, 4] (timed variant)
  int t, bp, n, BB;
};

// the bf16 sweep's row stride of its resident W rows (4n columns)
__host__ __device__ constexpr int ldr_bf16(int n) { return 4 * n + 8; }

// How the f32 sweep's block of BB rows and U units shares its work.
// - The chain: PAIRS (row, unit) pairs per thread, all of one unit (tid
//   % U), rows (q NT + tid) / U; the first CELLERS threads take part. A
//   thread of at most 4 pairs has its next step's streams in flight
//   ahead (AHEAD), else it loads them in the chain, 4 pairs at a time.
// - The dh sums: the [BB][U] sums of the block's rows and units, as NQ
//   4-unit quads, each summed over the nj partials of the batch group by
//   JG groups of threads (a contiguous share of the partials each, in
//   order), QPT quads a thread; the chain adds the JG group sums in order.
// - The product: thread (rg, vg) = (tid % RG, tid / RG) owns an 8 x 8
//   register tile of dh's partial [BB][n]: rows rg + RG i (i < 8) and
//   units p + 4 vg + k, p + PW / 2 + 4 vg + k (k < 4) of each PW-wide
//   pass p over n; its 8 rows sit side by side in dgs (dg_pos), so both
//   operands come as 16-byte shared loads of neighbouring addresses.
template <int BB, int U> struct SweepF32 {
  static constexpr int PAIRS = BB * U > NT ? BB * U / NT : 1;
  static constexpr int CELLERS = BB * U < NT ? BB * U : NT;
  static constexpr bool AHEAD = PAIRS <= 4;
  static constexpr int QB = AHEAD ? PAIRS : 4;  // pairs whose streams fly together
  static constexpr int NQ = BB * U / 4;
  static constexpr int JG = NQ >= NT ? 1 : NT / NQ;
  static constexpr int QPT = NQ >= NT ? NQ / NT : 1;
  static constexpr int RG = BB / 8;
  static constexpr int PW = 8 * (NT / RG);
  static constexpr int LDG = BB + 4;        // dgs row stride (floats)
  static constexpr int RED = JG * BB * U;   // floats of the groups' sums
  static_assert(BB % 16 == 0 && U % 4 == 0 && NT % U == 0 && PAIRS % QB == 0 &&
                    (NQ >= NT ? QPT * NT == NQ : JG * NQ == NT),
                "f32 sweep layout");
};

// The place of row r among dgs's columns: the rows rg + RG i of a product
// tile (rg = r % RG) side by side, i < 4 at 4 rg + i, i >= 4 at BB / 2 +
// 4 rg + i - 4.
template <int BB> __device__ __forceinline__ int dg_pos(int r) {
  constexpr int RG = BB / 8;
  const int i = r / RG;
  return (i < 4 ? 0 : BB / 2 - 4) + 4 * (r % RG) + i;
}

// Shared memory of the f32 sweep: Wt [4U][n], dgs [4U][LDG] and the
// groups' sums [JG][BB][U].
template <int U> __host__ __device__ constexpr size_t f32_wt_bytes(int n) {
  return round128(sizeof(float) * 4 * U * (size_t)n);
}
template <int U, int BB> __host__ __device__ constexpr size_t f32_dgs_bytes() {
  return round128(sizeof(float) * 4 * U * SweepF32<BB, U>::LDG);
}

template <typename T, int U, int BB>
size_t sweep_smem(int n) {
  if constexpr (sizeof(T) == 2) {  // W, the ring, the block's peephole weights and each thread's sums
    return round128(sizeof(bf16) * (size_t)U * ldr_bf16(n)) +
           BWD_STAGES * round128(sizeof(bf16) * (size_t)BB * lda<bf16>()) +
           round128(sizeof(float) * 3 * U) + sizeof(float) * 5 * (U / 4) * NT;
  } else {
    return f32_wt_bytes<U>(n) + f32_dgs_bytes<U, BB>() +
           sizeof(float) * SweepF32<BB, U>::RED;
  }
}

__device__ __forceinline__ void fma8x4(float (&acc)[8][8], int h, const float4& a0,
                                       const float4& a1, const float4& w) {
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i][4 * h] = fmaf(av[i], w.x, acc[i][4 * h]);
    acc[i][4 * h + 1] = fmaf(av[i], w.y, acc[i][4 * h + 1]);
    acc[i][4 * h + 2] = fmaf(av[i], w.z, acc[i][4 * h + 2]);
    acc[i][4 * h + 3] = fmaf(av[i], w.w, acc[i][4 * h + 3]);
  }
}

// The f32 design (see the header): a block of exactly BB rows. Step s
// (tt = t - 1 - s) waits for the batch group's partials of step s - 1,
// sums this block's share of them (dh_rec of its rows and units), runs
// the chain on it, then multiplies its dg_tt [BB][4U] by its resident Wt
// into a partial of dh for all n units, stored for their owners, and
// arrives; a last round of sums gives dh0. The partials live in
// a.dhp, [2][bp / BB][nj][nj][BB][U] (buffer s % 2, batch group, owner
// block, writing block): a block overwrites a buffer two steps later,
// after every block of its group has read it. TIMED stamps the
// globaltimer per step (thread 0) after the barrier, after the sums,
// after the chain and its stores, and after the product and its stores.
template <int U, int BB, bool TIMED>
__device__ void sweep_simt(const BwdArgs& a, unsigned char* smem) {
  using L = SweepF32<BB, U>;
  constexpr int PAIRS = L::PAIRS, QB = L::QB, NQ = L::NQ, JG = L::JG, RG = L::RG;
  constexpr int PW = L::PW, LDG = L::LDG;
  const int n = a.n, bp = a.bp, G = 4 * n, t = a.t;
  float* Wt = reinterpret_cast<float*>(smem);
  float* dgs = reinterpret_cast<float*>(smem + f32_wt_bytes<U>(n));
  float* red = reinterpret_cast<float*>(smem + f32_wt_bytes<U>(n) + f32_dgs_bytes<U, BB>());

  const int nj = n / U;
  const int bi = blockIdx.x / nj, j = blockIdx.x % nj;
  const int b0 = bi * BB, u0 = j * U;
  const int tid = threadIdx.x;
  // one step's partials of this batch group (BB n nj floats): owner jo's
  // nj partials of [BB][U] side by side
  auto partials = [&](int s) {
    return a.dhp + ((size_t)(s & 1) * (bp / BB) + bi) * ((size_t)BB * n * nj);
  };

  // resident: Wt[q U + u][v] = Wr[v][q n + u0 + u], the 4U columns of Wr
  // for the block's units, transposed (16-byte pieces of 4 units in)
  {
    const float* wr = static_cast<const float*>(a.wr);
    for (int i = tid; i < n * U; i += NT) {
      const int v = i / U, c = 4 * (i % U);  // column c of the 4U: gate c / U, unit c % U
      const float4 w = __ldg(reinterpret_cast<const float4*>(wr + (size_t)v * G + c / U * n + u0 + c % U));
      float* dst = Wt + (size_t)c * n + v;
      dst[0] = w.x;
      dst[n] = w.y;
      dst[2 * n] = w.z;
      dst[3 * n] = w.w;
    }
  }

  const float *ri = static_cast<const float*>(a.res[0]), *rf = static_cast<const float*>(a.res[1]),
              *ro = static_cast<const float*>(a.res[2]), *rb = static_cast<const float*>(a.res[3]),
              *rc = static_cast<const float*>(a.res[4]), *gout = static_cast<const float*>(a.gout),
              *h0 = static_cast<const float*>(a.h0);
  float* dg = static_cast<float*>(a.dg);
  float* hp = static_cast<float*>(a.hp);
  const int cu = tid % U;  // the chain's unit
  const bool celler = tid < L::CELLERS;
  auto row_of = [&](int q) { return (q * NT + tid) / U; };  // in the block
  // a pair's streams of step tt: i, f, o, blk, gout, c_{tt-1} (c0 at 0)
  auto load = [&](float (&v)[6], int tt, int q) {
    const int r = row_of(q);
    const size_t at = ((size_t)tt * bp + b0 + r) * n + u0 + cu;
    v[0] = __ldg(ri + at);
    v[1] = __ldg(rf + at);
    v[2] = __ldg(ro + at);
    v[3] = __ldg(rb + at);
    v[4] = __ldg(gout + at);
    v[5] = __ldg(tt > 0 ? rc + at - (size_t)bp * n : a.c0 + (size_t)(b0 + r) * n + u0 + cu);
  };
  float wci = 0.f, wcf = 0.f, wco = 0.f;
  // per pair: the dc carry and c_t of the coming step; the peephole sums
  // of the thread's pairs (one unit) over its steps
  float dc[PAIRS], cc[PAIRS], pi = 0.f, pf = 0.f, po = 0.f;
  float nx[L::AHEAD ? PAIRS : 1][6];  // the coming step's streams (AHEAD)
  if (celler) {
    wci = a.wci[u0 + cu];
    wcf = a.wcf[u0 + cu];
    wco = a.wco[u0 + cu];
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const size_t at = (size_t)(b0 + row_of(q)) * n + u0 + cu;
      dc[q] = a.gclast[at];
      cc[q] = __ldg(rc + (size_t)(t - 1) * bp * n + at);
      if (L::AHEAD) load(nx[L::AHEAD ? q : 0], t - 1, q);
    }
  }
  // this block's dh sums of a step's partials into red[jg][BB][U]
  auto sum_partials = [&](const float* P) {
    const float4* src = reinterpret_cast<const float4*>(P + (size_t)j * BB * n);
    const int jg = NQ >= NT ? 0 : tid / NQ;
    const int j0 = jg * nj / JG, j1 = (jg + 1) * nj / JG;
#pragma unroll
    for (int qi = 0; qi < L::QPT; ++qi) {
      const int qd = (NQ >= NT ? tid : tid % NQ) + qi * NT;
      const float4* p = src + (size_t)j0 * NQ + qd;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
      for (int jj = j0; jj < j1; ++jj, p += NQ) {
        const float4 v = __ldcg(p);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      reinterpret_cast<float4*>(red)[jg * NQ + qd] = acc;
    }
  };
  auto dh_sum = [&](int r) {  // the groups' sums of (r, cu) in order
    float x = 0.f;
#pragma unroll
    for (int g = 0; g < JG; ++g) x += red[(g * BB + r) * U + cu];
    return x;
  };
  __syncthreads();

  for (int s = 0;; ++s) {
    unsigned long long* st = TIMED ? a.stamps + ((size_t)blockIdx.x * t + (s < t ? s : 0)) * 4 : nullptr;
    if (s > 0) {
      group_wait(a.counter + bi, (unsigned int)(s * nj));
      if (TIMED && s < t && tid == 0) st[0] = globaltimer();
      sum_partials(partials(s - 1));
      __syncthreads();
    } else if (TIMED && tid == 0) {
      st[0] = globaltimer();
    }
    if (s == t) break;
    if (TIMED && tid == 0) st[1] = globaltimer();
    const int tt = t - 1 - s;

    // the chain per pair: dh = gout + the sums (none at the last step)
    if (celler) {
#pragma unroll
      for (int q0 = 0; q0 < PAIRS; q0 += QB) {
        float ld[L::AHEAD ? 1 : QB][6];
        if (!L::AHEAD) {
#pragma unroll
          for (int jj = 0; jj < QB; ++jj) load(ld[L::AHEAD ? 0 : jj], tt, q0 + jj);
        }
#pragma unroll
        for (int jj = 0; jj < QB; ++jj) {
          const int q = q0 + jj, r = row_of(q);
          const float* v = L::AHEAD ? nx[L::AHEAD ? q : 0] : ld[L::AHEAD ? 0 : jj];
          const float it = v[0], ft = v[1], ot = v[2], bt = v[3], cp = v[5], ct = cc[q];
          const float th = tanhf(ct);
          const float dh = v[4] + (s > 0 ? dh_sum(r) : 0.f);
          // the gate chain (`_bptt_gates`)
          const float dout = dh * th;
          const float da_o = dout * ot * (1.f - ot);
          const float dcc = dh * ot * (1.f - th * th) + dc[q] + da_o * wco;
          const float da_g = dcc * it * (1.f - bt * bt);
          const float da_i = dcc * bt * it * (1.f - it);
          const float da_f = dcc * cp * ft * (1.f - ft);
          dc[q] = dcc * ft + da_i * wci + da_f * wcf;
          const size_t row = (size_t)tt * bp + b0 + r;
          float* d = dg + row * G + u0 + cu;
          d[0] = da_i;
          d[n] = da_f;
          d[2 * n] = da_o;
          d[3 * n] = da_g;
          float* ds = dgs + cu * LDG + dg_pos<BB>(r);
          ds[0] = da_i;
          ds[U * LDG] = da_f;
          ds[2 * U * LDG] = da_o;
          ds[3 * U * LDG] = da_g;
          pi += da_i * cp;
          pf += da_f * cp;
          po += da_o * ct;
          const size_t at = row * n + u0 + cu;
          if (tt + 1 < t) hp[at + (size_t)bp * n] = ot * th;
          if (tt == 0) hp[at] = h0[at];
          cc[q] = cp;
        }
      }
      if (L::AHEAD && tt > 0) {  // in flight under the product and the barrier
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) load(nx[L::AHEAD ? q : 0], tt - 1, q);
      }
    }
    __syncthreads();  // dgs is whole
    if (TIMED && tid == 0) st[2] = globaltimer();

    // the partial of dh: dg_tt [BB][4U] . Wt [4U][n], for every unit's owner
    {
      const int rg = tid % RG, vg = tid / RG;
      const float4* A = reinterpret_cast<const float4*>(dgs) + rg;
      float* P = partials(s) + (size_t)j * BB * U;  // + owner jo's offset jo nj BB U
      for (int p0 = 0; p0 < n; p0 += PW) {
        int v[2] = {p0 + 4 * vg, p0 + PW / 2 + 4 * vg};
        const bool ok[2] = {v[0] < n, v[1] < n};
        v[0] = ok[0] ? v[0] : 0;  // a half past n reads unit 0 and stores nothing
        v[1] = ok[1] ? v[1] : 0;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
        const float* w0 = Wt + v[0];
        const float* w1 = Wt + v[1];
#pragma unroll 4
        for (int c = 0; c < 4 * U; ++c) {
          const float4 a0 = A[c * (LDG / 4)], a1 = A[c * (LDG / 4) + BB / 8];
          fma8x4(acc, 0, a0, a1, *reinterpret_cast<const float4*>(w0 + (size_t)c * n));
          fma8x4(acc, 1, a0, a1, *reinterpret_cast<const float4*>(w1 + (size_t)c * n));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ok[h]) {
            float* dst = P + (size_t)(v[h] / U) * nj * BB * U + v[h] % U;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              __stcg(reinterpret_cast<float4*>(dst + (size_t)(rg + RG * i) * U),
                     make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                 acc[i][4 * h + 3]));
          }
        }
      }
    }
    if (TIMED) {
      __syncthreads();
      if (tid == 0) st[3] = globaltimer();
    }
    group_arrive(a.counter + bi);  // the partials are out: the owners wait for them
  }

  // dh0 = dg_0 . Wr^T (the last sums) and dc0
  if (celler) {
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const int r = row_of(q);
      const size_t at = (size_t)(b0 + r) * n + u0 + cu;
      a.dh0[at] = dh_sum(r);
      a.dc0[at] = dc[q];
    }
  }
  // peephole partials of this block: the sums of a unit's threads, in
  // thread order (in row order where a thread has one pair)
  for (int g = 0; g < 3; ++g) {
    __syncthreads();
    if (celler) red[tid] = g == 0 ? pi : (g == 1 ? pf : po);
    __syncthreads();
    if (tid < U) {
      float acc = 0.f;
      for (int k = tid; k < L::CELLERS; k += U) acc += red[k];
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
  const int n = a.n, bp = a.bp, G = 4 * n, LDR = ldr_bf16(n);
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

// One kernel for both designs: a block of exactly BB rows of U units,
// the residuals' element type T.
template <typename T, int U, int BB, bool TIMED = false>
__global__ void __launch_bounds__(NT, 1) lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 2) {
    sweep_mma<U, BB, TIMED>(a, smem);
  } else {
    sweep_simt<U, BB, TIMED>(a, smem);
  }
}

template <typename T, int U, int BB, bool TIMED = false>
int launch_sweep(const BwdArgs& args, cudaStream_t stream) {
  const size_t smem = sweep_smem<T, U, BB>(args.n);
  if (smem > SMEM_LIMIT || args.BB != BB || (sizeof(T) == 4 && args.dhp == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = lstm_bwd_kernel<T, U, BB, TIMED>;
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

// the f32 instantiation for the block's rows BB and units u: every layout
// the wrapper's _block_shape gives (16 and 32 units only in 128-row
// blocks); the timer at 4 units of 32 and 64 rows
template <bool TIMED>
int launch_sweep_f32(const BwdArgs& a, int u, cudaStream_t s) {
  switch (u * 1000 + a.BB) {
    case 4032: return launch_sweep<float, 4, 32, TIMED>(a, s);
    case 4064: return launch_sweep<float, 4, 64, TIMED>(a, s);
  }
  if constexpr (!TIMED) {
    switch (u * 1000 + a.BB) {
      case 4016: return launch_sweep<float, 4, 16>(a, s);
      case 4128: return launch_sweep<float, 4, 128>(a, s);
      case 8016: return launch_sweep<float, 8, 16>(a, s);
      case 8032: return launch_sweep<float, 8, 32>(a, s);
      case 8064: return launch_sweep<float, 8, 64>(a, s);
      case 8128: return launch_sweep<float, 8, 128>(a, s);
      case 16128: return launch_sweep<float, 16, 128>(a, s);
      case 32128: return launch_sweep<float, 32, 128>(a, s);
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
  float* ws;             // [splits, n, 4n] (splits > 1): the splits' partial tiles
  unsigned int* tiles_done;  // [tiles] zeros (splits > 1)
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

// Once a split has stored its partial tile to ws: whether this block is
// the tile's last split to arrive, which sums them all (every split's
// partial is then visible to it). flag: a word of shared memory.
__device__ __forceinline__ bool last_split(const DwArgs& a, int tile, unsigned int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(a.tiles_done + tile, 1u) == (unsigned int)a.splits - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
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
    if (!last_split(a, tile, reinterpret_cast<unsigned int*>(smem + DW_MMA_SMEM - 128))) return;
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

// the f32 design: tiles of DWF_T units x DWF_T gate columns on the CUDA
// cores, fed by a DWF_STAGES-stage cp.async ring of DWF_KD-row chunks of
// h_prev and dg (both m-major: all threads read one chunk row at a time)
constexpr int DWF_T = 128, DWF_KD = 32, DWF_STAGES = 3;
constexpr size_t DWF_CHUNK = round128(sizeof(float) * (size_t)DWF_KD * DWF_T);
constexpr size_t DWF_SMEM = DWF_STAGES * 2 * DWF_CHUNK + 128;

// A tile's m range split as dw_mma's: each split's 128 x 128 partial to
// ws, the last split of the tile to finish sums them in split order.
// Thread (ty, tx) = (tid / 16, tid % 16) owns an 8 x 8 register tile:
// rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + k and 64 + 4 tx + k
// (i, k < 4), so that a warp's 16-byte shared loads of a chunk row fall
// on neighbouring addresses (4 per 64 FMAs).
__device__ void dw_simt(const DwArgs& a, unsigned char* smem) {
  const int n = a.n, G = 4 * n, ntn = G / DWF_T;
  const int tiles = (n + DWF_T - 1) / DWF_T * ntn;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int r0 = tile / ntn * DWF_T, c0 = tile % ntn * DWF_T;
  const int nk = (a.m + DWF_KD - 1) / DWF_KD;
  const int k_begin = (int)((long long)split * nk / a.splits);
  const int k_end = (int)((long long)(split + 1) * nk / a.splits);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* hp = static_cast<const float*>(a.hp);
  const float* dg = static_cast<const float*>(a.dg);
  auto As = [&](int st) { return reinterpret_cast<float*>(smem + 2 * st * DWF_CHUNK); };
  auto Bs = [&](int st) { return reinterpret_cast<float*>(smem + (2 * st + 1) * DWF_CHUNK); };
  auto fetch = [&](int kc) {  // rows [kc KD, +KD) of h_prev's and dg's tile columns
    const int m0 = kc * DWF_KD, st = (kc - k_begin) % DWF_STAGES, rows = a.m - m0;
    issue_rows<DWF_KD, DWF_T, DWF_T, true>(As(st), hp + (size_t)m0 * n + r0, n, rows, n - r0);
    issue_rows<DWF_KD, DWF_T, DWF_T, true>(Bs(st), dg + (size_t)m0 * G + c0, G, rows);
  };
#pragma unroll
  for (int q = 0; q < DWF_STAGES - 1; ++q) {
    if (k_begin + q < k_end) fetch(k_begin + q);
    cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
  for (int kc = k_begin; kc < k_end; ++kc) {
    cp_async_wait<DWF_STAGES - 2>();  // this thread's copies of chunk kc landed
    __syncthreads();                  // everyone's did; chunk kc - 1 is read
    if (kc + DWF_STAGES - 1 < k_end) fetch(kc + DWF_STAGES - 1);
    cp_async_commit();
    const int st = (kc - k_begin) % DWF_STAGES;
    const float* A = As(st) + 4 * ty;
    const float* B = Bs(st) + 4 * tx;
#pragma unroll 4
    for (int k = 0; k < DWF_KD; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + k * DWF_T);
      const float4 a1 = *reinterpret_cast<const float4*>(A + k * DWF_T + 64);
      fma8x4(acc, 0, a0, a1, *reinterpret_cast<const float4*>(B + k * DWF_T));
      fma8x4(acc, 1, a0, a1, *reinterpret_cast<const float4*>(B + k * DWF_T + 64));
    }
  }
  cp_async_wait<0>();

  // the tile: row r0 + 4 ty + (i < 4 ? i : 60 + i), columns c0 + 64 h + 4 tx + [0, 4)
  auto store = [&](float* dst, auto value) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + 4 * ty + (i < 4 ? i : 60 + i);
      if (row < n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t at = (size_t)row * G + c0 + 64 * h + 4 * tx;
          *reinterpret_cast<float4*>(dst + at) = value(i, h, at);
        }
      }
    }
  };
  const auto mine = [&](int i, int h, size_t) {
    return make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  };
  if (a.splits > 1) {
    store(a.ws + (size_t)split * n * G, mine);
    if (!last_split(a, tile, reinterpret_cast<unsigned int*>(smem + DWF_SMEM - 128))) return;
    // the splits' partials summed in split order (its own from registers),
    // a split's 8 rows of one column half at a time, their loads in
    // flight together (one at a time, the sum waited on each load)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 sum[8];
      for (int sp = 0; sp < a.splits; ++sp) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = r0 + 4 * ty + (i < 4 ? i : 60 + i);
          const size_t at = (size_t)(row < n ? row : 0) * G + c0 + 64 * h + 4 * tx;
          const float4 v = sp == split ? mine(i, h, at)
                                       : __ldcg(reinterpret_cast<const float4*>(
                                             a.ws + (size_t)sp * n * G + at));
          if (sp == 0) {
            sum[i] = v;
          } else {
            sum[i].x += v.x;
            sum[i].y += v.y;
            sum[i].z += v.z;
            sum[i].w += v.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + 4 * ty + (i < 4 ? i : 60 + i);
        if (row < n)
          *reinterpret_cast<float4*>(a.dwr + (size_t)row * G + c0 + 64 * h + 4 * tx) = sum[i];
      }
    }
  } else {
    store(a.dwr, mine);
  }
  if (tile % ntn == 0) peephole_sums(a, r0, DWF_T);
}

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
                  unsigned int* counter, float* dhp, int t, int bp, int n, int bb) {
  BwdArgs a = {};
  a.res[0] = i; a.res[1] = f; a.res[2] = o; a.res[3] = blk; a.res[4] = c;
  a.gout = gout; a.wr = wr; a.wci = wci; a.wcf = wcf; a.wco = wco; a.h0 = h0; a.c0 = c0;
  a.gclast = gclast; a.dg = dg; a.hp = hp; a.dh0 = dh0; a.dc0 = dc0; a.partial = partial;
  a.counter = counter; a.dhp = dhp; a.t = t; a.bp = bp; a.n = n; a.BB = bb;
  return a;
}

bool shape_ok(const BwdArgs& a) {
  return a.t >= 1 && a.n % 64 == 0 && a.n <= 1024 && a.BB % 16 == 0 && a.BB >= 16 &&
         a.BB <= MAX_BB && a.bp % a.BB == 0 && a.counter != nullptr;
}

}  // namespace

// The sweep. All tensors contiguous and 16-byte aligned, batch padded
// to bp (a multiple of bb); bb rows and u units per block; dtype 0 =
// float32, 1 = bfloat16 (residuals, gout, wr, h0, dg, hp); dhp, the f32
// sweep's scratch of 2 bp (n / u) n floats (null for bf16). Returns a
// cudaError_t (0 on success); a shape or layout the kernel is not built
// for returns cudaErrorInvalidValue, a grid that cannot be co-resident
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int dl4j_lstm_bwd(const void* i, const void* f, const void* o, const void* blk,
                             const void* c, const void* gout, const void* wr, const float* wci,
                             const float* wcf, const float* wco, const void* h0, const float* c0,
                             const float* gclast, void* dg, void* hp, float* dh0, float* dc0,
                             float* partial, unsigned int* counter, float* dhp, int t, int bp,
                             int n, int bb, int u, int dtype, void* stream) {
  const BwdArgs a = make_args(i, f, o, blk, c, gout, wr, wci, wcf, wco, h0, c0, gclast, dg, hp,
                              dh0, dc0, partial, counter, dhp, t, bp, n, bb);
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_sweep_bf16<false>(a, u, s);  // U >= 16: 8-unit tile pairs
  if (dtype == 0) return launch_sweep_f32<false>(a, u, s);
  return (int)cudaErrorInvalidValue;
}

// dl4j_lstm_bwd with the sweep's step timer (bf16: bb 128; f32: u 4, bb
// 32 or 64): per block and step, the globaltimer (ns) at four points
// into stamps [grid, t, 4] (grid = (bp / bb) * (n / u)). bf16: after the
// barrier, after the last dg chunk landed, after the product and after
// the chain, its stores and the next step's prefetch; f32: after the
// barrier, after the dh sums, after the chain and its stores and after
// the product and its stores.
extern "C" int dl4j_lstm_bwd_timed(const void* i, const void* f, const void* o,
                                   const void* blk, const void* c, const void* gout,
                                   const void* wr, const float* wci, const float* wcf,
                                   const float* wco, const void* h0, const float* c0,
                                   const float* gclast, void* dg, void* hp, float* dh0,
                                   float* dc0, float* partial, unsigned int* counter, float* dhp,
                                   unsigned long long* stamps, int t, int bp, int n, int bb,
                                   int u, int dtype, void* stream) {
  BwdArgs a = make_args(i, f, o, blk, c, gout, wr, wci, wcf, wco, h0, c0, gclast, dg, hp, dh0,
                        dc0, partial, counter, dhp, t, bp, n, bb);
  a.stamps = stamps;
  if (stamps == nullptr || !shape_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_sweep_bf16<true>(a, u, s);
  if (dtype == 0) return launch_sweep_f32<true>(a, u, s);
  return (int)cudaErrorInvalidValue;
}

// The weight gradients: dwr [n, 4n] f32 from hp [m, n] and dg [m, 4n]
// (m = t * bp rows, the sweep's outputs), and the peephole gradients
// from the sweep's partials [nb, 3, n]: ``splits`` ranges of m (the
// caller's choice, about the card's SMs over the tiles), ws [splits, n,
// 4n] f32 and tiles_done [tiles] zeros where splits > 1 (tiles: ceil(n /
// 128) * (4n / 256) in bf16, ceil(n / 128) * (4n / 128) in f32).
extern "C" int dl4j_lstm_dw(const void* hp, const void* dg, const float* partial, float* dwr,
                            float* dwci, float* dwcf, float* dwco, float* ws,
                            unsigned int* tiles_done, int m, int n, int nb, int splits,
                            int dtype, void* stream) {
  if (m < 1 || n % 64 || n > 1024 || nb < 1 || splits < 1 || splits > (m + KC - 1) / KC)
    return (int)cudaErrorInvalidValue;
  DwArgs a = {hp, dg, partial, dwr, dwci, dwcf, dwco, ws, tiles_done, m, n, nb, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1 || (splits > 1 && (ws == nullptr || tiles_done == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const int tiles = (n + DW_TM - 1) / DW_TM * (4 * n / DW_TN);
    return launch_dw<bf16>(a, dim3(tiles * splits), DW_MMA_SMEM, s);
  }
  const int tiles = (n + DWF_T - 1) / DWF_T * (4 * n / DWF_T);
  return launch_dw<float>(a, dim3(tiles * splits), DWF_SMEM, s);
}
