// Graves-LSTM scan forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/lstm_kernel.py
// `_fwd_pallas` -> `_fwd_kernel` (with residuals, for training) and
// `_fwd_only_kernel` (inference), which share the cell `_cell`: over
// pre-projected gates xg [t, b, 4n] (gate order i, f, o, blk), per step
//   g = f32(xg_t) + h_{t-1} . Wr          (f32 accumulation)
//   i = sig(g_i + c_{t-1} wci), f = sig(g_f + c_{t-1} wcf), blk = tanh(g_blk)
//   c_t = f c_{t-1} + i blk,  o = sig(g_o + c_t wco),  h_t = o tanh(c_t)
// with the h carry rounded to xg's dtype every step and the c carry in
// f32. `lstm_fwd` streams h and the residuals i, f, o, blk, c (xg's
// dtype); `lstm_fwd_only` streams h and writes h_T (xg's dtype) and c_T
// (f32) at the last step. Both are instantiations of one kernel.
//
// Layout. On the TPU the whole [n, 4n] Wr stays in VMEM across the
// sequential t axis; on Hopper it does not fit one SM (2 MB at n = 512 in
// bf16). So one persistent cooperative launch covers the whole sequence
// (at t = 1, a plain launch: no barrier, no counter):
// block (bi, j) owns batch rows [bi BB, +BB) and hidden units [j U, +U),
// keeps the 4U columns of Wr for those units resident in shared memory
// (~140 KB; the wrapper narrows U, down to 16 in bf16 and 4 in f32, where
// a small batch would leave most SMs idle) and its slice of the f32 c
// carry in registers, and loops over t inside the kernel. Per step it
// reads the h_{t-1} rows of its batch block from h_seq[t-1] (written by
// the other blocks of its group in the step before; L2-resident),
// multiplies them by its resident columns, applies the cell and writes
// its slice of h_seq[t] and the streams. A counter barrier per batch
// group separates the steps; writing h_t into h_seq[t] while others read
// h_seq[t - 1] needs no double buffer.
//
// bf16 (the training and bf16 inference paths): mma.sync m16n8k16 with
// the cell applied on the accumulators (fwd_mma).
// - The 8 warps split the block's rows and units (WarpLayout: 4 row
//   groups x 2 unit groups at BB 128, U 32: 32 rows x 16 units each), so
//   no warp reads the whole W slice per step.
// - A fragments come by ldmatrix from a ring of 3 stages of 64-deep
//   h_{t-1} chunks (cp.async, 2 in flight, one __syncthreads per chunk,
//   the first issued as the barrier opens); B fragments by ldmatrix.trans
//   from the resident W.
// - W's columns are gate-major and ordered so that the i, f, o and blk
//   columns of a unit sit at the same fragment position of four
//   accumulator tiles, and a thread's positions are 2 UH neighbouring
//   units (WarpLayout::col_at). The thread that sums a (row, unit)
//   pair's gates applies the cell to them in registers (`cell`, on the
//   fast exponential) and keeps that pair's c carry for the whole
//   sequence.
// - The step's xg rows reach shared memory as 16-byte cp.async pieces
//   issued with the ring's first refill, under the product; h and the
//   streams leave as 4- or 8-byte vectors of neighbouring units.
// - The barrier is a release add after h_t is stored and an acquire poll
//   (group_arrive, group_wait); the five residual streams are stored
//   between the two, off the path the other blocks wait on.
// f32 (the serving path: b 32, t 1, n 512, 318 launches per char-RNN
// generate): full f32 FMAs on the CUDA cores, no TF32 (fwd_simt).
// - At t = 1 the kernel is a plain launch with no counter, and every load
//   is issued at entry by cp.async: W's rows and h's columns chunk by
//   chunk (one group per 64-deep chunk, so the product starts on chunk 0
//   while the rest are in flight), the step's xg, c0 and the peepholes
//   into registers. At t > 1 W stays resident, the h_{t-1} chunks come
//   through a ring (every chunk in flight where they fit), and the steps
//   meet at the same split barrier as the bf16 design.
// - A thread owns a 4 x 4 register tile: 4 rows x 4 neighbouring
//   columns of W (F32Layout), fed by 16-byte shared loads. A block too
//   small to give every thread its own tile splits each chunk's depth over
//   KS k-groups (at the serving shape 8: 4 rows x 4 columns x 8 deep per
//   thread and chunk, 16 shared loads per 128 FMAs); one too large for the
//   registers (16 and 32 units of 128 rows) runs its rows in passes.
// - The k-groups' sums meet in shared memory with a unit's i, f, o and blk
//   side by side; the thread that adds them up for a (row, unit) pair
//   holds its four gates and applies the cell in registers (library expf
//   and tanhf, as the plain version), keeping the pair's c carry for the
//   whole sequence. h_t leaves before the barrier's arrival, the five
//   residuals after it.
//
// What the timer showed (chip_smoke.py phase 2b, lstm_fwd_phases; NVIDIA
// H100 80GB HBM3, 700 W; bf16 b 1024, t 128, n 512). Its stamps fall
// after the barrier, when the last h chunk has landed, after the last
// chunk's product and after the cell's stores, so the copies of the h
// chunks are not split from the products that overlap them. The first
// design (WMMA, the product into a shared f32 buffer, then the cell)
// spent ~53 us per step: ~31 until the last chunk landed and ~4.5 for
// the last chunk's product and the buffer's store (so ~4.4 per 64-deep
// chunk: every warp read all of the block's W), ~15 in the cell (xg
// loaded after the product in dependent rounds, scalar stores), the
// barrier ~1.7. This design spends ~10.7 us: ~6.8 until the last chunk
// landed, ~0.67 for the last chunk's product, ~2.5 in the cell and its
// stores, ~0.6 at the barrier (PERF.md). Inferred, not measured:
// if every chunk's product takes the last one's 0.66 us, the eight take
// ~5.3 (ldmatrix traffic, 24 KB per 16-deep slice per SM, and mma.sync
// issue) and the waits for h beyond them ~1.5.
// Its floor at that shape is its bytes (xg in, six streams out: ~3.1 us
// per step at 3.35 TB/s) beside the recurrent product (2 t b n 4n flops,
// ~2.2 us per step at the tensor cores' peak); wgmma with B read once per
// warpgroup, and TMA multicast of h within a cluster, are the next steps.
//
// The f32 design's timer (b 32, t 1, n 512, lstm_fwd_only; same card): the
// first design spent ~12.8 us from the kernel's entry to its last store,
// ~10.9 of them until the last h chunk landed (the 32 KB W slice loaded
// synchronously first, then h staged two chunks at a time). This design
// spends ~6.8 reading Wr and ~5.1 reading the packed copy: ~6.0 or ~4.2
// until the last chunk landed, ~0.4 for the last chunk's product and the
// k-groups' sums, ~0.5 in the cell and its stores (PERF.md). From
// Wr a block gathers 2,048 pieces of 16 bytes (4 gates x 512 rows, each
// in its own 128-byte line); packed per block (pack_wr) its 32 KB are
// contiguous. In trials both the copies alone and the product alone then
// take ~3.4 us: ~96 KB per SM come from L2 (each block reads all of h),
// and the product's 16-byte shared loads cost 4 wavefronts each (~0.4 us
// a chunk). Multicasting h to clusters of 2, 4 or 8 blocks by bulk
// copies, or loading W by the copy engine, was slower (the clusters of 4
// and 8 did not all fit at once). Its floor is its bytes (W, xg, h0, c0
// in; h, h_T, c_T out: ~1.4 us at 3.35 TB/s); 8 x 8 register tiles (half
// the shared loads per FMA), and 3xTF32 on the tensor cores, are next.
//
// Exposed as plain C functions so that no PyTorch header is compiled.

#include <atomic>

#include "lstm_common.cuh"

namespace {

using namespace lstm;

struct FwdArgs {
  const void* xg;      // [t, bp, 4n]
  const void* wr;      // [n, 4n]
  const float* wci;    // [n] each
  const float* wcf;
  const float* wco;
  const void* h0;      // [bp, n], xg's dtype
  const float* c0;     // [bp, n]
  void* hseq;          // [t, bp, n]
  void* res[5];        // i, f, o, blk, c: [t, bp, n] (residual variant)
  void* hT;            // [bp, n] (forward-only variant)
  float* cT;           // [bp, n] (forward-only variant)
  unsigned int* counter;  // [bp / BB] zeros, or null when t == 1
  unsigned long long* stamps;  // [grid, t, 4] (timed variant)
  int t, bp, n, BB;
  // f32: h chunks in flight ahead of the one multiplied, ring stages, the
  // byte offsets in shared memory of the ring and the k-group sums, and
  // whether the sums overlay the ring (set by f32_plan)
  int la, stages;
  unsigned int ring_off, red_off;
  int red_alias;
  // f32: wr is packed per block, [n / U][n][4][U] (pack_wr), so that a
  // block's slice is contiguous
  int w_packed;
};

template <int U> __host__ __device__ constexpr int ldw_bf16() { return 4 * U + 8; }

size_t bf16_smem_bytes(int U, int n, int BB) {
  // W, the ring, and one step's xg rows ([BB][4U], W's row stride)
  const size_t w = round128(sizeof(bf16) * (size_t)n * (4 * U + 8));
  return w + STAGES * round128(sizeof(bf16) * (size_t)BB * lda<bf16>()) +
         round128(sizeof(bf16) * (size_t)BB * (4 * U + 8));
}

// How the f32 design's block of BB rows and U units shares its work.
// The product runs in PASSES passes of BBP rows (one where BB U <= 1024;
// 16 and 32 units of 128 rows take 2 and 4, so that the sums fit the
// registers). In a pass, TILES thread tiles of 4 rows (rg + RG i) x 4
// neighbouring columns of W (4 units of one gate), repeated over KS
// k-groups, each of which sums a KD-deep share of every 64-deep chunk
// (so that a small block still gives each thread a 4 x 4 register tile:
// 8 16-byte shared loads per 64 FMAs). The cell: PAIRS (row, unit) pairs
// per thread, all of one unit (the thread's tid % U), rows (q NT + tid) /
// U; the first CELLERS threads take part.
// the row stride of the f32 design's k-group sums: 4 U + 4 spreads the
// rows of a tile's scattered stores over the banks
template <int U> __host__ __device__ constexpr int ldr_f32() { return 4 * U + 4; }

template <int BB, int U> struct F32Layout {
  static constexpr int BBP = BB * U > 1024 ? 1024 / U : BB;
  static constexpr int PASSES = BB / BBP;
  static constexpr int TR = 4;
  static constexpr int RG = BBP / TR;
  static constexpr int TILES = RG * U;
  static constexpr int KS = NT / TILES;
  static constexpr int KD = KC / KS;
  static constexpr int PAIRS = BB * U > NT ? BB * U / NT : 1;
  static constexpr int CELLERS = BB * U < NT ? BB * U : NT;
  static constexpr int QB = PAIRS < 4 ? PAIRS : 4;  // pairs whose xg loads fly together
  // xg loaded ahead, under the product and the barrier (else in the cell,
  // QB pairs at a time, where a thread has more than QB pairs)
  static constexpr bool AHEAD = PAIRS == QB;
  static_assert(PASSES * BBP == BB && RG * TR == BBP && TILES * KS == NT && KD % 4 == 0 &&
                    PAIRS % QB == 0,
                "f32 layout");
};

// The f32 design's shared memory, in bytes: W [n][4U] (gate-major, as
// Wr), a ring of h_{t-1} chunks [BBP][lda] (all of them when they fit,
// else as many as fit, 2 at least) and the k-groups' sums [KS][BB][ldr]
// (a unit's four gates side by side; after the ring where there is room,
// else over it, in one pass only). Fills a's plan; returns 0 where it
// does not fit.
template <int U, int BB>
size_t f32_plan(FwdArgs& a) {
  using L = F32Layout<BB, U>;
  const size_t w = round128(sizeof(float) * (size_t)a.n * 4 * U);
  const size_t stage = sizeof(float) * (size_t)L::BBP * lda<float>();
  const size_t red = sizeof(float) * (size_t)L::KS * BB * ldr_f32<U>();
  const int nk = a.n / KC;
  // what W and the ring may take
  const size_t room = L::PASSES > 1 ? SMEM_LIMIT - red : SMEM_LIMIT;
  if (w + red > SMEM_LIMIT || w + (nk > 1 ? 2 : 1) * stage > room) return 0;
  const int fit = (int)((room - w) / stage);
  a.stages = fit >= nk ? nk : fit;
  a.la = fit >= nk ? nk : fit - 1;
  const size_t ring = a.stages * stage;
  a.ring_off = (unsigned int)w;
  a.red_alias = w + ring + red > SMEM_LIMIT;
  a.red_off = (unsigned int)(a.red_alias ? w : w + ring);
  return a.red_alias ? w + (ring > red ? ring : red) : w + ring + red;
}

// sig(x) = 1 / (1 + e^-x) and tanh. FAST (the bf16 design, whose streams
// are rounded to bf16): the fast exponential and reciprocal, tanh(x) =
// 2 sig(2x) - 1, within ~1e-6 of the f32 library forms below; the
// library's expf and tanhf cost the bf16 step ~2.8 us more (PERF.md).
// Both give NaN for a NaN argument.
template <bool FAST> __device__ __forceinline__ float sig(float x) {
  if constexpr (FAST) return __fdividef(1.f, 1.f + __expf(-x));
  else return sigmoidf_(x);
}
template <bool FAST> __device__ __forceinline__ float tanh_(float x) {
  if constexpr (FAST) return 2.f * sig<true>(2.f * x) - 1.f;
  else return tanhf(x);
}

// One Graves step for one (row, unit): the gates from the pre-activations
// g_* (product + xg), the c carry advanced in place; returns h.
template <bool FAST>
__device__ __forceinline__ float cell(float gi, float gf, float go, float gg, float wci, float wcf,
                                      float wco, float& c, float& i, float& f, float& o,
                                      float& blk) {
  const float cp = c;
  i = sig<FAST>(gi + cp * wci);
  f = sig<FAST>(gf + cp * wcf);
  blk = tanh_<FAST>(gg);
  c = f * cp + i * blk;
  o = sig<FAST>(go + c * wco);
  return o * tanh_<FAST>(c);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float h, const float4& w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

// The f32 design (see the header): a block of exactly BB rows. TIMED
// stamps the globaltimer per step (thread 0) at the step's start (the
// kernel's entry at step 0, the end of the barrier wait after it), when
// the last h chunk has landed, after the product and after the cell and
// all its stores.
template <int U, int BB, bool RES, bool TIMED>
__device__ void fwd_simt(const FwdArgs& a, unsigned char* smem) {
  using L = F32Layout<BB, U>;
  constexpr int LDW = 4 * U, LDR = ldr_f32<U>(), LDA = lda<float>(), TR = L::TR, RG = L::RG;
  constexpr int KD = L::KD, BBP = L::BBP, PAIRS = L::PAIRS, QB = L::QB, STAGE = BBP * LDA;
  const int n = a.n, bp = a.bp, G = 4 * n, nk = n / KC, la = a.la, stages = a.stages;
  float* W = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + a.ring_off);
  float* red = reinterpret_cast<float*>(smem + a.red_off);

  const int nj = n / U;
  const int bi = blockIdx.x / nj, j = blockIdx.x % nj;
  const int b0 = bi * BB, u0 = j * U;
  const int tid = threadIdx.x;
  if (TIMED && tid == 0) a.stamps[(size_t)blockIdx.x * a.t * 4] = globaltimer();
  // the product's tile: k-group kg, W's columns 4 cg .. 4 cg + 3 (units
  // uq .. uq + 3 of gate gq), rows rg + RG i of the pass
  const int kg = tid / L::TILES, cg = tid % L::TILES % U, rg = tid % L::TILES / U;
  const int gq = 4 * cg / U, uq = 4 * cg % U;
  // the cell's unit; its rows are row_of(q)
  const int cu = tid % U;
  const bool celler = tid < L::CELLERS;
  auto row_of = [&](int q) { return (q * NT + tid) / U; };

  const float* wr = static_cast<const float*>(a.wr);
  const float* xg = static_cast<const float*>(a.xg);
  float* hseq = static_cast<float*>(a.hseq);
  // chunk kc of a pass's h_{s-1} rows into its ring stage; at step 0 also
  // W's rows of that chunk, W[k][gate U + u] = Wr[k][gate n + u0 + u]
  // (16-byte pieces, U / 4 per thread): from Wr, 4 U-float pieces per row
  // each in its own 128-byte line, or from the packed copy, where the
  // block's rows lie side by side
  auto issue = [&](const float* hrows, int kc, bool with_w) {
    issue_rows<BBP, LDA>(ring + (kc % stages) * STAGE, hrows + kc * KC, n);
    if (with_w) {
#pragma unroll
      for (int q = 0; q < KC * U / NT; ++q) {
        const int e = tid + q * NT, k = kc * KC + e / U, c = 4 * (e % U);
        const float* src = a.w_packed ? wr + ((size_t)j * n + k) * LDW + c
                                      : wr + (size_t)k * G + c / U * n + u0 + c % U;
        cp_async16(smem_addr(W + k * LDW + c), src, 16);
      }
    }
  };
  // step s's xg for the pairs q0 .. q0 + QB - 1, into registers
  float xr[QB][4];
  auto load_xg = [&](int s, int q0) {
#pragma unroll
    for (int jj = 0; jj < QB; ++jj) {
      const float* x = xg + ((size_t)s * bp + b0 + row_of(q0 + jj)) * G + u0 + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) xr[jj][g] = __ldg(x + (size_t)g * n);
    }
  };
  float creg[PAIRS];  // the c carry of the thread's pairs
  float pci = 0.f, pcf = 0.f, pco = 0.f;
  if (celler) {
    if (L::AHEAD) load_xg(0, 0);
    pci = a.wci[u0 + cu];
    pcf = a.wcf[u0 + cu];
    pco = a.wco[u0 + cu];
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) creg[q] = a.c0[(size_t)(b0 + row_of(q)) * n + u0 + cu];
  }

  for (int s = 0; s < a.t; ++s) {
    unsigned long long* st = TIMED ? a.stamps + ((size_t)blockIdx.x * a.t + s) * 4 : nullptr;
    if (TIMED && s > 0 && tid == 0) st[0] = globaltimer();
    const float* hprev = s == 0 ? static_cast<const float*>(a.h0) + (size_t)b0 * n
                                : hseq + ((size_t)(s - 1) * bp + b0) * n;
#pragma unroll 1
    for (int pass = 0; pass < L::PASSES; ++pass) {
      const float* hrows = hprev + (size_t)pass * BBP * n;
      // the ring: la chunks in flight at once (every chunk where they
      // fit); each iteration waits for its chunk, then refills the stage
      // the iteration before read (one group committed per chunk)
      if (pass > 0) __syncthreads();  // the last pass's chunks are read
      for (int q = 0; q < la; ++q) {
        issue(hrows, q, s == 0 && pass == 0);
        cp_async_commit();
      }
      float acc[TR][4];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
      for (int kc = 0; kc < nk; ++kc) {
        cp_async_wait_upto(la - 1);  // this thread's copies of chunk kc landed
        __syncthreads();             // everyone's did; chunk kc - 1 is read
        if (TIMED && pass + 1 == L::PASSES && kc + 1 == nk && tid == 0) st[1] = globaltimer();
        if (kc + la < nk) issue(hrows, kc + la, s == 0 && pass == 0);
        cp_async_commit();
        const float* hs = ring + (kc % stages) * STAGE + rg * LDA + kg * KD;
        const float* ws = W + (size_t)(kc * KC + kg * KD) * LDW + 4 * cg;
#pragma unroll 4
        for (int kk = 0; kk < KD; kk += 4) {  // 4 loads of W, 4 of h, 64 FMAs
          float4 w[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) w[m] = *reinterpret_cast<const float4*>(ws + (kk + m) * LDW);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float4 h = *reinterpret_cast<const float4*>(hs + i * RG * LDA + kk);
            fma4(acc[i], h.x, w[0]);
            fma4(acc[i], h.y, w[1]);
            fma4(acc[i], h.z, w[2]);
            fma4(acc[i], h.w, w[3]);
          }
        }
      }
      // each k-group's sums to shared memory, a unit's four gates side by
      // side (over the ring: once every warp is done with it)
      if (a.red_alias) __syncthreads();
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float* out = red + ((size_t)kg * BB + pass * BBP + rg + RG * i) * LDR + 4 * uq + gq;
#pragma unroll
        for (int m = 0; m < 4; ++m) out[4 * m] = acc[i][m];
      }
    }
    __syncthreads();
    if (TIMED && tid == 0) st[2] = globaltimer();

    // the cell per pair: the k-groups' sums in order, + xg; h_t leaves at
    // once (the other blocks wait for it), the residuals after the arrival
    // (LATE), or at once where a thread has more than QB pairs (registers)
    constexpr bool LATE = RES && L::AHEAD;
    float rv[LATE ? PAIRS : 1][5];
    if (celler) {
#pragma unroll
      for (int q0 = 0; q0 < PAIRS; q0 += QB) {
        if (!L::AHEAD) load_xg(s, q0);
#pragma unroll
        for (int jj = 0; jj < QB; ++jj) {
          const int q = q0 + jj, r = row_of(q);
          float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < L::KS; ++k) {
            const float4 p = *reinterpret_cast<const float4*>(red + ((size_t)k * BB + r) * LDR + 4 * cu);
            g4.x += p.x; g4.y += p.y; g4.z += p.z; g4.w += p.w;
          }
          float i, f, o, blk;
          const float h = cell<false>(g4.x + xr[jj][0], g4.y + xr[jj][1], g4.z + xr[jj][2],
                                      g4.w + xr[jj][3], pci, pcf, pco, creg[q], i, f, o, blk);
          hseq[((size_t)s * bp + b0 + r) * n + u0 + cu] = h;
          if constexpr (LATE) {
            rv[q][0] = i; rv[q][1] = f; rv[q][2] = o; rv[q][3] = blk; rv[q][4] = creg[q];
          } else if constexpr (RES) {
            const size_t at = ((size_t)s * bp + b0 + r) * n + u0 + cu;
            const float v[5] = {i, f, o, blk, creg[q]};
#pragma unroll
            for (int k = 0; k < 5; ++k) static_cast<float*>(a.res[k])[at] = v[k];
          } else if (s == a.t - 1) {
            const size_t last = (size_t)(b0 + r) * n + u0 + cu;
            static_cast<float*>(a.hT)[last] = h;
            a.cT[last] = creg[q];
          }
        }
      }
      if (L::AHEAD && s + 1 < a.t) load_xg(s + 1, 0);  // in flight across the barrier
    }
    if (s + 1 < a.t) group_arrive(a.counter + bi);
    if constexpr (LATE) {
      if (celler) {
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
          const size_t at = ((size_t)s * bp + b0 + row_of(q)) * n + u0 + cu;
#pragma unroll
          for (int k = 0; k < 5; ++k) static_cast<float*>(a.res[k])[at] = rv[q][k];
        }
      }
    }
    if (TIMED) {
      __syncthreads();
      if (tid == 0) st[3] = globaltimer();
    }
    if (s + 1 < a.t) group_wait(a.counter + bi, (unsigned int)((s + 1) * nj));
  }
}

// The bf16 design (see the header): a block of exactly BB rows. TIMED
// stamps the globaltimer per step (thread 0, each after a __syncthreads)
// after the barrier, after the last chunk landed, after its product and
// after the cell and all its stores.
template <int U, int BB, bool RES, bool TIMED>
__device__ void fwd_mma(const FwdArgs& a, unsigned char* smem) {
  using L = WarpLayout<BB, U>;
  constexpr int LDW = ldw_bf16<U>(), LDA = lda<bf16>(), MT = L::MT, UH = L::UH;
  constexpr int NTW = 4 * UH;          // 8-column accumulator tiles per row tile
  constexpr int STAGE = BB * LDA;      // elements of one ring stage
  const int n = a.n, bp = a.bp, G = 4 * n, nk = n / KC;
  bf16* W = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + round128(sizeof(bf16) * (size_t)n * LDW));
  bf16* xs = ring + STAGES * STAGE;  // step s's xg rows: xs[r][gate U + u], row stride LDW

  const int nj = n / U;
  const int bi = blockIdx.x / nj, j = blockIdx.x % nj;
  const int b0 = bi * BB, u0 = j * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const bool active = warp < L::WARPS;  // the same for every lane of a warp
  const int row0 = (warp / L::UG) * MT * 16;
  const int wcol = (warp % L::UG) * UH * 8;  // the warp's first column (and unit)
  const int unit = u0 + wcol + 2 * UH * c;   // this thread's 2 UH units: unit + [0, 2 UH)

  // W[k][gate U + col_at(u)] = Wr[k][gate n + u0 + u]: gate-major, each
  // gate's columns in the order of the warps' accumulator columns; read
  // in 16-byte pieces of 8 units, written as 4 bf16 pairs
  {
    const bf16* wr = static_cast<const bf16*>(a.wr);
    for (int i = tid; i < n * U / 2; i += NT) {
      const int k = i / (U / 2), gate = i % (U / 2) / (U / 8), u = 8 * (i % (U / 8));
      const uint4 v = *reinterpret_cast<const uint4*>(wr + (size_t)k * G + gate * n + u0 + u);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      bf16* dst = W + (size_t)k * LDW + gate * U;
#pragma unroll
      for (int m = 0; m < 4; ++m) *reinterpret_cast<uint32_t*>(dst + L::col_at(u + 2 * m)) = w[m];
    }
  }

  // per (row tile mt, row half h): the c carry of the thread's units
  // (word uh: units 2 uh, 2 uh + 1); the peepholes of the thread's units
  float creg[MT][2][2 * UH], pci[2 * UH], pcf[2 * UH], pco[2 * UH];
  const bf16* xg = static_cast<const bf16*>(a.xg);
  auto row_of = [&](int mt, int h) { return row0 + mt * 16 + g + 8 * h; };  // in the block
  // step s's xg rows for the block's units into xs, 16-byte pieces in
  // flight with the ring's chunks
  auto fetch_xg = [&](int s) {
    constexpr int CPG = U / 8, PIECES = BB * 4 * CPG;
#pragma unroll
    for (int q = 0; q < (PIECES + NT - 1) / NT; ++q) {
      const int i = tid + q * NT;
      if (PIECES % NT == 0 || i < PIECES) {
        const int r = i / (4 * CPG), col = i % (4 * CPG) * 8, gate = col / U;
        cp_async16(smem_addr(xs + r * LDW + col),
                   xg + ((size_t)s * bp + b0 + r) * G + gate * n + u0 + col % U, 16);
      }
    }
  };
  if (active) {
#pragma unroll
    for (int e = 0; e < 2 * UH; ++e) {
      pci[e] = a.wci[unit + e];
      pcf[e] = a.wcf[unit + e];
      pco[e] = a.wco[unit + e];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2 * UH; ++e)
          creg[mt][h][e] = a.c0[(size_t)(b0 + row_of(mt, h)) * n + unit + e];
  }
  __syncthreads();

  bf16* hseq = static_cast<bf16*>(a.hseq);
  for (int s = 0; s < a.t; ++s) {
    unsigned long long* st = TIMED ? a.stamps + ((size_t)blockIdx.x * a.t + s) * 4 : nullptr;
    if (TIMED && tid == 0) st[0] = globaltimer();
    const bf16* hprev = s == 0 ? static_cast<const bf16*>(a.h0) + (size_t)b0 * n
                               : hseq + ((size_t)(s - 1) * bp + b0) * n;
    auto fetch = [&](int kc) {  // chunk kc of h_{s-1} into its ring stage
      issue_rows<BB, LDA>(ring + (kc % STAGES) * STAGE, hprev + kc * KC, n);
    };
    // the ring: chunks 0 .. STAGES - 2 in flight at once; each iteration
    // waits for its chunk, then refills the stage the iteration before
    // read (one group committed per chunk, empty past the last)
#pragma unroll
    for (int q = 0; q < STAGES - 1; ++q) {
      if (q < nk) fetch(q);
      cp_async_commit();
    }
    float acc[MT][NTW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of chunk kc landed
      __syncthreads();              // everyone's did; chunk kc - 1 is read
      if (TIMED && kc + 1 == nk && tid == 0) st[1] = globaltimer();
      if (kc + STAGES - 1 < nk) fetch(kc + STAGES - 1);
      if (kc == 0) fetch_xg(s);  // xs was read in the step before
      cp_async_commit();
      if (active) {
        const bf16* A = ring + (kc % STAGES) * STAGE + (row0 + lane % 16) * LDA + 8 * (lane / 16);
        const bf16* B = W + (size_t)(kc * KC + lane % 16) * LDW + wcol;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], smem_addr(A + mt * 16 * LDA + 16 * kk));
#pragma unroll
          for (int pr = 0; pr < NTW / 2; ++pr) {
            // two 8-column tiles per ldmatrix.trans: gate pr's slices 0
            // and 1 (UH 2), or gates 2 pr and 2 pr + 1 (UH 1)
            const int col = UH == 2 ? pr * U + 8 * (lane / 16) : (2 * pr + lane / 16) * U;
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, smem_addr(B + 16 * kk * LDW + col));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][2 * pr], af[mt], bf[0], bf[1]);
              mma_bf16(acc[mt][2 * pr + 1], af[mt], bf[2], bf[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();  // this thread's pieces of xs landed
    __syncthreads();     // everyone's did
    if (TIMED && tid == 0) st[2] = globaltimer();
    if (active) {
      // g = product + xg
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t* x = reinterpret_cast<const uint32_t*>(
                xs + row_of(mt, h) * LDW + q * U + unit - u0);
#pragma unroll
            for (int uh = 0; uh < UH; ++uh) {
              const float2 v = unpack_bf16(x[uh]);
              acc[mt][q * UH + uh][2 * h] += v.x;
              acc[mt][q * UH + uh][2 * h + 1] += v.y;
            }
          }
      // the cell: i, f, o, blk back into the gates' accumulators, c in
      // its carry; h_t leaves at once (the other blocks wait for it)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hw[UH];
#pragma unroll
          for (int uh = 0; uh < UH; ++uh) {
            float hv[2];
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const int e = 2 * h + p, k = 2 * uh + p;
              float& gi = acc[mt][uh][e];
              float& gf = acc[mt][UH + uh][e];
              float& go = acc[mt][2 * UH + uh][e];
              float& gg = acc[mt][3 * UH + uh][e];
              hv[p] = cell<true>(gi, gf, go, gg, pci[k], pcf[k], pco[k], creg[mt][h][k], gi, gf, go,
                                 gg);
            }
            hw[uh] = pack_bf16(hv[0], hv[1]);
          }
          const int r = b0 + row_of(mt, h);
          store_words<UH>(hseq + ((size_t)s * bp + r) * n + unit, hw);
          if constexpr (!RES) {
            if (s == a.t - 1) {
              store_words<UH>(static_cast<bf16*>(a.hT) + (size_t)r * n + unit, hw);
#pragma unroll
              for (int k = 0; k < 2 * UH; ++k) a.cT[(size_t)r * n + unit + k] = creg[mt][h][k];
            }
          }
        }
    }
    if (s + 1 < a.t) group_arrive(a.counter + bi);
    if constexpr (RES) {
      // the residuals, after the arrival: no other block waits for them
      if (active) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t at = ((size_t)s * bp + b0 + row_of(mt, h)) * n + unit;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              uint32_t w[UH];
#pragma unroll
              for (int uh = 0; uh < UH; ++uh)
                w[uh] = pack_bf16(acc[mt][q * UH + uh][2 * h], acc[mt][q * UH + uh][2 * h + 1]);
              store_words<UH>(static_cast<bf16*>(a.res[q]) + at, w);
            }
            uint32_t w[UH];
#pragma unroll
            for (int uh = 0; uh < UH; ++uh)
              w[uh] = pack_bf16(creg[mt][h][2 * uh], creg[mt][h][2 * uh + 1]);
            store_words<UH>(static_cast<bf16*>(a.res[4]) + at, w);
          }
      }
    }
    if (TIMED) {
      __syncthreads();
      if (tid == 0) st[3] = globaltimer();
    }
    if (s + 1 < a.t) group_wait(a.counter + bi, (unsigned int)((s + 1) * nj));
  }
}

// One kernel for both designs and both variants: a block of exactly
// BB rows of U units, xg's element type T.
template <typename T, int U, bool RES, int BB, bool TIMED = false>
__global__ void __launch_bounds__(NT, 1) lstm_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 2) {
    fwd_mma<U, BB, RES, TIMED>(a, smem);
  } else {
    fwd_simt<U, BB, RES, TIMED>(a, smem);
  }
}

// Sets a kernel's dynamic shared-memory limit to the most a block may
// use, once per device (bit d of ``done``).
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// One launch: t = 1 is a plain launch (no barrier, no counter); a longer
// scan a cooperative one, whose blocks are all resident at once.
template <typename T, int U, bool RES, int BB, bool TIMED = false>
int launch(FwdArgs args, cudaStream_t stream) {
  if (args.BB != BB) return (int)cudaErrorInvalidValue;
  size_t smem;
  if constexpr (sizeof(T) == 2) {
    smem = bf16_smem_bytes(U, args.n, BB);
  } else {
    smem = f32_plan<U, BB>(args);
  }
  if (smem == 0 || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = lstm_fwd_kernel<T, U, RES, BB, TIMED>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args.bp / BB) * (args.n / U));
  if (args.t == 1) {
    kernel<<<grid, NT, smem, stream>>>(args);
  } else {
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(NT), params, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// the bf16 instantiation for the block's rows BB and units u
template <bool RES, bool TIMED>
int launch_bf16(const FwdArgs& a, int u, cudaStream_t s) {
  switch (u * 1000 + a.BB) {
    case 32128: return launch<bf16, 32, RES, 128, TIMED>(a, s);
    case 16128: return launch<bf16, 16, RES, 128, TIMED>(a, s);
  }
  if constexpr (!TIMED) {  // the timer is built for 128-row blocks
    switch (u * 1000 + a.BB) {
      case 32064: return launch<bf16, 32, RES, 64>(a, s);
      case 32032: return launch<bf16, 32, RES, 32>(a, s);
      case 32016: return launch<bf16, 32, RES, 16>(a, s);
      case 16064: return launch<bf16, 16, RES, 64>(a, s);
      case 16032: return launch<bf16, 16, RES, 32>(a, s);
      case 16016: return launch<bf16, 16, RES, 16>(a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// the f32 instantiation for the block's rows BB and units u: every
// layout the wrapper's _block_shape gives at a power-of-two U (16 and 32
// units only in 128-row blocks)
template <bool RES>
int launch_f32(const FwdArgs& a, int u, cudaStream_t s) {
  switch (u * 1000 + a.BB) {
    case 4016: return launch<float, 4, RES, 16>(a, s);
    case 4032: return launch<float, 4, RES, 32>(a, s);
    case 4064: return launch<float, 4, RES, 64>(a, s);
    case 4128: return launch<float, 4, RES, 128>(a, s);
    case 8016: return launch<float, 8, RES, 16>(a, s);
    case 8032: return launch<float, 8, RES, 32>(a, s);
    case 8064: return launch<float, 8, RES, 64>(a, s);
    case 8128: return launch<float, 8, RES, 128>(a, s);
    case 16128: return launch<float, 16, RES, 128>(a, s);
    case 32128: return launch<float, 32, RES, 128>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool shape_ok(const FwdArgs& a) {
  return a.t >= 1 && a.n % 64 == 0 && a.n <= 1024 && a.BB % 16 == 0 && a.BB >= 16 &&
         a.BB <= MAX_BB && a.bp % a.BB == 0 && (a.t == 1 || a.counter != nullptr);
}

template <bool RES>
int dispatch(const FwdArgs& a, int u, int dtype, cudaStream_t s) {
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !a.w_packed) return launch_bf16<RES, false>(a, u, s);  // U >= 16
  if (dtype == 0) return launch_f32<RES>(a, u, s);
  return (int)cudaErrorInvalidValue;
}

FwdArgs make_args(const void* xg, const void* wr, const float* wci, const float* wcf,
                  const float* wco, const void* h0, const float* c0, void* hseq,
                  unsigned int* counter, int t, int bp, int n, int bb, int w_packed) {
  FwdArgs a = {};
  a.xg = xg; a.wr = wr; a.wci = wci; a.wcf = wcf; a.wco = wco; a.h0 = h0; a.c0 = c0;
  a.hseq = hseq; a.counter = counter; a.t = t; a.bp = bp; a.n = n; a.BB = bb;
  a.w_packed = w_packed;
  return a;
}

}  // namespace

// All tensors contiguous and 16-byte aligned, batch padded to bp (a
// multiple of bb); bb rows and u units per block; dtype 0 = float32,
// 1 = bfloat16 (xg, wr, h0 and the streams); w_packed 1 where f32 wr is
// packed per block, [n / u][n][4][u] (ops/lstm_kernel.py pack_wr; bf16
// takes Wr as it is). Returns a cudaError_t (0
// on success); a shape or layout the kernel is not built for returns
// cudaErrorInvalidValue, a grid that cannot be co-resident
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int dl4j_lstm_fwd(const void* xg, const void* wr, const float* wci, const float* wcf,
                             const float* wco, const void* h0, const float* c0, void* hseq,
                             void* i, void* f, void* o, void* blk, void* c,
                             unsigned int* counter, int t, int bp, int n, int bb, int u,
                             int dtype, int w_packed, void* stream) {
  FwdArgs a = make_args(xg, wr, wci, wcf, wco, h0, c0, hseq, counter, t, bp, n, bb, w_packed);
  a.res[0] = i; a.res[1] = f; a.res[2] = o; a.res[3] = blk; a.res[4] = c;
  return dispatch<true>(a, u, dtype, static_cast<cudaStream_t>(stream));
}

// The forward kernels with their step timer: bf16 with residuals (bb
// 128), or f32 either variant (bb 32, u 4: the serving layout); per
// block and step, the globaltimer (ns) at the step's start (the kernel's
// entry at step 0, after the barrier after it), when the last h chunk
// has landed, after the product and after the cell and its stores, into
// stamps [grid, t, 4] (grid = (bp / bb) * (n / u)). res: 1 for
// dl4j_lstm_fwd's outputs (i .. c), 0 for dl4j_lstm_fwd_only's (hT, cT).
extern "C" int dl4j_lstm_fwd_timed(const void* xg, const void* wr, const float* wci,
                                   const float* wcf, const float* wco, const void* h0,
                                   const float* c0, void* hseq, void* i, void* f, void* o,
                                   void* blk, void* c, void* hT, float* cT,
                                   unsigned int* counter, unsigned long long* stamps, int t,
                                   int bp, int n, int bb, int u, int dtype, int res,
                                   int w_packed, void* stream) {
  FwdArgs a = make_args(xg, wr, wci, wcf, wco, h0, c0, hseq, counter, t, bp, n, bb, w_packed);
  a.res[0] = i; a.res[1] = f; a.res[2] = o; a.res[3] = blk; a.res[4] = c;
  a.hT = hT; a.cT = cT;
  a.stamps = stamps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stamps == nullptr || !shape_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && res && !w_packed) return launch_bf16<true, true>(a, u, s);
  if (dtype == 0 && u == 4)
    return res ? launch<float, 4, true, 32, true>(a, s) : launch<float, 4, false, 32, true>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dl4j_lstm_fwd_only(const void* xg, const void* wr, const float* wci,
                                  const float* wcf, const float* wco, const void* h0,
                                  const float* c0, void* hseq, void* hT, float* cT,
                                  unsigned int* counter, int t, int bp, int n, int bb, int u,
                                  int dtype, int w_packed, void* stream) {
  FwdArgs a = make_args(xg, wr, wci, wcf, wco, h0, c0, hseq, counter, t, bp, n, bb, w_packed);
  a.hT = hT; a.cT = cT;
  return dispatch<false>(a, u, dtype, static_cast<cudaStream_t>(stream));
}
