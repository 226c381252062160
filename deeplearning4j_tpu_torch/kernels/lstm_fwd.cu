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
// bf16). So one persistent cooperative launch covers the whole sequence:
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
// f32 (the serving path): the first design, unchanged (fwd_simt): the
// product on the CUDA cores into an f32 buffer in shared memory
// (block_product), then the cell per (row, unit).
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
// Exposed as plain C functions so that no PyTorch header is compiled.

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
};

template <int U> __host__ __device__ constexpr int ldw_f32() { return 4 * U + 4; }
template <int U> __host__ __device__ constexpr int ldw_bf16() { return 4 * U + 8; }
template <typename T, int U> __host__ __device__ constexpr int ldw() {
  return sizeof(T) == 2 ? ldw_bf16<U>() : ldw_f32<U>();
}
template <int U> __host__ __device__ constexpr int ldo() { return 4 * U + 4; }

template <typename T, int U>
size_t smem_bytes(int n, int BB) {
  const size_t w = round128(sizeof(T) * (size_t)n * ldw<T, U>());
  if (sizeof(T) == 2)  // W, the ring, and one step's xg rows ([BB][4U], W's row stride)
    return w + STAGES * round128(sizeof(T) * (size_t)BB * lda<T>()) +
           round128(sizeof(T) * (size_t)BB * ldw<T, U>());
  const size_t out = sizeof(float) * (size_t)BB * ldo<U>();
  const size_t stage = stage_bytes(BB);
  return w + round128(out > stage ? out : stage);
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

// (row, unit) pairs a thread owns, at most, for MAXB rows of U units,
// and how many of them are worked on together (f32 design)
template <int U, int MAXB> __host__ __device__ constexpr int pairs() {
  return (MAXB * U + NT - 1) / NT;
}
template <int U, int MAXB> __host__ __device__ constexpr int pair_batch() {
  return pairs<U, MAXB>() < 4 ? pairs<U, MAXB>() : 4;
}

// The f32 design: block_product into an f32 buffer, then the cell per
// (row, unit); BB <= MAXB.
template <int U, bool RES, int MAXB>
__device__ void fwd_simt(const FwdArgs& a, unsigned char* smem) {
  using T = float;
  constexpr int LDW = ldw<T, U>(), LDO = ldo<U>();
  constexpr int PAIRS = pairs<U, MAXB>(), QB = pair_batch<U, MAXB>();
  const int n = a.n, BB = a.BB, bp = a.bp, G = 4 * n;
  T* W = reinterpret_cast<T*>(smem);
  unsigned char* rest = smem + round128(sizeof(T) * (size_t)n * LDW);
  float* out = reinterpret_cast<float*>(rest);
  T* stage = reinterpret_cast<T*>(rest);

  const int nj = n / U;
  const int bi = blockIdx.x / nj, j = blockIdx.x % nj;
  const int b0 = bi * BB, u0 = j * U;
  const int tid = threadIdx.x;

  // resident: W[k][gate * U + u] = Wr[k][gate * n + u0 + u]
  {
    const T* wr = static_cast<const T*>(a.wr);
    constexpr int VEC = 16 / sizeof(T);
    constexpr int CPG = U / VEC;  // 16-byte pieces per gate slice
    for (int i = tid; i < n * 4 * CPG; i += NT) {
      const int k = i / (4 * CPG), rem = i % (4 * CPG), gate = rem / CPG, c = (rem % CPG) * VEC;
      *reinterpret_cast<uint4*>(W + (size_t)k * LDW + gate * U + c) =
          *reinterpret_cast<const uint4*>(wr + (size_t)k * G + gate * n + u0 + c);
    }
  }
  float creg[PAIRS];  // this thread's slice of the c carry
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = tid + q * NT;
    creg[q] = p < BB * U ? a.c0[(size_t)(b0 + p / U) * n + u0 + p % U] : 0.f;
  }
  __syncthreads();

  const T* xg = static_cast<const T*>(a.xg);
  T* hseq = static_cast<T*>(a.hseq);
  for (int s = 0; s < a.t; ++s) {
    const T* hprev = s == 0 ? static_cast<const T*>(a.h0) + (size_t)b0 * n
                            : hseq + ((size_t)(s - 1) * bp + b0) * n;
    block_product<4 * U, false, MAXB>(out, LDO, stage, hprev, n, W, LDW, n, BB);
    // the gates, QB (row, unit) pairs at a time: their loads of xg
    // (streamed from device memory) in flight together
#pragma unroll
    for (int q0 = 0; q0 < PAIRS; q0 += QB) {
      float xv[QB][4];
#pragma unroll
      for (int jj = 0; jj < QB; ++jj) {
        const int p = tid + (q0 + jj) * NT;
        if (p < BB * U) {
          const T* x = xg + ((size_t)s * bp + b0 + p / U) * G + u0 + p % U;
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[jj][g] = to_f(x[(size_t)g * n]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < QB; ++jj) {
        const int q = q0 + jj, p = tid + q * NT;
        if (p < BB * U) {
          const int r = p / U, u = p % U;
          const size_t row = (size_t)s * bp + b0 + r;
          const float* o_r = out + r * LDO + u;
          float i, f, o, blk;
          const float h = cell<false>(o_r[0] + xv[jj][0], o_r[U] + xv[jj][1],
                                      o_r[2 * U] + xv[jj][2], o_r[3 * U] + xv[jj][3],
                                      a.wci[u0 + u], a.wcf[u0 + u], a.wco[u0 + u], creg[q], i,
                                      f, o, blk);
          const size_t at = row * n + u0 + u;
          hseq[at] = from_f<T>(h);
          if constexpr (RES) {
            static_cast<T*>(a.res[0])[at] = from_f<T>(i);
            static_cast<T*>(a.res[1])[at] = from_f<T>(f);
            static_cast<T*>(a.res[2])[at] = from_f<T>(o);
            static_cast<T*>(a.res[3])[at] = from_f<T>(blk);
            static_cast<T*>(a.res[4])[at] = from_f<T>(creg[q]);
          } else {
            if (s == a.t - 1) {
              const size_t last = (size_t)(b0 + r) * n + u0 + u;
              static_cast<T*>(a.hT)[last] = from_f<T>(h);
              a.cT[last] = creg[q];
            }
          }
        }
      }
    }
    if (s + 1 < a.t) {
      group_arrive(a.counter + bi);
      group_wait(a.counter + bi, (unsigned int)((s + 1) * nj));
    }
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

// One kernel for both designs and both variants: T float (MAXB: the
// most rows a block may own) or bf16 (MAXB: exactly the rows it owns).
template <typename T, int U, bool RES, int MAXB, bool TIMED = false>
__global__ void __launch_bounds__(NT, 1) lstm_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 2) {
    fwd_mma<U, MAXB, RES, TIMED>(a, smem);
  } else {
    static_assert(!TIMED, "the timer is built for the bf16 design");
    fwd_simt<U, RES, MAXB>(a, smem);
  }
}

template <typename T, int U, bool RES, int MAXB, bool TIMED = false>
int launch(const FwdArgs& args, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, U>(args.n, args.BB);
  if (smem > SMEM_LIMIT || args.BB > MAXB || (sizeof(T) == 2 && args.BB != MAXB))
    return (int)cudaErrorInvalidValue;
  auto kernel = lstm_fwd_kernel<T, U, RES, MAXB, TIMED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args.bp / args.BB) * (args.n / U));
  FwdArgs copy = args;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(NT), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
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

bool shape_ok(const FwdArgs& a) {
  return a.t >= 1 && a.n % 64 == 0 && a.n <= 1024 && a.BB % 16 == 0 && a.BB >= 16 &&
         a.BB <= MAX_BB && a.bp % a.BB == 0 && (a.t == 1 || a.counter != nullptr);
}

template <bool RES>
int dispatch(const FwdArgs& a, int u, int dtype, cudaStream_t s) {
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_bf16<RES, false>(a, u, s);  // U >= 16: 8-unit slices
  if (dtype == 0) {  // f32: the per-thread row arrays sized by BB
    const bool small = a.BB <= 32;
    if (u == 32) return small ? launch<float, 32, RES, 32>(a, s) : launch<float, 32, RES, MAX_BB>(a, s);
    if (u == 16) return small ? launch<float, 16, RES, 32>(a, s) : launch<float, 16, RES, MAX_BB>(a, s);
    if (u == 8) return small ? launch<float, 8, RES, 32>(a, s) : launch<float, 8, RES, MAX_BB>(a, s);
    if (u == 4) return small ? launch<float, 4, RES, 32>(a, s) : launch<float, 4, RES, MAX_BB>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

FwdArgs make_args(const void* xg, const void* wr, const float* wci, const float* wcf,
                  const float* wco, const void* h0, const float* c0, void* hseq,
                  unsigned int* counter, int t, int bp, int n, int bb) {
  FwdArgs a = {};
  a.xg = xg; a.wr = wr; a.wci = wci; a.wcf = wcf; a.wco = wco; a.h0 = h0; a.c0 = c0;
  a.hseq = hseq; a.counter = counter; a.t = t; a.bp = bp; a.n = n; a.BB = bb;
  return a;
}

}  // namespace

// All tensors contiguous and 16-byte aligned, batch padded to bp (a
// multiple of bb); bb rows and u units per block; dtype 0 = float32,
// 1 = bfloat16 (xg, wr, h0 and the streams). Returns a cudaError_t (0
// on success); a shape or layout the kernel is not built for returns
// cudaErrorInvalidValue, a grid that cannot be co-resident
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int dl4j_lstm_fwd(const void* xg, const void* wr, const float* wci, const float* wcf,
                             const float* wco, const void* h0, const float* c0, void* hseq,
                             void* i, void* f, void* o, void* blk, void* c,
                             unsigned int* counter, int t, int bp, int n, int bb, int u,
                             int dtype, void* stream) {
  FwdArgs a = make_args(xg, wr, wci, wcf, wco, h0, c0, hseq, counter, t, bp, n, bb);
  a.res[0] = i; a.res[1] = f; a.res[2] = o; a.res[3] = blk; a.res[4] = c;
  return dispatch<true>(a, u, dtype, static_cast<cudaStream_t>(stream));
}

// dl4j_lstm_fwd's bf16 kernel with its step timer (bb 128 only): per
// block and step, the globaltimer (ns) after the barrier, after the last
// h chunk landed, after its product and after the cell and its stores,
// into stamps [grid, t, 4] (grid = (bp / bb) * (n / u)).
extern "C" int dl4j_lstm_fwd_timed(const void* xg, const void* wr, const float* wci,
                                   const float* wcf, const float* wco, const void* h0,
                                   const float* c0, void* hseq, void* i, void* f, void* o,
                                   void* blk, void* c, unsigned int* counter,
                                   unsigned long long* stamps, int t, int bp, int n, int bb,
                                   int u, int dtype, void* stream) {
  FwdArgs a = make_args(xg, wr, wci, wcf, wco, h0, c0, hseq, counter, t, bp, n, bb);
  a.res[0] = i; a.res[1] = f; a.res[2] = o; a.res[3] = blk; a.res[4] = c;
  a.stamps = stamps;
  if (dtype != 1 || stamps == nullptr || !shape_ok(a)) return (int)cudaErrorInvalidValue;
  return launch_bf16<true, true>(a, u, static_cast<cudaStream_t>(stream));
}

extern "C" int dl4j_lstm_fwd_only(const void* xg, const void* wr, const float* wci,
                                  const float* wcf, const float* wco, const void* h0,
                                  const float* c0, void* hseq, void* hT, float* cT,
                                  unsigned int* counter, int t, int bp, int n, int bb, int u,
                                  int dtype, void* stream) {
  FwdArgs a = make_args(xg, wr, wci, wcf, wco, h0, c0, hseq, counter, t, bp, n, bb);
  a.hT = hT; a.cT = cT;
  return dispatch<false>(a, u, dtype, static_cast<cudaStream_t>(stream));
}
