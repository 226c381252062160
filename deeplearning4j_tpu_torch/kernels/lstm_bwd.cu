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
// units ([U, 4n], about 128 KB) resident in shared memory and the dc
// carry in registers, and meets the other blocks of its batch group at
// a counter barrier after every step, since dh for its units needs all
// 4n columns of dg_{t+1}. Two by-products leave the sweep: h_prev =
// o_{t-1} tanh(c_{t-1}) (h0 at t = 0), rounded to Wr's dtype, for the
// weight gradient (tanh(c_t) is at hand in the step that computes the
// chain), and per-block partial sums of the peephole gradients over its
// rows, accumulated over time from the f32 da, as the TPU kernel sums
// them.
//
// `lstm_dw`, the weight gradients. The TPU kernel accumulates
// dWr += h_prev^T . dg in a VMEM buffer shared by the batch blocks,
// which on Hopper would take atomics or a [n, 4n] partial per block. So
// a second pass owns each 64 x 64 tile of dWr [n, 4n] in one block and
// walks all (t, b) rows: dWr = sum h_prev^T . dg with bf16 operands and
// f32 accumulation (WMMA), or f32 FMAs; the blocks of the first column
// tile also add up the sweep's peephole partials in a fixed order. No
// atomics: the result is deterministic.
//
// What bounds it: at the training shape (b 1024, t 128, n 512, bf16)
// the sweep moves ~1.3 GB (residuals in, dg out) against 275 GFLOP of
// recurrent product, so bytes; lstm_dw does 275 GFLOP on ~0.8 GB, so
// operations. The simple first version: WMMA from shared memory, chunks
// staged by cp.async while the one before is multiplied, no TMA, no
// wgmma.
//
// Exposed as plain C functions so that no PyTorch header is compiled.

#include "lstm_common.cuh"

namespace {

using namespace lstm;

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
  int t, bp, n, BB;
};

template <typename T> __host__ __device__ int ldr(int n) { return 4 * n + (sizeof(T) == 2 ? 8 : 1); }

template <typename T, int U>
size_t sweep_smem(int n, int BB) {
  const size_t w = round128(sizeof(T) * (size_t)U * ldr<T>(n));
  size_t rest = sizeof(float) * (size_t)BB * (U + 4);
  const size_t stage = stage_bytes<T>(BB);
  if (stage > rest) rest = stage;
  return w + round128(rest);
}

template <typename T, int U, int MAXB>
__global__ void __launch_bounds__(NT, 1) lstm_bwd_kernel(BwdArgs a) {
  constexpr int LDO = U + 4;
  // (row, unit) pairs a thread owns, at most, and how many are worked on
  // together
  constexpr int PAIRS = (MAXB * U + NT - 1) / NT, QB = PAIRS < 2 ? PAIRS : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n, BB = a.BB, bp = a.bp, G = 4 * n, LDR = ldr<T>(n);
  T* W = reinterpret_cast<T*>(smem);
  unsigned char* rest = smem + round128(sizeof(T) * (size_t)U * LDR);
  float* out = reinterpret_cast<float*>(rest);
  T* stage = reinterpret_cast<T*>(rest);

  const int nj = n / U;
  const int bi = blockIdx.x / nj, j = blockIdx.x % nj;
  const int b0 = bi * BB, u0 = j * U;
  const int tid = threadIdx.x;

  // resident: W[u][k] = Wr[u0 + u][k], the rows of this block's units
  {
    const T* wr = static_cast<const T*>(a.wr) + (size_t)u0 * G;
    if constexpr (sizeof(T) == 2) {
      constexpr int VEC = 8;
      const int cpr = G / VEC;
      for (int i = tid; i < U * cpr; i += NT) {
        const int u = i / cpr, c = (i % cpr) * VEC;
        *reinterpret_cast<uint4*>(W + (size_t)u * LDR + c) =
            *reinterpret_cast<const uint4*>(wr + (size_t)u * G + c);
      }
    } else {
      for (int i = tid; i < U * G; i += NT) W[(size_t)(i / G) * LDR + i % G] = wr[i];
    }
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
      block_product<T, U, true, MAXB>(out, LDO, stage, dg + ((size_t)(tt + 1) * bp + b0) * G,
                                      G, W, LDR, G, BB);
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
          v[jj][0] = to_f(ri[at]);
          v[jj][1] = to_f(rf[at]);
          v[jj][2] = to_f(ro[at]);
          v[jj][3] = to_f(rb[at]);
          v[jj][4] = to_f(rc[at]);
          v[jj][5] = tt > 0 ? to_f(rc[at - (size_t)bp * n])
                            : a.c0[(size_t)(b0 + p / U) * n + u0 + p % U];
          v[jj][6] = to_f(gout[at]);
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
          d[0] = from_f<T>(da_i);
          d[n] = from_f<T>(da_f);
          d[2 * n] = from_f<T>(da_o);
          d[3 * n] = from_f<T>(da_g);
          pi[q] += da_i * cp;
          pf[q] += da_f * cp;
          po[q] += da_o * ct;
          if (has_next) hp[at + (size_t)bp * n] = from_f<T>(ot * th);
          if (tt == 0) hp[at] = h0[at];
        }
      }
    }
    group_barrier(a.counter + bi, (unsigned int)((s + 1) * nj));
  }

  // dh0 = dg_0 . Wr^T and dc0
  block_product<T, U, true, MAXB>(out, LDO, stage, dg + (size_t)b0 * G, G, W, LDR, G, BB);
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

struct DwArgs {
  const void* hp;        // [m, n]
  const void* dg;        // [m, 4n]
  const float* partial;  // [nb, 3, n]
  float* dwr;            // [n, 4n]
  float* dwci;           // [n] each
  float* dwcf;
  float* dwco;
  int m, n, nb;
};

constexpr int TILE = 64;  // dWr tile per block: TILE x TILE (KC rows deep per chunk)

template <typename T> __host__ __device__ constexpr int dw_lds() { return TILE + Pad<T>::value; }
template <typename T> __host__ __device__ constexpr size_t dw_smem() {
  return 4 * round128(sizeof(T) * (size_t)KC * dw_lds<T>());  // two A, two B chunks
}

template <typename T>
__global__ void __launch_bounds__(NT) lstm_dw_kernel(DwArgs a) {
  constexpr int LDS = dw_lds<T>();
  constexpr size_t CH = round128(sizeof(T) * (size_t)KC * LDS);
  extern __shared__ __align__(128) unsigned char smem[];
  // chunk buffers: A = h_prev [KC rows][TILE units], B = dg [KC rows][TILE
  // gate columns]; the next pair is in flight while one is multiplied
  T* As[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem + CH)};
  T* Bs[2] = {reinterpret_cast<T*>(smem + 2 * CH), reinterpret_cast<T*>(smem + 3 * CH)};
  const int n = a.n, G = 4 * n, ncol = G / TILE;
  const int rt = blockIdx.x / ncol, ct = blockIdx.x % ncol;
  const int r0 = rt * TILE, c0 = ct * TILE;
  const int tid = threadIdx.x, warp = tid / 32;
  const T* hp = static_cast<const T*>(a.hp);
  const T* dg = static_cast<const T*>(a.dg);
  const int nk = (a.m + KC - 1) / KC;
  auto issue = [&](int kc) {
    const int m0 = kc * KC, valid = min(KC, a.m - m0);
    issue_chunk<T>(As[kc & 1], LDS, hp + (size_t)m0 * n, n, r0, KC, valid);
    issue_chunk<T>(Bs[kc & 1], LDS, dg + (size_t)m0 * G, G, c0, KC, valid);
  };
  issue(0);
  cp_async_commit();

  if constexpr (sizeof(T) == 2) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) issue(kc + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* A = As[kc & 1];
      const T* Bm = Bs[kc & 1];
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int tile = warp * 2 + q, tr = tile / 4, tc = tile % 4;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, A + kk * LDS + tr * 16, LDS);
          wmma::load_matrix_sync(fb, Bm + kk * LDS + tc * 16, LDS);
          wmma::mma_sync(acc[q], fa, fb, acc[q]);
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tile = warp * 2 + q, tr = tile / 4, tc = tile % 4;
      wmma::store_matrix_sync(a.dwr + (size_t)(r0 + tr * 16) * G + c0 + tc * 16, acc[q], G,
                              wmma::mem_row_major);
    }
  } else {
    const int tr = tid / 16, tc = tid % 16;  // a 4 x 4 micro tile each
    float acc[4][4] = {};
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) issue(kc + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* A = As[kc & 1];
      const T* Bm = Bs[kc & 1];
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = to_f(A[k * LDS + tr * 4 + i]);
          y[i] = to_f(Bm[k * LDS + tc * 4 + i]);
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
  }

  // the peephole gradients of this tile's units: the sweep's partials
  // summed over the batch blocks in order
  if (ct == 0 && tid < 3 * TILE) {
    const int g = tid / TILE, u = r0 + tid % TILE;
    float acc = 0.f;
    for (int b = 0; b < a.nb; ++b) acc += a.partial[((size_t)b * 3 + g) * n + u];
    (g == 0 ? a.dwci : (g == 1 ? a.dwcf : a.dwco))[u] = acc;
  }
}

template <typename T, int U, int MAXB>
int launch_sweep(const BwdArgs& args, cudaStream_t stream) {
  const size_t smem = sweep_smem<T, U>(args.n, args.BB);
  if (smem > SMEM_LIMIT || args.BB > MAXB) return (int)cudaErrorInvalidValue;
  auto kernel = lstm_bwd_kernel<T, U, MAXB>;
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

template <typename T>
int launch_dw(const DwArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = dw_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(lstm_dw_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lstm_dw_kernel<T><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
  BwdArgs a = {};
  a.res[0] = i; a.res[1] = f; a.res[2] = o; a.res[3] = blk; a.res[4] = c;
  a.gout = gout; a.wr = wr; a.wci = wci; a.wcf = wcf; a.wco = wco; a.h0 = h0; a.c0 = c0;
  a.gclast = gclast; a.dg = dg; a.hp = hp; a.dh0 = dh0; a.dc0 = dc0; a.partial = partial;
  a.counter = counter; a.t = t; a.bp = bp; a.n = n; a.BB = bb;
  if (t < 1 || n % 64 || n > 1024 || bb % 16 || bb < 16 || bb > MAX_BB || bp % bb ||
      counter == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {  // bf16: U >= 16 for the 16-wide tensor-core tiles
    if (u == 32) return launch_sweep<bf16, 32, MAX_BB>(a, s);
    if (u == 16) return launch_sweep<bf16, 16, MAX_BB>(a, s);
  } else if (dtype == 0) {  // f32: the per-thread row arrays sized by BB
    const bool small = bb <= 32;
    if (u == 32) return small ? launch_sweep<float, 32, 32>(a, s) : launch_sweep<float, 32, MAX_BB>(a, s);
    if (u == 16) return small ? launch_sweep<float, 16, 32>(a, s) : launch_sweep<float, 16, MAX_BB>(a, s);
    if (u == 8) return small ? launch_sweep<float, 8, 32>(a, s) : launch_sweep<float, 8, MAX_BB>(a, s);
    if (u == 4) return small ? launch_sweep<float, 4, 32>(a, s) : launch_sweep<float, 4, MAX_BB>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The weight gradients: dwr [n, 4n] f32 from hp [m, n] and dg [m, 4n]
// (m = t * bp rows, the sweep's outputs), and the peephole gradients
// from the sweep's partials [nb, 3, n].
extern "C" int dl4j_lstm_dw(const void* hp, const void* dg, const float* partial, float* dwr,
                            float* dwci, float* dwcf, float* dwco, int m, int n, int nb,
                            int dtype, void* stream) {
  if (m < 1 || n % TILE || n > 1024 || nb < 1) return (int)cudaErrorInvalidValue;
  DwArgs a = {hp, dg, partial, dwr, dwci, dwcf, dwco, m, n, nb};
  const dim3 grid((n / TILE) * (4 * n / TILE));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dw<bf16>(a, grid, s);
  if (dtype == 0) return launch_dw<float>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}
