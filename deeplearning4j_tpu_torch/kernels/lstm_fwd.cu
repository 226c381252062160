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
// (f32) at the last step. Both run the same device function for the cell.
//
// Design. On the TPU the whole [n, 4n] Wr stays in VMEM across the
// sequential t axis; on Hopper it does not fit one SM (2 MB at n = 512 in
// bf16). So one persistent launch covers the whole sequence: block
// (bi, j) owns batch rows [bi BB, +BB) and hidden units [j U, +U), keeps
// the 4U columns of Wr for those units resident in shared memory (up to
// ~140 KB; the wrapper narrows U, down to 16 in bf16 and 4 in f32, where
// a small batch would leave most SMs idle) and its slice of the f32 c
// carry in registers, and loops over t inside the kernel. Per step it reads the h_{t-1} rows of its batch
// block from h_seq[t-1] (written by the other blocks of its group in the
// step before; L2-resident), multiplies them by its resident columns
// (WMMA bf16 -> f32, or f32 FMAs), applies the gates and writes its slice
// of h_seq[t] and the residuals. A counter barrier per batch group
// separates the steps; writing h_t into h_seq[t] while others read
// h_seq[t - 1] needs no double buffer. The launch is cooperative, so the
// grid is co-resident or the launch fails.
//
// What bounds it: at the training shape (b 1024, n 512, bf16) the
// recurrent product, 2 t b n 4n flops, on the tensor cores; at the
// serving shape (b 32, t 1) reading Wr once (launch-bound in practice).
// This is the simple first version: WMMA from shared memory, each
// 64-deep chunk of h_{t-1} staged by cp.async while the one before is
// multiplied, no TMA, no wgmma.
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
  const size_t out = sizeof(float) * (size_t)BB * ldo<U>();
  const size_t stage = stage_bytes<T>(BB);
  return w + round128(out > stage ? out : stage);
}

// One Graves step for one (row, unit): the gates from the pre-activations
// g_* (product + xg), the c carry advanced in place; returns h.
__device__ __forceinline__ float cell(float gi, float gf, float go, float gg, float wci, float wcf,
                                      float wco, float& c, float& i, float& f, float& o,
                                      float& blk) {
  const float cp = c;
  i = sigmoidf_(gi + cp * wci);
  f = sigmoidf_(gf + cp * wcf);
  blk = tanhf(gg);
  c = f * cp + i * blk;
  o = sigmoidf_(go + c * wco);
  return o * tanhf(c);
}

// (row, unit) pairs a thread owns, at most, for MAXB rows of U units,
// and how many of them are worked on together
template <int U, int MAXB> __host__ __device__ constexpr int pairs() {
  return (MAXB * U + NT - 1) / NT;
}
template <int U, int MAXB> __host__ __device__ constexpr int pair_batch() {
  return pairs<U, MAXB>() < 4 ? pairs<U, MAXB>() : 4;
}

template <typename T, int U, bool RES, int MAXB>
__global__ void __launch_bounds__(NT, 1) lstm_fwd_kernel(FwdArgs a) {
  constexpr int LDW = ldw<T, U>(), LDO = ldo<U>();
  constexpr int PAIRS = pairs<U, MAXB>(), QB = pair_batch<U, MAXB>();
  extern __shared__ __align__(128) unsigned char smem[];
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
    block_product<T, 4 * U, false, MAXB>(out, LDO, stage, hprev, n, W, LDW, n, BB);
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
          const float h = cell(o_r[0] + xv[jj][0], o_r[U] + xv[jj][1], o_r[2 * U] + xv[jj][2],
                               o_r[3 * U] + xv[jj][3], a.wci[u0 + u], a.wcf[u0 + u],
                               a.wco[u0 + u], creg[q], i, f, o, blk);
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
    if (s + 1 < a.t) group_barrier(a.counter + bi, (unsigned int)((s + 1) * nj));
  }
}

template <typename T, int U, bool RES, int MAXB>
int launch(const FwdArgs& args, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, U>(args.n, args.BB);
  if (smem > SMEM_LIMIT || args.BB > MAXB) return (int)cudaErrorInvalidValue;
  auto kernel = lstm_fwd_kernel<T, U, RES, MAXB>;
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

template <bool RES>
int dispatch(const FwdArgs& a, int u, int dtype, cudaStream_t s) {
  if (a.t < 1 || a.n % 64 || a.n > 1024 || a.BB % 16 || a.BB < 16 || a.BB > MAX_BB ||
      a.bp % a.BB || (a.t > 1 && a.counter == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {  // bf16: U >= 16 for the 16-wide tensor-core tiles
    if (u == 32) return launch<bf16, 32, RES, MAX_BB>(a, s);
    if (u == 16) return launch<bf16, 16, RES, MAX_BB>(a, s);
  } else if (dtype == 0) {  // f32: the per-thread row arrays sized by BB
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

extern "C" int dl4j_lstm_fwd_only(const void* xg, const void* wr, const float* wci,
                                  const float* wcf, const float* wco, const void* h0,
                                  const float* c0, void* hseq, void* hT, float* cT,
                                  unsigned int* counter, int t, int bp, int n, int bb, int u,
                                  int dtype, void* stream) {
  FwdArgs a = make_args(xg, wr, wci, wcf, wco, h0, c0, hseq, counter, t, bp, n, bb);
  a.hT = hT; a.cT = cT;
  return dispatch<false>(a, u, dtype, static_cast<cudaStream_t>(stream));
}
