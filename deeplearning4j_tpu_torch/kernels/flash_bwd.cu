// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// the dq kernel and the dk/dv kernel.
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/flash_attention.py
// `_flash_bwd_impl` -> `_dq_kernel` and `_dkv_kernel` (shared `_bwd_block`).
// Inputs are those of the reference's backward: qs = q * (1/sqrt(d)) rounded
// to q's dtype, k, v, dO [bh, t, d]; lse and delta = rowsum(dO * O) in f32
// [bh, tq]. The probabilities are rebuilt tile by tile from (qs, k, lse), so
// the [t, t] matrix never exists in device memory:
//
//   s  = qs k^T      p = exp(s - lse)      dP = dO v^T
//   ds = p * (dP - delta), rounded to the operand dtype
//   dq = scale * sum_j ds_ij k_j      (flash_dq)
//   dv = sum_i p_ij dO_i, p rounded to v's dtype;  dk = sum_i ds_ij qs_i  (flash_dkv)
//
// The causal mask keeps the reference's finite -1e30 sentinel (offset =
// tk - tq); key tiles above the diagonal are skipped; keys past tk and query
// rows past tq (the ragged last tile) contribute an exact zero.
//
// Design. The TPU kernels carry their accumulators across a sequential grid
// axis in VMEM. Here that axis becomes a loop inside the block, and each
// block owns its output rows, so no two blocks write the same element: no
// atomics, no cross-block reduction, and the result is deterministic.
//   flash_dq:  one block per (bh, 64-row q tile), looping over the 64-key
//              tiles up to the causal diagonal; the dq accumulator is f32 in
//              shared memory.
//   flash_dkv: one block per (bh, 64-row key tile), looping over the q tiles
//              from the diagonal to tq; it builds the score tile transposed
//              ([keys, queries], as the reference's `_bwd_block` does), so
//              p^T dO and ds^T qs are plain row-major products; the dk and dv
//              accumulators are f32 in shared memory.
// bf16 products run on the tensor cores through WMMA 16x16x16 fragments with
// f32 accumulation; f32 inputs use CUDA-core FMAs (no TF32), so f32 results
// keep full f32 precision. A block is 128 threads (4 warps); its shared
// memory (up to ~213 KB) is set with cudaFuncSetAttribute, so one block runs
// per SM. What bounds it: at the training shape [128, 1024, 64] bf16 causal
// the work is operations (6 d flops per live (q, k) pair in dq, 8 d in dk/dv)
// against a few MB moved; this simple version (no TMA, no wgmma, synchronous
// tile loads, one block per SM) is far from that bound.
//
// Exposed as plain C functions so that no PyTorch header is compiled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;   // flash_dq: query rows per block
constexpr int BK = 64;   // keys per tile (flash_dq: per step; flash_dkv: per block)
constexpr int NT = 128;  // 4 warps
constexpr float NEG_INF_SENTINEL = -1e30f;  // the reference's finite -inf
constexpr size_t SMEM_LIMIT = 232448;       // an H100 block's opt-in maximum

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 1; };  // bank spread
template <> struct Pad<bf16> { static constexpr int value = 8; };   // keeps WMMA rows 32-byte aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

constexpr size_t round32(size_t n) { return (n + 31) / 32 * 32; }

// f32 tiles: WMMA needs a leading dimension that is a multiple of 4
template <typename T> constexpr int ld_f32(int n) { return sizeof(T) == 2 ? n + 4 : n + 1; }

// Rows [row0, row0 + nrows) of a row-major [t, D] matrix into shared memory
// with leading dimension LD; rows at or past t become zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int t, int nrows) {
  if constexpr (sizeof(T) == 2) {
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < nrows * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < t) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < nrows * D; i += NT) {
      const int r = i / D, c = i % D;
      dst[r * LD + c] = (row0 + r < t) ? src[(size_t)(row0 + r) * D + c] : from_f<T>(0.f);
    }
  }
}

// C[M, N] (f32) = A[M, K] . B[N, K]^T, A and B row-major in shared memory.
template <typename T, int M, int N, int K>
__device__ __forceinline__ void mm_abt(float* C, int ldc, const T* A, int lda, const T* B, int ldb) {
  if constexpr (sizeof(T) == 2) {
    const int warp = threadIdx.x / 32;
    for (int tile = warp; tile < (M / 16) * (N / 16); tile += NT / 32) {
      const int mi = tile / (N / 16), ni = tile % (N / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + (16 * mi) * lda + kk * 16, lda);
        wmma::load_matrix_sync(b, B + (16 * ni) * ldb + kk * 16, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + (16 * mi) * ldc + ni * 16, acc, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += NT) {
      const int r = i / N, c = i % N;
      float s = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < K; ++kk) s += to_f(A[r * lda + kk]) * to_f(B[c * ldb + kk]);
      C[r * ldc + c] = s;
    }
  }
}

// C[M, N] (f32) += A[M, K] . B[K, N], A and B row-major in shared memory.
template <typename T, int M, int N, int K>
__device__ __forceinline__ void mm_ab_acc(float* C, int ldc, const T* A, int lda, const T* B, int ldb) {
  if constexpr (sizeof(T) == 2) {
    const int warp = threadIdx.x / 32;
    for (int tile = warp; tile < (M / 16) * (N / 16); tile += NT / 32) {
      const int mi = tile / (N / 16), ni = tile % (N / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, C + (16 * mi) * ldc + ni * 16, ldc, wmma::mem_row_major);
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + (16 * mi) * lda + kk * 16, lda);
        wmma::load_matrix_sync(b, B + (16 * kk) * ldb + ni * 16, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + (16 * mi) * ldc + ni * 16, acc, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += NT) {
      const int r = i / N, c = i % N;
      float s = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < K; ++kk) s += to_f(A[r * lda + kk]) * to_f(B[kk * ldb + c]);
      C[r * ldc + c] += s;
    }
  }
}

// p for query row qrow and key column kcol, from the raw score s
__device__ __forceinline__ float prob(float s, float lse, int qrow, int kcol, int tq, int tk,
                                      int offset, int causal) {
  if (qrow >= tq || kcol >= tk) return 0.f;  // ragged edge: not in the problem at all
  if (causal && qrow + offset < kcol) s = NEG_INF_SENTINEL;
  return expf(s - lse);
}

// ------------------------------------------------------------------ flash_dq

template <typename T, int D>
struct DqLayout {
  static constexpr int LDT = D + Pad<T>::value;  // qs, dO, k, v rows
  static constexpr int LDS = ld_f32<T>(BK);       // f32 s and dP tiles
  static constexpr int LDP = BK + Pad<T>::value;  // ds, in T
  static constexpr int LDA = ld_f32<T>(D);        // f32 dq accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + round32(sizeof(T) * BQ * LDT);
  static constexpr size_t k_off = do_off + round32(sizeof(T) * BQ * LDT);
  static constexpr size_t v_off = k_off + round32(sizeof(T) * BK * LDT);
  static constexpr size_t s_off = v_off + round32(sizeof(T) * BK * LDT);
  static constexpr size_t dp_off = s_off + round32(sizeof(float) * BQ * LDS);
  static constexpr size_t ds_off = dp_off + round32(sizeof(float) * BQ * LDS);
  static constexpr size_t acc_off = ds_off + round32(sizeof(T) * BQ * LDP);
  static constexpr size_t lse_off = acc_off + round32(sizeof(float) * BQ * LDA);
  static constexpr size_t dl_off = lse_off + round32(sizeof(float) * BQ);
  static constexpr size_t bytes = dl_off + round32(sizeof(float) * BQ);
  static_assert(bytes <= SMEM_LIMIT, "flash_dq shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                int tq, int tk, int n_qtiles, int causal, float scale) {
  using Lay = DqLayout<T, D>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP, LDA = Lay::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::q_off);
  T* dOs = reinterpret_cast<T*>(smem + Lay::do_off);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k_off);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  float* dPs = reinterpret_cast<float*>(smem + Lay::dp_off);
  T* dSs = reinterpret_cast<T*>(smem + Lay::ds_off);
  float* Acc = reinterpret_cast<float*>(smem + Lay::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + Lay::dl_off);

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int offset = tk - tq;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  load_rows<T, D, LDT>(Qs, qs + (size_t)bh * tq * D, q0, tq, BQ);
  load_rows<T, D, LDT>(dOs, dout + (size_t)bh * tq * D, q0, tq, BQ);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool ok = q0 + r < tq;
    lse_s[r] = ok ? lse[(size_t)bh * tq + q0 + r] : 0.f;
    dl_s[r] = ok ? delta[(size_t)bh * tq + q0 + r] : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * LDA; i += NT) Acc[i] = 0.f;

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_ktiles = (k_end + BK - 1) / BK;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * BK;
    load_rows<T, D, LDT>(Ks, kb, k0, tk, BK);
    load_rows<T, D, LDT>(Vs, vb, k0, tk, BK);
    __syncthreads();
    mm_abt<T, BQ, BK, D>(Ss, LDS, Qs, LDT, Ks, LDT);    // s = qs k^T
    mm_abt<T, BQ, BK, D>(dPs, LDS, dOs, LDT, Vs, LDT);  // dP = dO v^T
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const float p = prob(Ss[r * LDS + c], lse_s[r], q0 + r, k0 + c, tq, tk, offset, causal);
      dSs[r * LDP + c] = from_f<T>(p * (dPs[r * LDS + c] - dl_s[r]));
    }
    __syncthreads();
    mm_ab_acc<T, BQ, D, BK>(Acc, LDA, dSs, LDP, Ks, LDT);  // acc += ds k
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    if (q0 + r < tq) dq[((size_t)bh * tq + q0 + r) * D + c] = from_f<T>(Acc[r * LDA + c] * scale);
  }
}

// ----------------------------------------------------------------- flash_dkv

template <typename T, int D>
struct DkvLayout {
  // query rows per step: 32 in f32, where 64 would not fit beside the two
  // f32 accumulators at d = 128
  static constexpr int BQT = sizeof(T) == 2 ? 64 : 32;
  static constexpr int LDT = D + Pad<T>::value;    // k, v, qs, dO rows
  static constexpr int LDS = ld_f32<T>(BQT);        // f32 s^T and dP^T tiles [BK, BQT]
  static constexpr int LDP = BQT + Pad<T>::value;   // p^T and ds^T, in T
  static constexpr int LDA = ld_f32<T>(D);          // f32 dk and dv accumulators
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + round32(sizeof(T) * BK * LDT);
  static constexpr size_t q_off = v_off + round32(sizeof(T) * BK * LDT);
  static constexpr size_t do_off = q_off + round32(sizeof(T) * BQT * LDT);
  static constexpr size_t s_off = do_off + round32(sizeof(T) * BQT * LDT);
  static constexpr size_t dp_off = s_off + round32(sizeof(float) * BK * LDS);
  static constexpr size_t p_off = dp_off + round32(sizeof(float) * BK * LDS);
  static constexpr size_t ds_off = p_off + round32(sizeof(T) * BK * LDP);
  static constexpr size_t dk_off = ds_off + round32(sizeof(T) * BK * LDP);
  static constexpr size_t dv_off = dk_off + round32(sizeof(float) * BK * LDA);
  static constexpr size_t lse_off = dv_off + round32(sizeof(float) * BK * LDA);
  static constexpr size_t dl_off = lse_off + round32(sizeof(float) * BQT);
  static constexpr size_t bytes = dl_off + round32(sizeof(float) * BQT);
  static_assert(bytes <= SMEM_LIMIT, "flash_dkv shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int tq, int tk, int n_ktiles, int causal) {
  using Lay = DkvLayout<T, D>;
  constexpr int BQT = Lay::BQT;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP, LDA = Lay::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + Lay::k_off);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v_off);
  T* Qs = reinterpret_cast<T*>(smem + Lay::q_off);
  T* dOs = reinterpret_cast<T*>(smem + Lay::do_off);
  float* St = reinterpret_cast<float*>(smem + Lay::s_off);
  float* dPt = reinterpret_cast<float*>(smem + Lay::dp_off);
  T* Pt = reinterpret_cast<T*>(smem + Lay::p_off);
  T* dSt = reinterpret_cast<T*>(smem + Lay::ds_off);
  float* dKa = reinterpret_cast<float*>(smem + Lay::dk_off);
  float* dVa = reinterpret_cast<float*>(smem + Lay::dv_off);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + Lay::dl_off);

  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * BK;
  const int offset = tk - tq;
  const T* qb = qs + (size_t)bh * tq * D;
  const T* db = dout + (size_t)bh * tq * D;

  load_rows<T, D, LDT>(Ks, k + (size_t)bh * tk * D, k0, tk, BK);
  load_rows<T, D, LDT>(Vs, v + (size_t)bh * tk * D, k0, tk, BK);
  for (int i = threadIdx.x; i < BK * LDA; i += NT) {
    dKa[i] = 0.f;
    dVa[i] = 0.f;
  }

  // causal: the first query row that sees any key of this tile (< tq,
  // since k0 - offset <= tq - 1)
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  const int n_qtiles = (tq + BQT - 1) / BQT;

  for (int qt = q_begin / BQT; qt < n_qtiles; ++qt) {
    const int q0 = qt * BQT;
    load_rows<T, D, LDT>(Qs, qb, q0, tq, BQT);
    load_rows<T, D, LDT>(dOs, db, q0, tq, BQT);
    for (int c = threadIdx.x; c < BQT; c += NT) {
      const bool ok = q0 + c < tq;
      lse_s[c] = ok ? lse[(size_t)bh * tq + q0 + c] : 0.f;
      dl_s[c] = ok ? delta[(size_t)bh * tq + q0 + c] : 0.f;
    }
    __syncthreads();
    mm_abt<T, BK, BQT, D>(St, LDS, Ks, LDT, Qs, LDT);    // s^T = k qs^T
    mm_abt<T, BK, BQT, D>(dPt, LDS, Vs, LDT, dOs, LDT);  // dP^T = v dO^T
    __syncthreads();
    for (int i = threadIdx.x; i < BK * BQT; i += NT) {
      const int r = i / BQT, c = i % BQT;  // r: key, c: query
      const float p = prob(St[r * LDS + c], lse_s[c], q0 + c, k0 + r, tq, tk, offset, causal);
      Pt[r * LDP + c] = from_f<T>(p);
      dSt[r * LDP + c] = from_f<T>(p * (dPt[r * LDS + c] - dl_s[c]));
    }
    __syncthreads();
    mm_ab_acc<T, BK, D, BQT>(dVa, LDA, Pt, LDP, dOs, LDT);  // dv += p^T dO
    mm_ab_acc<T, BK, D, BQT>(dKa, LDA, dSt, LDP, Qs, LDT);  // dk += ds^T qs
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int r = i / D, c = i % D;
    if (k0 + r < tk) {
      const size_t at = ((size_t)bh * tk + k0 + r) * D + c;
      dk[at] = from_f<T>(dKa[r * LDA + c]);
      dv[at] = from_f<T>(dVa[r * LDA + c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* qs, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int bh, int tq, int tk, int causal, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = DqLayout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + BQ - 1) / BQ;
  flash_dq_kernel<T, D><<<bh * n_qtiles, NT, smem, stream>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), tq, tk, n_qtiles, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* qs, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int bh, int tq, int tk, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = DkvLayout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ktiles = (tk + BK - 1) / BK;
  flash_dkv_kernel<T, D><<<bh * n_ktiles, NT, smem, stream>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), tq, tk,
      n_ktiles, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// qs, k, v, dout, dq: contiguous [bh, t, d], 16-byte aligned; lse, delta:
// contiguous f32 [bh, tq]. dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 on success); an unsupported head size returns
// cudaErrorInvalidValue.
extern "C" int dl4j_flash_dq(const void* qs, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq, int bh, int tq,
                             int tk, int d, int causal, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (d == 64) return launch_dq<bf16, 64>(qs, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
    if (d == 128) return launch_dq<bf16, 128>(qs, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
  } else if (dtype == 0) {
    if (d == 64) return launch_dq<float, 64>(qs, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
    if (d == 128) return launch_dq<float, 128>(qs, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Same inputs as dl4j_flash_dq; dk, dv: contiguous [bh, tk, d].
extern "C" int dl4j_flash_dkv(const void* qs, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int bh,
                              int tq, int tk, int d, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (d == 64) return launch_dkv<bf16, 64>(qs, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
    if (d == 128) return launch_dkv<bf16, 128>(qs, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
  } else if (dtype == 0) {
    if (d == 64) return launch_dkv<float, 64>(qs, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
    if (d == 128) return launch_dkv<float, 128>(qs, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The head sizes the kernels are built for, for the wrapper's checks.
extern "C" int dl4j_flash_bwd_supports(int d) { return d == 64 || d == 128; }
