// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/flash_attention.py
// `_flash_fwd_impl` -> `_fwd_kernel`: blocked online-softmax attention over
// q, k, v [bh, t, d] (q already scaled by 1/sqrt(d) in its own dtype),
// causal mask with offset = tk - tq, key blocks above the diagonal skipped,
// softmax statistics and the output accumulated in f32. Emits o [bh, tq, d]
// in q's dtype and lse = m + log(max(l, 1e-30)) [bh, tq] in f32.
//
// What bounds it: at the shapes the GPT prefill gives it (t = 64, d = 64)
// the work is tiny and launch latency dominates; at long t it is bound by
// operations (4 * t^2 * d flops against 4 * t * d elements moved). The TPU
// version sized 1024 x 1024 blocks for 16 MB of VMEM; here a block of 128
// threads (4 warps) owns 64 query rows and walks 64-key tiles of K and V
// through shared memory (about 104 KB at d = 128 in bf16), so several
// blocks share an SM and the O(t^2) scores never reach device memory.
// bf16 products run on the tensor cores through WMMA 16x16x16 fragments
// with f32 accumulation (each warp owns 16 query rows); f32 inputs use
// CUDA-core FMAs so the result keeps full f32 precision. This is the
// simple first version: no TMA, no wgmma, no warp specialisation.
//
// Exposed as a plain C function so that no PyTorch header is compiled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 128;       // 4 warps; warp w owns query rows [16w, 16w + 16)
constexpr float NEG_INF_SENTINEL = -1e30f;  // the reference's finite -inf

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 1; };  // bank spread
template <> struct Pad<bf16> { static constexpr int value = 8; };   // keeps WMMA rows 16-byte aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

constexpr size_t round32(size_t n) { return (n + 31) / 32 * 32; }

// Shared-memory layout of one block. Every array starts on a 32-byte
// boundary, which WMMA loads and stores require.
template <typename T, int D>
struct Layout {
  static constexpr int LDT = D + Pad<T>::value;   // q, k, v rows
  static constexpr int LDP = BK + Pad<T>::value;  // probabilities, in T
  static constexpr int LDS = BK + 4;              // f32 scores
  static constexpr int LDO = D + 4;               // f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + round32(sizeof(T) * BQ * LDT);
  static constexpr size_t v_off = k_off + round32(sizeof(T) * BK * LDT);
  static constexpr size_t s_off = v_off + round32(sizeof(T) * BK * LDT);
  static constexpr size_t p_off = s_off + round32(sizeof(float) * BQ * LDS);
  static constexpr size_t o_off = p_off + round32(sizeof(T) * BQ * LDP);
  static constexpr size_t m_off = o_off + round32(sizeof(float) * BQ * LDO);
  static constexpr size_t l_off = m_off + round32(sizeof(float) * BQ);
  static constexpr size_t c_off = l_off + round32(sizeof(float) * BQ);
  static constexpr size_t bytes = c_off + round32(sizeof(float) * BQ);
};

// Rows [row0, row0 + nrows) of a row-major [t, D] matrix into shared
// memory with leading dimension LD; rows at or past t become zeros.
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 int tq, int tk, int n_qtiles, int causal) {
  using Lay = Layout<T, D>;
  constexpr int LDT = Lay::LDT, LDP = Lay::LDP, LDS = Lay::LDS, LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::q_off);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k_off);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  T* Ps = reinterpret_cast<T*>(smem + Lay::p_off);
  float* Os = reinterpret_cast<float*>(smem + Lay::o_off);
  float* m_s = reinterpret_cast<float*>(smem + Lay::m_off);
  float* l_s = reinterpret_cast<float*>(smem + Lay::l_off);
  float* c_s = reinterpret_cast<float*>(smem + Lay::c_off);

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int offset = tk - tq;
  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  load_rows<T, D, LDT>(Qs, qb, q0, tq, BQ);
  for (int i = threadIdx.x; i < BQ * LDO; i += NT) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    m_s[i] = NEG_INF_SENTINEL;
    l_s[i] = 0.f;
  }

  // causal: the last key any valid row of this tile may see
  int k_end = tk;
  if (causal) k_end = min(tk, min(q0 + BQ, tq) + offset);
  const int n_ktiles = (k_end + BK - 1) / BK;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * BK;
    load_rows<T, D, LDT>(Ks, kb, k0, tk, BK);
    load_rows<T, D, LDT>(Vs, vb, k0, tk, BK);
    __syncthreads();

    // S = Q K^T  (f32)
    if constexpr (sizeof(T) == 2) {
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, Qs + (16 * warp) * LDT + kk * 16, LDT);
          wmma::load_matrix_sync(b, Ks + (16 * n) * LDT + kk * 16, LDT);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(Ss + (16 * warp) * LDS + n * 16, acc, LDS, wmma::mem_row_major);
      }
    } else {
      for (int i = threadIdx.x; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s += to_f(Qs[r * LDT + d]) * to_f(Ks[c * LDT + d]);
        Ss[r * LDS + c] = s;
      }
    }
    __syncthreads();

    // online softmax: each warp walks its 16 rows, each lane two columns
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * warp + rr;
      const int qrow = q0 + r;
      float s[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        const int kcol = k0 + c;
        float x = Ss[r * LDS + c];
        if (kcol >= tk) x = -INFINITY;  // past the last key: not in the row at all
        else if (causal && qrow + offset < kcol) x = NEG_INF_SENTINEL;
        s[j] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = expf(s[j] - m_new);
        sum += p;
        Ps[r * LDP + lane + 32 * j] = from_f<T>(p);
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
    if constexpr (sizeof(T) == 2) {
      for (int i = lane; i < 16 * D; i += 32) {
        const int r = 16 * warp + i / D;
        Os[r * LDO + i % D] *= c_s[r];
      }
      __syncwarp();
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Os + (16 * warp) * LDO + n * 16, LDO, wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, Ps + (16 * warp) * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(b, Vs + (16 * kk) * LDT + n * 16, LDT);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(Os + (16 * warp) * LDO + n * 16, acc, LDO, wmma::mem_row_major);
      }
    } else {
      for (int i = threadIdx.x; i < BQ * D; i += NT) {
        const int r = i / D, c = i % D;
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < BK; ++j) acc += to_f(Ps[r * LDP + j]) * to_f(Vs[j * LDT + c]);
        Os[r * LDO + c] = Os[r * LDO + c] * c_s[r] + acc;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    if (q0 + r < tq) {
      const float denom = fmaxf(l_s[r], 1e-30f);
      o[((size_t)bh * tq + q0 + r) * D + c] = from_f<T>(Os[r * LDO + c] / denom);
    }
  }
  for (int r = threadIdx.x; r < BQ; r += NT) {
    if (q0 + r < tq) lse[(size_t)bh * tq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int tq, int tk, int causal, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (tq + BQ - 1) / BQ;
  flash_fwd_kernel<T, D><<<bh * n_qtiles, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, tq, tk, n_qtiles, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [bh, t, d], 16-byte aligned; lse: contiguous f32
// [bh, tq]. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 on success); an unsupported head size returns cudaErrorInvalidValue.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int bh, int tq, int tk, int d, int causal, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (d == 64) return launch<bf16, 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
    if (d == 128) return launch<bf16, 128>(q, k, v, o, lse, bh, tq, tk, causal, s);
  } else if (dtype == 0) {
    if (d == 64) return launch<float, 64>(q, k, v, o, lse, bh, tq, tk, causal, s);
    if (d == 128) return launch<float, 128>(q, k, v, o, lse, bh, tq, tk, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The head sizes the kernel is built for, for the wrapper's checks.
extern "C" int dl4j_flash_fwd_supports(int d) { return d == 64 || d == 128; }
