// FA2-style causal prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefill_attention.py
// (`prefill_attention` / `_prefill_kernel`): q (B, T, H, D) against a
// (B, S, KV, D) cache span, S >= T; causal on absolute positions
// (k_idx <= q_offset[b] + q_idx), OR-ed with the prefix-LM mask
// k_idx < prefix_len[b]; causal=0 is full (encoder) attention.
//
// What bounds it on an H100: for a T-token prompt the causal products
// do 2*T^2*H*D flops against 4*T*D*(H+KV) bytes of Q, K, V and output,
// about 0.4*T flops per byte for llama3.1-8b's 32/8 heads -- bytes
// below T ~ 740 (the main path's 128-token prompts), the tensor cores
// above.  A 64-row query block reuses every K/V tile it loads 64 times
// (G*64 across the query heads of a kv head).  The design:
//   * one CTA per (q_block, head, batch row); the kv tiles are walked
//     in absolute tile order (tile j = keys [64j, 64j+64)) and the walk
//     stops at the block's causal limit (or the prefix end), so tiles
//     wholly in the future are never loaded;
//   * bf16: both products on tensor cores through WMMA (16x16x16 bf16
//     fragments, fp32 accumulate); fp32: plain FMA, so that the 1e-5
//     tolerance against the fp32 oracle holds;
//   * online softmax state (m, l) in fp32 shared memory, the output
//     accumulator in fp32 registers, divided by max(l, 1e-30) once;
//   * tile boundaries depend on neither q_offset nor T, and a tile that
//     is wholly masked for a row leaves that row's state bit-unchanged,
//     so a token's output is bitwise the same however its prompt was
//     split into chunks.
// Simple first version: synchronous tile loads, no cp.async/TMA ring
// and no wgmma yet.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

#include <type_traits>

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // keys per kv tile
constexpr int NT = 128;  // threads per CTA (4 warps, 16 query rows each)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory carve of one CTA (byte offsets).
template <typename TQ, typename TKV, int D>
struct Smem {
  static constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value &&
                               std::is_same<TKV, __nv_bfloat16>::value;
  static constexpr int LDQ = kMma ? D + 8 : D + 1;  // Q/K/V rows (elements)
  static constexpr int LDS = BK + 4;                 // fp32 scores
  static constexpr int LDP = BK + 8;                 // bf16 probabilities
  static constexpr int LDO = D + 4;                  // fp32 PV tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(TQ) * BQ * LDQ);
  static constexpr size_t v_off = align128(k_off + sizeof(TKV) * BK * LDQ);
  static constexpr size_t s_off = align128(v_off + sizeof(TKV) * BK * LDQ);
  static constexpr size_t p_off = align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t o_off =
      align128(p_off + (kMma ? sizeof(__nv_bfloat16) * BQ * LDP : 0));
  static constexpr size_t row_off =
      align128(o_off + (kMma ? sizeof(float) * BQ * LDO : 0));
  static constexpr size_t bytes = align128(row_off + sizeof(float) * 3 * BQ);
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NT)
    prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const int* __restrict__ prefix_len,
                   const int* __restrict__ q_offset, TQ* __restrict__ out,
                   int T_len, int S, int H, int KV, int causal, float scale) {
  using L = Smem<TQ, TKV, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem + L::q_off);
  TKV* Ks = reinterpret_cast<TKV*>(smem + L::k_off);
  TKV* Vs = reinterpret_cast<TKV*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* row_m = reinterpret_cast<float*>(smem + L::row_off);
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int kvh = h / (H / KV);
  const int qoff = q_offset[b];
  const int pre = prefix_len[b];
  const int q0 = qb * BQ;
  const size_t kv_row = (size_t)KV * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * L::LDQ + d] =
        t < T_len ? q[(((size_t)b * T_len + t) * H + h) * D + d]
                  : from_float<TQ>(0.f);
  }
  if (tid < BQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  constexpr int PER = BQ * D / NT;
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last = max(qoff + q0 + BQ - 1, pre - 1);
    n_tiles = min(n_tiles, last / BK + 1);
  }
  const int warp = tid / 32;

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // readers of the previous tile are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int s = kt * BK + r;
      const size_t off = ((size_t)b * S + s) * kv_row + (size_t)kvh * D + d;
      Ks[r * L::LDQ + d] = s < S ? k[off] : from_float<TKV>(0.f);
      Vs[r * L::LDQ + d] = s < S ? v[off] : from_float<TKV>(0.f);
    }
    __syncthreads();

    // scores S = Q K^T (unscaled)
    if constexpr (L::kMma) {
      using namespace nvcuda;
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
        for (int kk = 0; kk < D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              fb;
          wmma::load_matrix_sync(fa, Qs + (warp * 16) * L::LDQ + kk, L::LDQ);
          wmma::load_matrix_sync(fb, Ks + (n * 16) * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(c, fa, fb, c);
        }
        wmma::store_matrix_sync(Ss + (warp * 16) * L::LDS + n * 16, c, L::LDS,
                                wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        const TQ* qr = Qs + r * L::LDQ;
        const TKV* kr = Ks + c * L::LDQ;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += to_float(qr[d]) * to_float(kr[d]);
        Ss[r * L::LDS + c] = dot;
      }
    }
    __syncthreads();

    // mask + online softmax: two adjacent lanes per query row
    {
      const int r = tid >> 1;
      const int half = tid & 1;
      const int qpos = qoff + q0 + r;
      float* srow = Ss + r * L::LDS;
      const int c0 = half * (BK / 2);
      float mx = kNegInf;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int kidx = kt * BK + c;
        const bool ok =
            kidx < S && (!causal || kidx <= qpos || kidx < pre);
        const float s = ok ? srow[c] * scale : kNegInf;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const float p = expf(srow[c] - m_new);
        if constexpr (L::kMma) {
          Ps[r * L::LDP + c] = __float2bfloat16(p);
        } else {
          srow[c] = p;
        }
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float corr = expf(m_prev - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
    if constexpr (L::kMma) {
      using namespace nvcuda;
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fb;
          wmma::load_matrix_sync(fa, Ps + (warp * 16) * L::LDP + kk, L::LDP);
          wmma::load_matrix_sync(fb, Vs + kk * L::LDQ + n * 16, L::LDQ);
          wmma::mma_sync(c, fa, fb, c);
        }
        wmma::store_matrix_sync(Os + (warp * 16) * L::LDO + n * 16, c, L::LDO,
                                wmma::mem_row_major);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = tid + NT * j;
        const int r = i / D, d = i % D;
        acc[j] = acc[j] * row_c[r] + Os[r * L::LDO + d];
      }
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = tid + NT * j;
        const int r = i / D, d = i % D;
        const float* prow = Ss + r * L::LDS;
        float a = 0.f;
#pragma unroll 8
        for (int c = 0; c < BK; ++c) a += prow[c] * to_float(Vs[c * L::LDQ + d]);
        acc[j] = acc[j] * row_c[r] + a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + NT * j;
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    if (t < T_len)
      out[(((size_t)b * T_len + t) * H + h) * D + d] =
          from_float<TQ>(acc[j] / fmaxf(row_l[r], 1e-30f));
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const int* prefix_len,
           const int* q_offset, void* out, int B, int T_len, int S, int H,
           int KV, int causal, cudaStream_t stream) {
  using L = Smem<TQ, TKV, D>;
  auto kern = prefill_kernel<TQ, TKV, D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  APEX_LAUNCH(kern, grid, dim3(NT), L::bytes, stream, (const TQ*)q,
              (const TKV*)k, (const TKV*)v, prefix_len, q_offset, (TQ*)out,
              T_len,
              S, H, KV, causal, scale);
  return 0;
}

template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const int* prefix_len,
             const int* q_offset, void* out, int B, int T_len, int S, int H,
             int KV, int D, int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, prefix_len, q_offset, out, B, T_len, S, H,
                           KV, causal, stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, prefix_len, q_offset, out, B, T_len, S, H,
                           KV, causal, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, prefix_len, q_offset, out, B, T_len, S,
                            H, KV, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int apex_prefill_attention(const void* q, const void* k,
                                      const void* v, const void* prefix_len,
                                      const void* q_offset, void* out, int B,
                                      int T_len, int S, int H, int KV, int D,
                                      int q_bf16, int kv_bf16, int causal,
                                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* pre = (const int*)prefix_len;
  const int* qoff = (const int*)q_offset;
  int rc = (int)cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16)
    rc = dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pre, qoff, out, B,
                                                T_len, S, H, KV, D, causal, st);
  else if (!q_bf16 && !kv_bf16)
    rc = dispatch<float, float>(q, k, v, pre, qoff, out, B, T_len, S, H, KV, D,
                                causal, st);
  else if (!q_bf16 && kv_bf16)  // fp32 model over the bf16 KV cache
    rc = dispatch<float, __nv_bfloat16>(q, k, v, pre, qoff, out, B, T_len, S,
                                        H, KV, D, causal, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
