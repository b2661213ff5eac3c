// Split-KV flash-decoding GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`decode_attention` / `_decode_kernel`): one fresh query per row
// attends over a contiguous (B, S, KV, D) cache with per-row valid
// lengths; softmax in fp32, output divided by max(l, 1e-30).
//
// What bounds it on an H100: bytes.  Every cached K/V position is read
// once and used by only G = H/KV query heads, so the kernel does about
// 4·G flops per byte read -- two orders of magnitude below the card's
// balance point.  The design therefore spends its effort on reading
// each byte once and keeping enough loads in flight:
//   * one CTA per (split, kv_head, batch row); the G query heads of a
//     kv head share every K/V row a warp loads;
//   * each CTA reads only positions [split*split_size, min(.., len)),
//     so positions >= lengths[b] are never read (the TPU kernel streams
//     the whole zero-padded S);
//   * the KV axis is split so a decode batch of a few rows still fills
//     the 132 SMs; each CTA's four warps walk disjoint positions with
//     their own online-softmax state (m, l, acc in fp32 registers),
//     merged through shared memory into one partial per CTA;
//   * a small combine kernel folds the per-split partials (scratch the
//     wrapper allocates) into the output.
// Simple first version: one K/V row per warp per step, no cp.async or
// TMA pipelining yet.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (num_splits, KV, B), block kWarps*32.  Writes, per (b, kv_head,
// split, g): part_ml = (m, l) and part_acc = unnormalised acc (D).
template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
    decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int H, int KV, int S,
                        int split_size, int num_splits, float scale) {
  constexpr int VEC = D / 32;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lengths[b], S);
  const int s0 = split * split_size;
  const int s1 = min(s0 + split_size, len);

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      qr[g][i] = to_float(q[((size_t)b * H + kvh * G + g) * D + lane * VEC + i]);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const size_t row_stride = (size_t)KV * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)kvh * D + lane * VEC;
  for (int s = s0 + warp; s < s1; s += kWarps) {
    const TKV* kp = k + base + (size_t)s * row_stride;
    const TKV* vp = v + base + (size_t)s * row_stride;
    float kr[VEC], vr[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      kr[i] = to_float(kp[i]);
      vr[i] = to_float(vp[i]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot += qr[g][i] * kr[i];
      dot = warp_sum(dot) * scale;
      const float m_new = fmaxf(m[g], dot);
      const float corr = expf(m[g] - m_new);
      const float p = expf(dot - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] = acc[g][i] * corr + p * vr[i];
      m[g] = m_new;
    }
  }

  // merge the four warps' online-softmax states
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[warp][g][lane * VEC + i] = acc[g][i];
  __syncthreads();

  const size_t part = ((size_t)(b * KV + kvh) * num_splits + split) * G;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    part_acc[(part + g) * D + d] = a;
    if (d == 0) {
      part_ml[(part + g) * 2] = mx;
      part_ml[(part + g) * 2 + 1] = lsum;
    }
  }
}

// grid (B*H), block D.  Folds the splits of one (b, h) into out.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int H, int KV,
                                      int D, int num_splits) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int G = H / KV;
  const int kvh = h / G;
  const int g = h % G;
  const int d = threadIdx.x;
  const size_t base = (size_t)(b * KV + kvh) * num_splits * G + g;
  float mx = kNegInf;
  for (int i = 0; i < num_splits; ++i)
    mx = fmaxf(mx, part_ml[(base + (size_t)i * G) * 2]);
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < num_splits; ++i) {
    const size_t e = base + (size_t)i * G;
    const float c = expf(part_ml[e * 2] - mx);
    lsum += part_ml[e * 2 + 1] * c;
    a += part_acc[e * D + d] * c;
  }
  out[(size_t)bh * D + d] = from_float<T>(a / fmaxf(lsum, 1e-30f));
}

template <typename TQ, typename TKV, int D, int G>
void launch_split(const void* q, const void* k, const void* v,
                  const int* lengths, float* part_ml, float* part_acc, int B,
                  int H, int KV, int S, int split_size, int num_splits,
                  cudaStream_t stream) {
  auto kern = decode_split_kernel<TQ, TKV, D, G>;
  dim3 grid(num_splits, KV, B);
  dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf((float)D);
  APEX_LAUNCH(kern, grid, block, 0, stream, (const TQ*)q, (const TKV*)k,
              (const TKV*)v, lengths, part_ml, part_acc, H, KV, S, split_size,
              num_splits, scale);
}

template <typename TQ, typename TKV, int D>
int dispatch_group(const void* q, const void* k, const void* v,
                   const int* lengths, float* part_ml, float* part_acc, int B,
                   int H, int KV, int S, int split_size, int num_splits,
                   cudaStream_t stream) {
  switch (H / KV) {
    case 1:
      launch_split<TQ, TKV, D, 1>(q, k, v, lengths, part_ml, part_acc, B, H, KV, S,
                            split_size, num_splits, stream);
      return 0;
    case 2:
      launch_split<TQ, TKV, D, 2>(q, k, v, lengths, part_ml, part_acc, B, H, KV, S,
                            split_size, num_splits, stream);
      return 0;
    case 4:
      launch_split<TQ, TKV, D, 4>(q, k, v, lengths, part_ml, part_acc, B, H, KV, S,
                            split_size, num_splits, stream);
      return 0;
    case 8:
      launch_split<TQ, TKV, D, 8>(q, k, v, lengths, part_ml, part_acc, B, H, KV, S,
                            split_size, num_splits, stream);
      return 0;
    default:
      return -1;
  }
}

template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const int* lengths,
             void* out, float* part_ml, float* part_acc, int B, int H, int KV,
             int S, int D, int split_size, int num_splits,
             cudaStream_t stream) {
  int rc = -1;
  switch (D) {
    case 32:
      rc = dispatch_group<TQ, TKV, 32>(q, k, v, lengths, part_ml, part_acc, B, H, KV,
                                 S, split_size, num_splits, stream);
      break;
    case 64:
      rc = dispatch_group<TQ, TKV, 64>(q, k, v, lengths, part_ml, part_acc, B, H, KV,
                                 S, split_size, num_splits, stream);
      break;
    case 128:
      rc = dispatch_group<TQ, TKV, 128>(q, k, v, lengths, part_ml, part_acc, B, H,
                                  KV, S, split_size, num_splits, stream);
      break;
    default:
      break;
  }
  if (rc != 0) return rc;
  auto comb = decode_combine_kernel<TQ>;
  APEX_LAUNCH(comb, dim3(B * H), dim3(D), 0, stream, part_ml, part_acc,
              (TQ*)out, H, KV, D, num_splits);
  return 0;
}

}  // namespace

extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, void* part_ml, void* part_acc,
                                     int B, int H, int KV, int S, int D,
                                     int q_bf16, int kv_bf16, int split_size,
                                     int num_splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  float* pml = (float*)part_ml;
  float* pacc = (float*)part_acc;
  int rc = -1;
  if (q_bf16 && kv_bf16)
    rc = dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, lens, out, pml, pacc,
                                                B, H, KV, S, D, split_size,
                                                num_splits, st);
  else if (!q_bf16 && !kv_bf16)
    rc = dispatch<float, float>(q, k, v, lens, out, pml, pacc, B, H, KV, S, D,
                                split_size, num_splits, st);
  else if (!q_bf16 && kv_bf16)  // fp32 model over the bf16 KV cache
    rc = dispatch<float, __nv_bfloat16>(q, k, v, lens, out, pml, pacc, B, H,
                                        KV, S, D, split_size, num_splits, st);
  if (rc != 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
