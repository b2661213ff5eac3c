// Split-KV flash-decoding GQA attention for Hopper (sm_90a), one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`decode_attention` / `_decode_kernel`): one fresh query per row
// attends over a contiguous (B, S, KV, D) cache with per-row valid
// lengths; softmax in fp32, output divided by max(l, 1e-30).
//
// What bounds it on an H100: bytes.  Every cached K/V position is read
// once and used by only G = H/KV query heads, so the kernel does about
// 4·G flops per byte read -- two orders of magnitude below the card's
// balance point, so tensor cores do not help.  At the serving path's
// shape (4 rows of ~140 positions, 2.3 MB) the byte bound is out of
// reach and launches, empty CTAs and the latency of dependent loads
// set the time; at long contexts it is the bytes in flight.  The
// design:
//   * one launch per call.  grid (num_splits, KV, B): num_splits comes
//     from the host (`plan_splits` in the wrapper: one wave of resident
//     CTAs, four per SM, over B*KV); each row's split size is derived on
//     the device from its own length, round_up(ceil(len / num_splits),
//     32), so every split that runs has real work and a CTA whose split
//     starts at or past lengths[b] returns at once.  Positions >=
//     lengths[b] are never read;
//   * K/V tiles of 32 positions are staged into shared memory with
//     16-byte cp.async through a 3-stage ring (two tiles in flight while
//     one is computed), rows padded by 16 bytes so that threads reading
//     neighbouring rows hit distinct banks;
//   * scores without a warp reduction per position: a thread owns a
//     position and computes the dot products of its G/4 heads from the
//     staged tile; the online softmax then runs once per tile and head
//     (a warp per head, a lane per position, exp2f with scale*log2(e)
//     folded into the scores); P·V gives each thread two adjacent
//     output columns over a subset of the tile's positions;
//   * a row whose length fits one split writes its output directly; the
//     splits of a longer row write fp32 partials (m, l, acc) into a
//     workspace the wrapper allocates once, and the CTA that finishes
//     last -- it learns this from an atomic counter, after a
//     __threadfence -- merges them into the output and resets the
//     counter to 0 for the next call.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int NTH = 128;    // threads per CTA (4 warps)
constexpr int TILE = 32;    // cache positions per staged tile
constexpr int STAGES = 3;   // cp.async ring depth

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

// dot of 16 bytes of a staged K row (4 fp32 or 8 bf16) with fp32 q
__device__ __forceinline__ float dot16(const float4 raw, const float* qv,
                                       float acc, float) {
  acc = fmaf(raw.x, qv[0], acc);
  acc = fmaf(raw.y, qv[1], acc);
  acc = fmaf(raw.z, qv[2], acc);
  return fmaf(raw.w, qv[3], acc);
}
__device__ __forceinline__ float dot16(const float4 raw, const float* qv,
                                       float acc, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc = fmaf(f.x, qv[2 * i], acc);
    acc = fmaf(f.y, qv[2 * i + 1], acc);
  }
  return acc;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename TKV, int D, int G>
struct Layout {
  static constexpr int EPC = 16 / sizeof(TKV);  // elements per 16 bytes
  static constexpr int CH = D / EPC;            // 16-byte chunks per row
  static constexpr int LD = D + EPC;            // padded row (elements)
  static constexpr size_t tile_elems = (size_t)TILE * LD;
  static constexpr size_t ring_bytes = sizeof(TKV) * STAGES * 2 * tile_elems;
  static constexpr int NPG = NTH / (D / 2);     // position groups of P·V
  static constexpr size_t red_bytes = sizeof(float) * NPG * G * D;
  static constexpr size_t q_off =
      ring_bytes > red_bytes ? ring_bytes : red_bytes;
  static constexpr size_t p_off = q_off + sizeof(float) * G * D;
  static constexpr size_t c_off = p_off + sizeof(float) * G * TILE;
  static constexpr size_t ml_off = c_off + sizeof(float) * G;
  static constexpr size_t flag_off = ml_off + sizeof(float) * 2 * G;
  static constexpr size_t bytes = flag_off + 16;
};

template <typename TKV, int D, int G>
__device__ __forceinline__ void load_tile(TKV* Ks, TKV* Vs,
                                          const TKV* __restrict__ k,
                                          const TKV* __restrict__ v,
                                          size_t base, size_t row_stride,
                                          int p0, int p1) {
  using L = Layout<TKV, D, G>;
  for (int i = threadIdx.x; i < TILE * L::CH; i += NTH) {
    const int r = i / L::CH, c = i % L::CH;
    const int p = p0 + r;
    const size_t off = base + (size_t)min(p, p1 - 1) * row_stride + c * L::EPC;
    const int n = p < p1 ? 16 : 0;
    cp_async16(Ks + r * L::LD + c * L::EPC, k + off, n);
    cp_async16(Vs + r * L::LD + c * L::EPC, v + off, n);
  }
}

template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(NTH)
    decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const int* __restrict__ lengths,
                  TQ* __restrict__ out, int* __restrict__ counters,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int H, int KV, int S, int num_splits, float scale_log2) {
  using L = Layout<TKV, D, G>;
  extern __shared__ __align__(128) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // reuses the ring at the end
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);
  float* p_s = reinterpret_cast<float*>(smem + L::p_off);
  float* c_s = reinterpret_cast<float*>(smem + L::c_off);
  float* ml_s = reinterpret_cast<float*>(smem + L::ml_off);
  int* flag_s = reinterpret_cast<int*>(smem + L::flag_off);

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int len = min(lengths[b], S);
  TQ* out_row = out + ((size_t)b * H + (size_t)kvh * G) * D;
  if (len <= 0) {  // no valid position: zeros, as the empty softmax sum
    if (split == 0)
      for (int i = tid; i < G * D; i += NTH) out_row[i] = from_float<TQ>(0.f);
    return;
  }
  const int per_split = (len + num_splits - 1) / num_splits;
  const int ss = (per_split + TILE - 1) / TILE * TILE;  // split size
  const int n_active = (len + ss - 1) / ss;
  const int s0 = split * ss;
  if (s0 >= len) return;
  const int s1 = min(s0 + ss, len);
  const int n_tiles = (s1 - s0 + TILE - 1) / TILE;

  const size_t row_stride = (size_t)KV * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)kvh * D;
  auto stage_k = [&](int st) { return ring + (size_t)st * 2 * L::tile_elems; };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles)
      load_tile<TKV, D, G>(stage_k(t), stage_k(t) + L::tile_elems, k, v, base,
                           row_stride, s0 + t * TILE, s1);
    cp_async_commit();
  }
  for (int i = tid; i < G * D; i += NTH)
    q_s[i] = to_float(q[((size_t)b * H + (size_t)kvh * G) * D + i]);

  // online-softmax state of heads warp and warp + 4 (warp-uniform)
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  // P·V: columns 2*cp, 2*cp+1 over positions pg, pg + NPG, ...
  const int cp = tid % (D / 2), pg = tid / (D / 2);
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t visible; everyone is done with tile t-1
    {
      const int nt = t + STAGES - 1;
      if (nt < n_tiles) {
        TKV* st = stage_k(nt % STAGES);
        load_tile<TKV, D, G>(st, st + L::tile_elems, k, v, base, row_stride,
                             s0 + nt * TILE, s1);
      }
      cp_async_commit();
    }
    const TKV* Ks = stage_k(t % STAGES);
    const TKV* Vs = Ks + L::tile_elems;
    const int p0 = s0 + t * TILE;

    // scores: a thread per (position, head slot)
    {
      const int r = tid % TILE;
      const bool ok = p0 + r < s1;
      const float4* krow =
          reinterpret_cast<const float4*>(Ks + (size_t)r * L::LD);
      for (int g = tid / TILE; g < G; g += NTH / TILE) {
        const float* qg = q_s + g * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < L::CH; ++c)
          dot = dot16(krow[c], qg + c * L::EPC, dot, TKV());
        p_s[g * TILE + r] = ok ? dot * scale_log2 : kNegInf;
      }
    }
    __syncthreads();

    // online softmax once per tile and head: a warp per head
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = warp + 4 * j;
      if (g < G) {
        const float s = p_s[g * TILE + lane];
        const float m_new = fmaxf(m_r[j], warp_max(s));
        const float corr = exp2f(m_r[j] - m_new);
        const float p = exp2f(s - m_new);
        l_r[j] = l_r[j] * corr + warp_sum(p);
        m_r[j] = m_new;
        p_s[g * TILE + lane] = p;
        if (lane == 0) c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g][0] *= c_s[g];
      acc[g][1] *= c_s[g];
    }
#pragma unroll 4
    for (int r = pg; r < TILE; r += L::NPG) {
      const TKV* vr = Vs + (size_t)r * L::LD + 2 * cp;
      const float v0 = to_float(vr[0]), v1 = to_float(vr[1]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g * TILE + r];
        acc[g][0] = fmaf(p, v0, acc[g][0]);
        acc[g][1] = fmaf(p, v1, acc[g][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the reduction

  // fold the position groups; (m, l) of every head into shared memory
#pragma unroll
  for (int g = 0; g < G; ++g) {
    red[((size_t)pg * G + g) * D + 2 * cp] = acc[g][0];
    red[((size_t)pg * G + g) * D + 2 * cp + 1] = acc[g][1];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = warp + 4 * j;
    if (g < G && lane == 0) {
      ml_s[2 * g] = m_r[j];
      ml_s[2 * g + 1] = l_r[j];
    }
  }
  __syncthreads();

  const size_t part = ((size_t)(b * KV + kvh) * num_splits) * G;
  for (int i = tid; i < G * D; i += NTH) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < L::NPG; ++w) a += red[((size_t)w * G + g) * D + d];
    if (n_active == 1) {
      out_row[i] = from_float<TQ>(a / fmaxf(ml_s[2 * g + 1], 1e-30f));
    } else {
      const size_t e = part + (size_t)split * G + g;
      part_acc[e * D + d] = a;
      if (d == 0) {
        part_ml[e * 2] = ml_s[2 * g];
        part_ml[e * 2 + 1] = ml_s[2 * g + 1];
      }
    }
  }
  if (n_active == 1) return;

  // the last split of this (row, kv head) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + b * KV + kvh;
    const int done = atomicAdd(counter, 1);
    const int last = done == n_active - 1;
    if (last) *counter = 0;  // every split has arrived: reset for next call
    *flag_s = last;
  }
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  for (int i = tid; i < G * D; i += NTH) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
    for (int sp = 0; sp < n_active; ++sp)
      mx = fmaxf(mx, __ldcg(part_ml + (part + (size_t)sp * G + g) * 2));
    float lsum = 0.f, a = 0.f;
    for (int sp = 0; sp < n_active; ++sp) {
      const size_t e = part + (size_t)sp * G + g;
      const float c = exp2f(__ldcg(part_ml + e * 2) - mx);
      lsum = fmaf(__ldcg(part_ml + e * 2 + 1), c, lsum);
      a = fmaf(__ldcg(part_acc + e * D + d), c, a);
    }
    out_row[i] = from_float<TQ>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TKV, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int* counters, float* part_ml, float* part_acc, int B,
           int H, int KV, int S, int num_splits, cudaStream_t stream) {
  using L = Layout<TKV, D, G>;
  auto kern = decode_kernel<TQ, TKV, D, G>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const float scale_log2 = kLog2e / sqrtf((float)D);
  APEX_LAUNCH(kern, dim3(num_splits, KV, B), dim3(NTH), L::bytes, stream,
              (const TQ*)q, (const TKV*)k, (const TKV*)v, lengths, (TQ*)out,
              counters, part_ml, part_acc, H, KV, S, num_splits, scale_log2);
  return 0;
}

template <typename TQ, typename TKV, int D>
int dispatch_group(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int* counters,
                   float* part_ml, float* part_acc, int B, int H, int KV,
                   int S, int num_splits, cudaStream_t stream) {
  switch (H / KV) {
    case 1:
      return launch<TQ, TKV, D, 1>(q, k, v, lengths, out, counters, part_ml,
                                   part_acc, B, H, KV, S, num_splits, stream);
    case 2:
      return launch<TQ, TKV, D, 2>(q, k, v, lengths, out, counters, part_ml,
                                   part_acc, B, H, KV, S, num_splits, stream);
    case 4:
      return launch<TQ, TKV, D, 4>(q, k, v, lengths, out, counters, part_ml,
                                   part_acc, B, H, KV, S, num_splits, stream);
    case 8:
      return launch<TQ, TKV, D, 8>(q, k, v, lengths, out, counters, part_ml,
                                   part_acc, B, H, KV, S, num_splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const int* lengths,
             void* out, int* counters, float* part_ml, float* part_acc, int B,
             int H, int KV, int S, int D, int num_splits,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return dispatch_group<TQ, TKV, 32>(q, k, v, lengths, out, counters,
                                         part_ml, part_acc, B, H, KV, S,
                                         num_splits, stream);
    case 64:
      return dispatch_group<TQ, TKV, 64>(q, k, v, lengths, out, counters,
                                         part_ml, part_acc, B, H, KV, S,
                                         num_splits, stream);
    case 128:
      return dispatch_group<TQ, TKV, 128>(q, k, v, lengths, out, counters,
                                          part_ml, part_acc, B, H, KV, S,
                                          num_splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// workspace: counters (B*KV int32, all 0 between calls), part_ml
// (B*KV*num_splits*G*2 fp32) and part_acc (B*KV*num_splits*G*D fp32).
extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, void* counters, void* part_ml,
                                     void* part_acc, int B, int H, int KV,
                                     int S, int D, int q_bf16, int kv_bf16,
                                     int num_splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  int* cnt = (int*)counters;
  float* pml = (float*)part_ml;
  float* pacc = (float*)part_acc;
  int rc = (int)cudaErrorInvalidValue;
  if (num_splits < 1) return rc;
  if (q_bf16 && kv_bf16)
    rc = dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, lens, out, cnt, pml,
                                                pacc, B, H, KV, S, D,
                                                num_splits, st);
  else if (!q_bf16 && !kv_bf16)
    rc = dispatch<float, float>(q, k, v, lens, out, cnt, pml, pacc, B, H, KV,
                                S, D, num_splits, st);
  else if (!q_bf16 && kv_bf16)  // fp32 model over the bf16 KV cache
    rc = dispatch<float, __nv_bfloat16>(q, k, v, lens, out, cnt, pml, pacc, B,
                                        H, KV, S, D, num_splits, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
