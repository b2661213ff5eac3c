// Causal prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefill_attention.py
// (`prefill_attention` / `_prefill_kernel`): q (B, T, H, D) against a
// (B, S, KV, D) cache span, S >= T; causal on absolute positions
// (k_idx <= q_offset[b] + q_idx), OR-ed with the prefix-LM mask
// k_idx < prefix_len[b]; causal=0 is full (encoder) attention over the
// S keys.
//
// What bounds it on an H100: for a T-token prompt the causal products
// do 2*T^2*H*D flops against 4*T*D*(H+KV) bytes of Q, K, V and output,
// about 0.4*T flops per byte for llama3.1-8b's 32/8 heads -- bytes
// below T ~ 740 (the main path's 128-token prompts), the tensor cores
// above.  At the main path's shape (8 prompts of 128, 21 MB to move)
// moving Q in and O out is most of the time: a copy of this kernel
// that only loads and stores runs close to the full kernel's time
// (tools/attention_variants.py times both; PERF.md has the numbers).
// The bf16 design (FlashAttention-2's register layout on mma.sync):
//   * one CTA per (16-query block, group of GH query heads of one kv
//     head, batch row), one warp per head: every 32-key K/V tile is
//     loaded once for the GH heads it serves.  GH is G up to 4, 3 at
//     G 6 (two CTAs per kv head, each K/V tile read twice where GH 2
//     would read it three times), else 4 (Jamba's and PaliGemma's G 8
//     take two CTAs per kv head, llama3-405b's G 16 four).  The main
//     shape is 8 x 8 x 8 = 512 CTAs of 128 threads, four resident per
//     SM (128 registers, 52 KB of shared memory): one wave, the longest
//     causal walks dispatched first.
//   * head_dims above 128 (StableLM's 160, PaliGemma's 256): the warp's
//     16 x 256 fp32 output accumulator alone is 128 registers a lane,
//     so these are built for two CTAs per SM (255 registers a lane; at
//     D 256 the Q block and ring take 99 KB of shared memory, so no more
//     than two fit anyway); D 80 (HuBERT) keeps four.  build.py compiles with -Xptxas -v and
//     chip_smoke.py prints every instantiation's registers and spills.
//     Blocks of 64 queries (16 warps, 128 CTAs, one per SM) were slower:
//     each SM then runs one CTA through load, products and stores in
//     turn, with nothing to overlap;
//   * Q arrives with 16-byte cp.async in the first commit group; K/V
//     tiles of 32 keys stream through a 2-stage cp.async ring, so the
//     next tile is in flight while the current one is computed; one
//     __syncthreads per tile;
//   * both products on tensor cores with mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate), operands from shared memory by ldmatrix (V with
//     .trans); S, P and O stay in registers: the QK^T accumulator is
//     masked (only on tiles not wholly visible), exponentiated with
//     exp2f (scale*log2(e) folded into the scores) and repacked in
//     place as the bf16 A operand of PV; O leaves through the warp's own
//     Q rows as 16-byte stores;
//   * mma.sync rather than wgmma: at the main shape the products are the
//     smaller part of the time, so a faster tensor-core path moves
//     little there; at long prompts wgmma is what this kernel lacks
//     against SDPA.
// fp32 q (the exactness models, over an fp32 or a bf16 cache) runs a
// plain-FMA kernel: TF32 would break the 1e-5 bar against the fp32
// oracle, and its speed is not on the serving path.  At D 256 a CTA takes
// 32 query rows instead of 64 (64 output accumulators a thread; its Q,
// K and V blocks then take 177 KB of shared memory, one CTA per SM).
//
// Invariants of both kernels: kv tiles are walked in absolute tile
// order (tile j = keys [32j, 32j+32) here, [64j, 64j+64) in the FMA
// kernel) and the walk stops at the block's
// causal limit (or the prefix end), so tiles wholly in the future are
// never loaded; tile boundaries depend on neither q_offset nor T, and a
// tile that is wholly masked for a row leaves that row's (m, l, acc)
// bit-unchanged (its probabilities are exactly 0 and its correction
// exactly 1), so a token's output is bitwise the same however its
// prompt was split into chunks.
//
// Both kernels write, when given a (B, H, T) fp32 buffer, each row's
// natural-log log-sum-exp of its scaled scores (the backward in
// prefill_attention_bwd.cu recomputes the probabilities from it); a null
// pointer writes nothing else and leaves every output bit as it was.
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
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync, operands by ldmatrix
// ---------------------------------------------------------------------------

constexpr int MBQ = 16;        // query rows (tokens) per CTA: one warp's
constexpr int MBK = 32;        // keys per kv tile
constexpr int STAGES = 2;      // K/V tiles in the cp.async ring

// CTAs per SM the register budget is built for: 4 (128 registers a lane
// at 128 threads), 2 above D 128 (the output accumulator: 80 registers a
// lane at D 160, 128 at D 256)
constexpr int mma_min_blocks(int d) { return d > 128 ? 2 : 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int GH>
struct MmaSmem {
  static constexpr int LD = D + 8;  // row pitch (elements): 16-byte aligned,
                                    // ldmatrix rows fall in distinct banks
  static constexpr int kThreads = 32 * GH;  // one warp per head
  static constexpr size_t q_elems = (size_t)GH * MBQ * LD;
  static constexpr size_t tile_elems = (size_t)MBK * LD;
  // Q, then the ring: stage s holds K at 2s and V at 2s+1
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (q_elems + 2 * STAGES * tile_elems);
};

template <int D, int GH>
__device__ __forceinline__ void load_kv_tile(
    __nv_bfloat16* Ks, __nv_bfloat16* Vs, const __nv_bfloat16* k,
    const __nv_bfloat16* v, size_t kv_base, int KV, int S, int kt) {
  using L = MmaSmem<D, GH>;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < MBK * CH; i += L::kThreads) {
    const int r = i / CH, c = i % CH;
    const int s = kt * MBK + r;
    const size_t off = kv_base + (size_t)min(s, S - 1) * KV * D + c * 8;
    const int n = s < S ? 16 : 0;
    cp_async16(Ks + r * L::LD + c * 8, k + off, n);
    cp_async16(Vs + r * L::LD + c * 8, v + off, n);
  }
}

template <int D, int GH>
__global__ void __launch_bounds__(32 * GH, mma_min_blocks(D))
    prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ prefix_len,
                       const int* __restrict__ q_offset,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int T_len, int S, int H,
                       int KV, int causal, float scale_log2) {
  using L = MmaSmem<D, GH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = Qs + L::q_elems;

  const int G = H / KV;
  const int groups = G / GH;
  // the blocks with the longest causal walk are dispatched first
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int kvh = blockIdx.x / groups;
  const int h0 = kvh * G + (blockIdx.x % groups) * GH;  // first head of CTA
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int qoff = q_offset[b];
  const int pre = prefix_len[b];
  const int q0 = qb * MBQ;
  const size_t kv_base = (size_t)b * S * KV * D + (size_t)kvh * D;

  // Q block of GH heads rides in the first commit group, with tile 0
  {
    constexpr int CH = D / 8;
    for (int i = tid; i < GH * MBQ * CH; i += L::kThreads) {
      const int c = i % CH, r = (i / CH) % MBQ, g = i / (CH * MBQ);
      const int t = q0 + r;
      const size_t off =
          (((size_t)b * T_len + min(t, T_len - 1)) * H + h0 + g) * D + c * 8;
      cp_async16(Qs + ((size_t)g * MBQ + r) * L::LD + c * 8, q + off,
                 t < T_len ? 16 : 0);
    }
  }
  int n_tiles = (S + MBK - 1) / MBK;
  if (causal) {
    const int last = max(qoff + q0 + MBQ - 1, pre - 1);
    n_tiles = min(n_tiles, last / MBK + 1);
  }
  // STAGES - 1 tiles are in flight from the start
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles)
      load_kv_tile<D, GH>(ring + st * 2 * L::tile_elems,
                          ring + (st * 2 + 1) * L::tile_elems, k, v, kv_base,
                          KV, S, st);
    cp_async_commit();
  }

  constexpr int NS = MBK / 8;  // score n-tiles (8 keys each)
  constexpr int NO = D / 8;    // output n-tiles (8 columns each)
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows lr and lr + 8 of the warp's 16; l is this thread's partial sum
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  const int lr = lane / 4, lc = (lane % 4) * 2;
  const int q_first = qoff + q0;  // the block's first query position
  const __nv_bfloat16* q_warp = Qs + (size_t)warp * MBQ * L::LD;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt visible; every warp is done with kt-1
    {
      const int nt = kt + STAGES - 1;  // into the stage kt-1 left free
      if (nt < n_tiles) {
        __nv_bfloat16* st = ring + (nt % STAGES) * 2 * L::tile_elems;
        load_kv_tile<D, GH>(st, st + L::tile_elems, k, v, kv_base, KV, S,
                            nt);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* Ks = ring + (kt % STAGES) * 2 * L::tile_elems;
    const __nv_bfloat16* Vs = Ks + L::tile_elems;

    // S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_warp + (lane % 8 + ((lane / 8) % 2) * 8) * L::LD +
                         kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nn = 0; nn < MBK / 16; ++nn) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Ks + (nn * 16 + lane % 8 + (lane / 16) * 8) * L::LD +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // mask (only where the tile is not wholly visible to the block's
    // rows), online softmax in the log2 domain
    const int k_end = kt * MBK + MBK;
    const bool visible =
        k_end <= S && (!causal || k_end - 1 <= q_first || k_end <= pre);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * MBK + j * 8 + lc + (e & 1);
        const int qpos = q_first + lr + (e >> 1) * 8;
        const bool ok = visible ||
                        (key < S && (!causal || key <= qpos || key < pre));
        s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V, P repacked from the score accumulator as the A operand
#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * L::LD +
                    nd * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * nd], a, bv[0], bv[1]);
        mma_bf16(o[2 * nd + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  // normalise, stage the warp's rows in its own (no longer read) Q rows,
  // then write them out as 16-byte rows
  __nv_bfloat16* stage = const_cast<__nv_bfloat16*>(q_warp);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    // natural-log LSE of the scaled scores, for the backward
    if (lse != nullptr && lane % 4 == 0 && q0 + lr + 8 * r < T_len)
      lse[((size_t)b * H + h0 + warp) * T_len + q0 + lr + 8 * r] =
          (m_r[r] + log2f(l)) * kLn2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + (lr + 8 * r) * L::LD +
                                         j * 8 + lc) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  const int h = h0 + warp;
#pragma unroll
  for (int i = lane; i < MBQ * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const int t = q0 + r;
    if (t < T_len)
      *reinterpret_cast<uint4*>(out + (((size_t)b * T_len + t) * H + h) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * L::LD + c * 8);
  }
}

template <int D, int GH>
int launch_mma(const void* q, const void* k, const void* v,
               const int* prefix_len, const int* q_offset, void* out,
               float* lse, int B, int T_len, int S, int H, int KV, int causal,
               cudaStream_t stream) {
  using L = MmaSmem<D, GH>;
  auto kern = prefill_mma_kernel<D, GH>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(H / GH, B, (T_len + MBQ - 1) / MBQ);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  APEX_LAUNCH(kern, grid, dim3(L::kThreads), L::bytes, stream,
              (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
              (const __nv_bfloat16*)v, prefix_len, q_offset,
              (__nv_bfloat16*)out, lse, T_len, S, H, KV, causal, scale_log2);
  return 0;
}

template <int D>
int dispatch_mma(const void* q, const void* k, const void* v,
                 const int* prefix_len, const int* q_offset, void* out,
                 float* lse, int B, int T_len, int S, int H, int KV,
                 int causal, cudaStream_t stream) {
  switch (H / KV) {  // heads per CTA: G up to 4, 3 at G 6, else 4
    case 1:
      return launch_mma<D, 1>(q, k, v, prefix_len, q_offset, out, lse, B,
                              T_len, S, H, KV, causal, stream);
    case 2:
      return launch_mma<D, 2>(q, k, v, prefix_len, q_offset, out, lse, B,
                              T_len, S, H, KV, causal, stream);
    case 6:
      return launch_mma<D, 3>(q, k, v, prefix_len, q_offset, out, lse, B,
                              T_len, S, H, KV, causal, stream);
    case 4:
    case 8:
    case 16:
      return launch_mma<D, 4>(q, k, v, prefix_len, q_offset, out, lse, B,
                              T_len, S, H, KV, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// fp32 query (fp32 or bf16 cache): plain FMA, exact against the oracle
// ---------------------------------------------------------------------------

constexpr int BK = 64;   // keys per kv tile of the FMA kernel
constexpr int NT = 128;  // threads per CTA of the FMA kernel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename TKV, int D>
struct FmaSmem {
  // query rows per CTA: 64, or 32 above D 128 (at D 256, 64 rows held 128
  // output accumulators a thread: 255 registers and 1.6 KB of spills)
  static constexpr int BQ = D > 128 ? 32 : 64;
  static constexpr int LPR = NT / BQ;  // lanes per row in the softmax
  static constexpr int LDQ = D + 1;   // Q/K/V rows (elements)
  static constexpr int LDS = BK + 4;  // fp32 scores / probabilities
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(float) * BQ * LDQ);
  static constexpr size_t v_off = align128(k_off + sizeof(TKV) * BK * LDQ);
  static constexpr size_t s_off = align128(v_off + sizeof(TKV) * BK * LDQ);
  static constexpr size_t row_off = align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t bytes = align128(row_off + sizeof(float) * 3 * BQ);
};

// One CTA per (q_block, head, batch row); scores and probabilities in
// shared memory, the output accumulator in registers.
template <typename TKV, int D>
__global__ void __launch_bounds__(NT)
    prefill_fma_kernel(const float* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v,
                       const int* __restrict__ prefix_len,
                       const int* __restrict__ q_offset,
                       float* __restrict__ out, float* __restrict__ lse,
                       int T_len, int S, int H, int KV, int causal,
                       float scale) {
  using L = FmaSmem<TKV, D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  TKV* Ks = reinterpret_cast<TKV*>(smem + L::k_off);
  TKV* Vs = reinterpret_cast<TKV*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
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
        t < T_len ? q[(((size_t)b * T_len + t) * H + h) * D + d] : 0.f;
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

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // readers of the previous tile are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int s = kt * BK + r;
      const size_t off = ((size_t)b * S + s) * kv_row + (size_t)kvh * D + d;
      Ks[r * L::LDQ + d] = s < S ? k[off] : TKV(0.f);
      Vs[r * L::LDQ + d] = s < S ? v[off] : TKV(0.f);
    }
    __syncthreads();

    for (int i = tid; i < BQ * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const float* qr = Qs + r * L::LDQ;
      const TKV* kr = Ks + c * L::LDQ;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += qr[d] * to_float(kr[d]);
      Ss[r * L::LDS + c] = dot;
    }
    __syncthreads();

    // mask + online softmax: LPR adjacent lanes per query row
    {
      const int r = tid / L::LPR;
      const int part = tid % L::LPR;
      const int qpos = qoff + q0 + r;
      float* srow = Ss + r * L::LDS;
      constexpr int CPL = BK / L::LPR;  // columns per lane
      const int c0 = part * CPL;
      float mx = kNegInf;
      for (int c = c0; c < c0 + CPL; ++c) {
        const int kidx = kt * BK + c;
        const bool ok = kidx < S && (!causal || kidx <= qpos || kidx < pre);
        const float s = ok ? srow[c] * scale : kNegInf;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int o = 1; o < L::LPR; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = c0; c < c0 + CPL; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < L::LPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

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
  __syncthreads();

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + NT * j;
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    if (t < T_len)
      out[(((size_t)b * T_len + t) * H + h) * D + d] =
          acc[j] / fmaxf(row_l[r], 1e-30f);
  }
  // natural-log LSE of the scaled scores, for the backward
  if (lse != nullptr && tid < BQ && q0 + tid < T_len)
    lse[((size_t)b * H + h) * T_len + q0 + tid] =
        row_m[tid] + logf(row_l[tid]);
}

template <typename TKV, int D>
int launch_fma(const void* q, const void* k, const void* v,
               const int* prefix_len, const int* q_offset, void* out,
               float* lse, int B, int T_len, int S, int H, int KV, int causal,
               cudaStream_t stream) {
  using L = FmaSmem<TKV, D>;
  auto kern = prefill_fma_kernel<TKV, D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((T_len + L::BQ - 1) / L::BQ, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  APEX_LAUNCH(kern, grid, dim3(NT), L::bytes, stream, (const float*)q,
              (const TKV*)k, (const TKV*)v, prefix_len, q_offset,
              (float*)out, lse, T_len, S, H, KV, causal, scale);
  return 0;
}

template <typename TKV>
int dispatch_fma(const void* q, const void* k, const void* v,
                 const int* prefix_len, const int* q_offset, void* out,
                 float* lse, int B, int T_len, int S, int H, int KV, int D,
                 int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_fma<TKV, 32>(q, k, v, prefix_len, q_offset, out, lse,
                                 B, T_len, S, H, KV, causal, stream);
    case 64:
      return launch_fma<TKV, 64>(q, k, v, prefix_len, q_offset, out, lse,
                                 B, T_len, S, H, KV, causal, stream);
    case 80:
      return launch_fma<TKV, 80>(q, k, v, prefix_len, q_offset, out, lse,
                                 B, T_len, S, H, KV, causal, stream);
    case 128:
      return launch_fma<TKV, 128>(q, k, v, prefix_len, q_offset, out, lse,
                                 B, T_len, S, H, KV, causal, stream);
    case 160:
      return launch_fma<TKV, 160>(q, k, v, prefix_len, q_offset, out, lse,
                                 B, T_len, S, H, KV, causal, stream);
    case 256:
      return launch_fma<TKV, 256>(q, k, v, prefix_len, q_offset, out, lse,
                                 B, T_len, S, H, KV, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int apex_prefill_attention(const void* q, const void* k,
                                      const void* v, const void* prefix_len,
                                      const void* q_offset, void* out,
                                      void* lse, int B, int T_len, int S,
                                      int H, int KV, int D, int q_bf16,
                                      int kv_bf16, int causal, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* pre = (const int*)prefix_len;
  const int* qoff = (const int*)q_offset;
  float* lse_f = (float*)lse;
  int rc = (int)cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16) {
    switch (D) {
      case 32:
        rc = dispatch_mma<32>(q, k, v, pre, qoff, out, lse_f, B, T_len, S,
                              H, KV, causal, st);
        break;
      case 64:
        rc = dispatch_mma<64>(q, k, v, pre, qoff, out, lse_f, B, T_len, S,
                              H, KV, causal, st);
        break;
      case 80:
        rc = dispatch_mma<80>(q, k, v, pre, qoff, out, lse_f, B, T_len, S,
                              H, KV, causal, st);
        break;
      case 128:
        rc = dispatch_mma<128>(q, k, v, pre, qoff, out, lse_f, B, T_len, S,
                              H, KV, causal, st);
        break;
      case 160:
        rc = dispatch_mma<160>(q, k, v, pre, qoff, out, lse_f, B, T_len, S,
                              H, KV, causal, st);
        break;
      case 256:
        rc = dispatch_mma<256>(q, k, v, pre, qoff, out, lse_f, B, T_len, S,
                              H, KV, causal, st);
        break;
      default:
        break;
    }
  } else if (!q_bf16 && !kv_bf16) {
    rc = dispatch_fma<float>(q, k, v, pre, qoff, out, lse_f, B, T_len, S, H,
                             KV, D, causal, st);
  } else if (!q_bf16 && kv_bf16) {  // fp32 model over the bf16 KV cache
    rc = dispatch_fma<__nv_bfloat16>(q, k, v, pre, qoff, out, lse_f, B, T_len,
                                     S, H, KV, D, causal, st);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
