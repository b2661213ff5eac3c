// Backward of causal prefill attention for Hopper (sm_90a).
//
// The gradient of the Pallas TPU kernel src/repro/kernels/prefill_attention.py
// (`prefill_attention` / `_prefill_kernel`) that prefill_attention.cu
// replaces.  The TPU kernel has no backward: the reference trains through
// JAX autodiff of its jnp attention.  Given q (B, T, H, D), k and v
// (B, S, KV, D), the forward's output o and its natural-log log-sum-exp
// lse (B, H, T), and dO (B, T, H, D), it writes dq, dk and dv for the
// masks the stateless forward uses: causal on positions (k_idx <= q_idx),
// OR-ed with the prefix-LM mask k_idx < prefix_len[b], or full
// attention (causal=0).  Queries sit at positions 0..T-1 (no q_offset:
// no training path has one).  dk and dv are summed over the G query heads
// of each kv head.
//
// What bounds it on an H100: FlashAttention-2's backward does five
// products over the visible (query, key) pairs -- S = QK^T again, dP =
// dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K -- 10 flops per pair and
// head dimension, against 2 x 4 x (T*H + S*KV) * D bytes of q, k, v, o,
// dO and the three gradients: about 1.3*T flops per byte at llama3.1-8b's
// 32/8 heads, so the tensor cores bound it at the training shapes (T
// 1024), and only wgmma reaches their rate.  The split recomputes S and
// dP in both kernels: seven products where the plain backward has five.
//   * a pass writes delta_i = rowsum(dO_i * O_i) (fp32, (B, H, T));
//   * bf16 at D 64 and 128 (every training shape: llama 32/8, Jamba 64/8,
//     internlm2's G 6, llama3-405b's G 16) -- wgmma on tiles TMA fills:
//       - dK/dV: a CTA owns 64 keys of one kv head, K and V resident by
//         TMA; the 64-query Q and dO tiles of the G heads that see the
//         keys (all of them under a prefix key or full attention, from
//         the block's first key on under the causal mask) stream through
//         a 2-stage mbarrier ring with their LSE and delta, two (head,
//         tile) pairs a stage, one to each of the CTA's two warpgroups.
//         A warpgroup forms S^T = K Q^T and dP^T = V dO^T with wgmma from
//         shared memory, P^T = exp2(S^T - lse) and dS^T = P^T (dP^T -
//         delta) in registers, and dV += P^T dO, dK += dS^T Q with wgmma
//         whose A operand is those registers (the accumulator's layout is
//         wgmma's A fragment layout).  Each warpgroup sums its pairs in
//         its accumulators; the two are added once, in shared memory, in
//         a fixed order: nothing is added across CTAs.  The key block is
//         the grid's slowest index, so the longest causal walks start
//         first: 64-key blocks even the SMs' work out, where with 128-key
//         blocks the first block's CTA at llama's shape walks 64 rounds
//         against a mean of 36;
//       - dQ: a CTA (one warpgroup) owns 64 queries of one head, Q and dO
//         resident, 64-key K/V tiles streamed up to the causal limit; S,
//         dP and dQ += dS K on wgmma;
//       - no producer warp: warp 0 (dK/dV) or thread 0 (dQ) refills a
//         stage once every warp has released it.  A CTA with a producer warp is a third warpgroup
//         to the register allocator: ptxas then caps every thread at 168
//         registers (384 threads), setmaxnreg notwithstanding (this
//         toolkit compiled the consumers at the entry cap and spilled),
//         and two 64 x 128 fp32 accumulators with S^T and dP^T need ~240;
//       - tiles are 64-column boxes of 128-byte rows in TMA's 128-byte
//         swizzle, which is the layout wgmma's descriptors read; rows
//         past T or S arrive as zeros and the mask drops them;
//   * bf16 at D 32, 80, 160, 256 (HuBERT, stablelm, PaliGemma's
//     prefix-LM) -- mma.sync m16n8k16 with a 2-stage cp.async ring
//     (operands by ldmatrix): 80 and 160 are not multiples of the 64-
//     column box, and at 256 two 64 x 256 fp32 accumulators do not fit a
//     warpgroup's registers.  dK/dV: one CTA per 64 keys (a warp per 16
//     keys) walking the G heads' 32-query tiles, output columns split in
//     two CTAs above D 128; dQ: one CTA per 16 queries of up to four
//     heads, a warp per head;
//   * fp32 q/k/v (the exactness models) run plain-FMA kernels of the
//     same split, scores in shared memory, exact against the plain
//     version at fp32 rounding.
// With no atomics and every sum in a fixed order, the same inputs give
// the same bits.  launch_wgmma, launch_mma and launch_fma are the three
// routes; apex_prefill_attention_bwd_route names the one a call takes.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing (the wrapper passes the
// delta buffer), and returns cudaGetLastError().

#include <cuda.h>
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

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// helpers: cp.async, ldmatrix, mma.sync (as in prefill_attention.cu)
// ---------------------------------------------------------------------------

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

// The A operand (16 x 16 rows x k) of rows [0, 16) and columns [k0, k0+16)
// of a row-major tile with pitch ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int ld, int k0, int lane) {
  ldmatrix_x4(a, base + (lane % 8 + ((lane / 8) % 2) * 8) * ld + k0 +
                     (lane / 16) * 8);
}
// The B operands of two n-tiles (rows n0..n0+16) x k [k0, k0+16) of a tile
// stored n-major ([n][k], pitch ld): b[0..1] n-tile 0, b[2..3] n-tile 1.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* base,
                                          int ld, int n0, int k0, int lane) {
  ldmatrix_x4(b, base + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 +
                     ((lane / 8) % 2) * 8);
}
// The same from a tile stored k-major ([k][n], pitch ld), transposed.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* base,
                                          int ld, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, base + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld +
                           n0 + (lane / 16) * 8);
}
// Accumulators of two 16 x 8 n-tiles (j0, j0 + 1) as one 16 x 16 A operand.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[4],
                                       const float (&y)[4]) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(y[0], y[1]);
  a[3] = pack_bf16(y[2], y[3]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O), one warp per (b, t, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int T_len, int H, int D,
                 int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += to_float(o[base + d]) * to_float(dout[base + d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % H, t = (row / H) % T_len, b = row / (H * T_len);
    delta[((size_t)b * H + h) * T_len + t] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: dQ on tensor cores (16-query blocks, a warp per query head)
// ---------------------------------------------------------------------------

constexpr int MBQ = 16;     // query rows per warp
constexpr int MBK = 32;     // keys per K/V tile of the dQ kernel
constexpr int KB = 64;      // keys per CTA of the dK/dV kernel (4 warps)
constexpr int QB = 32;      // queries per Q/dO tile of the dK/dV kernel
constexpr int STAGES = 2;   // tiles in the cp.async ring

template <int D, int GH>
struct DqSmem {
  static constexpr int LD = D + 8;  // row pitch (elements), 16-byte aligned
  static constexpr int kThreads = 32 * GH;
  static constexpr size_t q_elems = (size_t)GH * MBQ * LD;  // Q, then dO
  static constexpr size_t tile_elems = (size_t)MBK * LD;
  static constexpr size_t bytes =
      sizeof(bf16) * (2 * q_elems + 2 * STAGES * tile_elems);
};

template <int D, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          size_t base, size_t row_stride,
                                          int row0, int rows, int n_valid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int s = row0 + r;
    const size_t off = base + (size_t)min(s, n_valid - 1) * row_stride + c * 8;
    cp_async16(dst + r * ld + c * 8, src + off, s < n_valid ? 16 : 0);
  }
}

template <int D, int GH>
__global__ void __launch_bounds__(32 * GH, 2)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ prefix_len, bf16* __restrict__ dq,
                  int T_len, int S, int H, int KV, int causal,
                  float scale_log2, float scale) {
  using L = DqSmem<D, GH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + L::q_elems;
  bf16* ring = dOs + L::q_elems;

  const int G = H / KV;
  const int groups = G / GH;
  const int qb = gridDim.z - 1 - blockIdx.z;  // longest walks first
  const int kvh = blockIdx.x / groups;
  const int h0 = kvh * G + (blockIdx.x % groups) * GH;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int pre = prefix_len[b];
  const int q0 = qb * MBQ;
  const size_t kv_base = (size_t)b * S * KV * D + (size_t)kvh * D;

  {  // Q and dO blocks of the GH heads, in the first commit group
    constexpr int CH = D / 8;
    for (int i = tid; i < GH * MBQ * CH; i += L::kThreads) {
      const int c = i % CH, r = (i / CH) % MBQ, g = i / (CH * MBQ);
      const int t = q0 + r;
      const size_t off =
          (((size_t)b * T_len + min(t, T_len - 1)) * H + h0 + g) * D + c * 8;
      const int n = t < T_len ? 16 : 0;
      cp_async16(Qs + ((size_t)g * MBQ + r) * L::LD + c * 8, q + off, n);
      cp_async16(dOs + ((size_t)g * MBQ + r) * L::LD + c * 8, dout + off, n);
    }
  }
  int n_tiles = (S + MBK - 1) / MBK;
  if (causal) {
    const int last = max(q0 + MBQ - 1, pre - 1);
    n_tiles = min(n_tiles, last / MBK + 1);
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      bf16* Ks = ring + st * 2 * L::tile_elems;
      load_rows<D, L::kThreads>(Ks, L::LD, k, kv_base, (size_t)KV * D,
                                st * MBK, MBK, S);
      load_rows<D, L::kThreads>(Ks + L::tile_elems, L::LD, v, kv_base,
                                (size_t)KV * D, st * MBK, MBK, S);
    }
    cp_async_commit();
  }

  constexpr int NS = MBK / 8;  // score n-tiles (8 keys each)
  constexpr int NO = D / 8;    // output n-tiles (8 columns each)
  const int lr = lane / 4, lc = (lane % 4) * 2;
  const int h = h0 + warp;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + lr + 8 * r;
    const size_t at = ((size_t)b * H + h) * T_len + min(t, T_len - 1);
    lse2[r] = t < T_len ? lse[at] * kLog2e : 0.f;
    dl[r] = t < T_len ? delta[at] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* q_warp = Qs + (size_t)warp * MBQ * L::LD;
  const bf16* do_warp = dOs + (size_t)warp * MBQ * L::LD;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt visible; every warp is done with kt-1
    {
      const int nt = kt + STAGES - 1;
      if (nt < n_tiles) {
        bf16* st = ring + (nt % STAGES) * 2 * L::tile_elems;
        load_rows<D, L::kThreads>(st, L::LD, k, kv_base, (size_t)KV * D,
                                  nt * MBK, MBK, S);
        load_rows<D, L::kThreads>(st + L::tile_elems, L::LD, v, kv_base,
                                  (size_t)KV * D, nt * MBK, MBK, S);
      }
      cp_async_commit();
    }
    const bf16* Ks = ring + (kt % STAGES) * 2 * L::tile_elems;
    const bf16* Vs = Ks + L::tile_elems;

    // S = Q K^T and dP = dO V^T
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], ad[4];
      load_a(a, q_warp, L::LD, kk * 16, lane);
      load_a(ad, do_warp, L::LD, kk * 16, lane);
#pragma unroll
      for (int nn = 0; nn < MBK / 16; ++nn) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, Ks, L::LD, nn * 16, kk * 16, lane);
        load_b_nk(bv, Vs, L::LD, nn * 16, kk * 16, lane);
        mma_bf16(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16(s[2 * nn + 1], a, bk[2], bk[3]);
        mma_bf16(dp[2 * nn], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * nn + 1], ad, bv[2], bv[3]);
      }
    }
    // P from the saved LSE, dS = P (dP - delta), in place of S
    const int k_end = kt * MBK + MBK;
    const bool visible =
        k_end <= S && (!causal || k_end - 1 <= q0 || k_end <= pre);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * MBK + j * 8 + lc + (e & 1);
        const int qpos = q0 + lr + (e >> 1) * 8;
        const bool ok = visible ||
                        (key < S && (!causal || key <= qpos || key < pre));
        const float p =
            ok ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bk[4];
        load_b_kn(bk, Ks, L::LD, kk * 16, nd * 16, lane);
        mma_bf16(acc[2 * nd], a, bk[0], bk[1]);
        mma_bf16(acc[2 * nd + 1], a, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's copies have landed

  // scale, stage in the warp's own (no longer read) Q rows, 16-byte stores
  bf16* stage = const_cast<bf16*>(q_warp);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + (lr + 8 * r) * L::LD +
                                         j * 8 + lc) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale,
                                acc[j][2 * r + 1] * scale);
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < MBQ * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const int t = q0 + r;
    if (t < T_len)
      *reinterpret_cast<uint4*>(dq + (((size_t)b * T_len + t) * H + h) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * L::LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// bf16: dK and dV on tensor cores (64 keys a CTA, a warp per 16 keys)
// ---------------------------------------------------------------------------

// output columns per CTA: the dK and dV accumulators of 16 x DC take DC
// registers a lane, so above D 128 the columns go in two chunks
__host__ __device__ constexpr int dkv_cols(int d) {
  return d <= 128 ? d : d / 2;
}

template <int D>
struct DkvSmem {
  static constexpr int LD = D + 8;
  static constexpr int kThreads = 32 * (KB / 16);
  static constexpr size_t kv_elems = (size_t)KB * LD;    // K, then V
  static constexpr size_t tile_elems = (size_t)QB * LD;  // a Q or dO tile
  static constexpr size_t ring_bytes =
      sizeof(bf16) * (2 * kv_elems + 2 * STAGES * tile_elems);
  // then per stage the tile's QB log2-domain LSEs and QB deltas
  static constexpr size_t bytes = ring_bytes + sizeof(float) * 2 * STAGES * QB;
};

template <int D>
__global__ void __launch_bounds__(32 * (KB / 16), 2)
    dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ prefix_len,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len,
                    int S, int H, int KV, int causal, float scale_log2,
                    float scale) {
  using L = DkvSmem<D>;
  constexpr int DC = dkv_cols(D);
  constexpr int CHUNKS = D / DC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L::kv_elems;
  bf16* ring = Vs + L::kv_elems;
  float* rows = reinterpret_cast<float*>(smem + L::ring_bytes);

  const int k0 = blockIdx.x * KB;
  const int kvh = blockIdx.y / CHUNKS;
  const int dc0 = (blockIdx.y % CHUNKS) * DC;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int pre = prefix_len[b];
  const size_t kv_base = (size_t)b * S * KV * D + (size_t)kvh * D;

  // queries that see a key of the block: all of them under a prefix key
  // or full attention, else the causal future of its first key
  const int qt_start = (causal && k0 >= pre) ? k0 / QB : 0;
  const int n_qt = (T_len + QB - 1) / QB;
  const int n_per = max(n_qt - qt_start, 0);
  const int n_it = G * n_per;

  load_rows<D, L::kThreads>(Ks, L::LD, k, kv_base, (size_t)KV * D, k0, KB, S);
  load_rows<D, L::kThreads>(Vs, L::LD, v, kv_base, (size_t)KV * D, k0, KB, S);

  // stage `it`: the Q and dO tile of one (head, query tile), and its rows'
  // LSE and delta by plain loads (visible after the next __syncthreads)
  auto load_stage = [&](int it) {
    const int g = it / n_per, qt = qt_start + it % n_per;
    const int h = kvh * G + g;
    bf16* st = ring + (it % STAGES) * 2 * L::tile_elems;
    const size_t q_base = (size_t)b * T_len * H * D + (size_t)h * D;
    load_rows<D, L::kThreads>(st, L::LD, q, q_base, (size_t)H * D, qt * QB,
                              QB, T_len);
    load_rows<D, L::kThreads>(st + L::tile_elems, L::LD, dout, q_base,
                              (size_t)H * D, qt * QB, QB, T_len);
    float* rw = rows + (it % STAGES) * 2 * QB;
    for (int i = tid; i < QB; i += L::kThreads) {
      const int t = qt * QB + i;
      const size_t at = ((size_t)b * H + h) * T_len + min(t, T_len - 1);
      rw[i] = t < T_len ? lse[at] * kLog2e : 0.f;
      rw[QB + i] = t < T_len ? delta[at] : 0.f;
    }
  };
  // K/V ride in the first commit group, with stage 0
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_it) load_stage(st);
    cp_async_commit();
  }

  constexpr int NQ = QB / 8;  // score n-tiles (8 queries each)
  constexpr int NO = DC / 8;  // output n-tiles
  const int lr = lane / 4, lc = (lane % 4) * 2;
  const int kw0 = k0 + warp * 16;  // the warp's first key
  const bf16* k_warp = Ks + (size_t)warp * 16 * L::LD;
  const bf16* v_warp = Vs + (size_t)warp * 16 * L::LD;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it visible; every warp is done with it-1
    {
      const int nt = it + STAGES - 1;
      if (nt < n_it) load_stage(nt);
      cp_async_commit();
    }
    const int q0 = (qt_start + it % n_per) * QB;
    const bf16* Qt = ring + (it % STAGES) * 2 * L::tile_elems;
    const bf16* dOt = Qt + L::tile_elems;
    const float* lse2 = rows + (it % STAGES) * 2 * QB;
    const float* dl = lse2 + QB;

    // S^T = K Q^T and dP^T = V dO^T over the warp's 16 keys
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, k_warp, L::LD, kk * 16, lane);
      load_a(av, v_warp, L::LD, kk * 16, lane);
#pragma unroll
      for (int nn = 0; nn < QB / 16; ++nn) {
        uint32_t bq[4], bo[4];
        load_b_nk(bq, Qt, L::LD, nn * 16, kk * 16, lane);
        load_b_nk(bo, dOt, L::LD, nn * 16, kk * 16, lane);
        mma_bf16(st[2 * nn], ak, bq[0], bq[1]);
        mma_bf16(st[2 * nn + 1], ak, bq[2], bq[3]);
        mma_bf16(dpt[2 * nn], av, bo[0], bo[1]);
        mma_bf16(dpt[2 * nn + 1], av, bo[2], bo[3]);
      }
    }
    // P^T and dS^T: rows are keys, columns queries
    const bool visible =
        kw0 + 16 <= S && q0 + QB <= T_len &&
        (!causal || kw0 + 15 <= q0 || kw0 + 16 <= pre);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw0 + lr + (e >> 1) * 8;
        const int qi = j * 8 + lc + (e & 1);
        const int qpos = q0 + qi;
        const bool ok = visible ||
                        (key < S && qpos < T_len &&
                         (!causal || key <= qpos || key < pre));
        const float p = ok ? exp2f(st[j][e] * scale_log2 - lse2[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl[qi]);
      }
    // dV += P^T dO and dK += dS^T Q over this CTA's output columns
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
      uint32_t ap[4], as[4];
      pack_a(ap, st[2 * kk], st[2 * kk + 1]);
      pack_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < DC / 16; ++nd) {
        uint32_t bo[4], bq[4];
        load_b_kn(bo, dOt, L::LD, kk * 16, dc0 + nd * 16, lane);
        load_b_kn(bq, Qt, L::LD, kk * 16, dc0 + nd * 16, lane);
        mma_bf16(dva[2 * nd], ap, bo[0], bo[1]);
        mma_bf16(dva[2 * nd + 1], ap, bo[2], bo[3]);
        mma_bf16(dka[2 * nd], as, bq[0], bq[1]);
        mma_bf16(dka[2 * nd + 1], as, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's copies have landed (K/V too, if n_it 0)

  // stage dK in the warp's own K rows and dV in its V rows (only this warp
  // reads them), then 16-byte stores of this CTA's columns
  bf16* sk = const_cast<bf16*>(k_warp);
  bf16* sv = const_cast<bf16*>(v_warp);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int at = (lr + 8 * r) * L::LD + j * 8 + lc;
      *reinterpret_cast<__nv_bfloat162*>(sk + at) = __floats2bfloat162_rn(
          dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(sv + at) =
          __floats2bfloat162_rn(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  __syncwarp();
  constexpr int CH = DC / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const int key = kw0 + r;
    if (key < S) {
      const size_t off = ((size_t)b * S + key) * KV * D + (size_t)kvh * D +
                         dc0 + c * 8;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(sk + r * L::LD + c * 8);
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(sv + r * L::LD + c * 8);
    }
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes, bool& configured) {
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  return 0;
}

template <int D, int GH>
int launch_dq_mma(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* dout, const float* lse, const float* delta,
                  const int* pre, bf16* dq, int B, int T_len, int S, int H,
                  int KV, int causal, cudaStream_t stream) {
  using L = DqSmem<D, GH>;
  auto kern = dq_mma_kernel<D, GH>;
  static bool configured = false;
  const int rc = set_smem(kern, L::bytes, configured);
  if (rc != 0) return rc;
  dim3 grid(H / GH, B, (T_len + MBQ - 1) / MBQ);
  // the forward's exponent scale, so P is the forward's to the last bit
  const float scale_log2 = kLog2e / sqrtf((float)D);
  APEX_LAUNCH(kern, grid, dim3(L::kThreads), L::bytes, stream, q, k, v, dout,
              lse, delta, pre, dq, T_len, S, H, KV, causal, scale_log2,
              1.0f / sqrtf((float)D));
  return 0;
}

template <int D>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* delta, const int* pre, bf16* dq,
               bf16* dk, bf16* dv, int B, int T_len, int S, int H, int KV,
               int causal, cudaStream_t stream) {
  using L = DkvSmem<D>;
  auto kern = dkdv_mma_kernel<D>;
  static bool configured = false;
  int rc = set_smem(kern, L::bytes, configured);
  if (rc != 0) return rc;
  dim3 grid((S + KB - 1) / KB, KV * (D / dkv_cols(D)), B);
  APEX_LAUNCH(kern, grid, dim3(L::kThreads), L::bytes, stream, q, k, v, dout,
              lse, delta, pre, dk, dv, T_len, S, H, KV, causal,
              kLog2e / sqrtf((float)D), 1.0f / sqrtf((float)D));
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  switch (H / KV) {  // heads per dQ CTA: G up to 4, 3 at G 6, else 4
    case 1:
      return launch_dq_mma<D, 1>(q, k, v, dout, lse, delta, pre, dq, B, T_len,
                                 S, H, KV, causal, stream);
    case 2:
      return launch_dq_mma<D, 2>(q, k, v, dout, lse, delta, pre, dq, B, T_len,
                                 S, H, KV, causal, stream);
    case 6:
      return launch_dq_mma<D, 3>(q, k, v, dout, lse, delta, pre, dq, B, T_len,
                                 S, H, KV, causal, stream);
    case 4:
    case 8:
    case 16:
      return launch_dq_mma<D, 4>(q, k, v, dout, lse, delta, pre, dq, B, T_len,
                                 S, H, KV, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 at D 64 and 128: wgmma on tiles that TMA fills
// ---------------------------------------------------------------------------

constexpr int WQ = 64;           // queries per Q/dO tile
constexpr int WK = 64;           // keys per dK/dV CTA and per dQ K/V tile
constexpr int kDkvStages = 2;    // rounds in the dK/dV kernel's ring
constexpr int kDqStages = 2;     // K/V tiles in the dQ kernel's ring
constexpr int ROW_B = 128;       // bytes of one swizzled row: 64 bf16
constexpr int TILE_B = 64 * ROW_B;  // one 64-row, 64-column box: 8 KB

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait past
// ~10 s of SM clock traps, so a lost transfer fails the launch with an
// error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}
// one box of a 4-d tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins registers an asynchronous wgmma reads or writes in place: the
// compiler may not move their uses across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Descriptor of a wgmma operand in the layout TMA's 128-byte swizzle
// writes: 64-column boxes of 128-byte rows, 8-row groups 1024 bytes
// apart (SBO).  K-major operands advance along K by 32 bytes inside a
// row; MN-major ones (B with trans-b) reach their next 64 columns `lbo`
// bytes on, the next box.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 64) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&d)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// accumulator columns 16kk..16kk+15 of a 64 x 64 tile as the bf16 A
// operand of a k-step: wgmma's A fragment is its accumulator's layout
__device__ __forceinline__ void pack_k16(uint32_t (&a)[4], const float* x) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

// the first 1024-byte boundary in the dynamic shared memory (the swizzle
// atoms' alignment), as an offset from it, so the compiler keeps knowing
// the pointer is shared memory
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// dK/dV: a CTA owns 64 keys of one kv head, K and V resident; its two
// warpgroups split the (head, query tile) pairs that see the keys, even
// pairs to one and odd to the other, each summing into its own dK and dV
// accumulators; at the end the second's sums go through shared memory
// and the first adds them (even + odd, a fixed order) and writes dK, dV.
// Both pairs of a round ride in one stage of the ring.  Warp 0 keeps the
// ring filled: once both warpgroups release a stage it stages the LSE
// and delta of the round due there (loaded one round ahead) and issues
// its TMA loads.  Small blocks keep the causal walks balanced: the
// grid's slowest index is the key block, so the longest walks start
// first and the SMs' work evens out.
template <int D>
struct DkvWg {
  static constexpr int NH = D / 64;                    // 64-column boxes
  static constexpr size_t tile = (size_t)NH * TILE_B;  // 64 rows, D cols
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = tile;
  static constexpr size_t ring_off = 2 * tile;
  // a stage: [pair 0, pair 1] x [Q, dO] tiles
  static constexpr size_t stage = 4 * tile;
  static constexpr size_t rows_off = ring_off + kDkvStages * stage;
  // a stage's rows: [pair 0, pair 1] x [LSE, delta] x 64 queries
  static constexpr size_t bar_off =
      rows_off + sizeof(float) * kDkvStages * 4 * WQ;
  static constexpr size_t bytes = bar_off + 8 * (1 + 2 * kDkvStages) + 1024;
  static_assert(kDkvStages * stage >= sizeof(float) * D * 128,
                "the second warpgroup's dK and dV go through the ring");
};

template <int D>
__global__ void __launch_bounds__(256, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ prefix_len,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int T_len, int S, int H, int KV, int causal,
                      float scale_log2, float scale) {
  using L = DkvWg<D>;
  constexpr int NH = L::NH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;
  float* rows = reinterpret_cast<float*>(smem + L::rows_off);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * WK;
  const int G = H / KV;
  const int pre = prefix_len[b];
  // query tiles that see a key of the block: all under a prefix key or
  // full attention, else from the causal future of its first key on
  const int qt_start = (causal && k0 >= pre) ? k0 / WQ : 0;
  const int n_per = max((T_len + WQ - 1) / WQ - qt_start, 0);
  const int n_it = G * n_per;           // (head, query tile) pairs
  const int n_rounds = (n_it + 1) / 2;  // two pairs a round
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const bool loader = tid < 32;

  // the loader's LSE and delta of queries lane and lane + 32 of a round's
  // two pairs, loaded one round ahead of the stage they go to: nothing
  // reads them until then, so the warp does not wait for them
  float nl[2][2] = {}, nd[2][2] = {};
  auto fetch = [&](int round) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int p = min(2 * round + w, n_it - 1);
      const int h = kvh * G + p / n_per;
      const int q0 = (qt_start + p % n_per) * WQ;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = min(q0 + lane + 32 * r, T_len - 1);
        nl[w][r] = lse[((size_t)b * H + h) * T_len + t];
        nd[w][r] = delta[((size_t)b * H + h) * T_len + t];
      }
    }
  };
  // a round's stage: its rows from the registers (log2-domain LSE, zeros
  // past T), then the tiles of its one or two pairs
  auto load_stage = [&](int round) {
    const int s = round % kDkvStages;
    const int np = min(2, n_it - 2 * round);
    float* rw = rows + s * 4 * WQ;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int q0 = (qt_start + (2 * round + w) % n_per) * WQ;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool in = q0 + lane + 32 * r < T_len;
        rw[w * 2 * WQ + lane + 32 * r] = in ? nl[w][r] * kLog2e : 0.f;
        rw[w * 2 * WQ + WQ + lane + 32 * r] = in ? nd[w][r] : 0.f;
      }
    }
    if (round + 1 < n_rounds) fetch(round + 1);
    if (lane == 0) {
      mbar_expect_tx(&full[s], np * 2 * L::tile);
      unsigned char* st = smem + L::ring_off + s * L::stage;
      for (int w = 0; w < np; ++w) {
        const int p = 2 * round + w;
        const int h = kvh * G + p / n_per;
        const int q0 = (qt_start + p % n_per) * WQ;
#pragma unroll
        for (int c = 0; c < NH; ++c) {
          tma_load(st + w * 2 * L::tile + c * TILE_B, &tq, &full[s], c * 64,
                   h, q0, b);
          tma_load(st + w * 2 * L::tile + L::tile + c * TILE_B, &tdo,
                   &full[s], c * 64, h, q0, b);
        }
      }
    } else {
      mbar_arrive(&full[s]);
    }
  };

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 32);   // the loader warp's lanes
      mbar_init(&empty[s], 8);   // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::tile);
#pragma unroll
      for (int c = 0; c < NH; ++c) {
        tma_load(smem + L::k_off + c * TILE_B, &tk, kv_full, c * 64, kvh, k0,
                 b);
        tma_load(smem + L::v_off + c * TILE_B, &tv, kv_full, c * 64, kvh, k0,
                 b);
      }
    }
    if (n_rounds > 0) fetch(0);
    for (int r = 0; r < min(kDkvStages, n_rounds); ++r) load_stage(r);
  }

  const int lr = lane / 4, lc = (lane % 4) * 2;
  const int key0 = k0 + warp * 16 + lr;   // this thread's keys: +0, +8
  const uint64_t kd = sw128_desc(smem + L::k_off, 16);
  const uint64_t vd = sw128_desc(smem + L::v_off, 16);
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int round = 0; round < n_rounds; ++round) {
    const int s = round % kDkvStages;
    mbar_wait(&full[s], (round / kDkvStages) & 1);
    const int p = 2 * round + wg;   // this warpgroup's pair
    if (p < n_it) {
      const int q0 = (qt_start + p % n_per) * WQ;
      const unsigned char* Qt =
          smem + L::ring_off + s * L::stage + wg * 2 * L::tile;
      const unsigned char* dOt = Qt + L::tile;
      const float* lse2 = rows + s * 4 * WQ + wg * 2 * WQ;
      const float* dl = lse2 + WQ;
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      const uint64_t qd = sw128_desc(Qt, 16), od = sw128_desc(dOt, 16);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // descriptors count 16-byte units
        const int off = ((kk / 4) * TILE_B + (kk % 4) * 32) >> 4;
        wgmma_ss_n64(st, kd + off, qd + off, kk > 0);
        wgmma_ss_n64(dpt, vd + off, od + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);
      // P^T and dS^T: rows are keys, columns queries
      const bool visible = k0 + WK <= S && q0 + WQ <= T_len &&
                           (!causal || k0 + WK - 1 <= q0 || k0 + WK <= pre);
      if (visible) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qi = (i / 4) * 8 + lc + (i % 2);
          st[i] = exp2f(st[i] * scale_log2 - lse2[qi]);
          dpt[i] = st[i] * (dpt[i] - dl[qi]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = key0 + 8 * ((i / 2) % 2);
          const int qi = (i / 4) * 8 + lc + (i % 2);
          const int qpos = q0 + qi;
          const bool ok = key < S && qpos < T_len &&
                          (!causal || key <= qpos || key < pre);
          const float e = exp2f(st[i] * scale_log2 - lse2[qi]);
          st[i] = ok ? e : 0.f;
          dpt[i] = st[i] * (dpt[i] - dl[qi]);
        }
      }
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pack_k16(pa[kk], st + 8 * kk);
        pack_k16(sa[kk], dpt + 8 * kk);
      }
      fence_regs(pa);
      fence_regs(sa);
      wgmma_fence();
      const uint64_t qmn = sw128_desc(Qt, TILE_B);
      const uint64_t omn = sw128_desc(dOt, TILE_B);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_d<D>(dva, pa[kk], omn + kk * (16 * ROW_B >> 4));
        wgmma_rs_d<D>(dka, sa[kk], qmn + kk * (16 * ROW_B >> 4));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(sa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    // refill the stage with the round due there once both warpgroups are
    // done with it
    if (loader && round + kDkvStages < n_rounds) {
      mbar_wait(&empty[s], (round / kDkvStages) & 1);
      load_stage(round + kDkvStages);
    }
  }

  // the odd pairs' sums through the (now idle) ring, added to the even
  // pairs' in that order
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + L::ring_off);
  const int t = tid % 128;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      part[i * 128 + t] = dka[i];
      part[(D / 2 + i) * 128 + t] = dva[i];
    }
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dka[i] += part[i * 128 + t];
      dva[i] += part[(D / 2 + i) * 128 + t];
    }
    // dK (scaled) and dV straight from the accumulators, a bf16 pair each
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < S) {
        const size_t base =
            ((size_t)b * S + key) * KV * D + (size_t)kvh * D + lc;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + base + j * 8) =
              __floats2bfloat162_rn(dka[4 * j + 2 * r] * scale,
                                    dka[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + base + j * 8) =
              __floats2bfloat162_rn(dva[4 * j + 2 * r],
                                    dva[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// dQ: one warpgroup a CTA, 64 queries of one head, Q and dO resident;
// K/V tiles stream up to the causal limit, thread 0 refilling each stage
// once the warpgroup is done with it
template <int D>
struct DqWg {
  static constexpr int NH = D / 64;
  static constexpr size_t tile = (size_t)NH * TILE_B;  // 64 rows, D cols
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = tile;
  static constexpr size_t ring_off = 2 * tile;          // K then V a stage
  static constexpr size_t bar_off = ring_off + kDqStages * 2 * tile;
  static constexpr size_t bytes = bar_off + 8 * (1 + kDqStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(128, 2)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ prefix_len,
                    bf16* __restrict__ dq, int T_len, int S, int H, int KV,
                    int causal, float scale_log2, float scale) {
  using L = DqWg<D>;
  constexpr int NH = L::NH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_full + 1;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * WQ;  // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int pre = prefix_len[b];
  int n_tiles = (S + WK - 1) / WK;
  if (causal) n_tiles = min(n_tiles, max(q0 + WQ - 1, pre - 1) / WK + 1);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  auto load_tile = [&](int kt) {
    const int s = kt % kDqStages;
    mbar_expect_tx(&full[s], 2 * L::tile);
    unsigned char* st = smem + L::ring_off + s * 2 * L::tile;
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      tma_load(st + c * TILE_B, &tk, &full[s], c * 64, kvh, kt * WK, b);
      tma_load(st + L::tile + c * TILE_B, &tv, &full[s], c * 64, kvh,
               kt * WK, b);
    }
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, 2 * L::tile);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      tma_load(smem + L::q_off + c * TILE_B, &tq, q_full, c * 64, h, q0, b);
      tma_load(smem + L::do_off + c * TILE_B, &tdo, q_full, c * 64, h, q0,
               b);
    }
    for (int kt = 0; kt < min(kDqStages, n_tiles); ++kt) load_tile(kt);
  }
  __syncthreads();

  const int lr = lane / 4, lc = (lane % 4) * 2;
  const int row0 = q0 + warp * 16 + lr;  // this thread's queries: +0, +8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    const size_t at = ((size_t)b * H + h) * T_len + min(t, T_len - 1);
    lse2[r] = t < T_len ? lse[at] * kLog2e : 0.f;
    dl[r] = t < T_len ? delta[at] : 0.f;
  }
  const uint64_t qd = sw128_desc(smem + L::q_off, 16);
  const uint64_t od = sw128_desc(smem + L::do_off, 16);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kDqStages, round = kt / kDqStages;
    mbar_wait(&full[s], round & 1);
    const unsigned char* Kt = smem + L::ring_off + s * 2 * L::tile;
    const unsigned char* Vt = Kt + L::tile;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    const uint64_t kd = sw128_desc(Kt, 16), vd = sw128_desc(Vt, 16);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = ((kk / 4) * TILE_B + (kk % 4) * 32) >> 4;
      wgmma_ss_n64(sc, qd + off, kd + off, kk > 0);
      wgmma_ss_n64(dp, od + off, vd + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
    // P from the saved LSE, dS = P (dP - delta), in place of S
    const int k_end = kt * WK + WK;
    const bool visible = k_end <= S && q0 + WQ <= T_len &&
                         (!causal || k_end - 1 <= q0 || k_end <= pre);
    if (visible) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2f(sc[i] * scale_log2 - lse2[r]) * (dp[i] - dl[r]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        const int qpos = row0 + 8 * r;
        const int key = kt * WK + (i / 4) * 8 + lc + (i % 2);
        const bool ok = key < S && qpos < T_len &&
                        (!causal || key <= qpos || key < pre);
        const float p = exp2f(sc[i] * scale_log2 - lse2[r]);
        sc[i] = (ok ? p : 0.f) * (dp[i] - dl[r]);
      }
    }
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_k16(sa[kk], sc + 8 * kk);
    fence_regs(sa);
    wgmma_fence();
    const uint64_t kmn = sw128_desc(Kt, TILE_B);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_d<D>(acc, sa[kk], kmn + kk * (16 * ROW_B >> 4));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(sa);
    // every warp is done with the stage: refill it
    __syncthreads();
    if (tid == 0 && kt + kDqStages < n_tiles) load_tile(kt + kDqStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t < T_len) {
      const size_t base = (((size_t)b * T_len + t) * H + h) * D + lc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a (B, rows, heads, D) bf16 tensor as 64-column, 64-row boxes of one head
// and batch row, 128-byte swizzled; rows past the end arrive as zeros
int box_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
            int D) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const float* lse, const float* delta,
                 const int* pre, bf16* dq, bf16* dk, bf16* dv, int B,
                 int T_len, int S, int H, int KV, int causal,
                 cudaStream_t stream) {
  // TMA reads from 16-byte-aligned addresses only
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tdo;
  int rc = box_map(&tq, q, B, T_len, H, D);
  if (rc == 0) rc = box_map(&tk, k, B, S, KV, D);
  if (rc == 0) rc = box_map(&tv, v, B, S, KV, D);
  if (rc == 0) rc = box_map(&tdo, dout, B, T_len, H, D);
  if (rc != 0) return rc;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const float scale = 1.0f / sqrtf((float)D);
  {
    auto kern = dkdv_wgmma_kernel<D>;
    static bool configured = false;
    rc = set_smem(kern, DkvWg<D>::bytes, configured);
    if (rc != 0) return rc;
    dim3 grid(KV, B, (S + WK - 1) / WK);  // key blocks slowest
    APEX_LAUNCH(kern, grid, dim3(256), DkvWg<D>::bytes, stream, tq, tk, tv,
                tdo, lse, delta, pre, dk, dv, T_len, S, H, KV, causal,
                scale_log2, scale);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  auto kern = dq_wgmma_kernel<D>;
  static bool configured = false;
  rc = set_smem(kern, DqWg<D>::bytes, configured);
  if (rc != 0) return rc;
  dim3 grid((T_len + WQ - 1) / WQ, H, B);
  APEX_LAUNCH(kern, grid, dim3(128), DqWg<D>::bytes, stream, tq, tk, tv, tdo,
              lse, delta, pre, dq, T_len, S, H, KV, causal, scale_log2,
              scale);
  return 0;
}

// ---------------------------------------------------------------------------
// fp32: plain FMA, scores in shared memory
// ---------------------------------------------------------------------------

constexpr int NT = 128;   // threads per CTA of the FMA kernels
constexpr int FQ = 32;    // queries per CTA (dQ) or per tile (dK/dV)
constexpr int FK = 32;    // keys per tile of the dQ kernel

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <int D>
struct FdqSmem {
  static constexpr int LDQ = D + 1;
  static constexpr int LDS = FK + 1;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = align128(q_off + sizeof(float) * FQ * LDQ);
  static constexpr size_t k_off = align128(do_off + sizeof(float) * FQ * LDQ);
  static constexpr size_t v_off = align128(k_off + sizeof(float) * FK * LDQ);
  static constexpr size_t s_off = align128(v_off + sizeof(float) * FK * LDQ);
  static constexpr size_t row_off = align128(s_off + sizeof(float) * FQ * LDS);
  static constexpr size_t bytes = align128(row_off + sizeof(float) * 2 * FQ);
};

__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int D) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// rows [row0, row0 + rows) of one head of a (B, n, heads, D) fp32 tensor
// into shared memory (pitch D + 1), zeros past n
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              size_t base, size_t row_stride,
                                              int row0, int rows, int n) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    dst[r * (D + 1) + d] = s < n ? src[base + (size_t)s * row_stride + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
    dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ prefix_len, float* __restrict__ dq,
                  int T_len, int S, int H, int KV, int causal, float scale) {
  using L = FdqSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dOs = reinterpret_cast<float*>(smem + L::do_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* row_lse = reinterpret_cast<float*>(smem + L::row_off);
  float* row_dl = row_lse + FQ;

  const int q0 = blockIdx.x * FQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int kvh = h / (H / KV);
  const int pre = prefix_len[b];
  const size_t q_base = (size_t)b * T_len * H * D + (size_t)h * D;
  const size_t kv_base = (size_t)b * S * KV * D + (size_t)kvh * D;

  load_rows_f32<D>(Qs, q, q_base, (size_t)H * D, q0, FQ, T_len);
  load_rows_f32<D>(dOs, dout, q_base, (size_t)H * D, q0, FQ, T_len);
  if (tid < FQ) {
    const int t = q0 + tid;
    const size_t at = ((size_t)b * H + h) * T_len + min(t, T_len - 1);
    row_lse[tid] = t < T_len ? lse[at] : 0.f;
    row_dl[tid] = t < T_len ? delta[at] : 0.f;
  }
  constexpr int PER = FQ * D / NT;
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  int n_tiles = (S + FK - 1) / FK;
  if (causal) {
    const int last = max(q0 + FQ - 1, pre - 1);
    n_tiles = min(n_tiles, last / FK + 1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // readers of the previous tile are done
    load_rows_f32<D>(Ks, k, kv_base, (size_t)KV * D, kt * FK, FK, S);
    load_rows_f32<D>(Vs, v, kv_base, (size_t)KV * D, kt * FK, FK, S);
    __syncthreads();
    for (int i = tid; i < FQ * FK; i += NT) {
      const int r = i / FK, c = i % FK;
      const int key = kt * FK + c, qpos = q0 + r;
      float ds = 0.f;
      if (key < S && qpos < T_len &&
          (!causal || key <= qpos || key < pre)) {
        const float p = expf(dot_rows(Qs + r * L::LDQ, Ks + c * L::LDQ, D) *
                                 scale -
                             row_lse[r]);
        const float dp = dot_rows(dOs + r * L::LDQ, Vs + c * L::LDQ, D);
        ds = p * (dp - row_dl[r]);
      }
      Ss[r * L::LDS + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + NT * j;
      const int r = i / D, d = i % D;
      const float* srow = Ss + r * L::LDS;
      float a = 0.f;
#pragma unroll 8
      for (int c = 0; c < FK; ++c) a += srow[c] * Ks[c * L::LDQ + d];
      acc[j] += a;
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + NT * j;
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    if (t < T_len) dq[q_base + (size_t)t * H * D + d] = acc[j] * scale;
  }
}

template <int D>
struct FdkvSmem {
  // keys per CTA: 32, or 16 above D 128 (the dK and dV accumulators of a
  // thread stay at 2 x 32)
  static constexpr int BKV = D > 128 ? 16 : 32;
  static constexpr int LDQ = D + 1;
  static constexpr int LDP = FQ + 1;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align128(k_off + sizeof(float) * BKV * LDQ);
  static constexpr size_t q_off = align128(v_off + sizeof(float) * BKV * LDQ);
  static constexpr size_t do_off = align128(q_off + sizeof(float) * FQ * LDQ);
  static constexpr size_t p_off = align128(do_off + sizeof(float) * FQ * LDQ);
  static constexpr size_t ds_off = align128(p_off + sizeof(float) * BKV * LDP);
  static constexpr size_t row_off = align128(ds_off + sizeof(float) * BKV * LDP);
  static constexpr size_t bytes = align128(row_off + sizeof(float) * 2 * FQ);
};

template <int D>
__global__ void __launch_bounds__(NT)
    dkdv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ prefix_len,
                    float* __restrict__ dk, float* __restrict__ dv, int T_len,
                    int S, int H, int KV, int causal, float scale) {
  using L = FdkvSmem<D>;
  constexpr int BKV = L::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dOs = reinterpret_cast<float*>(smem + L::do_off);
  float* Ps = reinterpret_cast<float*>(smem + L::p_off);
  float* dSs = reinterpret_cast<float*>(smem + L::ds_off);
  float* row_lse = reinterpret_cast<float*>(smem + L::row_off);
  float* row_dl = row_lse + FQ;

  const int k0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / KV;
  const int pre = prefix_len[b];
  const size_t kv_base = (size_t)b * S * KV * D + (size_t)kvh * D;
  load_rows_f32<D>(Ks, k, kv_base, (size_t)KV * D, k0, BKV, S);
  load_rows_f32<D>(Vs, v, kv_base, (size_t)KV * D, k0, BKV, S);

  constexpr int PER = BKV * D / NT;
  float acc_k[PER], acc_v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc_k[j] = acc_v[j] = 0.f;
  const int qt_start = (causal && k0 >= pre) ? k0 / FQ : 0;
  const int n_qt = (T_len + FQ - 1) / FQ;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_base = (size_t)b * T_len * H * D + (size_t)h * D;
    for (int qt = qt_start; qt < n_qt; ++qt) {
      const int q0 = qt * FQ;
      __syncthreads();  // readers of the previous tile are done
      load_rows_f32<D>(Qs, q, q_base, (size_t)H * D, q0, FQ, T_len);
      load_rows_f32<D>(dOs, dout, q_base, (size_t)H * D, q0, FQ, T_len);
      if (tid < FQ) {
        const int t = q0 + tid;
        const size_t at = ((size_t)b * H + h) * T_len + min(t, T_len - 1);
        row_lse[tid] = t < T_len ? lse[at] : 0.f;
        row_dl[tid] = t < T_len ? delta[at] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < BKV * FQ; i += NT) {
        const int c = i / FQ, r = i % FQ;
        const int key = k0 + c, qpos = q0 + r;
        float p = 0.f, ds = 0.f;
        if (key < S && qpos < T_len &&
            (!causal || key <= qpos || key < pre)) {
          p = expf(dot_rows(Qs + r * L::LDQ, Ks + c * L::LDQ, D) * scale -
                   row_lse[r]);
          ds = p * (dot_rows(dOs + r * L::LDQ, Vs + c * L::LDQ, D) -
                    row_dl[r]);
        }
        Ps[c * L::LDP + r] = p;
        dSs[c * L::LDP + r] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = tid + NT * j;
        const int c = i / D, d = i % D;
        const float* prow = Ps + c * L::LDP;
        const float* srow = dSs + c * L::LDP;
        float av = 0.f, ak = 0.f;
#pragma unroll 8
        for (int r = 0; r < FQ; ++r) {
          av += prow[r] * dOs[r * L::LDQ + d];
          ak += srow[r] * Qs[r * L::LDQ + d];
        }
        acc_v[j] += av;
        acc_k[j] += ak;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + NT * j;
    const int c = i / D, d = i % D;
    const int key = k0 + c;
    if (key < S) {
      const size_t off = kv_base + (size_t)key * KV * D + d;
      dk[off] = acc_k[j] * scale;
      dv[off] = acc_v[j];
    }
  }
}

template <int D>
int launch_fma(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               const int* pre, float* dq, float* dk, float* dv, int B,
               int T_len, int S, int H, int KV, int causal,
               cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  {
    using L = FdkvSmem<D>;
    auto kern = dkdv_fma_kernel<D>;
    static bool configured = false;
    const int rc = set_smem(kern, L::bytes, configured);
    if (rc != 0) return rc;
    dim3 grid((S + L::BKV - 1) / L::BKV, KV, B);
    APEX_LAUNCH(kern, grid, dim3(NT), L::bytes, stream, q, k, v, dout, lse,
                delta, pre, dk, dv, T_len, S, H, KV, causal, scale);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  using L = FdqSmem<D>;
  auto kern = dq_fma_kernel<D>;
  static bool configured = false;
  const int rc = set_smem(kern, L::bytes, configured);
  if (rc != 0) return rc;
  dim3 grid((T_len + FQ - 1) / FQ, H, B);
  APEX_LAUNCH(kern, grid, dim3(NT), L::bytes, stream, q, k, v, dout, lse,
              delta, pre, dq, T_len, S, H, KV, causal, scale);
  return 0;
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B,
                 int T_len, int H, int D, cudaStream_t stream) {
  const int rows = B * T_len * H;
  const int per_block = 256 / 32;
  APEX_LAUNCH(delta_kernel<T>, dim3((rows + per_block - 1) / per_block),
              dim3(256), 0, stream, (const T*)o, (const T*)dout, delta, T_len,
              H, D, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int apex_prefill_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* prefix_len, void* delta,
    void* dq, void* dk, void* dv, int B, int T_len, int S, int H, int KV,
    int D, int bf16_in, int causal, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* pre = (const int*)prefix_len;
  const float* lse_f = (const float*)lse;
  float* dl = (float*)delta;
  int rc = bf16_in ? launch_delta<bf16>(o, dout, dl, B, T_len, H, D, st)
                   : launch_delta<float>(o, dout, dl, B, T_len, H, D, st);
  if (rc != 0) return rc;
  rc = (int)cudaErrorInvalidValue;
  if (bf16_in) {
    const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k,
               *vb = (const bf16*)v, *ob = (const bf16*)dout;
    bf16 *dqb = (bf16*)dq, *dkb = (bf16*)dk, *dvb = (bf16*)dv;
    switch (D) {
      case 32:
        rc = launch_mma<32>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb, B,
                            T_len, S, H, KV, causal, st);
        break;
      case 64:
        rc = launch_wgmma<64>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb,
                              B, T_len, S, H, KV, causal, st);
        break;
      case 80:
        rc = launch_mma<80>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb, B,
                            T_len, S, H, KV, causal, st);
        break;
      case 128:
        rc = launch_wgmma<128>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb,
                               B, T_len, S, H, KV, causal, st);
        break;
      case 160:
        rc = launch_mma<160>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb, B,
                             T_len, S, H, KV, causal, st);
        break;
      case 256:
        rc = launch_mma<256>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb, B,
                             T_len, S, H, KV, causal, st);
        break;
      default:
        break;
    }
  } else {
    const float *qf = (const float*)q, *kf = (const float*)k,
                *vf = (const float*)v, *of = (const float*)dout;
    float *dqf = (float*)dq, *dkf = (float*)dk, *dvf = (float*)dv;
    switch (D) {
      case 32:
        rc = launch_fma<32>(qf, kf, vf, of, lse_f, dl, pre, dqf, dkf, dvf, B,
                            T_len, S, H, KV, causal, st);
        break;
      case 64:
        rc = launch_fma<64>(qf, kf, vf, of, lse_f, dl, pre, dqf, dkf, dvf, B,
                            T_len, S, H, KV, causal, st);
        break;
      case 80:
        rc = launch_fma<80>(qf, kf, vf, of, lse_f, dl, pre, dqf, dkf, dvf, B,
                            T_len, S, H, KV, causal, st);
        break;
      case 128:
        rc = launch_fma<128>(qf, kf, vf, of, lse_f, dl, pre, dqf, dkf, dvf, B,
                             T_len, S, H, KV, causal, st);
        break;
      case 160:
        rc = launch_fma<160>(qf, kf, vf, of, lse_f, dl, pre, dqf, dkf, dvf, B,
                             T_len, S, H, KV, causal, st);
        break;
      case 256:
        rc = launch_fma<256>(qf, kf, vf, of, lse_f, dl, pre, dqf, dkf, dvf, B,
                             T_len, S, H, KV, causal, st);
        break;
      default:
        break;
    }
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The kernels a call of this head_dim and dtype runs: 2 wgmma (bf16 at
// D 64 and 128), 1 mma.sync (bf16 at D 32, 80, 160, 256), 0 FMA (fp32),
// -1 none.
extern "C" int apex_prefill_attention_bwd_route(int D, int bf16_in) {
  if (D != 32 && D != 64 && D != 80 && D != 128 && D != 160 && D != 256)
    return -1;
  if (!bf16_in) return 0;
  return D == 64 || D == 128 ? 2 : 1;
}
