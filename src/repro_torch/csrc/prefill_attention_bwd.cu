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
// 1024).  The design (FlashAttention-2's split, on mma.sync as the
// forward):
//   * a pass writes delta_i = rowsum(dO_i * O_i) (fp32, (B, H, T));
//   * dK/dV: one CTA per 64 keys of one kv head (a warp per 16 keys)
//     walks the kv head's G query heads and, for each, the 32-query tiles
//     that see its keys (all of them under a prefix or full attention,
//     from the block's first key on under the causal mask).  Q and dO
//     tiles stream through a 2-stage cp.async ring; S^T and dP^T are
//     recomputed in registers, P^T = exp2(S^T - lse) from the saved LSE,
//     dS^T = P^T (dP^T - delta), and dV += P^T dO, dK += dS^T Q stay in
//     registers for the whole walk: the G heads' sum is taken there, so
//     nothing is added across CTAs and no atomics are used.  Above D 128
//     the two accumulators do not fit a warp's registers, so the output
//     columns are cut in two chunks, each a CTA of its own that
//     recomputes S^T and dP^T;
//   * dQ: one CTA per 16-query block of up to four query heads of one kv
//     head (a warp per head), as the forward: K/V tiles through the ring
//     up to the block's causal limit, S and dP recomputed, dQ += dS K in
//     registers;
//   * fp32 q/k/v (the exactness models) run plain-FMA kernels of the
//     same split, scores in shared memory, exact against the plain
//     version at fp32 rounding.
// With no atomics and every sum in a fixed order, the same inputs give
// the same bits.  wgmma and TMA are later work: the products here run on
// mma.sync m16n8k16, operands by ldmatrix.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing (the wrapper passes the
// delta buffer), and returns cudaGetLastError().

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
        rc = launch_mma<64>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb, B,
                            T_len, S, H, KV, causal, st);
        break;
      case 80:
        rc = launch_mma<80>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb, B,
                            T_len, S, H, KV, causal, st);
        break;
      case 128:
        rc = launch_mma<128>(qb, kb, vb, ob, lse_f, dl, pre, dqb, dkb, dvb, B,
                             T_len, S, H, KV, causal, st);
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
