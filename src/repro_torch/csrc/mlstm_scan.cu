// mLSTM recurrence for Hopper (sm_90a): the forward, by two routes.
//
// Replaces no Pallas kernel: the reference runs the recurrence as one
// `lax.scan` (src/repro/models/ssm.py:369, `mlstm_forward`, over the cell
// `_mlstm_cell` at :285); the port's plain version is a Python loop
// (kernels/ref.py `mlstm_recurrence_ref`).  Per (row b, head j, step t),
// with q, k, v (hd) and the gate pre-activations i, f (f already through
// log-sigmoid):
//   m_t = max(f + m, i);  i_g = exp(i - m_t);  f_g = exp(f + m - m_t)
//   C_t = f_g C + i_g v k^T          (hd x hd matrix memory)
//   n_t = f_g n + i_g k
//   h_t = C_t q / max(|n_t . q|, 1)
// h is emitted from the unmasked C_t; past the row's valid length only the
// state (C, n, m) is held, as the reference masks the state alone.
//
// What bounds it on an H100.  At xlstm-125m (hd 384) the memory is 576 KB
// a head, 2.36 MB a row: at one decode step the time is the bytes of C
// read and written; over a prompt each step is ~6 hd^2 fp32 operations
// per (row, head) (the rank-1 update and the read-out), so the walk is
// bound by the CUDA cores' fp32 rate and by the latency of its sequential
// steps.  The v-rows of C update independently (C_t[v, :] = f_g C[v, :] +
// i_g v[v] k, h[v] = C_t[v, :] . q), so:
//   * a CTA owns a slab of 32 v-rows of one (row, head) for the whole walk,
//     held in registers (warp w: rows 4w..4w+3; lane l: columns l + 32 i),
//     so C moves through device memory once per call each way; at hd 384
//     that is 12 CTAs a (row, head), 192 CTAs at B 4, with no exchange
//     between them;
//   * every warp recomputes the head's normaliser n (hd values, lane-
//     strided) and n . q itself, so no CTA waits on another;
//   * q, k, the slab's v and the two gates arrive by cp.async in tiles of
//     4 steps, double-buffered, ahead of use;
//   * each dot product is one FMA chain per lane in column order, then a
//     butterfly across the warp whose lane-0 result is broadcast: one
//     fixed order.  Every update is written with round-to-nearest
//     intrinsics, and the step's arithmetic does not depend on t, so a
//     call split in T with the state carried equals one call, and a row
//     of length 0 keeps its state bit for bit;
//   * no tensor cores: a rank-1 update and a matrix-vector product per
//     step carry no matrix product for wgmma, and the reference's fp32
//     arithmetic is kept.
//
// That is the walk route: a call with lens, or with T below
// APEX_MLSTM_FWD_CROSSOVER (decode, the serving chunk, a row held past
// its length, a call split in T).  A call with no lens and T at or above
// the crossover (training's forward and its remat recompute, a long
// prompt) takes the chunkwise route instead, whose longest chain of
// dependent steps runs over chunks of L = APEX_MLSTM_FWD_CHUNK steps, not
// over T (the algebra of mlstm_scan_bwd.cu and kernels/ref.py
// `mlstm_chunkwise_fwd_ref`; its building blocks are mlstm_chunk.cuh's,
// shared with the backward).  With, in a chunk, alpha_j = exp(lf summed
// from the chunk's start to j), W_jr = exp(lf summed over (r, j] + li_r)
// for r <= j, and the boundary memory B_c = [C; n] before chunk c:
//   1. mlstm_fwd_gates: m's max-plus scan over lane segments, lf, li, and
//      per chunk alpha and w (m_T is the last step's m);
//   2. mlstm_fwd_bounds: one 64 x 64 tile of B a CTA, walking the chunks,
//      B_{c+1} = alpha_last B_c + [V; 1]^T diag(w) K; the last one is the
//      final state [C_T; n_T];
//   3. mlstm_fwd_chunk: per chunk, WS = W * (Q K^T) (L x L);
//   4. mlstm_fwd_out: per (chunk, 64 columns of hd), all chunks at once:
//      s_j = alpha_j q_j . n_c + sum_r WS_jr, den_j = max(|s_j|, 1),
//      h_j = (alpha_j C_c q_j + sum_r WS_jr v_r) / den_j.
// Its products (about 2 (hd + 1) hd L + 2 hd L^2 multiply-adds a chunk)
// run on fp32 FMAs (APEX_MLSTM_FWD_TF32X3 1: 3xTF32 on tensor cores),
// every sum in one fixed order and no atomics, so a repeat gives the same
// bits; its sums run in another order than the walk's, so a call split in
// T is bitwise one call on the walk route only.  One scratch tensor from
// the caller holds the per-step scalars, the boundary memories and the
// chunks' WS (`apex_mlstm_scan_chunkwise_scratch_floats`).
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif
#ifndef APEX_MLSTM_FWD_CHUNK
#define APEX_MLSTM_FWD_CHUNK 64
#endif
#ifndef APEX_MLSTM_FWD_TF32X3
#define APEX_MLSTM_FWD_TF32X3 0
#endif
// the first T where the chunkwise route beat the walk by events and by
// device time, at B 2 with 4 heads of 384 (tools/xlstm_variants.py; the
// chunkwise kernels' fixed cost is ~0.06 ms, the walk's ~1.3 us a step)
#ifndef APEX_MLSTM_FWD_CROSSOVER
#define APEX_MLSTM_FWD_CROSSOVER 96
#endif
#define APEX_MLSTM_CHUNK APEX_MLSTM_FWD_CHUNK
#define APEX_MLSTM_TF32X3 APEX_MLSTM_FWD_TF32X3
#include "mlstm_chunk.cuh"

namespace {

constexpr int kRows = 32;        // v-rows of C per CTA (a slab)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kTileT = 4;        // steps per staged tile

template <int HD>
struct Geo {
  static constexpr int NC = HD / 32;             // columns per lane
  static constexpr int kSlabs = HD / kRows;
  // one staged step: q, k (hd each), the slab's v, then i and f
  static constexpr int kStep = 2 * HD + kRows + 4;
  static_assert(HD % kRows == 0 && HD % 32 == 0, "slabs of 32 rows");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the warp's sum of x, lane 0's result on every lane
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return __shfl_sync(0xffffffffu, x, 0);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_scan_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ ig,
                      const float* __restrict__ fg,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0,
                      const int* __restrict__ lens, float* __restrict__ hs,
                      float* __restrict__ c_out, float* __restrict__ n_out,
                      float* __restrict__ m_out, int T, int H) {
  using G = Geo<HD>;
  const int slab = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = slab * kRows + warp * kRowsPerWarp;   // first v-row
  __shared__ __align__(16) float st_s[2][kTileT][G::kStep];

  const size_t bh = (size_t)b * H + head;
  float cm[kRowsPerWarp][G::NC], nv[G::NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < G::NC; ++j)
      cm[r][j] = c0[(bh * HD + row0 + r) * HD + lane + 32 * j];
#pragma unroll
  for (int j = 0; j < G::NC; ++j) nv[j] = n0[bh * HD + lane + 32 * j];
  float m = m0[bh];
  const int len = lens != nullptr ? lens[b] : T;

  // tile kt: per step q and k rows, the slab's v, i and f
  auto stage = [&](int kt, int buf) {
    const int t0 = kt * kTileT;
    const int rows = min(kTileT, T - t0);
    constexpr int kVec = 2 * (HD / 4) + kRows / 4;   // 16-byte chunks a step
    for (int j = tid; j < rows * kVec; j += kThreads) {
      const int s = j / kVec, c = j % kVec;
      const size_t src = (((size_t)b * T + t0 + s) * H + head) * HD;
      float* dst = st_s[buf][s];
      if (c < HD / 4)
        cp_async16(dst + 4 * c, q + src + 4 * c);
      else if (c < HD / 2)
        cp_async16(dst + 4 * c, k + src + 4 * (c - HD / 4));
      else
        cp_async16(dst + 4 * c, v + src + slab * kRows + 4 * (c - HD / 2));
    }
    for (int j = tid; j < 2 * rows; j += kThreads) {
      const int s = j >> 1;
      const size_t gi = ((size_t)b * T + t0 + s) * H + head;
      cp_async4(&st_s[buf][s][2 * HD + kRows + (j & 1)],
                (j & 1) ? fg + gi : ig + gi);
    }
    cp_async_commit();
  };

  const int ntiles = (T + kTileT - 1) / kTileT;
  stage(0, 0);
  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) {
      stage(kt + 1, (kt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(kTileT, T - kt * kTileT);
    for (int s = 0; s < rows; ++s) {
      const int t = kt * kTileT + s;
      const float* sp = st_s[kt & 1][s];
      const float i_pre = sp[2 * HD + kRows], f_pre = sp[2 * HD + kRows + 1];
      const float a = __fadd_rn(f_pre, m);
      const float m_new = fmaxf(a, i_pre);
      const float i_g = expf(__fsub_rn(i_pre, m_new));
      const float f_g = expf(__fsub_rn(a, m_new));
      const bool keep = t < len;
      float qv[G::NC], kv[G::NC], nn[G::NC];
      float sdot = 0.f;
#pragma unroll
      for (int j = 0; j < G::NC; ++j) {
        qv[j] = sp[lane + 32 * j];
        kv[j] = sp[HD + lane + 32 * j];
        nn[j] = __fadd_rn(__fmul_rn(f_g, nv[j]), __fmul_rn(i_g, kv[j]));
        sdot = __fmaf_rn(nn[j], qv[j], sdot);
      }
      const float den = fmaxf(fabsf(warp_sum(sdot)), 1.f);
      float h_mine = 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float vr = sp[2 * HD + warp * kRowsPerWarp + r];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < G::NC; ++j) {
          const float cn = __fadd_rn(__fmul_rn(f_g, cm[r][j]),
                                     __fmul_rn(i_g, __fmul_rn(vr, kv[j])));
          acc = __fmaf_rn(cn, qv[j], acc);
          if (keep) cm[r][j] = cn;
        }
        const float h = __fdiv_rn(warp_sum(acc), den);
        if (lane == r) h_mine = h;
      }
      if (lane < kRowsPerWarp)
        hs[(((size_t)b * T + t) * H + head) * HD + row0 + lane] = h_mine;
      if (keep) {
#pragma unroll
        for (int j = 0; j < G::NC; ++j) nv[j] = nn[j];
        m = m_new;
      }
    }
    __syncthreads();   // the buffer is refilled by the next tile's stage
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < G::NC; ++j)
      c_out[(bh * HD + row0 + r) * HD + lane + 32 * j] = cm[r][j];
  if (slab == 0 && warp == 0) {
#pragma unroll
    for (int j = 0; j < G::NC; ++j) n_out[bh * HD + lane + 32 * j] = nv[j];
    if (lane == 0) m_out[bh] = m;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* ig,
           const float* fg, const float* c0, const float* n0,
           const float* m0, const int* lens, float* hs, float* c_out,
           float* n_out, float* m_out, int B, int T, int H,
           cudaStream_t stream) {
  auto kern = mlstm_scan_kernel<HD>;
  APEX_LAUNCH(kern, dim3(Geo<HD>::kSlabs, H, B), dim3(kThreads), 0, stream,
              q, k, v, ig, fg, c0, n0, m0, lens, hs, c_out, n_out, m_out, T,
              H);
  return 0;
}


// ---------------------------------------------------------------------------
// The chunkwise route (see the top of the file)
// ---------------------------------------------------------------------------

namespace mlc {

struct FwdGeo {
  int B, T, H, HD, nck, rt, ct;
  size_t sc, bnd, ws, total;                  // scratch offsets in floats
  __host__ __device__ FwdGeo(int b, int t, int h, int hd)
      : B(b), T(t), H(h), HD(hd), nck(cdiv(t, kL)), rt(cdiv(hd + 1, 64)),
        ct(cdiv(hd, 64)) {
    const size_t bh = (size_t)b * h, st = (size_t)(hd + 1) * hd;
    sc = 0;
    bnd = sc + up4(bh * kGateSlots * t);
    ws = bnd + up4(bh * (nck + 1) * st);
    total = ws + up4(bh * nck * kL * kL);
  }
  // element (b, t, head, x) of a (B, T, H, hd) tensor
  __device__ size_t seq(int b, int t, int head) const {
    return (((size_t)b * T + t) * H + head) * HD;
  }
  __device__ size_t gate(int b, int t, int head) const {
    return ((size_t)b * T + t) * H + head;
  }
  __device__ float* slots(float* scratch, int bh) const {
    return scratch + sc + (size_t)bh * kGateSlots * T;
  }
};

struct FwdArgs {
  const float *q, *k, *v, *ig, *fg, *c0, *n0, *m0;
  float *scratch, *hs, *c_out, *n_out, *m_out;
};

// 1. the stabiliser's scan and the gates; one warp a (row, head)
__global__ void __launch_bounds__(32)
    mlstm_fwd_gates(FwdArgs a, FwdGeo geo) {
  const int bh = blockIdx.x, b = bh / geo.H, head = bh % geo.H;
  float* sc = geo.slots(a.scratch, bh);
  gates_scan(a.ig + geo.gate(b, 0, head), a.fg + geo.gate(b, 0, head),
             geo.H, a.m0[bh], sc, geo.T);
  __syncwarp();
  if (threadIdx.x == 0) a.m_out[bh] = sc[kSm * geo.T + geo.T - 1];
}

// 2. the boundary memories, one 64 x 64 tile of [C; n] a CTA; the last is
// the final state
__global__ void __launch_bounds__(kThreads)
    mlstm_fwd_bounds(FwdArgs a, FwdGeo geo) {
  __shared__ __align__(16) float As[2 * kBuf], Bs[2 * kBuf];
  const int bh = blockIdx.z, b = bh / geo.H, head = bh % geo.H;
  const int HD = geo.HD, r0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const size_t st = (size_t)(HD + 1) * HD;
  using TL = Tile<64>;
  constexpr int N = TL::kRun;
  TL acc;
  bounds_walk(acc, As, Bs, geo.slots(a.scratch, bh),
              a.scratch + geo.bnd + (size_t)bh * (geo.nck + 1) * st,
              a.c0 + (size_t)bh * HD * HD, a.n0 + (size_t)bh * HD,
              a.v + geo.seq(b, 0, head), a.k + geo.seq(b, 0, head),
              (size_t)geo.H * HD, HD, geo.T, r0, k0);
#pragma unroll
  for (int e = 0; e < TL::kE; e += N) {
    const int r = r0 + acc.row(e), c = k0 + acc.col(e);
    if (r < HD && c < HD)
      put_run<N>(a.c_out + ((size_t)bh * HD + r) * HD + c, acc.v + e);
    else if (r == HD && c < HD)
      put_run<N>(a.n_out + (size_t)bh * HD + c, acc.v + e);
  }
}

// 3. WS = W * (Q K^T) per chunk, into the scratch
constexpr size_t kFwdChunkSmem =
    (size_t)(4 * kBuf + kL * kLp + 2 * kL) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
    mlstm_fwd_chunk(FwdArgs a, FwdGeo geo) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + 2 * kBuf;
  float* Wm = Bs + 2 * kBuf;
  float* lf = Wm + kL * kLp;
  float* li = lf + kL;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / geo.H,
            head = bh % geo.H;
  const int HD = geo.HD, T = geo.T, tid = threadIdx.x;
  const int c0 = c * kL, len = min(kL, T - c0);
  const float* sc = geo.slots(a.scratch, bh);
  float* ws = a.scratch + geo.ws + ((size_t)bh * geo.nck + c) * kL * kL;
  for (int j = tid; j < kL; j += kThreads) {
    lf[j] = j < len ? sc[kSlf * T + c0 + j] : 0.f;
    li[j] = j < len ? sc[kSli * T + c0 + j] : 0.f;
  }
  __syncthreads();
  decay_matrix(Wm, lf, li, len);
  __syncthreads();
  for (int rb = 0; rb < kL; rb += kM) {
    for (int cb = 0; cb < kL; cb += kN) {
      Tile<kM> acc;
      acc.zero();
      gemm<kM, true, true>(
          acc, As, Bs, HD,
          [&](int p, int i) {
            return rb + i < len && p < HD
                       ? ld4(a.q + geo.seq(b, c0 + rb + i, head) + p)
                       : zero4();
          },
          [&](int p, int j) {
            return cb + j < len && p < HD
                       ? ld4(a.k + geo.seq(b, c0 + cb + j, head) + p)
                       : zero4();
          });
#pragma unroll
      for (int e = 0; e < Tile<kM>::kE; ++e) {
        const int j = rb + acc.row(e), r = cb + acc.col(e);
        if (r < kL) ws[j * kL + r] = __fmul_rn(Wm[j * kLp + r], acc.v[e]);
      }
    }
  }
}

// 4. h for kM steps x 64 columns of one chunk
__global__ void __launch_bounds__(kThreads)
    mlstm_fwd_out(FwdArgs a, FwdGeo geo) {
  __shared__ __align__(16) float As[2 * kBuf], Bs[2 * kBuf];
  __shared__ float alpha_s[kM], den_s[kM];
  // (chunk, row, head) on x: T / L x B x H may pass 65535
  const int c = blockIdx.x % geo.nck, bh = blockIdx.x / geo.nck;
  const int rb = blockIdx.y * kM, k0 = blockIdx.z * 64;
  const int b = bh / geo.H, head = bh % geo.H;
  const int HD = geo.HD, T = geo.T, tid = threadIdx.x;
  const int c0 = c * kL, len = min(kL, T - c0);
  if (rb >= len) return;
  const float* sc = geo.slots(a.scratch, bh);
  const size_t st = (size_t)(HD + 1) * HD;
  const float* bc =
      a.scratch + geo.bnd + ((size_t)bh * (geo.nck + 1) + c) * st;
  const float* ws = a.scratch + geo.ws + ((size_t)bh * geo.nck + c) * kL * kL;
  // s_j = alpha_j q_j . n_c + sum_r WS_jr and den_j, a warp a step, each
  // sum a lane-strided chain joined by a butterfly
  const int warp = tid >> 5, lane = tid & 31;
  for (int j = warp; j < kM; j += kThreads / 32) {
    if (rb + j >= len) {
      if (lane == 0) alpha_s[j] = 0.f, den_s[j] = 1.f;
      continue;
    }
    const size_t o = geo.seq(b, c0 + rb + j, head);
    float x = 0.f, y = 0.f;
    for (int i = lane; i < HD; i += 32)
      x = __fmaf_rn(a.q[o + i], bc[(size_t)HD * HD + i], x);
    for (int r = lane; r < kL; r += 32)
      y = __fadd_rn(y, ws[(rb + j) * kL + r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
      y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, off));
    }
    if (lane == 0) {
      const float al = sc[kSal * T + c0 + rb + j];
      alpha_s[j] = al;
      den_s[j] = fmaxf(fabsf(__fadd_rn(__fmul_rn(al, x), y)), 1.f);
    }
  }
  // alpha C_c q over hd, then + WS V over the chunk's steps
  Tile<kM> acc;
  acc.zero();
  gemm<kM, true, true>(
      acc, As, Bs, HD,
      [&](int p, int i) {
        return rb + i < len && p < HD
                   ? ld4(a.q + geo.seq(b, c0 + rb + i, head) + p) : zero4();
      },
      [&](int p, int j) {
        return p < HD && k0 + j < HD ? ld4(bc + (size_t)(k0 + j) * HD + p)
                                     : zero4();
      });
  acc.scale_rows(alpha_s);
  gemm<kM, true, false>(
      acc, As, Bs, len,
      [&](int p, int i) {   // WS is 0 past the chunk's length
        return rb + i < len ? ld4(ws + (rb + i) * kL + p) : zero4();
      },
      [&](int p, int j) {
        return p < len && k0 + j < HD
                   ? ld4(a.v + geo.seq(b, c0 + p, head) + k0 + j) : zero4();
      });
  constexpr int N = Tile<kM>::kRun;
#pragma unroll
  for (int e = 0; e < Tile<kM>::kE; e += N) {
    const int j = rb + acc.row(e), col = k0 + acc.col(e);
    if (j < len && col < HD) {
      float h[N];
#pragma unroll
      for (int x = 0; x < N; ++x)
        h[x] = __fdiv_rn(acc.v[e + x], den_s[acc.row(e)]);
      put_run<N>(a.hs + geo.seq(b, c0 + j, head) + col, h);
    }
  }
}

int launch_chunkwise(const FwdArgs& a, const FwdGeo& geo,
                     cudaStream_t stream) {
  const int bh = geo.B * geo.H;
  APEX_LAUNCH(mlstm_fwd_gates, dim3(bh), dim3(32), 0, stream, a, geo);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  APEX_LAUNCH(mlstm_fwd_bounds, dim3(geo.rt, geo.ct, bh), dim3(kThreads), 0,
              stream, a, geo);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_fwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kFwdChunkSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  APEX_LAUNCH(mlstm_fwd_chunk, dim3(geo.nck, bh), dim3(kThreads),
              kFwdChunkSmem, stream, a, geo);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  APEX_LAUNCH(mlstm_fwd_out, dim3(geo.nck * bh, kL / kM, geo.ct),
              dim3(kThreads), 0, stream, a, geo);
  return 0;
}

}  // namespace mlc

}  // namespace

extern "C" int apex_mlstm_scan(const void* q, const void* k, const void* v,
                               const void* i_pre, const void* f_pre,
                               const void* cmat, const void* n,
                               const void* m, const void* lens, void* hs,
                               void* c_out, void* n_out, void* m_out, int B,
                               int T, int H, int HD, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k;
  const float *vf = (const float*)v, *ip = (const float*)i_pre;
  const float *fp = (const float*)f_pre, *cf = (const float*)cmat;
  const float *nf = (const float*)n, *mf = (const float*)m;
  const int* ln = (const int*)lens;
  float *ho = (float*)hs, *co = (float*)c_out, *no = (float*)n_out;
  float* mo = (float*)m_out;
  int rc;
  switch (HD) {
    case 32:
      rc = launch<32>(qf, kf, vf, ip, fp, cf, nf, mf, ln, ho, co, no, mo, B,
                      T, H, st);
      break;
    case 64:
      rc = launch<64>(qf, kf, vf, ip, fp, cf, nf, mf, ln, ho, co, no, mo, B,
                      T, H, st);
      break;
    case 384:
      rc = launch<384>(qf, kf, vf, ip, fp, cf, nf, mf, ln, ho, co, no, mo, B,
                      T, H, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}


// The route a call takes: 0 the walk (apex_mlstm_scan), 1 chunkwise
// (apex_mlstm_scan_chunkwise).
extern "C" int apex_mlstm_scan_route(int T, int has_lens) {
  return !has_lens && T >= APEX_MLSTM_FWD_CROSSOVER ? 1 : 0;
}

extern "C" int apex_mlstm_scan_chunk() { return mlc::kL; }

extern "C" long long apex_mlstm_scan_chunkwise_scratch_floats(int B, int T,
                                                              int H, int HD) {
  return (long long)mlc::FwdGeo(B, T, H, HD).total;
}

extern "C" int apex_mlstm_scan_chunkwise(
    const void* q, const void* k, const void* v, const void* i_pre,
    const void* f_pre, const void* cmat, const void* n, const void* m,
    void* scratch, void* hs, void* c_out, void* n_out, void* m_out, int B,
    int T, int H, int HD, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (HD != 32 && HD != 64 && HD != 384) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)cmat |
       (uintptr_t)n | (uintptr_t)scratch | (uintptr_t)hs |
       (uintptr_t)c_out | (uintptr_t)n_out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const mlc::FwdArgs a{(const float*)q,     (const float*)k,
                       (const float*)v,     (const float*)i_pre,
                       (const float*)f_pre, (const float*)cmat,
                       (const float*)n,     (const float*)m,
                       (float*)scratch,     (float*)hs,
                       (float*)c_out,       (float*)n_out,
                       (float*)m_out};
  const int rc = mlc::launch_chunkwise(a, mlc::FwdGeo(B, T, H, HD),
                                       (cudaStream_t)stream);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
