// mLSTM recurrence for Hopper (sm_90a): the backward, chunkwise-parallel.
//
// Replaces no Pallas kernel: the reference differentiates its `lax.scan`
// (src/repro/models/ssm.py:369, the cell at :285) with autodiff; the
// port's plain versions are kernels/ref.py `mlstm_recurrence_bwd_ref` (the
// reverse walk, one step at a time) and `mlstm_chunkwise_bwd_ref` (this
// file's algebra in PyTorch, which the tests hold to the first).
//
// The forward, per (row, head) and step t, with the stabiliser m:
//   m_t = max(f_t + m_{t-1}, i_t);  i_g = exp(li_t), li_t = i_t - m_t;
//   f_g = exp(lf_t), lf_t = f_t + m_{t-1} - m_t  (both exponents <= 0)
//   C_t = f_g C + i_g v k^T;  n_t = f_g n + i_g k;  s_t = n_t . q_t
//   h_t = C_t q_t / max(|s_t|, 1)
// Within a chunk of L steps every product of forget gates is exp of a sum
// of lf over its own span, so the chunk's work is matrix products (Beck et
// al., "Tiled Flash Linear Attention", arXiv:2503.14376).  With, in a
// chunk, alpha_j = exp(lf summed from the chunk's start to j), w_j =
// exp(lf summed after j to the chunk's end + li_j) and W_jr = exp(lf
// summed over (r, j] + li_r) for r <= j, and the memory and normaliser as
// one (hd + 1) x hd matrix B = [C; n] (v extended by a 1), their
// gradients as E = [dC; dn] (dnum = dh / den extended by ds):
//   1. gates_fwd: m's max-plus scan (each lane composes its segment of
//      steps, a warp scan joins them in a fixed order, each lane then
//      walks its segment with the forward's arithmetic), lf, li, and per
//      chunk alpha and w;
//   2. pass 1, one CTA per 64 x 64 tile of B, walking the chunks:
//      B_{c+1} = alpha_last B_c + [V; 1]^T diag(w) K;
//   3. chunk: per chunk in parallel, S = Q K^T, s_j = alpha_j q_j . n_c +
//      sum_r W_jr S_jr, den, ds, e_j = dh_j . h_j + ds_j s_j, and the
//      masked L x L matrices WP = W * (dnum V^T + ds) and WS = W * S;
//   4. pass 2, per tile walking the chunks in reverse: E_{c-1} =
//      alpha_last E_c + (alpha [dnum, ds])^T Q from E = the final state's
//      gradient (its end is dC0, dn0), and each tile's <E_c, B_{c+1}>;
//   5. intra: per (chunk, 64 columns) in parallel, dq = alpha [dnum, ds]
//      B_c + WP K, dk = w ([V, 1] E_c) + WP^T Q, dv = w (K dC_c^T) + WS^T
//      dnum, and X_j = dk_j . k_j (= di_g i_g) per column tile;
//   6. gates_bwd: df_g f_g = Y_j = <E_c, B_{c+1}> + sum over the chunk's
//      steps s >= j of (e_s - X_s) (0 where f_g is 0), then m's chain in
//      reverse, dm_{t-1} = Y + w_a (dm - X - Y), as an affine scan over
//      lane segments joined in a fixed order; di, df, dm0.
// So the longest chain of dependent steps runs over chunks: no kernel
// walks T one step at a time.
// Steps 1 and 2, the decay matrix W and the staged products are
// mlstm_chunk.cuh's, shared with the forward's chunkwise route
// (mlstm_scan.cu).
//
// What bounds it on an H100: the products, about 6 (hd + 1) hd L fp32
// multiply-adds a chunk (passes 1 and 2 and the intra gradients' state
// terms) and 5 hd L^2 (the masked products), on tensor cores in 3xTF32
// (each fp32 operand split into a TF32 high and low part, three mma.sync
// m16n8k8 products summed in fp32: about fp32's accuracy) or on FMAs
// (APEX_MLSTM_BWD_TF32X3 0).  Every sum has one fixed order and there are
// no atomics, so a repeat gives the same bits.  Scratch: the boundary
// memories and their gradients, (T / L + 1) and T / L tiles of (hd + 1)
// hd floats a (row, head), the chunks' L x L matrices and a few floats a
// step, and dnum = dh / den (`apex_mlstm_scan_bwd_scratch_floats`).
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
#ifndef APEX_MLSTM_BWD_CHUNK
#define APEX_MLSTM_BWD_CHUNK 64
#endif
#ifndef APEX_MLSTM_BWD_TF32X3
#define APEX_MLSTM_BWD_TF32X3 0
#endif
#define APEX_MLSTM_CHUNK APEX_MLSTM_BWD_CHUNK
#define APEX_MLSTM_TF32X3 APEX_MLSTM_BWD_TF32X3
#include "mlstm_chunk.cuh"

namespace {

using namespace mlc;
constexpr int kSlots = 8;                    // per-step scalars
// slots after the gates' (m, lf, li, alpha, w): den, ds, e
enum { kSden = kGateSlots, kSds, kSe };
static_assert(kSe < kSlots, "eight slots a step");

__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// ---------------------------------------------------------------------------
// Geometry of one call and its scratch
// ---------------------------------------------------------------------------

struct Geo {
  int B, T, H, HD, nck, rt, ct;
  size_t sc, bnd, ebnd, wps, pp, px, dnum, total;   // offsets in floats
  __host__ __device__ Geo(int b, int t, int h, int hd)
      : B(b), T(t), H(h), HD(hd), nck(cdiv(t, kL)), rt(cdiv(hd + 1, 64)),
        ct(cdiv(hd, 64)) {
    const size_t bh = (size_t)b * h, st = (size_t)(hd + 1) * hd;
    sc = 0;
    bnd = sc + up4(bh * kSlots * t);
    ebnd = bnd + up4(bh * (nck + 1) * st);
    wps = ebnd + up4(bh * nck * st);
    pp = wps + up4(bh * nck * 2 * kL * kL);
    px = pp + up4(bh * nck * rt * ct);
    dnum = px + up4(bh * ct * t);
    total = dnum + up4(bh * t * hd);
  }
  // element (b, t, head, x) of a (B, T, H, hd) tensor
  __device__ size_t seq(int b, int t, int head) const {
    return (((size_t)b * T + t) * H + head) * HD;
  }
  __device__ size_t gate(int b, int t, int head) const {
    return ((size_t)b * T + t) * H + head;
  }
};

struct Args {
  const float *q, *k, *v, *ig, *fg, *c0, *n0, *m0, *hs, *dhs, *dc_t, *dn_t,
      *dm_t;
  float *scratch, *dq, *dk, *dv, *di, *df, *dc0, *dn0, *dm0;
};

// ---------------------------------------------------------------------------
// 1. gates_fwd: m, lf, li a step, alpha and w a chunk; one warp a (row, head)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
    mlstm_bwd_gates_fwd(Args a, Geo geo) {
  const int bh = blockIdx.x, b = bh / geo.H, head = bh % geo.H;
  gates_scan(a.ig + geo.gate(b, 0, head), a.fg + geo.gate(b, 0, head),
             geo.H, a.m0[bh],
             a.scratch + geo.sc + (size_t)bh * kSlots * geo.T, geo.T);
}

// ---------------------------------------------------------------------------
// 2. pass 1: the boundary memories [C; n], one 64 x 64 tile a CTA
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_bounds(Args a, Geo geo) {
  __shared__ __align__(16) float As[2 * kBuf], Bs[2 * kBuf];
  const int bh = blockIdx.z, b = bh / geo.H, head = bh % geo.H;
  const int HD = geo.HD, T = geo.T;
  const size_t st = (size_t)(HD + 1) * HD;
  Tile<64> acc;
  bounds_walk(acc, As, Bs, a.scratch + geo.sc + (size_t)bh * kSlots * T,
              a.scratch + geo.bnd + (size_t)bh * (geo.nck + 1) * st,
              a.c0 + (size_t)bh * HD * HD, a.n0 + (size_t)bh * HD,
              a.v + geo.seq(b, 0, head), a.k + geo.seq(b, 0, head),
              (size_t)geo.H * HD, HD, T, blockIdx.x * 64, blockIdx.y * 64);
}

// ---------------------------------------------------------------------------
// 3. chunk: den, ds, e per step and the masked L x L products per chunk
// ---------------------------------------------------------------------------

constexpr size_t kChunkSmem =
    (size_t)(4 * kBuf + 2 * kL * kLp + 8 * kL) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_chunk(Args a, Geo geo) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + 2 * kBuf;
  float* Wm = Bs + 2 * kBuf;           // W, then W * S
  float* Xm = Wm + kL * kLp;           // W * S (row sums)
  float* lf = Xm + kL * kLp;
  float* li = lf + kL;
  float* al = li + kL;
  float* den = al + kL;
  float* ds = den + kL;
  float* sq = ds + kL;
  float* hd_ = sq + kL;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / geo.H,
            head = bh % geo.H;
  const int HD = geo.HD, T = geo.T, tid = threadIdx.x;
  const int c0 = c * kL, len = min(kL, T - c0);
  float* sc = a.scratch + geo.sc + (size_t)bh * kSlots * T;
  const size_t st = (size_t)(HD + 1) * HD;
  const float* nb = a.scratch + geo.bnd +
                    ((size_t)bh * (geo.nck + 1) + c) * st + (size_t)HD * HD;
  float* wp = a.scratch + geo.wps + ((size_t)bh * geo.nck + c) * 2 * kL * kL;
  float* ws = wp + kL * kL;
  for (int j = tid; j < kL; j += kThreads) {
    lf[j] = j < len ? sc[kSlf * T + c0 + j] : 0.f;
    li[j] = j < len ? sc[kSli * T + c0 + j] : 0.f;
    al[j] = j < len ? sc[kSal * T + c0 + j] : 0.f;
  }
  __syncthreads();
  decay_matrix(Wm, lf, li, len);
  // q_j . n_c and dh_j . h_j, a warp a step
  const int warp = tid >> 5, lane = tid & 31;
  for (int j = warp; j < len; j += kThreads / 32) {
    const size_t o = geo.seq(b, c0 + j, head);
    float x = 0.f, y = 0.f;
    for (int i = lane; i < HD; i += 32) {
      x = __fmaf_rn(a.q[o + i], nb[i], x);
      y = __fmaf_rn(a.dhs[o + i], a.hs[o + i], y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
      y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, off));
    }
    if (lane == 0) {
      sq[j] = x;
      hd_[j] = y;
    }
  }
  __syncthreads();
  // S = Q K^T, then W * S
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
        if (r < kL) {
          const float x = __fmul_rn(Wm[j * kLp + r], acc.v[e]);
          Xm[j * kLp + r] = x;
          ws[j * kL + r] = x;
        }
      }
    }
  }
  __syncthreads();
  // s, den, ds, e: row sums in column order
  for (int j = tid; j < kL; j += kThreads) {
    if (j >= len) {
      den[j] = 1.f;
      ds[j] = 0.f;
      continue;
    }
    float s = 0.f;
    for (int r = 0; r <= j; ++r) s = __fadd_rn(s, Xm[j * kLp + r]);
    s = __fadd_rn(__fmul_rn(al[j], sq[j]), s);
    const float dn = fmaxf(fabsf(s), 1.f);
    const float dsv = __fmul_rn(__fmul_rn(__fdiv_rn(-hd_[j], dn), sign_of(s)),
                                max_share(fabsf(s), 1.f));
    den[j] = dn;
    ds[j] = dsv;
    sc[kSden * T + c0 + j] = dn;
    sc[kSds * T + c0 + j] = dsv;
    sc[kSe * T + c0 + j] = __fadd_rn(hd_[j], __fmul_rn(dsv, s));
  }
  __syncthreads();
  // dnum = dh / den for the passes after this one, laid out as dh
  float* dnum = a.scratch + geo.dnum;
  for (int e = tid; e < len * HD; e += kThreads) {
    const size_t o = geo.seq(b, c0 + e / HD, head) + e % HD;
    dnum[o] = __fdiv_rn(a.dhs[o], den[e / HD]);
  }
  __syncthreads();
  // D = dnum V^T, then W * (D + ds)
  for (int rb = 0; rb < kL; rb += kM) {
    for (int cb = 0; cb < kL; cb += kN) {
      Tile<kM> acc;
      acc.zero();
      gemm<kM, true, true>(
          acc, As, Bs, HD,
          [&](int p, int i) {
            return rb + i < len && p < HD
                       ? ld4(dnum + geo.seq(b, c0 + rb + i, head) + p)
                       : zero4();
          },
          [&](int p, int jj) {
            return cb + jj < len && p < HD
                       ? ld4(a.v + geo.seq(b, c0 + cb + jj, head) + p)
                       : zero4();
          });
#pragma unroll
      for (int e = 0; e < Tile<kM>::kE; ++e) {
        const int j = rb + acc.row(e), r = cb + acc.col(e);
        if (r < kL)
          wp[j * kL + r] =
              __fmul_rn(Wm[j * kLp + r], __fadd_rn(acc.v[e], ds[j]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4. pass 2: the carried gradients [dC; dn] at each chunk's end, in reverse
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_carry(Args a, Geo geo) {
  __shared__ __align__(16) float As[2 * kBuf], Bs[2 * kBuf];
  __shared__ float red[kThreads / 32];
  const int bh = blockIdx.z, b = bh / geo.H, head = bh % geo.H;
  const int HD = geo.HD, T = geo.T, tid = threadIdx.x;
  const int r0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int tile = blockIdx.x * geo.ct + blockIdx.y;
  const float* sc = a.scratch + geo.sc + (size_t)bh * kSlots * T;
  const size_t st = (size_t)(HD + 1) * HD;
  const float* bnd = a.scratch + geo.bnd + (size_t)bh * (geo.nck + 1) * st;
  float* ebnd = a.scratch + geo.ebnd + (size_t)bh * geo.nck * st;
  float* pp = a.scratch + geo.pp + (size_t)bh * geo.nck * geo.rt * geo.ct;
  const float* dnum = a.scratch + geo.dnum;
  using TL = Tile<64>;
  constexpr int N = TL::kRun;
  TL acc;
  acc.zero();
#pragma unroll
  for (int e = 0; e < TL::kE; e += N) {
    const int r = r0 + acc.row(e), c = k0 + acc.col(e);
    if (r < HD && c < HD && a.dc_t != nullptr)
      get_run<N>(a.dc_t + ((size_t)bh * HD + r) * HD + c, acc.v + e);
    else if (r == HD && c < HD && a.dn_t != nullptr)
      get_run<N>(a.dn_t + (size_t)bh * HD + c, acc.v + e);
  }
  for (int c = geo.nck - 1; c >= 0; --c) {
    const int c0 = c * kL, len = min(kL, T - c0);
    float part = 0.f;
    const float* nxt = bnd + (size_t)(c + 1) * st;
    float* dst = ebnd + (size_t)c * st;
#pragma unroll
    for (int e = 0; e < TL::kE; e += N) {
      const int r = r0 + acc.row(e), col = k0 + acc.col(e);
      if (r <= HD && col < HD) {
        float w[N];
        put_run<N>(dst + (size_t)r * HD + col, acc.v + e);
        get_run<N>(nxt + (size_t)r * HD + col, w);
#pragma unroll
        for (int q = 0; q < N; ++q) part = __fmaf_rn(acc.v[e + q], w[q], part);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float s = red[0];
      for (int w = 1; w < kThreads / 32; ++w) s = __fadd_rn(s, red[w]);
      pp[(size_t)c * geo.rt * geo.ct + tile] = s;
    }
    const float alast = sc[kSal * T + c0 + len - 1];
#pragma unroll
    for (int e = 0; e < TL::kE; ++e) acc.v[e] = __fmul_rn(alast, acc.v[e]);
    gemm<64, false, false>(
        acc, As, Bs, len,
        [&](int p, int i) {
          const int r = r0 + i, t = c0 + p;
          if (p >= len || r > HD) return zero4();
          const float al = sc[kSal * T + t];
          return r < HD ? scale4(al, ld4(dnum + geo.seq(b, t, head) + r))
                        : first4(__fmul_rn(al, sc[kSds * T + t]));
        },
        [&](int p, int j) {
          const int col = k0 + j;
          return p < len && col < HD
                     ? ld4(a.q + geo.seq(b, c0 + p, head) + col) : zero4();
        });
  }
#pragma unroll
  for (int e = 0; e < TL::kE; e += N) {
    const int r = r0 + acc.row(e), c = k0 + acc.col(e);
    if (r < HD && c < HD)
      put_run<N>(a.dc0 + ((size_t)bh * HD + r) * HD + c, acc.v + e);
    else if (r == HD && c < HD)
      put_run<N>(a.dn0 + (size_t)bh * HD + c, acc.v + e);
  }
}

// ---------------------------------------------------------------------------
// 5. intra: dq, dk, dv of M steps x 64 columns of one chunk, and X's part
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_intra(Args a, Geo geo) {
  // the staged slices; after the dk products, dk's tile (kM x (kN + 1))
  __shared__ __align__(16) float stage_s[4 * kBuf];
  __shared__ float rowf[kM];
  float* As = stage_s;
  float* Bs = stage_s + 2 * kBuf;
  float* dkt = stage_s;
  static_assert(kM * (kN + 1) <= 4 * kBuf, "dk's tile fits the slices");
  // (chunk, row, head) on x: T / L x B x H may pass 65535
  const int c = blockIdx.x % geo.nck, bh = blockIdx.x / geo.nck;
  const int rb = blockIdx.y * kM, ctile = blockIdx.z;
  const int b = bh / geo.H, head = bh % geo.H;
  const int HD = geo.HD, T = geo.T, tid = threadIdx.x;
  const int c0 = c * kL, len = min(kL, T - c0), k0 = ctile * 64;
  if (rb >= len) return;
  const float* sc = a.scratch + geo.sc + (size_t)bh * kSlots * T;
  const size_t st = (size_t)(HD + 1) * HD;
  const float* bc =
      a.scratch + geo.bnd + ((size_t)bh * (geo.nck + 1) + c) * st;
  const float* ec = a.scratch + geo.ebnd + ((size_t)bh * geo.nck + c) * st;
  const float* wp =
      a.scratch + geo.wps + ((size_t)bh * geo.nck + c) * 2 * kL * kL;
  const float* ws = wp + kL * kL;
  float* px = a.scratch + geo.px + ((size_t)bh * geo.ct + ctile) * T;
  const float* dnum = a.scratch + geo.dnum;
  auto dnum1 = [&](int t, int x) {      // [dh / den, ds], x..x+3
    return x < HD ? ld4(dnum + geo.seq(b, t, head) + x)
                  : first4(sc[kSds * T + t]);
  };
  auto store = [&](Tile<kM>& acc, float* out) {
    constexpr int N = Tile<kM>::kRun;
#pragma unroll
    for (int e = 0; e < Tile<kM>::kE; e += N) {
      const int j = rb + acc.row(e), col = k0 + acc.col(e);
      if (j < len && col < HD)
        put_run<N>(out + geo.seq(b, c0 + j, head) + col, acc.v + e);
    }
  };
  auto load_rows = [&](int slot) {
    __syncthreads();
    for (int j = tid; j < kM; j += kThreads)
      rowf[j] = rb + j < len ? sc[slot * T + c0 + rb + j] : 0.f;
    __syncthreads();
  };
  Tile<kM> acc;
  // dq = alpha [dnum, ds] B_c + WP K
  acc.zero();
  gemm<kM, true, false>(
      acc, As, Bs, HD + 1,
      [&](int p, int i) {
        return rb + i < len && p <= HD ? dnum1(c0 + rb + i, p) : zero4();
      },
      [&](int p, int j) {
        return p <= HD && k0 + j < HD ? ld4(bc + (size_t)p * HD + k0 + j)
                                      : zero4();
      });
  load_rows(kSal);
  acc.scale_rows(rowf);
  gemm<kM, true, false>(
      acc, As, Bs, len,
      [&](int p, int i) {   // WP is 0 past the chunk's length
        return rb + i < len ? ld4(wp + (rb + i) * kL + p) : zero4();
      },
      [&](int p, int j) {
        return p < len && k0 + j < HD
                   ? ld4(a.k + geo.seq(b, c0 + p, head) + k0 + j) : zero4();
      });
  store(acc, a.dq);
  // dk = w ([V, 1] E_c) + WP^T Q
  acc.zero();
  gemm<kM, true, false>(
      acc, As, Bs, HD + 1,
      [&](int p, int i) {
        if (rb + i >= len || p > HD) return zero4();
        return p < HD ? ld4(a.v + geo.seq(b, c0 + rb + i, head) + p)
                      : first4(1.f);
      },
      [&](int p, int j) {
        return p <= HD && k0 + j < HD ? ld4(ec + (size_t)p * HD + k0 + j)
                                      : zero4();
      });
  load_rows(kSw);
  acc.scale_rows(rowf);
  gemm<kM, false, false>(
      acc, As, Bs, len,
      [&](int p, int i) { return ld4(wp + p * kL + rb + i); },
      [&](int p, int j) {
        return p < len && k0 + j < HD
                   ? ld4(a.q + geo.seq(b, c0 + p, head) + k0 + j) : zero4();
      });
  store(acc, a.dk);
  // X_j's part over these columns: dk_j . k_j in column order
#pragma unroll
  for (int e = 0; e < Tile<kM>::kE; ++e)
    dkt[acc.row(e) * (kN + 1) + acc.col(e)] = acc.v[e];
  __syncthreads();
  for (int j = tid; j < kM; j += kThreads) {
    if (rb + j >= len) continue;
    const size_t o = geo.seq(b, c0 + rb + j, head);
    float x = 0.f;
    for (int i = 0; i < kN && k0 + i < HD; ++i)
      x = __fmaf_rn(dkt[j * (kN + 1) + i], a.k[o + k0 + i], x);
    px[c0 + rb + j] = x;
  }
  __syncthreads();   // dk's tile is read: the slices may be refilled
  // dv = w (K dC_c^T) + WS^T dnum
  acc.zero();
  gemm<kM, true, true>(
      acc, As, Bs, HD,
      [&](int p, int i) {
        return rb + i < len && p < HD
                   ? ld4(a.k + geo.seq(b, c0 + rb + i, head) + p) : zero4();
      },
      [&](int p, int j) {
        return p < HD && k0 + j < HD ? ld4(ec + (size_t)(k0 + j) * HD + p)
                                     : zero4();
      });
  acc.scale_rows(rowf);   // still w
  gemm<kM, false, false>(
      acc, As, Bs, len,
      [&](int p, int i) { return ld4(ws + p * kL + rb + i); },
      [&](int p, int j) {
        return p < len && k0 + j < HD ? dnum1(c0 + p, k0 + j) : zero4();
      });
  store(acc, a.dv);
}

// ---------------------------------------------------------------------------
// 6. gates_bwd: Y per chunk, then m's chain in reverse; one warp a (row, head)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
    mlstm_bwd_gates(Args a, Geo geo) {
  const int bh = blockIdx.x, b = bh / geo.H, head = bh % geo.H;
  const int lane = threadIdx.x, T = geo.T;
  float* sc = a.scratch + geo.sc + (size_t)bh * kSlots * T;
  const float* pp =
      a.scratch + geo.pp + (size_t)bh * geo.nck * geo.rt * geo.ct;
  const float* px = a.scratch + geo.px + (size_t)bh * geo.ct * T;
  float* xs = sc + kSal * T;    // alpha and w are spent: X and Y go there
  float* ys = sc + kSw * T;
  const int tiles = geo.rt * geo.ct;
  for (int c = lane; c < geo.nck; c += 32) {
    const int c0 = c * kL, c1 = min(T, c0 + kL);
    float p = pp[(size_t)c * tiles];
    for (int i = 1; i < tiles; ++i) p = __fadd_rn(p, pp[(size_t)c * tiles + i]);
    float suf = 0.f;
    for (int t = c1 - 1; t >= c0; --t) {
      float x = px[t];
      for (int i = 1; i < geo.ct; ++i) x = __fadd_rn(x, px[(size_t)i * T + t]);
      suf = __fadd_rn(suf, __fsub_rn(sc[kSe * T + t], x));
      xs[t] = x;
      ys[t] = expf(sc[kSlf * T + t]) == 0.f ? 0.f : __fadd_rn(p, suf);
    }
  }
  __syncwarp();
  const float m_first = a.m0[bh];
  auto wa_at = [&](int t) {
    const size_t gi = geo.gate(b, t, head);
    const float mp = t == 0 ? m_first : sc[kSm * T + t - 1];
    return max_share(__fadd_rn(a.fg[gi], mp), a.ig[gi]);
  };
  const int seg = cdiv(T, 32), t0 = min(T, lane * seg),
            t1 = min(T, t0 + seg);
  // the segment's map dm -> A dm + Bc over its steps in reverse
  float A = 1.f, Bc = 0.f;
  for (int t = t1 - 1; t >= t0; --t) {
    const float wa = wa_at(t);
    const float cst = __fsub_rn(ys[t], __fmul_rn(wa, __fadd_rn(xs[t], ys[t])));
    Bc = __fadd_rn(__fmul_rn(wa, Bc), cst);
    A = __fmul_rn(wa, A);
  }
  // inclusive scan from the last lane down: the later map first
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float ao = __shfl_down_sync(0xffffffffu, A, off);
    const float bo = __shfl_down_sync(0xffffffffu, Bc, off);
    if (lane + off < 32) {
      Bc = __fadd_rn(__fmul_rn(A, bo), Bc);
      A = __fmul_rn(A, ao);
    }
  }
  const float ae = __shfl_down_sync(0xffffffffu, A, 1);
  const float be = __shfl_down_sync(0xffffffffu, Bc, 1);
  const float dm_last = a.dm_t != nullptr ? a.dm_t[bh] : 0.f;
  float dm = lane == 31 ? dm_last : __fadd_rn(__fmul_rn(ae, dm_last), be);
  for (int t = t1 - 1; t >= t0; --t) {
    const size_t gi = geo.gate(b, t, head);
    const float wa = wa_at(t);
    const float dm_tot = __fsub_rn(__fsub_rn(dm, xs[t]), ys[t]);
    a.di[gi] = __fadd_rn(xs[t], __fmul_rn(dm_tot, __fsub_rn(1.f, wa)));
    dm = __fadd_rn(ys[t], __fmul_rn(dm_tot, wa));
    a.df[gi] = dm;
  }
  if (lane == 0) a.dm0[bh] = dm;
}

int launch(const Args& a, const Geo& geo, cudaStream_t stream) {
  const int bh = geo.B * geo.H;
  APEX_LAUNCH(mlstm_bwd_gates_fwd, dim3(bh), dim3(32), 0, stream, a, geo);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  APEX_LAUNCH(mlstm_bwd_bounds, dim3(geo.rt, geo.ct, bh), dim3(kThreads), 0,
              stream, a, geo);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kChunkSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  APEX_LAUNCH(mlstm_bwd_chunk, dim3(geo.nck, bh), dim3(kThreads), kChunkSmem,
              stream, a, geo);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  APEX_LAUNCH(mlstm_bwd_carry, dim3(geo.rt, geo.ct, bh), dim3(kThreads), 0,
              stream, a, geo);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  APEX_LAUNCH(mlstm_bwd_intra, dim3(geo.nck * bh, kL / kM, geo.ct),
              dim3(kThreads), 0, stream, a, geo);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  APEX_LAUNCH(mlstm_bwd_gates, dim3(bh), dim3(32), 0, stream, a, geo);
  return 0;
}

}  // namespace

extern "C" int apex_mlstm_scan_bwd_chunk() { return kL; }

extern "C" long long apex_mlstm_scan_bwd_scratch_floats(int B, int T, int H,
                                                        int HD) {
  return (long long)Geo(B, T, H, HD).total;
}

extern "C" int apex_mlstm_scan_bwd(
    const void* q, const void* k, const void* v, const void* i_pre,
    const void* f_pre, const void* cmat0, const void* n0, const void* m0,
    const void* hs, const void* dhs, const void* dc_t, const void* dn_t,
    const void* dm_t, void* scratch, void* dq, void* dk, void* dv, void* di,
    void* df, void* dc0, void* dn0, void* dm0, int B, int T, int H, int HD,
    void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (HD != 32 && HD != 64 && HD != 384) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)scratch % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Args a{(const float*)q,    (const float*)k,    (const float*)v,
         (const float*)i_pre, (const float*)f_pre, (const float*)cmat0,
         (const float*)n0,   (const float*)m0,   (const float*)hs,
         (const float*)dhs,  (const float*)dc_t, (const float*)dn_t,
         (const float*)dm_t, (float*)scratch,    (float*)dq,
         (float*)dk,         (float*)dv,         (float*)di,
         (float*)df,         (float*)dc0,        (float*)dn0,
         (float*)dm0};
  const int rc = launch(a, Geo(B, T, H, HD), (cudaStream_t)stream);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
