// The mLSTM's chunkwise-parallel building blocks for Hopper (sm_90a),
// shared by the forward (mlstm_scan.cu, its chunkwise route) and the
// backward (mlstm_scan_bwd.cu).  The including source defines
// APEX_MLSTM_CHUNK (steps per chunk: 32, 64 or 128) and APEX_MLSTM_TF32X3
// (products on tensor cores in 3xTF32, or on fp32 FMAs) first.
//
// What is here:
//   * Tile / gemm: a 64-column tile of M rows (32 or 64) accumulated over
//     staged slices, A(i, p) and B(p, j) fetched four elements at a time by
//     the caller's functions, two slices in flight, one barrier a slice;
//   * gates_scan: the stabiliser m's max-plus chain as a scan over lane
//     segments (each lane composes its segment's maps x -> max(x + P, Q),
//     a warp scan joins them in a fixed order, each lane then walks its
//     segment with the forward's arithmetic), each step's lf and li, and
//     per chunk alpha_j = exp(lf summed from the chunk's start to j) and
//     w_j = exp(lf summed after j to the chunk's end + li_j);
//   * bounds_walk: one 64 x 64 tile of the boundary memories [C; n]
//     ((hd + 1) x hd, v extended by a 1), walking the chunks:
//     B_{c+1} = alpha_last B_c + [V; 1]^T diag(w) K;
//   * decay_matrix: a chunk's W_jr = exp(lf summed over (r, j] + li_r) for
//     r <= j < len, 0 elsewhere.
// Every exponent is a sum of lf over its own span, never a difference of
// prefix sums (a first step from m0 = -1e30 has lf ~ -1e30, which would
// swallow every later term of a prefix sum), and every sum has one fixed
// order, so a repeat gives the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {
namespace mlc {

constexpr int kL = APEX_MLSTM_CHUNK;         // steps per chunk
constexpr bool kTf32x3 = APEX_MLSTM_TF32X3 != 0;
constexpr int kM = kL < 64 ? kL : 64;        // rows of an output tile
constexpr int kThreads = 256;
constexpr int kN = 64;                       // columns of a tile
constexpr int kKS = 32;                      // depth of a staged slice
constexpr int kLd = 72;                      // smem row stride (floats)
constexpr int kLp = kL + 1;                  // row stride of L x L smem
// the first per-step scalars of the scratch: m, lf, li, alpha, w (a
// source may add its own slots after these)
enum { kSm = 0, kSlf, kSli, kSal, kSw, kGateSlots };
static_assert(kL == 32 || kL == 64 || kL == 128, "chunk of 32/64/128");

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr size_t up4(size_t x) {
  return (x + 3) & ~(size_t)3;
}

// ---------------------------------------------------------------------------
// A 64-column tile of M rows (32 or 64) accumulated over staged slices:
// As[p][i] = A(i, p) and Bs[p][j] = B(p, j), kKS deep, rows kLd floats.
// 3xTF32 on mma.sync m16n8k8 (warp (wm, wn): rows 16 wm, NT n-tiles of 8)
// or fp32 FMAs (thread (ty, tx): rows M/16 ty.., columns 4 tx..).
// ---------------------------------------------------------------------------

template <int M>
struct Tile {
  static constexpr int kE = M / 4;           // accumulators a thread
  static constexpr int WM = M / 16, WN = 8 / WM, NW = kN / WN, NT = NW / 8;
  static constexpr int RPT = M / 16;         // FMA rows a thread
  // a thread's accumulators come in runs of kRun adjacent columns
  static constexpr int kRun = kTf32x3 ? 2 : 4;
  float v[kE];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = 0.f;
  }
  __device__ __forceinline__ static int row(int e) {
    const int tid = threadIdx.x;
    if (kTf32x3) {
      const int w = tid >> 5, g = (tid & 31) >> 2;
      return (w % WM) * 16 + g + ((e & 3) >= 2 ? 8 : 0);
    }
    return (tid >> 4) * RPT + (e >> 2);
  }
  __device__ __forceinline__ static int col(int e) {
    const int tid = threadIdx.x;
    if (kTf32x3) {
      const int w = tid >> 5, t = tid & 3;
      return (w / WM) * NW + (e >> 2) * 8 + 2 * t + (e & 1);
    }
    return (tid & 15) * 4 + (e & 3);
  }
  __device__ __forceinline__ void scale_rows(const float* f) {
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = __fmul_rn(f[row(e)], v[e]);
  }
};

// a run of N (4 or 2) adjacent floats at a 4N-byte aligned address
template <int N>
__device__ __forceinline__ void put_run(float* p, const float* v) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <int N>
__device__ __forceinline__ void get_run(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B over one staged slice
template <int M>
__device__ __forceinline__ void mma_slice(Tile<M>& acc, const float* As,
                                          const float* Bs) {
  using T = Tile<M>;
  const int tid = threadIdx.x;
  if constexpr (kTf32x3) {
    const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int m0 = (w % T::WM) * 16, n0 = (w / T::WM) * T::NW;
#pragma unroll
    for (int k0 = 0; k0 < kKS; k0 += 8) {
      unsigned ah[4], al[4];
      split_tf32(As[(k0 + t) * kLd + m0 + g], ah[0], al[0]);
      split_tf32(As[(k0 + t) * kLd + m0 + g + 8], ah[1], al[1]);
      split_tf32(As[(k0 + t + 4) * kLd + m0 + g], ah[2], al[2]);
      split_tf32(As[(k0 + t + 4) * kLd + m0 + g + 8], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        unsigned bh[2], bl[2];
        split_tf32(Bs[(k0 + t) * kLd + n0 + nt * 8 + g], bh[0], bl[0]);
        split_tf32(Bs[(k0 + t + 4) * kLd + n0 + nt * 8 + g], bh[1], bl[1]);
        mma_tf32(acc.v + 4 * nt, al, bh);   // the small terms first
        mma_tf32(acc.v + 4 * nt, ah, bl);
        mma_tf32(acc.v + 4 * nt, ah, bh);
      }
    }
  } else {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll 4
    for (int p = 0; p < kKS; ++p) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + p * kLd + 4 * tx);
#pragma unroll
      for (int r = 0; r < T::RPT; ++r) {
        const float a = As[p * kLd + ty * T::RPT + r];
        acc.v[4 * r + 0] = __fmaf_rn(a, b.x, acc.v[4 * r + 0]);
        acc.v[4 * r + 1] = __fmaf_rn(a, b.y, acc.v[4 * r + 1]);
        acc.v[4 * r + 2] = __fmaf_rn(a, b.z, acc.v[4 * r + 2]);
        acc.v[4 * r + 3] = __fmaf_rn(a, b.w, acc.v[4 * r + 3]);
      }
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 scale4(float s, float4 v) {
  return make_float4(__fmul_rn(s, v.x), __fmul_rn(s, v.y), __fmul_rn(s, v.z),
                     __fmul_rn(s, v.w));
}
__device__ __forceinline__ float4 zero4() { return make_float4(0, 0, 0, 0); }
__device__ __forceinline__ float4 first4(float x) {
  return make_float4(x, 0, 0, 0);
}

// A slice S[p][i], p < kKS, i < W, moves four elements at a time: with
// PFAST f(p, i) gives (p..p+3, i) (sources contiguous in p: eight threads
// read 128 bytes of one row), else (p, i..i+3), stored as one 16-byte
// word.  fetch loads a thread's pieces into registers, put stores them.
template <int W>
constexpr int kPieces = kKS * W / 4 / kThreads;

template <int W, bool PFAST>
__device__ __forceinline__ void piece(int n, int& p, int& i) {
  const int e = threadIdx.x + n * kThreads;
  p = PFAST ? 4 * (e % (kKS / 4)) : e / (W / 4);
  i = PFAST ? e / (kKS / 4) : 4 * (e % (W / 4));
}

template <int W, bool PFAST, class F>
__device__ __forceinline__ void fetch(float4* r, int k0, F f) {
#pragma unroll
  for (int n = 0; n < kPieces<W>; ++n) {
    int p, i;
    piece<W, PFAST>(n, p, i);
    r[n] = f(k0 + p, i);
  }
}

template <int W, bool PFAST>
__device__ __forceinline__ void put(float* S, const float4* r) {
#pragma unroll
  for (int n = 0; n < kPieces<W>; ++n) {
    int p, i;
    piece<W, PFAST>(n, p, i);
    if (PFAST) {
      S[p * kLd + i] = r[n].x;
      S[(p + 1) * kLd + i] = r[n].y;
      S[(p + 2) * kLd + i] = r[n].z;
      S[(p + 3) * kLd + i] = r[n].w;
    } else {
      *reinterpret_cast<float4*>(S + p * kLd + i) = r[n];
    }
  }
}

// acc += A B, A(i, p) and B(p, j) from fa(p, i) and fb(p, j), four
// elements each (see fetch), p < depth (the functions give 0 past every
// edge; hd is a multiple of 4, so no group of four straddles it).  As and
// Bs hold two slices each: the next slice's loads are in flight while the
// current one is multiplied, one barrier a slice.
constexpr int kBuf = kKS * kLd;              // floats of one staged slice

template <int M, bool AP, bool BP, class FA, class FB>
__device__ __forceinline__ void gemm(Tile<M>& acc, float* As, float* Bs,
                                     int depth, FA fa, FB fb) {
  float4 ra[kPieces<M>], rb[kPieces<kN>];
  fetch<M, AP>(ra, 0, fa);
  fetch<kN, BP>(rb, 0, fb);
  put<M, AP>(As, ra);
  put<kN, BP>(Bs, rb);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < depth; k0 += kKS) {
    const bool more = k0 + kKS < depth;
    if (more) {
      fetch<M, AP>(ra, k0 + kKS, fa);
      fetch<kN, BP>(rb, k0 + kKS, fb);
    }
    mma_slice<M>(acc, As + cur * kBuf, Bs + cur * kBuf);
    if (more) {
      put<M, AP>(As + (cur ^ 1) * kBuf, ra);
      put<kN, BP>(Bs + (cur ^ 1) * kBuf, rb);
    }
    __syncthreads();
    cur ^= 1;
  }
}

// ---------------------------------------------------------------------------
// The stabiliser's scan: one warp a (row, head).  ig / fg point at the
// (row, step 0, head) gate and step t lies t * gs floats further; sc holds
// the (row, head)'s per-step slots, T floats each.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void gates_scan(const float* ig, const float* fg,
                                           int gs, float m_first, float* sc,
                                           int T) {
  const int lane = threadIdx.x;
  const int seg = cdiv(T, 32), t0 = min(T, lane * seg),
            t1 = min(T, t0 + seg);
  // the segment's map x -> max(x + P, Q)
  float P = 0.f, Q = -INFINITY;
  for (int t = t0; t < t1; ++t) {
    const size_t gi = (size_t)t * gs;
    P = __fadd_rn(P, fg[gi]);
    Q = fmaxf(__fadd_rn(Q, fg[gi]), ig[gi]);
  }
  // inclusive scan over lanes: the earlier map first
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float p = __shfl_up_sync(0xffffffffu, P, off);
    const float q = __shfl_up_sync(0xffffffffu, Q, off);
    if (lane >= off) {
      Q = fmaxf(__fadd_rn(q, P), Q);
      P = __fadd_rn(p, P);
    }
  }
  float pe = __shfl_up_sync(0xffffffffu, P, 1);
  float qe = __shfl_up_sync(0xffffffffu, Q, 1);
  float m = lane == 0 ? m_first : fmaxf(__fadd_rn(m_first, pe), qe);
  for (int t = t0; t < t1; ++t) {
    const size_t gi = (size_t)t * gs;
    const float am = __fadd_rn(fg[gi], m);
    const float m_new = fmaxf(am, ig[gi]);
    sc[kSm * T + t] = m_new;
    sc[kSlf * T + t] = __fsub_rn(am, m_new);
    sc[kSli * T + t] = __fsub_rn(ig[gi], m_new);
    m = m_new;
  }
  __syncwarp();
  const int nck = cdiv(T, kL);
  for (int c = lane; c < nck; c += 32) {
    const int c0 = c * kL, c1 = min(T, c0 + kL);
    float acc = 0.f;
    for (int t = c0; t < c1; ++t) {
      acc = __fadd_rn(acc, sc[kSlf * T + t]);
      sc[kSal * T + t] = expf(acc);
    }
    float suf = 0.f;
    for (int t = c1 - 1; t >= c0; --t) {
      sc[kSw * T + t] = expf(__fadd_rn(suf, sc[kSli * T + t]));
      suf = __fadd_rn(suf, sc[kSlf * T + t]);
    }
  }
}

// ---------------------------------------------------------------------------
// The boundary memories: the tile at rows r0.., columns k0.. of [C; n],
// from the initial state (c0 / n0 at the (row, head)'s hd x hd and hd
// floats) over every chunk, each boundary stored at bnd + c (hd + 1) hd
// (c = 0 the initial state, nck the final one), the last left in acc.
// v / k point at the (row, step 0, head) vector, step t ts floats further.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bounds_walk(Tile<64>& acc, float* As,
                                            float* Bs, const float* sc,
                                            float* bnd, const float* c0,
                                            const float* n0, const float* v,
                                            const float* k, size_t ts,
                                            int HD, int T, int r0, int k0) {
  using TL = Tile<64>;
  constexpr int N = TL::kRun;
  const size_t st = (size_t)(HD + 1) * HD;
  auto store = [&](float* dst) {
#pragma unroll
    for (int e = 0; e < TL::kE; e += N) {
      const int r = r0 + acc.row(e), c = k0 + acc.col(e);
      if (r <= HD && c < HD) put_run<N>(dst + (size_t)r * HD + c, acc.v + e);
    }
  };
  acc.zero();
#pragma unroll
  for (int e = 0; e < TL::kE; e += N) {
    const int r = r0 + acc.row(e), c = k0 + acc.col(e);
    if (r < HD && c < HD)
      get_run<N>(c0 + (size_t)r * HD + c, acc.v + e);
    else if (r == HD && c < HD)
      get_run<N>(n0 + c, acc.v + e);
  }
  store(bnd);
  const int nck = cdiv(T, kL);
  for (int c = 0; c < nck; ++c) {
    const int c0 = c * kL, len = min(kL, T - c0);
    const float al = sc[kSal * T + c0 + len - 1];
#pragma unroll
    for (int e = 0; e < TL::kE; ++e) acc.v[e] = __fmul_rn(al, acc.v[e]);
    gemm<64, false, false>(
        acc, As, Bs, len,
        [&](int p, int i) {
          const int r = r0 + i;
          if (p >= len || r > HD) return zero4();
          const float w = sc[kSw * T + c0 + p];
          return r < HD ? scale4(w, ld4(v + (size_t)(c0 + p) * ts + r))
                        : first4(w);
        },
        [&](int p, int j) {
          const int col = k0 + j;
          return p < len && col < HD
                     ? ld4(k + (size_t)(c0 + p) * ts + col) : zero4();
        });
    store(bnd + (size_t)(c + 1) * st);
  }
}

// W_jr = exp(lf summed over (r, j] + li_r) for r <= j < len, else 0, into
// Wm (kL x kLp); lf and li hold the chunk's first len steps.  One column a
// thread.
__device__ __forceinline__ void decay_matrix(float* Wm, const float* lf,
                                             const float* li, int len) {
  for (int r = threadIdx.x; r < kL; r += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < kL; ++j) {
      if (j > r) acc = __fadd_rn(acc, lf[j]);
      Wm[j * kLp + r] = (j >= r && j < len && r < len)
                            ? expf(__fadd_rn(acc, li[r])) : 0.f;
    }
  }
}

}  // namespace mlc
}  // namespace
