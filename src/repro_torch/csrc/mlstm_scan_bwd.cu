// mLSTM recurrence for Hopper (sm_90a): the backward walk over T.
//
// Replaces no Pallas kernel: the reference differentiates its `lax.scan`
// (src/repro/models/ssm.py:369, the cell at :285) with autodiff; the
// port's plain version is kernels/ref.py `mlstm_recurrence_bwd_ref`.  For
// step t in reverse, with C, n, m the state before the step, C_t, n_t its
// update, s = n_t . q, den = max(|s|, 1), h = C_t q / den (the forward's
// emitted h) and the carried dC, dn, dm of the state after the step:
//   dnum = dh / den;  dden = -(dh . h) / den;  ds = dden sign(s) [|s| > 1]
//   dC_t = dC + dnum q^T;  dn_t = dn + ds q
//   dq = C_t^T dnum + ds n_t
//   df_g = <dC_t, C> + dn_t . n;  di_g = v . (dC_t k) + dn_t . k
//   dv = i_g dC_t k;  dk = i_g (dC_t^T v + dn_t)
//   dm_tot = dm - di_g i_g - df_g f_g;  di = di_g i_g + dm_tot w_i
//   df = dm_{t-1} = df_g f_g + dm_tot w_a   (`maximum`: half each on a tie)
//   dC_{t-1} = f_g dC_t;  dn_{t-1} = f_g dn_t
// m is differentiated exactly as the reference's autodiff does: the clamp
// max(|n . q|, 1) makes h depend on m's scale, so m is no constant here.
//
// What bounds it on an H100: the fp32 operations on the memory (about 23
// per element of C and step, the recompute included) and the latency of
// the sequential walk; the bytes (q, k, v, h, dh read, dq, dk, dv written)
// are far below.  Four launches, one call:
//   1. dh . h per (row, step, head), one warp each;
//   2. the walk: a CTA per slab of 32 v-rows of one (row, head), as the
//      forward kernel, 256 threads, the slab of C and of dC in registers.
//      It first walks forward from the initial state writing the slab of
//      C (and its own copy of n and m) every 16 steps; then, chunk by
//      chunk in reverse, recomputes the chunk's 16 memories from the
//      checkpoint into a per-CTA stash in device memory (each thread reads
//      back only what it wrote), and walks the chunk in reverse.  dv is
//      slab-local; dq and dk are sums over all v-rows and df_g, di_g over
//      all of C, so each CTA writes its slab's partial sums (warps summed
//      through shared memory in warp order; slab 0 adds the normaliser's
//      terms) -- no atomics;
//   3. dq, dk: the slabs' partials summed in slab order;
//   4. the gates: per (row, head), the stabiliser's chain in reverse over
//      the slabs' df_g, di_g sums (summed in slab order), giving di, df
//      and m's initial gradient.
// Every sum has one fixed order, so a repeat gives the same bits.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing (the wrapper passes the
// checkpoint, stash and partial-sum scratch), and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kRows = 32;        // v-rows of C per CTA (a slab)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kChunk = 16;       // steps between checkpoints

template <int HD>
struct Geo {
  static constexpr int NC = HD / 32;             // columns per lane
  static constexpr int kSlabs = HD / kRows;
  // one staged step: q, k (hd), the slab's v and dh, i, f, dh . h, pad
  static constexpr int kQ = 0, kK = HD, kV = 2 * HD, kDH = 2 * HD + kRows;
  static constexpr int kI = 2 * HD + 2 * kRows, kF = kI + 1, kHdot = kI + 2;
  static constexpr int kStep = 2 * HD + 2 * kRows + 4;
  static constexpr int kIn = 0;                          // [kChunk][kStep]
  static constexpr int kN = kIn + kChunk * kStep;        // [kChunk][HD]
  static constexpr int kSc = kN + kChunk * HD;           // [kChunk][4]
  static constexpr int kRedQ = kSc + kChunk * 4;         // [kWarps][HD]
  static constexpr int kRedK = kRedQ + kWarps * HD;      // [kWarps][HD]
  static constexpr int kExQ = kRedK + kWarps * HD;       // [HD]
  static constexpr int kExK = kExQ + HD;                 // [HD]
  static constexpr int kRedS = kExK + HD;                // [kWarps][2] + 2
  static constexpr int kFloats = kRedS + 2 * kWarps + 4;
  static constexpr size_t kBytes = (size_t)kFloats * sizeof(float);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// 1. dh . h for every (row, step, head), into scal[(b, h, t)][0]
template <int HD>
__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_hdot(const float* __restrict__ hs,
                   const float* __restrict__ dhs, float* __restrict__ scal,
                   int B, int T, int H) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= B * T * H) return;
  const int head = w % H, bt = w / H, t = bt % T, b = bt / T;
  const float* hp = hs + (size_t)w * HD;
  const float* dp = dhs + (size_t)w * HD;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 32; ++j)
    acc = __fmaf_rn(dp[lane + 32 * j], hp[lane + 32 * j], acc);
  acc = warp_sum(acc);
  if (lane == 0) scal[(((size_t)b * H + head) * T + t) * 2] = acc;
}

// 2. the walk
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_bwd_walk(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg,
                   const float* __restrict__ c0,
                   const float* __restrict__ n0,
                   const float* __restrict__ m0,
                   const float* __restrict__ dhs,
                   const float* __restrict__ dc_t,
                   const float* __restrict__ dn_t,
                   float* __restrict__ ckpt_c, float* __restrict__ ckpt_nm,
                   float* __restrict__ stash, float* __restrict__ part_qk,
                   float* __restrict__ part_fi,
                   const float* __restrict__ scal, float* __restrict__ dv,
                   float* __restrict__ dc0, float* __restrict__ dn0, int B,
                   int T, int H) {
  using G = Geo<HD>;
  constexpr int S = G::kSlabs, NC = G::NC;
  const int slab = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = slab * kRows + warp * kRowsPerWarp;
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem + G::kIn;
  float* n_st = smem + G::kN;
  float* sc_s = smem + G::kSc;
  float* red_q = smem + G::kRedQ;
  float* red_k = smem + G::kRedK;
  float* ex_q = smem + G::kExQ;
  float* ex_k = smem + G::kExK;
  float* red_s = smem + G::kRedS;

  const size_t bh = (size_t)b * H + head;
  const int nck = (T + kChunk - 1) / kChunk;
  const size_t cta = bh * S + slab;
  float* my_nm = ckpt_nm + cta * nck * (HD + 4);
  float* my_stash = stash + cta * kChunk * kRows * HD;
  const size_t seq = (size_t)B * T * H * HD;   // one partial plane

  // stage chunk c's steps; `full` adds q, dh and dh . h (the reverse walk)
  auto stage = [&](int c, bool full) {
    const int t0 = c * kChunk, rows = min(kChunk, T - t0);
    constexpr int kVec = HD / 4;
    const int per = (full ? 2 * kVec + 2 * (kRows / 4) : kVec + kRows / 4);
    for (int j = tid; j < rows * per; j += kThreads) {
      const int s = j / per, e = j % per;
      const size_t src = (((size_t)b * T + t0 + s) * H + head) * HD;
      float* dst = in_s + s * G::kStep;
      if (!full) {
        if (e < kVec)
          cp_async16(dst + G::kK + 4 * e, k + src + 4 * e);
        else
          cp_async16(dst + G::kV + 4 * (e - kVec),
                     v + src + slab * kRows + 4 * (e - kVec));
      } else if (e < kVec) {
        cp_async16(dst + G::kQ + 4 * e, q + src + 4 * e);
      } else if (e < 2 * kVec) {
        cp_async16(dst + G::kK + 4 * (e - kVec), k + src + 4 * (e - kVec));
      } else if (e < 2 * kVec + kRows / 4) {
        cp_async16(dst + G::kV + 4 * (e - 2 * kVec),
                   v + src + slab * kRows + 4 * (e - 2 * kVec));
      } else {
        const int o = e - 2 * kVec - kRows / 4;
        cp_async16(dst + G::kDH + 4 * o, dhs + src + slab * kRows + 4 * o);
      }
    }
    const int scalars = full ? 3 : 2;
    for (int j = tid; j < rows * scalars; j += kThreads) {
      const int s = j / scalars, e = j % scalars;
      const size_t gi = ((size_t)b * T + t0 + s) * H + head;
      float* dst = in_s + s * G::kStep;
      if (e == 0)
        cp_async4(dst + G::kI, ig + gi);
      else if (e == 1)
        cp_async4(dst + G::kF, fg + gi);
      else
        cp_async4(dst + G::kHdot, scal + (bh * T + t0 + s) * 2);
    }
    cp_async_wait_all();
  };

  float cm[kRowsPerWarp][NC], nv[NC];
  float m;
  // ---- forward walk: a checkpoint every kChunk steps ----
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      cm[r][j] = c0[(bh * HD + row0 + r) * HD + lane + 32 * j];
#pragma unroll
  for (int j = 0; j < NC; ++j) nv[j] = n0[bh * HD + lane + 32 * j];
  m = m0[bh];
  for (int c = 0; c < nck; ++c) {
    float* ck = ckpt_c + ((bh * nck + c) * HD + row0) * HD;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) ck[r * HD + lane + 32 * j] = cm[r][j];
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        my_nm[(size_t)c * (HD + 4) + lane + 32 * j] = nv[j];
      if (lane == 0) my_nm[(size_t)c * (HD + 4) + HD] = m;
    }
    if (c == nck - 1) break;
    __syncthreads();
    stage(c, false);
    __syncthreads();
    for (int s = 0; s < kChunk; ++s) {
      const float* sp = in_s + s * G::kStep;
      const float a = __fadd_rn(sp[G::kF], m);
      const float m_new = fmaxf(a, sp[G::kI]);
      const float i_g = expf(__fsub_rn(sp[G::kI], m_new));
      const float f_g = expf(__fsub_rn(a, m_new));
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kj = sp[G::kK + lane + 32 * j];
        nv[j] = __fadd_rn(__fmul_rn(f_g, nv[j]), __fmul_rn(i_g, kj));
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float vr = sp[G::kV + warp * kRowsPerWarp + r];
          cm[r][j] = __fadd_rn(__fmul_rn(f_g, cm[r][j]),
                               __fmul_rn(i_g, __fmul_rn(vr, kj)));
        }
      }
      m = m_new;
    }
  }

  // ---- reverse walk, chunk by chunk ----
  float dcm[kRowsPerWarp][NC], dn[NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dcm[r][j] = dc_t != nullptr
                      ? dc_t[(bh * HD + row0 + r) * HD + lane + 32 * j]
                      : 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    dn[j] = dn_t != nullptr ? dn_t[bh * HD + lane + 32 * j] : 0.f;

  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kChunk, rows = min(kChunk, T - t0);
    __syncthreads();
    stage(c, true);
    const float* ck = ckpt_c + ((bh * nck + c) * HD + row0) * HD;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) cm[r][j] = ck[r * HD + lane + 32 * j];
    __syncthreads();   // the staged chunk, and warp 0's n checkpoint
#pragma unroll
    for (int j = 0; j < NC; ++j)
      nv[j] = my_nm[(size_t)c * (HD + 4) + lane + 32 * j];
    m = my_nm[(size_t)c * (HD + 4) + HD];
    // recompute the chunk: the memory before each step into the stash
    for (int s = 0; s < rows; ++s) {
      const float* sp = in_s + s * G::kStep;
      float* st = my_stash + ((size_t)s * kRows + warp * kRowsPerWarp) * HD;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int j = 0; j < NC; ++j) st[r * HD + lane + 32 * j] = cm[r][j];
      if (warp == 0) {
#pragma unroll
        for (int j = 0; j < NC; ++j) n_st[s * HD + lane + 32 * j] = nv[j];
      }
      const float a = __fadd_rn(sp[G::kF], m);
      const float m_new = fmaxf(a, sp[G::kI]);
      const float i_g = expf(__fsub_rn(sp[G::kI], m_new));
      const float f_g = expf(__fsub_rn(a, m_new));
      float sdot = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kj = sp[G::kK + lane + 32 * j];
        nv[j] = __fadd_rn(__fmul_rn(f_g, nv[j]), __fmul_rn(i_g, kj));
        sdot = __fmaf_rn(nv[j], sp[G::kQ + lane + 32 * j], sdot);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float vr = sp[G::kV + warp * kRowsPerWarp + r];
          cm[r][j] = __fadd_rn(__fmul_rn(f_g, cm[r][j]),
                               __fmul_rn(i_g, __fmul_rn(vr, kj)));
        }
      }
      sdot = warp_sum(sdot);
      if (tid == 0) {
        sc_s[4 * s] = i_g;
        sc_s[4 * s + 1] = f_g;
        sc_s[4 * s + 2] = sdot;
        sc_s[4 * s + 3] = fmaxf(fabsf(sdot), 1.f);
      }
      m = m_new;
    }
    __syncthreads();   // n_st and sc_s
    for (int s = rows - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float* sp = in_s + s * G::kStep;
      const float i_g = sc_s[4 * s], f_g = sc_s[4 * s + 1];
      const float sdot = sc_s[4 * s + 2], den = sc_s[4 * s + 3];
      const float dden = __fdiv_rn(-sp[G::kHdot], den);
      const float ds = __fmul_rn(__fmul_rn(dden, sign_of(sdot)),
                                 max_share(fabsf(sdot), 1.f));
      const float* st = my_stash + ((size_t)s * kRows + warp * kRowsPerWarp) * HD;
      float qv[NC], kv[NC], qacc[NC], kacc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        qv[j] = sp[G::kQ + lane + 32 * j];
        kv[j] = sp[G::kK + lane + 32 * j];
        qacc[j] = 0.f;
        kacc[j] = 0.f;
      }
      float dfp = 0.f, dip = 0.f;
      const size_t bth = ((size_t)b * T + t) * H + head;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float vr = sp[G::kV + warp * kRowsPerWarp + r];
        const float dnum = __fdiv_rn(sp[G::kDH + warp * kRowsPerWarp + r], den);
        float rr = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float cp = st[r * HD + lane + 32 * j];
          const float dcn = __fadd_rn(dcm[r][j], __fmul_rn(dnum, qv[j]));
          const float cn = __fadd_rn(__fmul_rn(f_g, cp),
                                     __fmul_rn(i_g, __fmul_rn(vr, kv[j])));
          dfp = __fmaf_rn(dcn, cp, dfp);
          rr = __fmaf_rn(dcn, kv[j], rr);
          qacc[j] = __fmaf_rn(cn, dnum, qacc[j]);
          kacc[j] = __fmaf_rn(dcn, vr, kacc[j]);
          dcm[r][j] = __fmul_rn(f_g, dcn);
        }
        rr = warp_sum(rr);
        if (lane == 0) dv[bth * HD + row0 + r] = __fmul_rn(i_g, rr);
        dip = __fmaf_rn(vr, rr, dip);
      }
      dfp = warp_sum(dfp);
      if (slab == 0) {       // the normaliser's terms, once per (row, head)
        float dfn = 0.f, din = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = lane + 32 * j;
          const float dnn = __fadd_rn(dn[j], __fmul_rn(ds, qv[j]));
          const float np = n_st[s * HD + col];
          const float nn = __fadd_rn(__fmul_rn(f_g, np), __fmul_rn(i_g, kv[j]));
          dfn = __fmaf_rn(dnn, np, dfn);
          din = __fmaf_rn(dnn, kv[j], din);
          if (warp == 0) {
            ex_q[col] = __fmul_rn(ds, nn);
            ex_k[col] = dnn;
          }
          dn[j] = __fmul_rn(f_g, dnn);
        }
        dfn = warp_sum(dfn);
        din = warp_sum(din);
        if (tid == 0) {
          red_s[2 * kWarps] = dfn;
          red_s[2 * kWarps + 1] = din;
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        red_q[warp * HD + lane + 32 * j] = qacc[j];
        red_k[warp * HD + lane + 32 * j] = kacc[j];
      }
      if (lane == 0) {
        red_s[2 * warp] = dfp;
        red_s[2 * warp + 1] = dip;
      }
      __syncthreads();
      float* pq = part_qk + (size_t)slab * seq + bth * HD;
      float* pk = part_qk + (size_t)(S + slab) * seq + bth * HD;
      for (int col = tid; col < HD; col += kThreads) {
        float sq = red_q[col], sk = red_k[col];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          sq = __fadd_rn(sq, red_q[w * HD + col]);
          sk = __fadd_rn(sk, red_k[w * HD + col]);
        }
        if (slab == 0) {
          sq = __fadd_rn(sq, ex_q[col]);
          sk = __fadd_rn(sk, ex_k[col]);
        }
        pq[col] = sq;
        pk[col] = __fmul_rn(i_g, sk);
      }
      if (tid == 0) {
        float sf = red_s[0], si = red_s[1];
        for (int w = 1; w < kWarps; ++w) {
          sf = __fadd_rn(sf, red_s[2 * w]);
          si = __fadd_rn(si, red_s[2 * w + 1]);
        }
        if (slab == 0) {
          sf = __fadd_rn(sf, red_s[2 * kWarps]);
          si = __fadd_rn(si, red_s[2 * kWarps + 1]);
        }
        float* pf = part_fi + ((bh * T + t) * S + slab) * 2;
        pf[0] = sf;
        pf[1] = si;
      }
      __syncthreads();   // the reduction buffers are reused next step
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dc0[(bh * HD + row0 + r) * HD + lane + 32 * j] = dcm[r][j];
  if (slab == 0 && warp == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) dn0[bh * HD + lane + 32 * j] = dn[j];
  }
}

// 3. dq, dk: the slabs' partials in slab order
__global__ void mlstm_bwd_reduce(const float* __restrict__ part_qk,
                                 float* __restrict__ dq,
                                 float* __restrict__ dk, size_t seq, int S) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= seq) return;
  float sq = part_qk[i], sk = part_qk[(size_t)S * seq + i];
  for (int s = 1; s < S; ++s) {
    sq = __fadd_rn(sq, part_qk[(size_t)s * seq + i]);
    sk = __fadd_rn(sk, part_qk[(size_t)(S + s) * seq + i]);
  }
  dq[i] = sq;
  dk[i] = sk;
}

// 4. the gates: the stabiliser's chain per (row, head)
__global__ void mlstm_bwd_gates(const float* __restrict__ ig,
                                const float* __restrict__ fg,
                                const float* __restrict__ m0,
                                const float* __restrict__ dm_t,
                                const float* __restrict__ part_fi,
                                float* __restrict__ scal,
                                float* __restrict__ di,
                                float* __restrict__ df,
                                float* __restrict__ dm0, int B, int T, int H,
                                int S) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * H) return;
  const int b = idx / H, head = idx % H;
  float m = m0[idx];
  for (int t = 0; t < T; ++t) {
    const size_t gi = ((size_t)b * T + t) * H + head;
    scal[((size_t)idx * T + t) * 2 + 1] = m;
    m = fmaxf(__fadd_rn(fg[gi], m), ig[gi]);
  }
  float dm = dm_t != nullptr ? dm_t[idx] : 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t gi = ((size_t)b * T + t) * H + head;
    const float m_prev = scal[((size_t)idx * T + t) * 2 + 1];
    const float a = __fadd_rn(fg[gi], m_prev);
    const float m_new = fmaxf(a, ig[gi]);
    const float i_g = expf(__fsub_rn(ig[gi], m_new));
    const float f_g = expf(__fsub_rn(a, m_new));
    const float* pf = part_fi + ((size_t)idx * T + t) * S * 2;
    float dfg = pf[0], dig = pf[1];
    for (int s = 1; s < S; ++s) {
      dfg = __fadd_rn(dfg, pf[2 * s]);
      dig = __fadd_rn(dig, pf[2 * s + 1]);
    }
    const float dm_tot = __fsub_rn(__fsub_rn(dm, __fmul_rn(dig, i_g)),
                                   __fmul_rn(dfg, f_g));
    di[gi] = __fadd_rn(__fmul_rn(dig, i_g),
                       __fmul_rn(dm_tot, max_share(ig[gi], a)));
    dm = __fadd_rn(__fmul_rn(dfg, f_g), __fmul_rn(dm_tot, max_share(a, ig[gi])));
    df[gi] = dm;
  }
  dm0[idx] = dm;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* ig,
           const float* fg, const float* c0, const float* n0,
           const float* m0, const float* hs, const float* dhs,
           const float* dc_t, const float* dn_t, const float* dm_t,
           float* ckpt_c, float* ckpt_nm, float* stash, float* part_qk,
           float* part_fi, float* scal, float* dq, float* dk, float* dv,
           float* di, float* df, float* dc0, float* dn0, float* dm0, int B,
           int T, int H, cudaStream_t stream) {
  using G = Geo<HD>;
  auto hdot = mlstm_bwd_hdot<HD>;
  const int warps = B * T * H;
  APEX_LAUNCH(hdot, dim3((warps + kWarps - 1) / kWarps), dim3(kThreads), 0,
              stream, hs, dhs, scal, B, T, H);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  auto walk = mlstm_bwd_walk<HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  APEX_LAUNCH(walk, dim3(G::kSlabs, H, B), dim3(kThreads), G::kBytes,
              stream, q, k, v, ig, fg, c0, n0, m0, dhs, dc_t, dn_t, ckpt_c,
              ckpt_nm, stash, part_qk, part_fi, scal, dv, dc0, dn0, B, T, H);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t seq = (size_t)B * T * H * HD;
  APEX_LAUNCH(mlstm_bwd_reduce, dim3((unsigned)((seq + 255) / 256)),
              dim3(256), 0, stream, part_qk, dq, dk, seq, G::kSlabs);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  APEX_LAUNCH(mlstm_bwd_gates, dim3((B * H + 63) / 64), dim3(64), 0, stream,
              ig, fg, m0, dm_t, part_fi, scal, di, df, dm0, B, T, H,
              G::kSlabs);
  return 0;
}

}  // namespace

extern "C" int apex_mlstm_scan_bwd_chunk() { return kChunk; }
extern "C" int apex_mlstm_scan_bwd_rows() { return kRows; }

extern "C" int apex_mlstm_scan_bwd(
    const void* q, const void* k, const void* v, const void* i_pre,
    const void* f_pre, const void* cmat0, const void* n0, const void* m0,
    const void* hs, const void* dhs, const void* dc_t, const void* dn_t,
    const void* dm_t, void* ckpt_c, void* ckpt_nm, void* stash,
    void* part_qk, void* part_fi, void* scal, void* dq, void* dk, void* dv,
    void* di, void* df, void* dc0, void* dn0, void* dm0, int B, int T, int H,
    int HD, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dhs) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
#define APEX_MLSTM_BWD_ARGS                                                   \
  (const float*)q, (const float*)k, (const float*)v, (const float*)i_pre,     \
      (const float*)f_pre, (const float*)cmat0, (const float*)n0,             \
      (const float*)m0, (const float*)hs, (const float*)dhs,                  \
      (const float*)dc_t, (const float*)dn_t, (const float*)dm_t,             \
      (float*)ckpt_c, (float*)ckpt_nm, (float*)stash, (float*)part_qk,        \
      (float*)part_fi, (float*)scal, (float*)dq, (float*)dk, (float*)dv,      \
      (float*)di, (float*)df, (float*)dc0, (float*)dn0, (float*)dm0, B, T, H, \
      st
  int rc;
  switch (HD) {
    case 32:
      rc = launch<32>(APEX_MLSTM_BWD_ARGS);
      break;
    case 64:
      rc = launch<64>(APEX_MLSTM_BWD_ARGS);
      break;
    case 384:
      rc = launch<384>(APEX_MLSTM_BWD_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef APEX_MLSTM_BWD_ARGS
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
