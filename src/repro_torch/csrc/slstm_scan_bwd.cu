// sLSTM recurrence for Hopper (sm_90a): the backward walk over T.
//
// Replaces no Pallas kernel: the reference differentiates its `lax.scan`
// (src/repro/models/ssm.py:246, the cell at :209) with autodiff; the
// port's plain version is kernels/ref.py `slstm_recurrence_bwd_ref`.  It
// walks T in reverse over what the forward kernel saved (every step's
// gate pre-activations and state), carrying the gradients of (c, n, m)
// per unit and of h through the recurrent product:
//   dh_new = dh_{t+1 -> t} + dhs_t
//   do  = dh_new c / den sigmoid'(o);  dc_new = dc + dh_new sigmoid(o)/den
//   dn_new = dn - dh_new sigmoid(o) c / den^2 sign(n) [|n| > 1e-6]
//   df_g = dc_new c_{t-1} + dn_new n_{t-1};  di_g = dc_new tanh(z) + dn_new
//   dz  = dc_new i_g (1 - tanh^2 z)
//   m's gradient through exp and `maximum` (half each on a tie, as the
//   reference's autodiff): dm_tot = dm - di_g i_g - df_g f_g,
//   di = di_g i_g + dm_tot w_i,  df = dm_{t-1} = df_g f_g + dm_tot w_a
//   dc_{t-1} = f_g dc_new,  dn_{t-1} = f_g dn_new
//   dh_{t -> t-1} = R . (di, df, dz, do)            (the recurrent product)
// It writes d(pre-activations) (= gates_x's gradient) for every step and
// the initial state's gradient.  R's gradient, sum_t h_{t-1} (x) dpre_t,
// and the bias's are one product and one sum after the walk
// (kernels/xlstm.py), as the reference leaves them to XLA.
//
// What bounds it on an H100: as the forward, the latency of a step (the
// 147k-FMA product R . dpre at xlstm-125m and one exchange), not bytes.
// The design carries over the forward kernel's exchange (slstm_scan.cu):
//   * a cluster of APEX_SLSTM_BWD_CLUSTER CTAs (8, or 4 at head_dim 16) per
//     (row, head), CTA q owning units [q U, (q+1) U), U = hd / cluster;
//     one thread per unit runs the elementwise step above;
//   * the recurrent product, reduce-scattered (APEX_SLSTM_BWD_BROADCAST
//     0): a thread owns one input d of the head and half of the CTA's 4 U
//     gate columns of R (2 U fp32 registers, staged once through shared
//     memory), sums its half of R[d, :] . dpre over them, a lane pair adds
//     the halves, and the sum goes into unit d's owner CTA's next buffer
//     by st.async (complete_tx), its slot the sender's rank; the owner
//     adds its cluster's slots in rank order, so a repeat gives the same
//     bits.  Each CTA's two buffers have one mbarrier each, armed for
//     hd x 4 bytes a phase.  (APEX_SLSTM_BWD_BROADCAST 1: each owner
//     sends its unit's 4 dpre values to every CTA instead, and each CTA
//     sums R[u, :] . dpre over all 4 hd columns for its own units: no
//     cross-CTA sum, 4x the bytes, 4 hd x 4 a phase);
//   * no cluster barrier in the step loop (APEX_SLSTM_BWD_EXCHANGE 0: a
//     distributed shared memory store and one cluster barrier a step, the
//     first design's way), one at the end.  Two buffers suffice, as in
//     the forward: a CTA sends step t-1's values into a buffer only after
//     it has received every CTA's step-t values, each of which was sent
//     after that CTA's owners had read the same buffer at step t+1's
//     values;
//   * the saved per-step values (acts, cs, ns, ms, dhs) of the CTA's
//     units arrive by 16-byte cp.async in tiles of kTileT steps (with the
//     step before the tile's first, whose state is the first step's
//     previous one), double-buffered, a tile ahead of use.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef APEX_SLSTM_BWD_CLUSTER
#define APEX_SLSTM_BWD_CLUSTER 8
#endif
#ifndef APEX_SLSTM_BWD_EXCHANGE
#define APEX_SLSTM_BWD_EXCHANGE 1
#endif
#ifndef APEX_SLSTM_BWD_BROADCAST
#define APEX_SLSTM_BWD_BROADCAST 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kTileT = 8;     // steps of saved values per staged tile
constexpr bool kMbar = APEX_SLSTM_BWD_EXCHANGE != 0;
constexpr bool kBcast = APEX_SLSTM_BWD_BROADCAST != 0;

template <int HD, typename TR>
struct Geo {
  // the asked cluster where its CTAs keep 16-byte staging, else 4
  static constexpr int kCl =
      (HD / APEX_SLSTM_BWD_CLUSTER) % 4 == 0 ? APEX_SLSTM_BWD_CLUSTER : 4;
  static constexpr int U = HD / kCl;        // units per CTA
  static constexpr int kThreads = 2 * HD;   // (input, half) or (unit, part)
  static constexpr int kCols = 2 * U;       // R values a thread holds
  static constexpr int kLanes = 2 * kCl;    // threads a unit (broadcast)
  // a staged step: acts (4 U: i, f, z, o), c, n, m and dh of the units
  static constexpr int kRow = 8 * U;
  // R's staged copy (reduce-scatter): HD rows of the CTA's 4 U columns
  static constexpr int kSegB = U * (int)sizeof(TR);
  static constexpr int kPiece = kSegB % 16 == 0 ? 16 : (kSegB % 8 == 0 ? 8 : 4);
  static constexpr size_t kRBytes =
      kBcast ? 0 : (size_t)HD * 4 * U * sizeof(TR);
  // floats of one exchange buffer
  static constexpr int kRecv = kBcast ? 4 * HD : kCl * U;
  static_assert(U % 4 == 0 && kCols % 4 == 0, "16-byte staging");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem) {
  if constexpr (N == 16)
    cp_async16(smem, gmem);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(smem)), "l"(gmem), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarriers in shared memory (a CTA's own, or a peer's by its cluster
// address), as slstm_scan.cu uses them
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_arm(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ unsigned cluster_addr(unsigned addr,
                                                 unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// store x at a peer's address and complete 4 bytes of its mbarrier
__device__ __forceinline__ void st_async(unsigned addr, float x,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(x), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// the share of maximum(a, b)'s gradient that goes to a
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// One reverse step of a unit: its staged step (row) and the step before
// (prev: c, n, m), the carried gradients in and out, dpre (i, f, z, o).
template <int U>
__device__ __forceinline__ void bwd_cell(const float* row, const float* prev,
                                         int u, float dh, float& dc,
                                         float& dn, float& dm, float* dg) {
  const float gi = row[u], gf = row[U + u], gz = row[2 * U + u],
              go = row[3 * U + u];
  const float c_new = row[4 * U + u], n_new = row[5 * U + u],
              dy = row[7 * U + u];
  const float c_prev = prev[4 * U + u], n_prev = prev[5 * U + u],
              m_prev = prev[6 * U + u];
  const float a = __fadd_rn(gf, m_prev);
  const float m_new = fmaxf(a, gi);
  const float i_g = expf(__fsub_rn(gi, m_new));
  const float f_g = expf(__fsub_rn(a, m_new));
  const float tz = tanhf(gz), so = sigmoid_rn(go);
  const float den = fmaxf(fabsf(n_new), 1e-6f);
  const float dh_new = __fadd_rn(dh, dy);
  const float dgo = __fmul_rn(
      __fmul_rn(__fdiv_rn(__fmul_rn(dh_new, c_new), den), so),
      __fsub_rn(1.f, so));
  const float dc_new = __fadd_rn(dc, __fdiv_rn(__fmul_rn(dh_new, so), den));
  const float w_abs = max_share(fabsf(n_new), 1e-6f);
  const float dn_new = __fsub_rn(
      dn, __fmul_rn(__fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(dh_new, so),
                                                  c_new),
                                        __fmul_rn(den, den)),
                              sign_of(n_new)),
                    w_abs));
  const float df_g = __fadd_rn(__fmul_rn(dc_new, c_prev),
                               __fmul_rn(dn_new, n_prev));
  const float di_g = __fadd_rn(__fmul_rn(dc_new, tz), dn_new);
  const float dgz = __fmul_rn(__fmul_rn(dc_new, i_g),
                              __fsub_rn(1.f, __fmul_rn(tz, tz)));
  const float dm_tot = __fsub_rn(__fsub_rn(dm, __fmul_rn(di_g, i_g)),
                                 __fmul_rn(df_g, f_g));
  const float w_a = max_share(a, gi), w_i = max_share(gi, a);
  dg[0] = __fadd_rn(__fmul_rn(di_g, i_g), __fmul_rn(dm_tot, w_i));
  dg[1] = __fadd_rn(__fmul_rn(df_g, f_g), __fmul_rn(dm_tot, w_a));
  dg[2] = dgz;
  dg[3] = dgo;
  dm = dg[1];
  dc = __fmul_rn(dc_new, f_g);
  dn = __fmul_rn(dn_new, f_g);
}

// x . w over N values in four FMA chains, then the chains in a fixed order
template <int N>
__device__ __forceinline__ float dot4(const float* x, const float* w) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    a0 = __fmaf_rn(v.x, w[i], a0);
    a1 = __fmaf_rn(v.y, w[i + 1], a1);
    a2 = __fmaf_rn(v.z, w[i + 2], a2);
    a3 = __fmaf_rn(v.w, w[i + 3], a3);
  }
  return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}

template <int HD, typename TR>
__global__ void __launch_bounds__(Geo<HD, TR>::kThreads, 1)
    slstm_bwd_kernel(const TR* __restrict__ r,
                     const float* __restrict__ acts,
                     const float* __restrict__ cs,
                     const float* __restrict__ ns,
                     const float* __restrict__ ms,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0,
                     const float* __restrict__ dhs,
                     const float* __restrict__ dc_t,
                     const float* __restrict__ dn_t,
                     const float* __restrict__ dh_t,
                     const float* __restrict__ dm_t,
                     float* __restrict__ dacts, float* __restrict__ dc0,
                     float* __restrict__ dn0, float* __restrict__ dh0,
                     float* __restrict__ dm0, int T, int H) {
  using G = Geo<HD, TR>;
  constexpr int CL = G::kCl, U = G::U;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  __shared__ __align__(16) float st_s[2][kTileT + 1][G::kRow];
  __shared__ __align__(16) float dg_s[2][4 * U];
  __shared__ __align__(16) float recv[2][G::kRecv];
  __shared__ float dh_s[U];
  __shared__ __align__(8) unsigned long long bar[2];
  extern __shared__ __align__(16) unsigned char r_s[];

  // this thread's R values in fp32: reduce-scatter, input d and half of
  // the CTA's local columns j = gate U + unit (staged through shared
  // memory); broadcast, unit u's row over columns [part 2U, +2U) of 4 hd
  const int d = tid >> 1, half = tid & 1;
  const int bu = tid / G::kLanes, part = tid % G::kLanes;
  float rw[G::kCols];
  const TR* rh = r + (size_t)head * HD * (4 * HD);
  if constexpr (kBcast) {
    const TR* rp = rh + (size_t)(rank * U + bu) * 4 * HD + part * G::kCols;
#pragma unroll
    for (int i = 0; i < G::kCols; ++i) rw[i] = to_f(rp[i]);
  } else {
    constexpr int kPer = G::kSegB / G::kPiece;   // pieces a segment
    TR* rs = reinterpret_cast<TR*>(r_s);
    for (int j = tid; j < HD * 4 * kPer; j += G::kThreads) {
      const int row = j / (4 * kPer), rem = j % (4 * kPer);
      const int gg = rem / kPer, pc = rem % kPer;
      cp_async_n<G::kPiece>(
          reinterpret_cast<unsigned char*>(rs + row * 4 * U + gg * U)
              + pc * G::kPiece,
          reinterpret_cast<const unsigned char*>(
              rh + (size_t)row * 4 * HD + gg * HD + rank * U)
              + pc * G::kPiece);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G::kCols; ++i)
      rw[i] = to_f(rs[d * 4 * U + half * G::kCols + i]);
  }

  const bool owner = tid < U;                  // one thread per unit
  const int unit = rank * U + tid;             // (owners only)
  const size_t sbase = ((size_t)b * H + head) * HD;
  float dc = 0.f, dn = 0.f, dm = 0.f, dh = 0.f;
  if (owner) {
    if (dc_t != nullptr) dc = dc_t[sbase + unit];
    if (dn_t != nullptr) dn = dn_t[sbase + unit];
    if (dm_t != nullptr) dm = dm_t[sbase + unit];
    if (dh_t != nullptr) dh = dh_t[sbase + unit];
  }
  const unsigned bar0 = smem_addr(&bar[0]);
  constexpr unsigned kPhase = G::kRecv * 4;    // bytes a CTA receives a step
  if (kMbar && tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(bar0, kPhase);       // each buffer's first phase
    mbar_arm(bar0 + 8, kPhase);
  }
  // where this thread's sends land: reduce-scatter, slot rank of input
  // d's owner (senders are the half-0 threads); broadcast, unit's gate
  // columns in every CTA (senders are the owners)
  const int dest = d / U;
  const unsigned slot0 = smem_addr(kBcast ? &recv[0][tid < U ? unit : 0]
                                          : &recv[0][rank * U + d % U]);
  unsigned peer_slot[kBcast ? CL : 1], peer_bar[kBcast ? CL : 1];
  if (kMbar) {
#pragma unroll
    for (int q = 0; q < (kBcast ? CL : 1); ++q) {
      const int to = kBcast ? q : dest;
      peer_slot[q] = cluster_addr(slot0, to);
      peer_bar[q] = cluster_addr(bar0, to);
    }
  }

  // tile k holds steps [t0, t1) (counted from the end) in rows 1.., and
  // the state before t0 (c, n, m) in row 0
  const size_t bt0 = (size_t)b * T;
  auto stage = [&](int k, int buf) {
    const int t1 = T - k * kTileT, t0 = max(0, t1 - kTileT);
    constexpr int kQ = U / 4;                  // 16-byte pieces a field
    for (int j = tid; j < (t1 - t0) * 8 * kQ; j += G::kThreads) {
      const int s = j / (8 * kQ), f = (j / kQ) % 8, q4 = j % kQ;
      const size_t bt = (bt0 + t0 + s) * H + head;
      const float* src =
          f < 4 ? acts + bt * 4 * HD + f * HD
                : (f == 4 ? cs : f == 5 ? ns : f == 6 ? ms : dhs) + bt * HD;
      cp_async16(&st_s[buf][s + 1][f * U + 4 * q4], src + rank * U + 4 * q4);
    }
    for (int j = tid; j < 3 * kQ; j += G::kThreads) {
      const int f = 4 + j / kQ, q4 = j % kQ;
      const float* src =
          t0 > 0 ? (f == 4 ? cs : f == 5 ? ns : ms)
                       + ((bt0 + t0 - 1) * H + head) * HD
                 : (f == 4 ? c0 : f == 5 ? n0 : m0) + sbase;
      cp_async16(&st_s[buf][0][f * U + 4 * q4], src + rank * U + 4 * q4);
    }
    cp_async_commit();
  };

  // the step-s exchange's values, summed for this CTA's units into dh
  // (owners; broadcast: every thread takes part in the product)
  unsigned parity[2] = {0u, 0u};
  const unsigned full = 0xffffffffu;
  auto receive = [&](int buf) {
    if (kMbar && (kBcast || owner)) {
      mbar_wait(bar0 + 8 * buf, parity[buf]);
      parity[buf] ^= 1u;
      if (tid == 0) mbar_arm(bar0 + 8 * buf, kPhase);   // its next phase
    }
    if constexpr (kBcast) {
      float x = dot4<G::kCols>(&recv[buf][part * G::kCols], rw);
#pragma unroll
      for (int off = CL; off > 0; off >>= 1)
        x = __fadd_rn(x, __shfl_xor_sync(full, x, off));
      if (part == 0) dh_s[bu] = x;
      __syncthreads();
      if (owner) dh = dh_s[tid];
    } else if (owner) {
      float x = recv[buf][tid];
#pragma unroll
      for (int q = 1; q < CL; ++q) x = __fadd_rn(x, recv[buf][q * U + tid]);
      dh = x;
    }
  };

  const int ntiles = (T + kTileT - 1) / kTileT;
  stage(0, 0);
  cluster.sync();   // every CTA runs (and its barriers are set up)
  int s = 0;        // steps taken, from the end
  for (int k = 0; k < ntiles; ++k) {
    __syncthreads();   // tile k-1's rows are read: its buffer is refilled
    if (k + 1 < ntiles) {
      stage(k + 1, (k + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t1 = T - k * kTileT, t0 = max(0, t1 - kTileT);
    for (int t = t1 - 1; t >= t0; --t, ++s) {
      const int cur = s & 1;
      if (s > 0) receive(cur ^ 1);
      float dg[4];
      if (owner) {
        bwd_cell<U>(st_s[k & 1][t - t0 + 1], st_s[k & 1][t - t0], tid, dh,
                    dc, dn, dm, dg);
        float* out = dacts + ((bt0 + t) * H + head) * 4 * HD + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g) out[g * HD] = dg[g];
      }
      if constexpr (kBcast) {
        if (owner) {
#pragma unroll
          for (int q = 0; q < CL; ++q)
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if (kMbar)
                st_async(peer_slot[q] + 4 * (cur * G::kRecv + g * HD), dg[g],
                         peer_bar[q] + 8 * cur);
              else
                *cluster.map_shared_rank(&recv[cur][g * HD + unit], q) =
                    dg[g];
            }
        }
      } else {
        if (owner) {
#pragma unroll
          for (int g = 0; g < 4; ++g) dg_s[cur][g * U + tid] = dg[g];
        }
        __syncthreads();
        // R[d, the CTA's columns] . dpre, this thread's half, then the
        // pair's sum, sent to the owner of d
        const float part_sum = dot4<G::kCols>(&dg_s[cur][half * G::kCols], rw);
        const float other = __shfl_xor_sync(full, part_sum, 1);
        if (half == 0) {
          const float sum = __fadd_rn(part_sum, other);
          if (kMbar)
            st_async(peer_slot[0] + 4 * cur * G::kRecv, sum,
                     peer_bar[0] + 8 * cur);
          else
            *cluster.map_shared_rank(&recv[cur][rank * U + d % U], dest) =
                sum;
        }
      }
      if (!kMbar) cluster.sync();
    }
  }
  receive((s - 1) & 1);   // the last step's product: dh_0's gradient
  if (owner) {
    dc0[sbase + unit] = dc;
    dn0[sbase + unit] = dn;
    dh0[sbase + unit] = dh;
    dm0[sbase + unit] = dm;
  }
  cluster.sync();   // no CTA leaves while a peer may store to it
}

template <int HD, typename TR>
int launch(const void* r, const float* acts, const float* cs,
           const float* ns, const float* ms, const float* c0,
           const float* n0, const float* m0, const float* dhs,
           const float* dc_t, const float* dn_t, const float* dh_t,
           const float* dm_t, float* dacts, float* dc0, float* dn0,
           float* dh0, float* dm0, int B, int T, int H,
           cudaStream_t stream) {
  using G = Geo<HD, TR>;
  auto kern = slstm_bwd_kernel<HD, TR>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kRBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G::kCl, H, B);
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kRBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, (const TR*)r, acts, cs, ns, ms,
                                 c0, n0, m0, dhs, dc_t, dn_t, dh_t, dm_t,
                                 dacts, dc0, dn0, dh0, dm0, T, H);
}
template <typename TR>
int dispatch(int HD, const void* r, const float* acts, const float* cs,
             const float* ns, const float* ms, const float* c0,
             const float* n0, const float* m0, const float* dhs,
             const float* dc_t, const float* dn_t, const float* dh_t,
             const float* dm_t, float* dacts, float* dc0, float* dn0,
             float* dh0, float* dm0, int B, int T, int H, cudaStream_t st) {
  switch (HD) {
    case 16:
      return launch<16, TR>(r, acts, cs, ns, ms, c0, n0, m0, dhs, dc_t, dn_t,
                            dh_t, dm_t, dacts, dc0, dn0, dh0, dm0, B, T, H,
                            st);
    case 32:
      return launch<32, TR>(r, acts, cs, ns, ms, c0, n0, m0, dhs, dc_t, dn_t,
                            dh_t, dm_t, dacts, dc0, dn0, dh0, dm0, B, T, H,
                            st);
    case 64:
      return launch<64, TR>(r, acts, cs, ns, ms, c0, n0, m0, dhs, dc_t, dn_t,
                            dh_t, dm_t, dacts, dc0, dn0, dh0, dm0, B, T, H,
                            st);
    case 192:
      return launch<192, TR>(r, acts, cs, ns, ms, c0, n0, m0, dhs, dc_t, dn_t,
                            dh_t, dm_t, dacts, dc0, dn0, dh0, dm0, B, T, H,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int apex_slstm_scan_bwd(
    const void* r, int r_bf16, const void* acts, const void* cs,
    const void* ns, const void* ms, const void* c0, const void* n0,
    const void* m0, const void* dhs, const void* dc_t, const void* dn_t,
    const void* dh_t, const void* dm_t, void* dacts, void* dc0, void* dn0,
    void* dh0, void* dm0, int B, int T, int H, int HD, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)acts, *c = (const float*)cs;
  const float *n = (const float*)ns, *m = (const float*)ms;
  const float *ci = (const float*)c0, *ni = (const float*)n0;
  const float *mi = (const float*)m0, *dy = (const float*)dhs;
  const float *dct = (const float*)dc_t, *dnt = (const float*)dn_t;
  const float *dht = (const float*)dh_t, *dmt = (const float*)dm_t;
  float *da = (float*)dacts, *dco = (float*)dc0, *dno = (float*)dn0;
  float *dho = (float*)dh0, *dmo = (float*)dm0;
  const int rc =
      r_bf16 ? dispatch<__nv_bfloat16>(HD, r, a, c, n, m, ci, ni, mi, dy, dct,
                                       dnt, dht, dmt, da, dco, dno, dho, dmo,
                                       B, T, H, st)
             : dispatch<float>(HD, r, a, c, n, m, ci, ni, mi, dy, dct, dnt,
                               dht, dmt, da, dco, dno, dho, dmo, B, T, H, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
