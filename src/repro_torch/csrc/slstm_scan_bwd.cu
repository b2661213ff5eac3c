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
// The design mirrors the forward kernel's cluster of 4 CTAs per (row,
// head), CTA q owning units [q hd/4, (q+1) hd/4):
//   * a thread owns one input d of the head and half of the CTA's 4 hd/4
//     gate columns of R (hd/2 fp32 registers), so it sums its half of
//     R[d, :] . dpre over the CTA's columns; a lane pair adds the halves;
//   * the partial sums for d go to the CTA that owns unit d, through
//     distributed shared memory (double-buffered slots, one per source
//     CTA), and after one cluster barrier the owner adds its four slots
//     in rank order: dh_{t-1} in one fixed order, no atomics, so a repeat
//     gives the same bits;
//   * one thread per unit runs the elementwise step above, with the next
//     step's saved values loaded ahead of use (one step of prefetch).
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

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;   // CTAs per (row, head)

template <int HD>
struct Geo {
  static constexpr int U = HD / kCluster;   // units per CTA
  static constexpr int kThreads = 2 * HD;   // one input x 2 halves
  static constexpr int kHalf = 2 * U;       // gate columns per thread
  static_assert(kHalf % 4 == 0, "four FMA chains");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// what one step of a unit reads: its saved pre-activations, its state
// after the step and before it, and the emitted h's gradient
struct StepIn {
  float gi, gf, gz, go, c_new, n_new, c_prev, n_prev, m_prev, dy;
};

template <int HD, typename TR>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(Geo<HD>::kThreads, 1)
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
  using G = Geo<HD>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int d = tid >> 1, half = tid & 1;
  __shared__ __align__(16) float dg_s[4 * G::U];
  __shared__ float recv[2][kCluster][G::U];

  // R[head, d, c] for this thread's half of the CTA's gate columns
  // (local column j = gate * U + unit within the CTA)
  float rw[G::kHalf];
  const TR* rp = r + ((size_t)head * HD + d) * (4 * HD);
#pragma unroll
  for (int i = 0; i < G::kHalf; ++i) {
    const int j = half * G::kHalf + i;
    rw[i] = to_f(rp[(j / G::U) * HD + rank * G::U + j % G::U]);
  }

  const bool owner = tid < G::U;               // one thread per unit
  const int unit = rank * G::U + tid;          // (owners only)
  const size_t sbase = ((size_t)b * H + head) * HD;
  float dc = 0.f, dn = 0.f, dm = 0.f, dh = 0.f;
  auto load_step = [&](int t) {
    StepIn s;
    const size_t bt = ((size_t)b * T + t) * H + head;
    const float* a = acts + bt * 4 * HD + unit;
    s.gi = a[0];
    s.gf = a[HD];
    s.gz = a[2 * HD];
    s.go = a[3 * HD];
    s.c_new = cs[bt * HD + unit];
    s.n_new = ns[bt * HD + unit];
    s.dy = dhs[bt * HD + unit];
    if (t > 0) {
      const size_t pv = (bt - H) * HD + unit;
      s.c_prev = cs[pv];
      s.n_prev = ns[pv];
      s.m_prev = ms[pv];
    } else {
      s.c_prev = c0[sbase + unit];
      s.n_prev = n0[sbase + unit];
      s.m_prev = m0[sbase + unit];
    }
    return s;
  };
  StepIn cur{};
  if (owner) {
    if (dc_t != nullptr) dc = dc_t[sbase + unit];
    if (dn_t != nullptr) dn = dn_t[sbase + unit];
    if (dm_t != nullptr) dm = dm_t[sbase + unit];
    if (dh_t != nullptr) dh = dh_t[sbase + unit];
    cur = load_step(T - 1);
  }
  cluster.sync();   // every CTA runs before any writes into its memory
  const unsigned full = 0xffffffffu;
  int nb = 0;
  for (int t = T - 1; t >= 0; --t) {
    if (owner) {
      const StepIn s = cur;
      if (t > 0) cur = load_step(t - 1);       // ahead of use
      const float a = __fadd_rn(s.gf, s.m_prev);
      const float m_new = fmaxf(a, s.gi);
      const float i_g = expf(__fsub_rn(s.gi, m_new));
      const float f_g = expf(__fsub_rn(a, m_new));
      const float tz = tanhf(s.gz), so = sigmoid_rn(s.go);
      const float den = fmaxf(fabsf(s.n_new), 1e-6f);
      const float dh_new = __fadd_rn(dh, s.dy);
      const float dgo = __fmul_rn(
          __fmul_rn(__fdiv_rn(__fmul_rn(dh_new, s.c_new), den), so),
          __fsub_rn(1.f, so));
      const float dc_new = __fadd_rn(dc, __fdiv_rn(__fmul_rn(dh_new, so),
                                                   den));
      const float w_abs = max_share(fabsf(s.n_new), 1e-6f);
      const float dn_new = __fsub_rn(
          dn, __fmul_rn(__fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(dh_new, so),
                                                      s.c_new),
                                            __fmul_rn(den, den)),
                                  sign_of(s.n_new)),
                        w_abs));
      const float df_g = __fadd_rn(__fmul_rn(dc_new, s.c_prev),
                                   __fmul_rn(dn_new, s.n_prev));
      const float di_g = __fadd_rn(__fmul_rn(dc_new, tz), dn_new);
      const float dgz = __fmul_rn(__fmul_rn(dc_new, i_g),
                                  __fsub_rn(1.f, __fmul_rn(tz, tz)));
      const float dm_tot = __fsub_rn(__fsub_rn(dm, __fmul_rn(di_g, i_g)),
                                     __fmul_rn(df_g, f_g));
      const float w_a = max_share(a, s.gi), w_i = max_share(s.gi, a);
      const float dgi = __fadd_rn(__fmul_rn(di_g, i_g),
                                  __fmul_rn(dm_tot, w_i));
      const float dgf = __fadd_rn(__fmul_rn(df_g, f_g),
                                  __fmul_rn(dm_tot, w_a));
      dm = dgf;
      dc = __fmul_rn(dc_new, f_g);
      dn = __fmul_rn(dn_new, f_g);
      dg_s[tid] = dgi;
      dg_s[G::U + tid] = dgf;
      dg_s[2 * G::U + tid] = dgz;
      dg_s[3 * G::U + tid] = dgo;
      float* out = dacts + (((size_t)b * T + t) * H + head) * 4 * HD + unit;
      out[0] = dgi;
      out[HD] = dgf;
      out[2 * HD] = dgz;
      out[3 * HD] = dgo;
    }
    __syncthreads();
    // R[d, CTA's columns] . dpre, this thread's half, then the pair's sum
    const float* gp = &dg_s[half * G::kHalf];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int i = 0; i < G::kHalf; i += 4) {
      const float4 gv = *reinterpret_cast<const float4*>(gp + i);
      a0 = __fmaf_rn(gv.x, rw[i], a0);
      a1 = __fmaf_rn(gv.y, rw[i + 1], a1);
      a2 = __fmaf_rn(gv.z, rw[i + 2], a2);
      a3 = __fmaf_rn(gv.w, rw[i + 3], a3);
    }
    const float part = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
    const float other = __shfl_xor_sync(full, part, 1);
    if (half == 0) {
      const float sum = __fadd_rn(part, other);
      *cluster.map_shared_rank(&recv[nb][rank][d % G::U], d / G::U) = sum;
    }
    cluster.sync();
    if (owner) {
      dh = __fadd_rn(__fadd_rn(__fadd_rn(recv[nb][0][tid], recv[nb][1][tid]),
                               recv[nb][2][tid]),
                     recv[nb][3][tid]);
    }
    nb ^= 1;
  }
  if (owner) {
    dc0[sbase + unit] = dc;
    dn0[sbase + unit] = dn;
    dh0[sbase + unit] = dh;
    dm0[sbase + unit] = dm;
  }
}

template <int HD, typename TR>
int launch(const void* r, const float* acts, const float* cs,
           const float* ns, const float* ms, const float* c0,
           const float* n0, const float* m0, const float* dhs,
           const float* dc_t, const float* dn_t, const float* dh_t,
           const float* dm_t, float* dacts, float* dc0, float* dn0,
           float* dh0, float* dm0, int B, int T, int H,
           cudaStream_t stream) {
  auto kern = slstm_bwd_kernel<HD, TR>;
  APEX_LAUNCH(kern, dim3(kCluster, H, B), dim3(Geo<HD>::kThreads), 0,
              stream, (const TR*)r, acts, cs, ns, ms, c0, n0, m0, dhs, dc_t,
              dn_t, dh_t, dm_t, dacts, dc0, dn0, dh0, dm0, T, H);
  return 0;
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
