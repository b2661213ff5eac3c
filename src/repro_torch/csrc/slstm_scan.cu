// sLSTM recurrence for Hopper (sm_90a): the forward walk over T.
//
// Replaces no Pallas kernel: the reference runs the recurrence as one
// `lax.scan` (src/repro/models/ssm.py:246, `slstm_forward`, over the cell
// `_slstm_cell` at :209), the port's plain version is a Python loop of
// ~15-20 PyTorch ops a step (kernels/ref.py `slstm_recurrence_ref`).  Per
// (row b, head j, step t), with gates_x the input contribution and R_j
// the head's recurrent gates (hd, 4 hd):
//   pre     = gates_x[b, t, j] + h_{t-1} R_j + bias_j      (i, f, z, o)
//   m_t     = max(f + m, i);  i_g = exp(i - m_t);  f_g = exp(f + m - m_t)
//   c_t     = f_g c + i_g tanh(z);  n_t = f_g n + i_g
//   h_t     = sigmoid(o) c_t / max(|n_t|, 1e-6)
// with the state (c, n, h, m) frozen past the row's valid length, and the
// frozen h emitted there (the reference's scan emits the masked h).
//
// What bounds it on an H100.  Each step needs the whole of h_{t-1} of the
// head before any unit can take its next step, so the walk is sequential
// in T and the time is the latency of a step: a (hd) x (hd, 4 hd)
// product (xlstm-125m: 192 x 768, 147k FMAs) and one exchange of h.  The
// bytes (gates_x read once, hs written once) are far below what the card
// moves in that time.  One head's R is 288 KB in bf16, more than an SM
// holds, so the design spreads a head over a thread-block cluster:
//   * a cluster of APEX_SLSTM_CLUSTER CTAs (4 or 8) per (row, head); CTA
//     q owns units [q U, (q+1) U), U = hd / cluster, and their 4 gates.
//     A thread owns one column of R and half of its hd inputs, converted
//     to fp32 once and kept in registers for the whole walk (hd/2 values:
//     96 at hd 192).  R arrives once per call: the CTA's columns are
//     copied into shared memory by cp.async (whole rows of U columns, in
//     16-byte pieces where U allows) and each thread moves its column
//     into registers from there (APEX_SLSTM_STAGE_R 0: strided loads from
//     device memory, the first design's way; 2: R handed over already
//     packed in the threads' order, [head][cta][input][thread], so each
//     load of a warp is 32 adjacent values -- a copy the caller would
//     make once per weight version);
//   * h_{t-1} sits in every CTA's shared memory (double-buffered); a step
//     is the thread's half-dot (four FMA chains over 16-byte broadcast
//     loads of h), the halves added across a lane pair, the gates of a
//     unit gathered by warp shuffles (a unit's 8 threads are neighbours),
//     the cell, and the new h sent to all CTAs of the cluster;
//   * the cell's lanes have roles (APEX_SLSTM_ROLES 1): with i and f
//     shuffled to every lane for m_t, one lane computes exp(i - m_t), one
//     exp(f + m - m_t), one tanh(z) and one sigmoid(o), and four shuffles
//     pass them on; each expression keeps its form, so its bits are the
//     same as when every lane computes all four (APEX_SLSTM_ROLES 0);
//   * the exchange (APEX_SLSTM_EXCHANGE 1) has no cluster barrier in the
//     step loop.  Each CTA's two h buffers have one mbarrier each; a
//     unit's writer lane stores its h into every CTA's next buffer with
//     st.async, which completes 4 bytes of the receiver's mbarrier
//     transaction; one thread of the receiver arms the barrier for hd x 4
//     bytes a phase, and every thread waits (acquire, cluster scope) on
//     the buffer it reads next.  Two buffers suffice: a CTA writes buffer
//     b at step t+1 only after it has received every unit's step-t h,
//     and each unit sends that only after its warp's step-t reads of b;
//     the barrier's phase for step t+1's data therefore opens only after
//     the step-t phase has completed at the receiver.  The last step
//     sends nothing, and one cluster barrier ends the call.
//     (APEX_SLSTM_EXCHANGE 0: distributed shared memory stores and one
//     cluster barrier a step, the first design's way);
//   * gates_x for this CTA's columns arrives by 16-byte cp.async in tiles
//     of 16 steps, double-buffered, ahead of use;
//   * sequential in T with every sum in one fixed order and written with
//     round-to-nearest intrinsics: a step's bits do not depend on where
//     a call starts or how long it is, so a call split in T with the
//     state carried equals one call, and a row of length 0 keeps its
//     state bit for bit.  A row stops at its length (every CTA of its
//     cluster alike) and writes its frozen h over the rest of hs;
//   * no tensor cores: the reference multiplies h (fp32) by R in fp32
//     (exact on bf16 weights), which bf16 or TF32 operands would round.
// With `acts` (training) it also writes every step's gate pre-activations
// and state (c, n, m), which the backward walks in reverse.
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

#ifndef APEX_SLSTM_CLUSTER
#define APEX_SLSTM_CLUSTER 8
#endif
#ifndef APEX_SLSTM_EXCHANGE
#define APEX_SLSTM_EXCHANGE 1
#endif
#ifndef APEX_SLSTM_ROLES
#define APEX_SLSTM_ROLES 0
#endif
#ifndef APEX_SLSTM_STAGE_R
#define APEX_SLSTM_STAGE_R 1
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kTileT = 16;    // steps of gates_x per staged tile
constexpr bool kMbar = APEX_SLSTM_EXCHANGE != 0;
constexpr bool kRoles = APEX_SLSTM_ROLES != 0;
constexpr int kRLoad = APEX_SLSTM_STAGE_R;   // 0 strided, 1 staged, 2 packed

template <int HD, typename TR>
struct Geo {
  // the asked cluster where its CTAs keep 16-byte staging, else 4
  static constexpr int kCl =
      (HD / APEX_SLSTM_CLUSTER) % 4 == 0 ? APEX_SLSTM_CLUSTER : 4;
  static constexpr int U = HD / kCl;        // units per CTA
  static constexpr int kThreads = 8 * U;    // 4 gates x 2 halves a unit
  static constexpr int kHalf = HD / 2;      // inputs per thread
  static constexpr int kCols = 4 * U;       // gate columns per CTA
  // R's staged copy: HD rows of the CTA's 4 U columns
  static constexpr int kSegB = U * (int)sizeof(TR);
  static constexpr int kPiece = kSegB % 16 == 0 ? 16 : (kSegB % 8 == 0 ? 8 : 4);
  static constexpr size_t kRBytes = kRLoad == 1
                                        ? (size_t)HD * kCols * sizeof(TR)
                                            : 0;
  static_assert(U % 4 == 0 && kHalf % 4 == 0, "16-byte staging");
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
// address)
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

// One step of a unit, as the plain version writes it, every lane alike.
__device__ __forceinline__ void slstm_cell(float gi, float gf, float gz,
                                           float go, float& c, float& n,
                                           float& h, float& m) {
  const float a = __fadd_rn(gf, m);
  const float m_new = fmaxf(a, gi);
  const float i_g = expf(__fsub_rn(gi, m_new));
  const float f_g = expf(__fsub_rn(a, m_new));
  const float c_new =
      __fadd_rn(__fmul_rn(f_g, c), __fmul_rn(i_g, tanhf(gz)));
  const float n_new = __fadd_rn(__fmul_rn(f_g, n), i_g);
  h = __fdiv_rn(__fmul_rn(sigmoid_rn(go), c_new),
                fmaxf(fabsf(n_new), 1e-6f));
  c = c_new;
  n = n_new;
  m = m_new;
}

// The same step with roles: lane g of the unit (base + 2 g) computes gate
// g's transcendental, the shuffles pass them on.
__device__ __forceinline__ void slstm_cell_roles(float pre, int g, int base,
                                                 float& c, float& n,
                                                 float& h, float& m) {
  const unsigned full = 0xffffffffu;
  const float gi = __shfl_sync(full, pre, base + 0);
  const float gf = __shfl_sync(full, pre, base + 2);
  const float a = __fadd_rn(gf, m);
  const float m_new = fmaxf(a, gi);
  float x;
  if (g == 2) {
    x = tanhf(pre);
  } else {
    x = expf(g == 0 ? __fsub_rn(gi, m_new)
                    : (g == 1 ? __fsub_rn(a, m_new) : -pre));
    if (g == 3) x = __fdiv_rn(1.f, __fadd_rn(1.f, x));
  }
  const float i_g = __shfl_sync(full, x, base + 0);
  const float f_g = __shfl_sync(full, x, base + 2);
  const float tz = __shfl_sync(full, x, base + 4);
  const float so = __shfl_sync(full, x, base + 6);
  const float c_new = __fadd_rn(__fmul_rn(f_g, c), __fmul_rn(i_g, tz));
  const float n_new = __fadd_rn(__fmul_rn(f_g, n), i_g);
  h = __fdiv_rn(__fmul_rn(so, c_new), fmaxf(fabsf(n_new), 1e-6f));
  c = c_new;
  n = n_new;
  m = m_new;
}

template <int HD, typename TR>
__global__ void __launch_bounds__(Geo<HD, TR>::kThreads, 1)
    slstm_scan_kernel(const float* __restrict__ gx,
                      const TR* __restrict__ r,
                      const float* __restrict__ bias,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ h0,
                      const float* __restrict__ m0,
                      const int* __restrict__ lens, float* __restrict__ hs,
                      float* __restrict__ c_out, float* __restrict__ n_out,
                      float* __restrict__ h_out, float* __restrict__ m_out,
                      float* __restrict__ acts, float* __restrict__ cs,
                      float* __restrict__ ns, float* __restrict__ ms,
                      int T, int H) {
  using G = Geo<HD, TR>;
  constexpr int CL = G::kCl;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int u = tid >> 3, g = (tid >> 1) & 3, half = tid & 1;
  const int unit = rank * G::U + u;            // within the head
  const int col = g * HD + unit;               // within the head's 4 hd
  __shared__ __align__(16) float h_s[2][HD];
  __shared__ __align__(16) float gx_s[2][kTileT][G::kCols];
  __shared__ __align__(8) unsigned long long bar[2];
  extern __shared__ __align__(16) unsigned char r_s[];

  // this thread's column of R over its half of the inputs, in fp32
  float rw[G::kHalf];
  const TR* rh = r + (size_t)head * HD * (4 * HD);
  if constexpr (kRLoad == 1) {
    // the CTA's 4 U columns of every row, whole rows of U at a time
    constexpr int kPer = G::kSegB / G::kPiece;   // pieces a segment
    TR* rs = reinterpret_cast<TR*>(r_s);
    for (int j = tid; j < HD * 4 * kPer; j += G::kThreads) {
      const int row = j / (4 * kPer), rem = j % (4 * kPer);
      const int gg = rem / kPer, pc = rem % kPer;
      cp_async_n<G::kPiece>(
          reinterpret_cast<unsigned char*>(rs + row * G::kCols + gg * G::U)
              + pc * G::kPiece,
          reinterpret_cast<const unsigned char*>(
              rh + (size_t)row * 4 * HD + gg * HD + rank * G::U)
              + pc * G::kPiece);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G::kHalf; ++i)
      rw[i] = to_f(rs[(half * G::kHalf + i) * G::kCols + g * G::U + u]);
  } else if constexpr (kRLoad == 2) {
    const TR* rp = rh + (size_t)rank * G::kHalf * G::kThreads + tid;
#pragma unroll
    for (int i = 0; i < G::kHalf; ++i)
      rw[i] = to_f(rp[(size_t)i * G::kThreads]);
  } else {
    const TR* rp = rh + (size_t)half * G::kHalf * (4 * HD) + col;
#pragma unroll
    for (int i = 0; i < G::kHalf; ++i)
      rw[i] = to_f(rp[(size_t)i * 4 * HD]);
  }
  const float bcol = bias[head * 4 * HD + col];

  const size_t sbase = ((size_t)b * H + head) * HD;
  float c = c0[sbase + unit], n = n0[sbase + unit];
  float h = h0[sbase + unit], m = m0[sbase + unit];
  for (int i = tid; i < HD; i += G::kThreads) h_s[0][i] = h0[sbase + i];
  const int steps = lens != nullptr ? min(max(lens[b], 0), T) : T;
  const size_t row_floats = (size_t)4 * H * HD;   // gates_x per (b, t)
  const float* gxb =
      gx + (size_t)b * T * row_floats + (size_t)head * 4 * HD + rank * G::U;
  const unsigned bar0 = smem_addr(&bar[0]);
  if (kMbar && tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(bar0, HD * 4);       // each buffer's first phase
    mbar_arm(bar0 + 8, HD * 4);
  }
  // the unit's h slot and the barriers, in every CTA of the cluster
  unsigned peer_h[CL], peer_bar[CL];
  if (kMbar) {
#pragma unroll
    for (int q = 0; q < CL; ++q) {
      peer_h[q] = cluster_addr(smem_addr(&h_s[0][unit]), q);
      peer_bar[q] = cluster_addr(bar0, q);
    }
  }

  // tile k of this CTA's gate columns: per step 4 segments of U floats
  auto stage = [&](int k, int buf) {
    const int t0 = k * kTileT;
    const int rows = min(kTileT, steps - t0);
    for (int j = tid; j < rows * G::U; j += G::kThreads) {
      const int row = j / G::U, rem = j % G::U;
      const int gg = rem / (G::U / 4), q4 = rem % (G::U / 4);
      cp_async16(&gx_s[buf][row][gg * G::U + 4 * q4],
                 gxb + (size_t)(t0 + row) * row_floats + gg * HD + 4 * q4);
    }
    cp_async_commit();
  };

  const int ntiles = (steps + kTileT - 1) / kTileT;
  if (ntiles > 0) stage(0, 0);
  cluster.sync();   // every CTA runs (and its barriers are set up)
  int cur = 0;
  unsigned parity[2] = {0u, 0u};
  const unsigned full = 0xffffffffu;
  const int base = (tid & 31) & ~7;            // the unit's first lane
  for (int k = 0; k < ntiles; ++k) {
    if (k + 1 < ntiles) {
      stage(k + 1, (k + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(kTileT, steps - k * kTileT);
    for (int s = 0; s < rows; ++s) {
      const int t = k * kTileT + s;
      if (kMbar && t > 0) {
        mbar_wait(bar0 + 8 * cur, parity[cur]);
        parity[cur] ^= 1u;
        if (tid == 0) mbar_arm(bar0 + 8 * cur, HD * 4);   // its next phase
      }
      const float* hp = &h_s[cur][half * G::kHalf];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int i = 0; i < G::kHalf; i += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hp + i);
        a0 = __fmaf_rn(hv.x, rw[i], a0);
        a1 = __fmaf_rn(hv.y, rw[i + 1], a1);
        a2 = __fmaf_rn(hv.z, rw[i + 2], a2);
        a3 = __fmaf_rn(hv.w, rw[i + 3], a3);
      }
      const float part = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
      const float other = __shfl_xor_sync(full, part, 1);
      const float rec = half == 0 ? __fadd_rn(part, other)
                                  : __fadd_rn(other, part);
      const float pre =
          __fadd_rn(__fadd_rn(gx_s[k & 1][s][g * G::U + u], rec), bcol);
      if constexpr (kRoles) {
        slstm_cell_roles(pre, g, base, c, n, h, m);
      } else {
        const float gi = __shfl_sync(full, pre, base + 0);
        const float gf = __shfl_sync(full, pre, base + 2);
        const float gz = __shfl_sync(full, pre, base + 4);
        const float go = __shfl_sync(full, pre, base + 6);
        slstm_cell(gi, gf, gz, go, c, n, h, m);
      }
      const size_t bt = ((size_t)b * T + t) * H + head;
      if (acts != nullptr && half == 0) acts[bt * 4 * HD + col] = pre;
      if (g == 0 && half == 0) {
        hs[bt * HD + unit] = h;
        if (cs != nullptr) {
          cs[bt * HD + unit] = c;
          ns[bt * HD + unit] = n;
          ms[bt * HD + unit] = m;
        }
        if (kMbar) {
          if (t + 1 < steps) {
            const unsigned off = (unsigned)((cur ^ 1) * HD * sizeof(float));
#pragma unroll
            for (int q = 0; q < CL; ++q)
              st_async(peer_h[q] + off, h, peer_bar[q] + 8 * (cur ^ 1));
          }
        } else {
#pragma unroll
          for (int q = 0; q < CL; ++q)
            *cluster.map_shared_rank(&h_s[cur ^ 1][unit], q) = h;
        }
      }
      if (!kMbar) cluster.sync();
      cur ^= 1;
    }
  }
  if (g == 0 && half == 0) {
    for (int t = steps; t < T; ++t)
      hs[(((size_t)b * T + t) * H + head) * HD + unit] = h;
    c_out[sbase + unit] = c;
    n_out[sbase + unit] = n;
    h_out[sbase + unit] = h;
    m_out[sbase + unit] = m;
  }
  if (kMbar) cluster.sync();   // no CTA leaves while a peer may store to it
}

template <int HD, typename TR>
int launch(const float* gx, const void* r, const float* bias,
           const float* c0, const float* n0, const float* h0,
           const float* m0, const int* lens, float* hs, float* c_out,
           float* n_out, float* h_out, float* m_out, float* acts, float* cs,
           float* ns, float* ms, int B, int T, int H, cudaStream_t stream) {
  using G = Geo<HD, TR>;
  auto kern = slstm_scan_kernel<HD, TR>;
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
  return (int)cudaLaunchKernelEx(&cfg, kern, gx, (const TR*)r, bias, c0, n0,
                                 h0, m0, lens, hs, c_out, n_out, h_out,
                                 m_out, acts, cs, ns, ms, T, H);
}

template <typename TR>
int dispatch(int HD, const float* gx, const void* r, const float* bias,
             const float* c0, const float* n0, const float* h0,
             const float* m0, const int* lens, float* hs, float* c_out,
             float* n_out, float* h_out, float* m_out, float* acts,
             float* cs, float* ns, float* ms, int B, int T, int H,
             cudaStream_t st) {
  switch (HD) {
    case 16:
      return launch<16, TR>(gx, r, bias, c0, n0, h0, m0, lens, hs, c_out,
                            n_out, h_out, m_out, acts, cs, ns, ms, B, T, H,
                            st);
    case 32:
      return launch<32, TR>(gx, r, bias, c0, n0, h0, m0, lens, hs, c_out,
                            n_out, h_out, m_out, acts, cs, ns, ms, B, T, H,
                            st);
    case 64:
      return launch<64, TR>(gx, r, bias, c0, n0, h0, m0, lens, hs, c_out,
                            n_out, h_out, m_out, acts, cs, ns, ms, B, T, H,
                            st);
    case 192:
      return launch<192, TR>(gx, r, bias, c0, n0, h0, m0, lens, hs, c_out,
                            n_out, h_out, m_out, acts, cs, ns, ms, B, T, H,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int apex_slstm_scan(const void* gates_x, const void* r,
                               int r_bf16, const void* bias, const void* c0,
                               const void* n0, const void* h0,
                               const void* m0, const void* lens, void* hs,
                               void* c_out, void* n_out, void* h_out,
                               void* m_out, void* acts, void* cs, void* ns,
                               void* ms, int B, int T, int H, int HD,
                               void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((acts == nullptr) != (cs == nullptr) || (cs == nullptr) != (ns == nullptr)
      || (ns == nullptr) != (ms == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)gates_x % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)gates_x;
  const float* bi = (const float*)bias;
  const float *c = (const float*)c0, *n = (const float*)n0;
  const float *h = (const float*)h0, *m = (const float*)m0;
  const int* ln = (const int*)lens;
  float *o = (float*)hs, *co = (float*)c_out, *no = (float*)n_out;
  float *ho = (float*)h_out, *mo = (float*)m_out;
  float *a = (float*)acts, *cq = (float*)cs, *nq = (float*)ns;
  float* mq = (float*)ms;
  const int rc =
      r_bf16 ? dispatch<__nv_bfloat16>(HD, g, r, bi, c, n, h, m, ln, o, co,
                                       no, ho, mo, a, cq, nq, mq, B, T, H, st)
             : dispatch<float>(HD, g, r, bi, c, n, h, m, ln, o, co, no, ho,
                               mo, a, cq, nq, mq, B, T, H, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
