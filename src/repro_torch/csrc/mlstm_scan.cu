// mLSTM recurrence for Hopper (sm_90a): the forward walk over T.
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
