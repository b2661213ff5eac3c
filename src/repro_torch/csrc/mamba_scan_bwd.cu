// Backward of the Mamba-1 selective scan for Hopper (sm_90a).
//
// The gradient of the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (`mamba_selective_scan` / `_scan_kernel`) that mamba_scan.cu replaces.
// The TPU kernel has no backward: the reference trains through JAX
// autodiff of its `lax.scan`.  The forward, per (row, channel i, state n):
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t b_t,   y_t = c_t . h_t + D x_t
// over every step (no lens: the stateless forward has none).  Given dy
// (B, T, I) and the gradient of the final state (or none), a reverse scan
//   g_t = c_t dy_t + exp(dt_{t+1} A) g_{t+1}        (g = dL/dh_t)
// gives per step ddt = sum_n g (A exp(dt A) h_{t-1} + x b), dx = D dy +
// dt sum_n g b, db_t = sum_i g dt x, dc_t = sum_i dy h_t, and over (B, T)
// dA = sum g dt exp(dt A) h_{t-1}, dD = sum dy x; dh0 = exp(dt_0 A) g_0.
// Inputs fp32 (the model passes fp32 to the scan), outputs fp32.
//
// h_{t-1} is needed in reverse order.  All of h is (B, T, I, N): 2.1 GB
// fp32 per layer at Jamba's published width (I 16384, N 16) for B*T 2048
// tokens, so it is not kept.  Instead each lane first runs the forward
// over T and writes its state at the start of every chunk of kChunk
// steps (B * T/8 * I * N * 4 bytes: 134 MB at B 1, T 1024 of Jamba,
// scratch for one call); the reverse pass then recomputes each chunk's
// eight states and exp(dt A) factors from its checkpoint into registers
// and walks them backwards.  exp() is computed twice per (t, i, n), the
// forward's count twice over; the reverse steps take none.
//
// What bounds it on an H100: the same as the forward -- B*T*I*N exp()
// calls (two passes here) on the special function units and the
// instructions around them, against 4 bytes each of dt, x, dy read (twice
// for dt and x) and ddt, dx written per (b, t, i).  The design:
//   * the forward kernel's lane layout: a lane keeps S = 8 consecutive
//     states of one (row, channel), L = N / S lanes share a channel, a CTA
//     of 128 threads takes C = 128 / L channels of one row;
//   * per step, ddt and dx are sums over the lane's S states, then across
//     the L lanes by __shfl_xor_sync;
//   * db and dc are sums over the I channels of every CTA: each lane
//     writes its S terms of a chunk to shared memory, the CTA sums its C
//     channels in a fixed order after the chunk, and writes one partial
//     per (row, channel block, t, n); a second kernel adds the channel
//     blocks in order.  dA and dD stay in registers over T and are
//     written per row; the second kernel adds the rows in order.  No
//     atomics: the same inputs give the same bits.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing (the wrapper passes the
// checkpoint and partial-sum scratch), and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 128;  // threads per CTA (4 warps)
constexpr int kStates = 8;     // states of one channel per lane (S)
constexpr int kChunk = 8;      // steps between checkpoints of h

template <int N>
struct Geo {
  static constexpr int S = kStates < N ? kStates : N;  // states per lane
  static constexpr int L = N / S;                      // lanes per channel
  static constexpr int C = kThreads / L;               // channels per CTA
  static constexpr int RP = 2 * N + 1;                 // db|dc pitch, padded
  static_assert(S % 4 == 0 && N % S == 0 && 32 % L == 0,
                "lanes must tile a warp with 16-byte state vectors");
  __host__ __device__ static constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)kChunk * C * RP;
  }
};

template <int S>
__device__ __forceinline__ void load_s(const float* p, float* out) {
#pragma unroll
  for (int k = 0; k < S / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(p)[k];
    out[4 * k] = v.x;
    out[4 * k + 1] = v.y;
    out[4 * k + 2] = v.z;
    out[4 * k + 3] = v.w;
  }
}
template <int S>
__device__ __forceinline__ void store_s(float* p, const float* v) {
#pragma unroll
  for (int k = 0; k < S / 4; ++k)
    reinterpret_cast<float4*>(p)[k] =
        make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                    const float* __restrict__ bmat,
                    const float* __restrict__ cmat,
                    const float* __restrict__ a_neg,
                    const float* __restrict__ d_skip,
                    const float* __restrict__ h0,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_final,
                    float* __restrict__ ckpt, float* __restrict__ ddt,
                    float* __restrict__ dx, float* __restrict__ part_bc,
                    float* __restrict__ part_a, float* __restrict__ part_d,
                    float* __restrict__ dh0, int Tlen, int I) {
  using G = Geo<N>;
  constexpr int S = G::S;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [kChunk][C][2N + 1]
  const int row = blockIdx.y;
  const int blk = blockIdx.x;
  const int ch = threadIdx.x / G::L;
  const int part = threadIdx.x % G::L;
  const int i = blk * G::C + ch;
  const bool active = i < I;
  const int n_chunks = (Tlen + kChunk - 1) / kChunk;
  const size_t state = ((size_t)row * I + i) * N + part * S;

  float a[S], h[S];
  float dsk = 0.f;
  if (active) {
    load_s<S>(a_neg + (size_t)i * N + part * S, a);
    load_s<S>(h0 + state, h);
    dsk = d_skip[i];
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = h[s] = 0.f;
  }

  // 1. the forward over T, h kept at the start of every chunk
  if (active) {
    for (int t = 0; t < Tlen; ++t) {
      if (t % kChunk == 0)
        store_s<S>(ckpt + (((size_t)row * n_chunks + t / kChunk) * I + i) *
                              N + part * S, h);
      const size_t at = ((size_t)row * Tlen + t) * I + i;
      const float dtv = dt[at], dbx = dtv * x[at];
      const float* bt = bmat + ((size_t)row * Tlen + t) * N + part * S;
#pragma unroll
      for (int s = 0; s < S; ++s)
        h[s] = fmaf(expf(dtv * a[s]), h[s], dbx * bt[s]);
    }
  }

  // 2. the reverse scan, chunk by chunk from the end
  float g[S], da_acc[S];
  float dd_acc = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) da_acc[s] = 0.f;
  if (active && dh_final != nullptr) {
    load_s<S>(dh_final + state, g);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) g[s] = 0.f;
  }
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int nt = min(kChunk, Tlen - t0);
    float hs[kChunk + 1][S], da[kChunk][S], dts[kChunk], xs[kChunk];
    if (active)
      load_s<S>(ckpt + (((size_t)row * n_chunks + k) * I + i) * N + part * S,
                hs[0]);
    else
#pragma unroll
      for (int s = 0; s < S; ++s) hs[0][s] = 0.f;
    // recompute the chunk's states h_{t0}..h_{t0+nt-1} as hs[1..nt]
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const bool live = active && tt < nt;
      const size_t at = ((size_t)row * Tlen + t0 + tt) * I + i;
      dts[tt] = live ? dt[at] : 0.f;
      xs[tt] = live ? x[at] : 0.f;
      const float dbx = dts[tt] * xs[tt];
      const float* bt = bmat + ((size_t)row * Tlen + t0 + min(tt, nt - 1)) *
                                   N + part * S;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        da[tt][s] = live ? expf(dts[tt] * a[s]) : 0.f;
        hs[tt + 1][s] = live ? fmaf(da[tt][s], hs[tt][s], dbx * bt[s])
                             : hs[tt][s];
      }
    }
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      if (tt < nt) {  // the same for the whole CTA
        const int t = t0 + tt;
        const size_t at = ((size_t)row * Tlen + t) * I + i;
        const float dyv = active ? dy[at] : 0.f;
        const float* bt = bmat + ((size_t)row * Tlen + t) * N + part * S;
        const float* ct = cmat + ((size_t)row * Tlen + t) * N + part * S;
        const float dbx = dts[tt] * xs[tt];
        float* rw = red + ((size_t)tt * G::C + ch) * G::RP + part * S;
        float ddt_p = 0.f, dx_p = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float bv = bt[s];
          g[s] = fmaf(ct[s], dyv, g[s]);           // dL/dh_t
          rw[s] = g[s] * dbx;                      // db_t, this channel
          rw[N + s] = dyv * hs[tt + 1][s];         // dc_t, this channel
          const float dah = da[tt][s] * hs[tt][s];
          ddt_p = fmaf(g[s], fmaf(a[s], dah, xs[tt] * bv), ddt_p);
          dx_p = fmaf(g[s], bv, dx_p);
          da_acc[s] = fmaf(g[s] * dts[tt], dah, da_acc[s]);
          g[s] *= da[tt][s];                       // into dL/dh_{t-1}
        }
#pragma unroll
        for (int off = 1; off < G::L; off *= 2) {
          ddt_p += __shfl_xor_sync(0xffffffffu, ddt_p, off);
          dx_p += __shfl_xor_sync(0xffffffffu, dx_p, off);
        }
        if (active && part == 0) {
          ddt[at] = ddt_p;
          dx[at] = fmaf(dts[tt], dx_p, dsk * dyv);
          dd_acc = fmaf(dyv, xs[tt], dd_acc);
        }
      }
    }
    __syncthreads();
    // db and dc of the chunk, summed over the CTA's channels in order
    for (int o = threadIdx.x; o < nt * 2 * N; o += kThreads) {
      const int tt = o / (2 * N), n2 = o % (2 * N);
      const float* col = red + (size_t)tt * G::C * G::RP + n2;
      float sum = 0.f;
      for (int c = 0; c < G::C; ++c) sum += col[(size_t)c * G::RP];
      part_bc[(((size_t)row * gridDim.x + blk) * Tlen + t0 + tt) * 2 * N +
              n2] = sum;
    }
    __syncthreads();  // red is free for the next chunk
  }

  if (active) {
    store_s<S>(dh0 + state, g);
    store_s<S>(part_a + state, da_acc);
    if (part == 0) part_d[(size_t)row * I + i] = dd_acc;
  }
}

// db, dc (B, T, N) over the channel blocks; dA (I, N) and dD (I,) over
// the rows; each sum in a fixed order
__global__ void __launch_bounds__(256)
    scan_bwd_reduce(const float* __restrict__ part_bc,
                    const float* __restrict__ part_a,
                    const float* __restrict__ part_d, float* __restrict__ db,
                    float* __restrict__ dc, float* __restrict__ da,
                    float* __restrict__ dd, int B, int Tlen, int I, int N,
                    int nblk) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_bc = (size_t)B * Tlen * 2 * N;
  const size_t n_a = (size_t)I * N;
  if (idx < n_bc) {
    const size_t bt = idx / (2 * N);
    const int n2 = (int)(idx % (2 * N));
    const size_t b = bt / Tlen, t = bt % Tlen;
    float sum = 0.f;
    for (int k = 0; k < nblk; ++k)
      sum += part_bc[((b * nblk + k) * Tlen + t) * 2 * N + n2];
    if (n2 < N)
      db[bt * N + n2] = sum;
    else
      dc[bt * N + n2 - N] = sum;
  } else if (idx < n_bc + n_a) {
    const size_t j = idx - n_bc;
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum += part_a[(size_t)b * n_a + j];
    da[j] = sum;
  } else if (idx < n_bc + n_a + I) {
    const size_t j = idx - n_bc - n_a;
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum += part_d[(size_t)b * I + j];
    dd[j] = sum;
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* b, const float* c,
           const float* a_neg, const float* d_skip, const float* h0,
           const float* dy, const float* dh_final, float* ckpt, float* ddt,
           float* dx, float* db, float* dc, float* da, float* dd, float* dh0,
           float* part_bc, float* part_a, float* part_d, int B, int Tlen,
           int I, cudaStream_t stream) {
  using G = Geo<N>;
  auto kern = scan_bwd_kernel<N>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::smem_bytes());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int nblk = (I + G::C - 1) / G::C;
  APEX_LAUNCH(kern, dim3(nblk, B), dim3(kThreads), G::smem_bytes(), stream,
              dt, x, b, c, a_neg, d_skip, h0, dy, dh_final, ckpt, ddt, dx,
              part_bc, part_a, part_d, dh0, Tlen, I);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t total = (size_t)B * Tlen * 2 * N + (size_t)I * N + I;
  APEX_LAUNCH(scan_bwd_reduce, dim3((unsigned)((total + 255) / 256)),
              dim3(256), 0, stream, part_bc, part_a, part_d, db, dc, da, dd,
              B, Tlen, I, N, nblk);
  return 0;
}

}  // namespace

// Scratch the caller allocates: ckpt (B, ceil(T / 8), I, N), part_bc
// (B, ceil(I / C), T, 2N) with C = 128 / (N / 8) channels per block,
// part_a (B, I, N), part_d (B, I), all fp32.
extern "C" int apex_mamba_scan_bwd_channels(int N) {
  return N == 8 ? Geo<8>::C : N == 16 ? Geo<16>::C : 0;
}

extern "C" int apex_mamba_scan_bwd_chunk() { return kChunk; }

extern "C" int apex_mamba_scan_bwd(
    const void* dt, const void* x, const void* b, const void* c,
    const void* a_neg, const void* d_skip, const void* h0, const void* dy,
    const void* dh_final, void* ckpt, void* part_bc, void* part_a,
    void* part_d, void* ddt, void* dx, void* db, void* dc, void* da,
    void* dd, void* dh0, int B, int T, int I, int N, void* stream) {
  if (B <= 0 || T <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  // the states move as 16-byte vectors
  if (((uintptr_t)a_neg | (uintptr_t)h0 | (uintptr_t)dh_final |
       (uintptr_t)ckpt | (uintptr_t)part_a | (uintptr_t)dh0) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
  switch (N) {
    case 8:
      rc = launch<8>((const float*)dt, (const float*)x, (const float*)b,
                     (const float*)c, (const float*)a_neg,
                     (const float*)d_skip, (const float*)h0,
                     (const float*)dy, (const float*)dh_final, (float*)ckpt,
                     (float*)ddt, (float*)dx, (float*)db, (float*)dc,
                     (float*)da, (float*)dd, (float*)dh0, (float*)part_bc,
                     (float*)part_a, (float*)part_d, B, T, I, st);
      break;
    case 16:
      rc = launch<16>((const float*)dt, (const float*)x, (const float*)b,
                      (const float*)c, (const float*)a_neg,
                      (const float*)d_skip, (const float*)h0,
                      (const float*)dy, (const float*)dh_final, (float*)ckpt,
                      (float*)ddt, (float*)dx, (float*)db, (float*)dc,
                      (float*)da, (float*)dd, (float*)dh0, (float*)part_bc,
                      (float*)part_a, (float*)part_d, B, T, I, st);
      break;
    default:
      break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
