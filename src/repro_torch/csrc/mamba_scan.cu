// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (`mamba_selective_scan` / `_scan_kernel`):
//   h_new = exp(dt * A) * h + (dt * x) * b
//   y_t   = sum_N(h_new * c) + D * x
// with the carry frozen past each row's valid length (h advances only
// while t < lens[b]) while y_t is still taken from the pre-freeze h_new,
// exactly as the TPU kernel does.  Outputs y (B, T, I) and h_final
// (B, I, N) are fp32 whatever the input dtype.
//
// What bounds it on an H100: bytes, with the SFU close behind.  Each
// (b, t, i) reads dt and x and writes y once (12 bytes in fp32) and takes
// N exp() calls; at N = 16 and fp32 inputs the byte time and the exp time
// at 16 SFU results per SM per clock are about equal.  The design
// therefore reads every byte once and keeps the state out of memory:
//   * one thread per (b, i) channel holds its N fp32 states and its row
//     of A in registers and walks T; the state never leaves the chip;
//   * neighbouring threads take neighbouring i, so the loads of
//     dt[b,t,i], x[b,t,i] and the store of y[b,t,i] coalesce;
//   * b[b,t,:] and c[b,t,:] are the same for every thread of a block:
//     a T-tile of them is staged in shared memory once per block;
//   * grid (ceil(I / 128), B); the last block masks a ragged I.
// Simple first version: sequential in T (no chunked parallel scan), no
// cp.async staging.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().  h_final may alias h0: each thread reads its own
// h0 slice before it writes the same slice of h_final.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTileT = 32;     // time steps of b, c staged per tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                      const T* __restrict__ bmat, const T* __restrict__ cmat,
                      const float* __restrict__ a_neg,
                      const float* __restrict__ d_skip, const float* h0,
                      const int* __restrict__ lens, float* __restrict__ y,
                      float* h_final, int Tlen, int I) {
  __shared__ float sb[kTileT][N];
  __shared__ float sc[kTileT][N];
  const int bi = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < I;
  const int len = lens != nullptr ? lens[bi] : Tlen;

  float a[N], h[N];
  float dsk = 0.f;
  if (active) {
    const float* arow = a_neg + (size_t)i * N;
    const float* hrow = h0 + ((size_t)bi * I + i) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a[n] = arow[n];
      h[n] = hrow[n];
    }
    dsk = d_skip[i];
  }

  const size_t row_ti = (size_t)bi * Tlen;  // (b, t=0) row of (B, T, .)
  for (int t0 = 0; t0 < Tlen; t0 += kTileT) {
    const int nt = min(kTileT, Tlen - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < nt * N; k += kThreads) {
      const size_t src = (row_ti + t0) * N + k;
      sb[k / N][k % N] = to_float(bmat[src]);
      sc[k / N][k % N] = to_float(cmat[src]);
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const int t = t0 + tt;
      const size_t off = (row_ti + t) * I + i;
      const float dtv = to_float(dt[off]);
      const float xv = to_float(x[off]);
      const float dbx = dtv * xv;
      const bool keep = t < len;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float hn = expf(dtv * a[n]) * h[n] + dbx * sb[tt][n];
        acc += hn * sc[tt][n];
        h[n] = keep ? hn : h[n];
      }
      y[off] = acc + dsk * xv;
    }
  }

  if (active) {
    float* hrow = h_final + ((size_t)bi * I + i) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hrow[n] = h[n];
  }
}

template <int N, typename T>
int launch(const void* dt, const void* x, const void* b, const void* c,
           const float* a_neg, const float* d_skip, const float* h0,
           const int* lens, float* y, float* h_final, int B, int Tlen, int I,
           cudaStream_t stream) {
  const dim3 grid((I + kThreads - 1) / kThreads, B);
  auto kern = mamba_scan_kernel<N, T>;
  APEX_LAUNCH(kern, grid, dim3(kThreads), 0, stream, (const T*)dt,
              (const T*)x, (const T*)b, (const T*)c, a_neg, d_skip, h0, lens,
              y, h_final, Tlen, I);
  return 0;
}

template <typename T>
int dispatch(const void* dt, const void* x, const void* b, const void* c,
             const float* a_neg, const float* d_skip, const float* h0,
             const int* lens, float* y, float* h_final, int B, int Tlen,
             int I, int N, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<8, T>(dt, x, b, c, a_neg, d_skip, h0, lens, y, h_final,
                          B, Tlen, I, stream);
    case 16:
      return launch<16, T>(dt, x, b, c, a_neg, d_skip, h0, lens, y, h_final,
                           B, Tlen, I, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" int apex_mamba_scan(const void* dt, const void* x, const void* b,
                               const void* c, const void* a_neg,
                               const void* d_skip, const void* h0,
                               const void* lens, void* y, void* h_final,
                               int B, int T, int I, int N, int in_bf16,
                               void* stream) {
  if (B <= 0 || T <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* an = (const float*)a_neg;
  const float* ds = (const float*)d_skip;
  const float* hi = (const float*)h0;
  const int* ln = (const int*)lens;
  float* yo = (float*)y;
  float* ho = (float*)h_final;
  const int rc =
      in_bf16 ? dispatch<__nv_bfloat16>(dt, x, b, c, an, ds, hi, ln, yo, ho,
                                        B, T, I, N, st)
              : dispatch<float>(dt, x, b, c, an, ds, hi, ln, yo, ho, B, T, I,
                                N, st);
  if (rc != 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
