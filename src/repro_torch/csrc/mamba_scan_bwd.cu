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
// tokens, so it is not kept.  Each lane first runs the forward over T and
// writes its state at the start of every chunk of kChunk = 16 steps (B *
// T/16 * I * N * 4 bytes: 67 MB at B 1, T 1024 of Jamba, scratch for one
// call); the reverse pass then recomputes each chunk's states and
// exp(dt A) factors from its checkpoint and walks them backwards.  exp()
// is computed twice per (t, i, n), the forward's count twice over; the
// reverse steps take none.
//
// What bounds it on an H100: the same as the forward -- B*T*I*N exp()
// calls (two passes here) on the special function units and the ~12
// instructions around each, against 4 bytes each of dt, x, dy read (twice
// for dt and x) and ddt, dx written per (b, t, i).  At Jamba's training
// shape the byte bound is 0.10 ms and the two exp passes alone ~0.13 ms;
// what sets the pace is latency: each step of a lane depends on the last,
// so the SM needs many lanes in flight.  The design:
//   * a lane keeps S = 4 consecutive states of one (row, channel), L = N
//     / S lanes share a channel, a CTA of 256 threads takes C = 256 / L
//     channels of one row; at most 128 registers a thread, so two CTAs
//     (16 warps) fit an SM;
//   * the chunk's recomputed states go to shared memory, each thread's
//     own 16-byte slot per step (64 KB a CTA), and the chunk's decay
//     factors stay in registers (64 of them), so the reverse walk reads
//     h_{t-1}, recomputes h_t = exp(dt A) h_{t-1} + dt x b with one FMA
//     and takes no exp; the next chunk's checkpoint is loaded while this
//     one walks;
//   * per step, ddt and dx are sums over the lane's S states, then across
//     the L lanes by __shfl_xor_sync;
//   * db and dc (sums over the I channels) are reduced across the warp's
//     channels by halving shuffle rounds, each lane keeping one of the
//     eight sums it started with, then written per (step, warp) to a
//     double buffer in shared memory; after the chunk's one barrier the
//     CTA adds its eight warps in order and writes one partial per (row,
//     channel block, t, n); a second kernel adds the channel blocks in
//     order.  dA and dD stay in registers over T and are written per row;
//     the second kernel adds the rows in order.  No atomics: the same
//     inputs give the same bits.
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

constexpr int kThreads = 256;  // threads per CTA (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kStates = 4;     // states of one channel per lane (S)
constexpr int kChunk = 16;     // steps between checkpoints of h

template <int N>
struct Geo {
  static constexpr int S = kStates;       // states per lane
  static constexpr int L = N / S;         // lanes per channel
  static constexpr int C = kThreads / L;  // channels per CTA
  static_assert(N % S == 0 && (L == 2 || L == 4),
                "a warp's channels reduce in three halving rounds");
  // the chunk's states before each step, one 16-byte vector per thread
  // and step, then two buffers of db|dc partial sums per (step, warp)
  static constexpr size_t hs_floats = (size_t)kChunk * kThreads * S;
  static constexpr size_t red_floats = (size_t)kChunk * kWarps * 2 * N;
  __host__ __device__ static constexpr size_t smem_bytes() {
    return sizeof(float) * (hs_floats + 2 * red_floats);
  }
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// v: this lane's four db terms, then its four dc terms.  Sums them over
// the warp's channels (lanes L, 2L, 4L apart, and 16 apart when L is 2)
// by halving rounds: each round a lane keeps half its values, adds its
// partner's copy of that half and sends the other half.  Returns the one
// sum left to this lane, which is term 4 b(L) + 2 b(2L) + b(4L) of the
// eight, b(m) = 1 where lane & m.  A fixed tree: the same bits each run.
template <int L>
__device__ __forceinline__ float reduce_channels(const float (&v)[8],
                                                 int lane) {
  float w[4], x[2];
  {
    const bool up = lane & L;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float send = up ? v[j] : v[j + 4];
      const float keep = up ? v[j + 4] : v[j];
      w[j] = keep + __shfl_xor_sync(0xffffffffu, send, L);
    }
  }
  {
    const bool up = lane & (2 * L);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float send = up ? w[j] : w[j + 2];
      const float keep = up ? w[j + 2] : w[j];
      x[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * L);
    }
  }
  const bool up = lane & (4 * L);
  const float send = up ? x[0] : x[1];
  float r = (up ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, send, 4 * L);
  if constexpr (8 * L < 32) r += __shfl_xor_sync(0xffffffffu, r, 8 * L);
  return r;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
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
  float* hs = reinterpret_cast<float*>(smem);   // [kChunk][kThreads][S]
  float* red = hs + G::hs_floats;               // [2][kChunk][kWarps][2N]
  const int row = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int part = tid % G::L;
  const int i = blk * G::C + tid / G::L;
  const bool active = i < I;
  const int n_chunks = (Tlen + kChunk - 1) / kChunk;
  const size_t state = ((size_t)row * I + i) * N + part * S;
  // the db|dc term this lane holds after reduce_channels
  const int j = 4 * ((lane & G::L) != 0) + 2 * ((lane & (2 * G::L)) != 0) +
                ((lane & (4 * G::L)) != 0);
  const int n2 = j < 4 ? part * S + j : N + part * S + j - 4;
  const bool writer = G::L == 4 || lane < 16;

  float a[S], h[S];
  float dsk = 0.f;
  if (active) {
    load4(a_neg + (size_t)i * N + part * S, a);
    load4(h0 + state, h);
    dsk = d_skip[i];
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = h[s] = 0.f;
  }

  // 1. the forward over T, h kept at the start of every chunk
  if (active) {
    for (int k = 0; k < n_chunks; ++k) {
      store4(ckpt + (((size_t)row * n_chunks + k) * I + i) * N + part * S,
             h);
      const int t0 = k * kChunk;
      const int nt = min(kChunk, Tlen - t0);
#pragma unroll 4
      for (int tt = 0; tt < nt; ++tt) {
        const size_t at = ((size_t)row * Tlen + t0 + tt) * I + i;
        const float dtv = dt[at], dbx = dtv * x[at];
        float bv[S];
        load4(bmat + ((size_t)row * Tlen + t0 + tt) * N + part * S, bv);
#pragma unroll
        for (int s = 0; s < S; ++s)
          h[s] = fmaf(expf(dtv * a[s]), h[s], dbx * bv[s]);
      }
    }
  }

  // 2. the reverse scan, chunk by chunk from the end
  float g[S], da_acc[S];
  float dd_acc = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) da_acc[s] = 0.f;
  if (active && dh_final != nullptr) {
    load4(dh_final + state, g);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) g[s] = 0.f;
  }
  // each chunk's checkpoint is loaded while the chunk after it runs
  if (active)
    load4(ckpt + (((size_t)row * n_chunks + n_chunks - 1) * I + i) * N +
              part * S, h);
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int nt = min(kChunk, Tlen - t0);
    float* rb = red + (size_t)(k % 2) * G::red_floats;
    // recompute the chunk's states from its checkpoint: the state before
    // each step to shared memory (this thread's own slot), the decay
    // factors exp(dt A) in registers
    float da[kChunk][S];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < nt) {  // the same for the whole CTA
        store4(hs + ((size_t)tt * kThreads + tid) * S, h);
        const size_t at = ((size_t)row * Tlen + t0 + tt) * I + i;
        const float dtv = active ? dt[at] : 0.f;
        const float dbx = dtv * (active ? x[at] : 0.f);
        float bv[S];
        load4(bmat + ((size_t)row * Tlen + t0 + tt) * N + part * S, bv);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          da[tt][s] = expf(dtv * a[s]);
          h[s] = fmaf(da[tt][s], h[s], dbx * bv[s]);
        }
      }
    }
    if (active && k > 0)
      load4(ckpt + (((size_t)row * n_chunks + k - 1) * I + i) * N + part * S,
            h);
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      if (tt < nt) {
        const int t = t0 + tt;
        const size_t at = ((size_t)row * Tlen + t) * I + i;
        const float dyv = active ? dy[at] : 0.f;
        const float dtv = active ? dt[at] : 0.f;
        const float xv = active ? x[at] : 0.f;
        const float dbx = dtv * xv;
        float bv[S], cv[S], hp[S], v[8];
        load4(bmat + ((size_t)row * Tlen + t) * N + part * S, bv);
        load4(cmat + ((size_t)row * Tlen + t) * N + part * S, cv);
        load4(hs + ((size_t)tt * kThreads + tid) * S, hp);
        float ddt_p = 0.f, dx_p = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          g[s] = fmaf(cv[s], dyv, g[s]);                    // dL/dh_t
          v[s] = g[s] * dbx;                                // db_t term
          v[S + s] = dyv * fmaf(da[tt][s], hp[s], dbx * bv[s]);  // dc_t
          const float dah = da[tt][s] * hp[s];
          ddt_p = fmaf(g[s], fmaf(a[s], dah, xv * bv[s]), ddt_p);
          dx_p = fmaf(g[s], bv[s], dx_p);
          da_acc[s] = fmaf(g[s] * dtv, dah, da_acc[s]);
          g[s] *= da[tt][s];                                // into dL/dh_{t-1}
        }
#pragma unroll
        for (int off = 1; off < G::L; off *= 2) {
          ddt_p += __shfl_xor_sync(0xffffffffu, ddt_p, off);
          dx_p += __shfl_xor_sync(0xffffffffu, dx_p, off);
        }
        if (active && part == 0) {
          ddt[at] = ddt_p;
          dx[at] = fmaf(dtv, dx_p, dsk * dyv);
          dd_acc = fmaf(dyv, xv, dd_acc);
        }
        const float r = reduce_channels<G::L>(v, lane);
        if (writer) rb[((size_t)tt * kWarps + warp) * 2 * N + n2] = r;
      }
    }
    // the one barrier of the chunk: every warp's sums are in `rb`, and
    // the other buffer's readers (the chunk before) are done
    __syncthreads();
    for (int o = tid; o < nt * 2 * N; o += kThreads) {
      const int tt = o / (2 * N), m = o % (2 * N);
      const float* col = rb + (size_t)tt * kWarps * 2 * N + m;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += col[(size_t)w * 2 * N];
      part_bc[(((size_t)row * gridDim.x + blk) * Tlen + t0 + tt) * 2 * N +
              m] = sum;
    }
  }

  if (active) {
    store4(dh0 + state, g);
    store4(part_a + state, da_acc);
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

// Scratch the caller allocates: ckpt (B, ceil(T / kChunk), I, N), part_bc
// (B, ceil(I / C), T, 2N) with C = 256 / (N / 4) channels per block,
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
