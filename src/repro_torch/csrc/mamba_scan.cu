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
// What bounds it on an H100.  At one decode step (T 1) nearly every byte
// is state: h0 in and h_final out, 4 * N bytes per (b, i) channel each
// way, so the time is the rate at which those move.  Over a prompt each
// (b, t, i) reads dt and x and writes y once (12 bytes in fp32) and takes
// N exp() calls on the special function units (16 per SM per clock), so
// bytes and the SFU are about equal -- but the instructions around each
// exp() set the pace: about twelve per state and step with an exp()
// accurate to 1e-5, against 128 issued per SM per clock.  The design:
//   * lanes over the state: a thread owns S = kStates consecutive states
//     of one (b, i) channel, so L = N / S neighbouring lanes share a
//     channel and a warp covers 32 / L channels.  h0, the row of A and
//     h_final move as S-float vectors, contiguous across the CTA;
//   * sequential in T, never re-associated across time: a row of length
//     0 keeps its state bit for bit, a padded row gives the bits of its
//     unpadded run, and a call split anywhere in T with h0 carried
//     between the parts gives the bits of one call (chunked prefill
//     needs this).  The parallelism comes from the B * I * N / S lanes;
//   * y_t is summed in one fixed order whatever S is: an FMA chain over
//     each group of four consecutive states, then a pairwise tree over
//     the groups, first inside the lane, then across the L lanes by a
//     __shfl_xor_sync butterfly.  So y has the same bits at every t, for
//     every split of T and for every S of 4 or more;
//   * one CTA takes kThreads / L channels of one batch row, so b and c
//     are the same for all its lanes.  A T-tile of dt and x for its
//     channels and of b and c for its row arrives in shared memory by
//     16-byte cp.async into a double buffer: tile k + 1 is in flight
//     while tile k computes.  Each lane reads its S values of b and c
//     per step as one vector (a broadcast across the channels).  The
//     tile's y goes through shared memory and out as 16-byte stores;
//   * exp(dt * A) is CUDA's expf of the rounded product, as the plain
//     version takes it: nine instructions, one of them on the SFU.  The
//     SFU's ex2.approx of dt * (A log2 e) alone is two, but it is not
//     accurate enough for negative arguments: its error compounds in
//     the states that decay slowly and misses 1e-5 over a 128-step
//     prompt (kExp2 keeps it as a variant to time).  Reduced to a
//     fraction in [0, 1) first, as expf does, it holds 1e-5 but saves
//     too few instructions to pay for its extra registers;
//   * every update is written with explicit round-to-nearest intrinsics,
//     so no contraction choice of the compiler can differ between two
//     copies of a step;
//   * no tensor cores: the update is elementwise in (i, n) with scalars
//     per t and the only reduction is over N per step, so there is no
//     matrix product for wgmma to take;
//   * grid (ceil(I / channels per CTA), B); a ragged I is masked.  Shapes
//     whose rows are not 16-byte aligned stage with plain loads.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().  h_final may alias h0: each lane reads its own h0
// slice before it writes the same slice of h_final, and no lane reads
// another lane's slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef APEX_LAUNCH
#define APEX_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 128;   // threads per CTA (4 warps)
constexpr int kStates = 8;      // states of one channel per lane (S)
constexpr int kTileT = 32;      // time steps per staged tile
constexpr bool kExp2 = false;   // exp(z) as ex2.approx(z * log2 e)
constexpr bool kAsync = true;   // stage tiles with cp.async
constexpr int kStages = 2;      // tiles in the double buffer
constexpr float kLog2e = 1.4426950408889634f;

template <int N, typename T>
struct Geo {
  static constexpr int S = kStates < N ? kStates : N;  // states per lane
  static constexpr int L = N / S;                      // lanes per channel
  static constexpr int C = kThreads / L;               // channels per CTA
  static constexpr int EPC = 16 / (int)sizeof(T);      // elements / 16 B
  static_assert(N % S == 0 && 32 % L == 0, "lanes must tile a warp");
  // bytes of one staged tile of `rows` steps: dt, x (rows, C); b, c
  // (rows, N); every block a multiple of 16 bytes
  __host__ __device__ static constexpr size_t stage_bytes(int rows) {
    return (size_t)rows * (2 * C + 2 * N) * sizeof(T);
  }
  __host__ __device__ static constexpr size_t smem_bytes(int rows) {
    return kStages * stage_bytes(rows) + (size_t)rows * C * sizeof(float);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// S consecutive values as fp32, in 16-, 8- or 4-byte vectors
template <int S>
__device__ __forceinline__ void load_s(const float* p, float* out) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int k = 0; k < S / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      out[4 * k] = v.x;
      out[4 * k + 1] = v.y;
      out[4 * k + 2] = v.z;
      out[4 * k + 3] = v.w;
    }
  } else if constexpr (S == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}
template <int S>
__device__ __forceinline__ void load_s(const __nv_bfloat16* p, float* out) {
  if constexpr (S % 2 == 0) {
#pragma unroll
    for (int k = 0; k < S / 2; ++k) {
      const float2 v = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(p)[k]);
      out[2 * k] = v.x;
      out[2 * k + 1] = v.y;
    }
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}
template <int S>
__device__ __forceinline__ void store_s(float* p, const float* v) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int k = 0; k < S / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else if constexpr (S == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// exp(dt * A) from a2 = A, or from a2 = A log2 e under kExp2
__device__ __forceinline__ float exp_of(float dtv, float a2) {
  if constexpr (kExp2) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(__fmul_rn(dtv, a2)));
    return r;
  } else {
    return expf(__fmul_rn(dtv, a2));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// Stage steps [t0, t0 + nt) of batch row `row` into one buffer of
// `rows` steps: dt, x for the CTA's channels [i0, i0 + C), b, c whole.
// Channels past I read as 0.
template <int N, typename T>
__device__ __forceinline__ void stage_tile(
    unsigned char* buf, int rows, const T* dt, const T* x, const T* bmat,
    const T* cmat, int row, int t0, int nt, int Tlen, int I, int i0,
    bool vec) {
  using G = Geo<N, T>;
  T* sdt = reinterpret_cast<T*>(buf);
  T* sx = sdt + rows * G::C;
  T* sb = sx + rows * G::C;
  T* sc = sb + rows * N;
  const size_t first = (size_t)row * Tlen + t0;  // (b, t0) row of (B, T, .)
  if (kAsync && vec) {
    constexpr int CPR = G::C / G::EPC;  // 16-byte chunks per channel row
    for (int q = threadIdx.x; q < nt * CPR; q += kThreads) {
      const int r = q / CPR, ci = (q % CPR) * G::EPC;
      const size_t src = (first + r) * I + i0 + ci;
      const int n = i0 + ci < I ? 16 : 0;  // I * sizeof(T) % 16 == 0
      cp_async16(sdt + r * G::C + ci, n ? dt + src : dt, n);
      cp_async16(sx + r * G::C + ci, n ? x + src : x, n);
    }
    for (int q = threadIdx.x; q < nt * N / G::EPC; q += kThreads) {
      const size_t src = first * N + q * G::EPC;
      cp_async16(sb + q * G::EPC, bmat + src, 16);
      cp_async16(sc + q * G::EPC, cmat + src, 16);
    }
  } else {
    for (int q = threadIdx.x; q < nt * G::C; q += kThreads) {
      const int r = q / G::C, ci = q % G::C;
      const size_t src = (first + r) * I + i0 + ci;
      const bool in = i0 + ci < I;
      sdt[r * G::C + ci] = in ? dt[src] : zero_of<T>();
      sx[r * G::C + ci] = in ? x[src] : zero_of<T>();
    }
    for (int q = threadIdx.x; q < nt * N; q += kThreads) {
      sb[q] = bmat[first * N + q];
      sc[q] = cmat[first * N + q];
    }
  }
}

// One time step of this lane's S states.  kUpdate: the step is inside
// the row's length and advances the carry; otherwise only y is taken.
template <int N, typename T, bool kUpdate>
__device__ __forceinline__ void scan_step(
    float (&h)[Geo<N, T>::S], const float (&a2)[Geo<N, T>::S], float dsk,
    const T* sdt, const T* sx, const T* sb, const T* sc, float* sy, int tt,
    int ch, int part) {
  using G = Geo<N, T>;
  constexpr int S = G::S;
  constexpr int NG = S >= 4 ? S / 4 : 1;  // groups of four in the lane
  const float dtv = to_float(sdt[tt * G::C + ch]);
  const float xv = to_float(sx[tt * G::C + ch]);
  float bv[S], cv[S], grp[NG];
  load_s<S>(sb + tt * N + part * S, bv);
  load_s<S>(sc + tt * N + part * S, cv);
  const float dbx = __fmul_rn(dtv, xv);
#pragma unroll
  for (int g = 0; g < NG; ++g) grp[g] = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float hn = __fmaf_rn(exp_of(dtv, a2[s]), h[s],
                               __fmul_rn(dbx, bv[s]));
    grp[s * NG / S] = __fmaf_rn(hn, cv[s], grp[s * NG / S]);
    if (kUpdate) h[s] = hn;
  }
#pragma unroll
  for (int w = 1; w < NG; w *= 2)
#pragma unroll
    for (int g = 0; g < NG; g += 2 * w) grp[g] = __fadd_rn(grp[g], grp[g + w]);
  float acc = grp[0];
#pragma unroll
  for (int off = 1; off < G::L; off *= 2)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (part == 0) sy[tt * G::C + ch] = __fmaf_rn(dsk, xv, acc);
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                      const T* __restrict__ bmat, const T* __restrict__ cmat,
                      const float* __restrict__ a_neg,
                      const float* __restrict__ d_skip, const float* h0,
                      const int* __restrict__ lens, float* __restrict__ y,
                      float* h_final, int Tlen, int I, int rows, int vec_in) {
  using G = Geo<N, T>;
  constexpr int S = G::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool vec = vec_in != 0;
  const int row = blockIdx.y;
  const int i0 = blockIdx.x * G::C;
  const int ch = threadIdx.x / G::L;    // channel within the CTA
  const int part = threadIdx.x % G::L;  // which S states of it
  const int i = i0 + ch;
  const bool active = i < I;
  const int len = lens != nullptr ? lens[row] : Tlen;
  const size_t stage = G::stage_bytes(rows);
  float* sy = reinterpret_cast<float*>(smem + kStages * stage);
  const int ntiles = (Tlen + rows - 1) / rows;

  stage_tile<N, T>(smem, rows, dt, x, bmat, cmat, row, 0, min(rows, Tlen),
                   Tlen, I, i0, vec);
  cp_async_commit();

  float a2[S], h[S];
  float dsk = 0.f;
  const size_t state = ((size_t)row * I + i) * N + part * S;
  if (active) {
    load_s<S>(a_neg + (size_t)i * N + part * S, a2);
    load_s<S>(h0 + state, h);
    dsk = d_skip[i];
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) a2[s] = h[s] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (kExp2) a2[s] = __fmul_rn(a2[s], kLog2e);

  for (int k = 0; k < ntiles; ++k) {
    const int t0 = k * rows;
    const int nt = min(rows, Tlen - t0);
    if (k + 1 < ntiles) {
      stage_tile<N, T>(smem + ((k + 1) % kStages) * stage, rows, dt, x,
                       bmat, cmat, row, t0 + rows,
                       min(rows, Tlen - t0 - rows), Tlen, I, i0, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sdt = reinterpret_cast<const T*>(smem + (k % kStages) * stage);
    const T* sx = sdt + rows * G::C;
    const T* sb = sx + rows * G::C;
    const T* sc = sb + rows * N;
    // steps below n_upd advance the carry, the rest only give y; the
    // row's length is the same for the whole CTA
    const int n_upd = max(0, min(len - t0, nt));
    int tt = 0;
#pragma unroll 8
    for (; tt < n_upd; ++tt)
      scan_step<N, T, true>(h, a2, dsk, sdt, sx, sb, sc, sy, tt, ch, part);
    for (; tt < nt; ++tt)
      scan_step<N, T, false>(h, a2, dsk, sdt, sx, sb, sc, sy, tt, ch, part);
    __syncthreads();
    // y of the tile: rows of C floats, out as 16-byte stores
    const size_t first = (size_t)row * Tlen + t0;
    if (vec) {  // I % 4 == 0
      constexpr int CPR = G::C / 4;
      for (int q = threadIdx.x; q < nt * CPR; q += kThreads) {
        const int r = q / CPR, ci = (q % CPR) * 4;
        if (i0 + ci < I)
          *reinterpret_cast<float4*>(y + (first + r) * I + i0 + ci) =
              *reinterpret_cast<const float4*>(sy + r * G::C + ci);
      }
    } else {
      for (int q = threadIdx.x; q < nt * G::C; q += kThreads) {
        const int r = q / G::C, ci = q % G::C;
        if (i0 + ci < I) y[(first + r) * I + i0 + ci] = sy[r * G::C + ci];
      }
    }
  }

  if (active) store_s<S>(h_final + state, h);
}

template <int N, typename T>
int launch(const void* dt, const void* x, const void* b, const void* c,
           const float* a_neg, const float* d_skip, const float* h0,
           const int* lens, float* y, float* h_final, int B, int Tlen, int I,
           cudaStream_t stream) {
  using G = Geo<N, T>;
  auto kern = mamba_scan_kernel<N, T>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::smem_bytes(kTileT));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int rows = Tlen < kTileT ? Tlen : kTileT;
  const uintptr_t ptrs = (uintptr_t)dt | (uintptr_t)x | (uintptr_t)b |
                         (uintptr_t)c;
  const int vec = ptrs % 16 == 0 && ((size_t)I * sizeof(T)) % 16 == 0;
  const dim3 grid((I + G::C - 1) / G::C, B);
  APEX_LAUNCH(kern, grid, dim3(kThreads), G::smem_bytes(rows), stream,
              (const T*)dt, (const T*)x, (const T*)b, (const T*)c, a_neg,
              d_skip, h0, lens, y, h_final, Tlen, I, rows, vec);
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
      return (int)cudaErrorInvalidValue;
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
  // the state moves as 16-byte vectors
  if (((uintptr_t)a_neg | (uintptr_t)h0 | (uintptr_t)h_final) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
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
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
