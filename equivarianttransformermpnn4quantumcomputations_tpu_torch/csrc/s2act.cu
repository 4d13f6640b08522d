// K2a / K2b / K2c: fused S2 point-sample activation and its first and
// second adjoints, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_k1`, `_k2` and `_k3` (launched by
// `_call`) of equivarianttransformermpnn4quantumcomputations_tpu/ops/pallas/
// s2act.py:
//
//   K2a  out   = F^T silu(A x)                      (to-grid, SiLU, from-grid)
//   K2b  dx    = A^T (silu'(A x) * (F dout))        (the backward of K2a)
//   K2c  ddout = F^T (silu'(A x) * (A ddx))         (the backward of K2b,
//        dx2   = A^T (silu''(A x) * (F dout) * (A ddx))   run by force training)
//
// for every node n and channel c, with A (to-grid) and F (from-grid) the
// [P, K] tables of ops/s2grid.py (P = 324 grid points at resolution 18,
// K = 25 coefficients at lmax 4).  The grid tensor [N, P, C] is ~P/K = 13x
// the coefficient tensor; it never touches device memory here.
//
// Bound: arithmetic.  Per (n, c) column K2a does 2 P K multiply-adds
// (4 P K flops) on 2 K values read and written; K2b does 3 P K; K2c 5 P K
// on 5 K values.  Design: one thread owns one (n, c) column, holds its K
// inputs and K accumulators in registers (K is a template constant, padded
// to KP = 4 ceil(K / 4)), and walks the grid points in chunks of CHUNK
// staged in shared memory; all threads of a block read the same table entry
// at once (broadcast), as 16-byte vectors.  Neighbouring threads own
// neighbouring channels, so every load and store of x, dout, ddx and the
// outputs is coalesced.  Math is f32 for both input types.  Tables arrive
// zero-padded to [Pp, KP] (Pp a multiple of CHUNK): a zero grid point is an
// exact no-op, since silu(0) = 0 and every K2b / K2c term carries a zero A-
// or F-row factor there.  K2c keeps 3 K inputs and 2 K accumulators live
// (140 floats at K = 25); its grid-point loop is not unrolled, so the
// register file holds them (up to 255 registers a thread at THREADS = 256).
// Instances: K = 4, 7, 9, 16, 19, 25 (lmax <= 4) and 14, 29, 49 (the edge
// sites of lmax 3 and 6 at mmax 2, the node sites of lmax 6).  At K = 49
// the 3 K (K2a / K2b) or 5 K (K2c) live floats exceed the register file and
// spill; chip_smoke.py prints ptxas's report of each instance.
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 32;  // grid points staged in shared memory at once
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

template <int KP>
__device__ __forceinline__ float dot4(const float4* __restrict__ row, const float (&v)[KP]) {
  float s = 0.0f;
#pragma unroll
  for (int k4 = 0; k4 < KP / 4; ++k4) {
    const float4 a = row[k4];
    s = fmaf(a.x, v[4 * k4], s);
    s = fmaf(a.y, v[4 * k4 + 1], s);
    s = fmaf(a.z, v[4 * k4 + 2], s);
    s = fmaf(a.w, v[4 * k4 + 3], s);
  }
  return s;
}

template <int KP>
__device__ __forceinline__ void axpy4(const float4* __restrict__ row, float s, float (&acc)[KP]) {
#pragma unroll
  for (int k4 = 0; k4 < KP / 4; ++k4) {
    const float4 a = row[k4];
    acc[4 * k4] = fmaf(a.x, s, acc[4 * k4]);
    acc[4 * k4 + 1] = fmaf(a.y, s, acc[4 * k4 + 1]);
    acc[4 * k4 + 2] = fmaf(a.z, s, acc[4 * k4 + 2]);
    acc[4 * k4 + 3] = fmaf(a.w, s, acc[4 * k4 + 3]);
  }
}

// BACKWARD = false: K2a (out = F^T silu(A x));  true: K2b (dx).
template <typename T, int K, bool BACKWARD>
__global__ void __launch_bounds__(THREADS)
s2act_kernel(const T* __restrict__ x, const T* __restrict__ dout,
             const float* __restrict__ A, const float* __restrict__ F,
             T* __restrict__ out, int N, int C, int Pp) {
  constexpr int KP = (K + 3) / 4 * 4;
  constexpr int Q = KP / 4;  // float4 per table row
  __shared__ float4 As[CHUNK * Q];
  __shared__ float4 Fs[CHUNK * Q];

  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool active = t < (long long)N * C;
  const long long n = active ? t / C : 0;
  const int c = (int)(t - n * C);
  const long long base = n * K * C + c;

  float xr[KP], dr[KP], acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    xr[k] = (active && k < K) ? to_f(x[base + (long long)k * C]) : 0.0f;
    dr[k] = (BACKWARD && active && k < K) ? to_f(dout[base + (long long)k * C]) : 0.0f;
    acc[k] = 0.0f;
  }

  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* F4 = reinterpret_cast<const float4*>(F);
  for (int p0 = 0; p0 < Pp; p0 += CHUNK) {
    __syncthreads();
    for (int i = threadIdx.x; i < CHUNK * Q; i += THREADS) {
      As[i] = A4[p0 * Q + i];
      Fs[i] = F4[p0 * Q + i];
    }
    __syncthreads();
#pragma unroll 2
    for (int q = 0; q < CHUNK; ++q) {
      const float g = dot4<KP>(As + q * Q, xr);
      const float s = sigmoid(g);
      if constexpr (!BACKWARD) {
        axpy4<KP>(Fs + q * Q, g * s, acc);
      } else {
        const float h = dot4<KP>(Fs + q * Q, dr);
        const float w = s * (1.0f + g * (1.0f - s)) * h;  // silu'(g) * h
        axpy4<KP>(As + q * Q, w, acc);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[base + (long long)k * C] = from_f<T>(acc[k]);
  }
}

// K2c: the backward of K2b, two outputs (ddout, dx2) in one pass.
template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
s2act_k3_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                const T* __restrict__ ddx, const float* __restrict__ A,
                const float* __restrict__ F, T* __restrict__ ddout,
                T* __restrict__ dx2, int N, int C, int Pp) {
  constexpr int KP = (K + 3) / 4 * 4;
  constexpr int Q = KP / 4;  // float4 per table row
  __shared__ float4 As[CHUNK * Q];
  __shared__ float4 Fs[CHUNK * Q];

  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool active = t < (long long)N * C;
  const long long n = active ? t / C : 0;
  const int c = (int)(t - n * C);
  const long long base = n * K * C + c;

  float xr[KP], dr[KP], ur[KP], acc_o[KP], acc_x[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const bool on = active && k < K;
    xr[k] = on ? to_f(x[base + (long long)k * C]) : 0.0f;
    dr[k] = on ? to_f(dout[base + (long long)k * C]) : 0.0f;
    ur[k] = on ? to_f(ddx[base + (long long)k * C]) : 0.0f;
    acc_o[k] = 0.0f;
    acc_x[k] = 0.0f;
  }

  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* F4 = reinterpret_cast<const float4*>(F);
  for (int p0 = 0; p0 < Pp; p0 += CHUNK) {
    __syncthreads();
    for (int i = threadIdx.x; i < CHUNK * Q; i += THREADS) {
      As[i] = A4[p0 * Q + i];
      Fs[i] = F4[p0 * Q + i];
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < CHUNK; ++q) {
      const float g = dot4<KP>(As + q * Q, xr);
      const float u = dot4<KP>(As + q * Q, ur);
      const float h = dot4<KP>(Fs + q * Q, dr);
      const float s = sigmoid(g);
      const float d1 = s * (1.0f + g * (1.0f - s));                      // silu'(g)
      const float d2 = s * (1.0f - s) * (2.0f + g * (1.0f - 2.0f * s));  // silu''(g)
      axpy4<KP>(Fs + q * Q, d1 * u, acc_o);
      axpy4<KP>(As + q * Q, d2 * h * u, acc_x);
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ddout[base + (long long)k * C] = from_f<T>(acc_o[k]);
      dx2[base + (long long)k * C] = from_f<T>(acc_x[k]);
    }
  }
}

template <typename T, int K>
int launch(int backward, const void* x, const void* dout, const float* A,
           const float* F, void* out, int N, int C, int Pp, cudaStream_t stream) {
  const long long total = (long long)N * C;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dout);
  T* ot = static_cast<T*>(out);
  if (backward)
    s2act_kernel<T, K, true><<<blocks, THREADS, 0, stream>>>(xt, dt, A, F, ot, N, C, Pp);
  else
    s2act_kernel<T, K, false><<<blocks, THREADS, 0, stream>>>(xt, dt, A, F, ot, N, C, Pp);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int backward, int K, const void* x, const void* dout, const float* A,
             const float* F, void* out, int N, int C, int Pp, cudaStream_t stream) {
  switch (K) {
    case 4: return launch<T, 4>(backward, x, dout, A, F, out, N, C, Pp, stream);
    case 7: return launch<T, 7>(backward, x, dout, A, F, out, N, C, Pp, stream);
    case 9: return launch<T, 9>(backward, x, dout, A, F, out, N, C, Pp, stream);
    case 16: return launch<T, 16>(backward, x, dout, A, F, out, N, C, Pp, stream);
    case 19: return launch<T, 19>(backward, x, dout, A, F, out, N, C, Pp, stream);
    case 25: return launch<T, 25>(backward, x, dout, A, F, out, N, C, Pp, stream);
    case 14: return launch<T, 14>(backward, x, dout, A, F, out, N, C, Pp, stream);
    case 29: return launch<T, 29>(backward, x, dout, A, F, out, N, C, Pp, stream);
    case 49: return launch<T, 49>(backward, x, dout, A, F, out, N, C, Pp, stream);
    default: return -2;
  }
}

template <typename T, int K>
int launch_k3(const void* x, const void* dout, const void* ddx, const float* A,
              const float* F, void* ddout, void* dx2, int N, int C, int Pp,
              cudaStream_t stream) {
  const long long total = (long long)N * C;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  s2act_k3_kernel<T, K><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(ddx),
      A, F, static_cast<T*>(ddout), static_cast<T*>(dx2), N, C, Pp);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k3(int K, const void* x, const void* dout, const void* ddx, const float* A,
                const float* F, void* ddout, void* dx2, int N, int C, int Pp,
                cudaStream_t stream) {
  switch (K) {
    case 4: return launch_k3<T, 4>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    case 7: return launch_k3<T, 7>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    case 9: return launch_k3<T, 9>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    case 16: return launch_k3<T, 16>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    case 19: return launch_k3<T, 19>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    case 25: return launch_k3<T, 25>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    case 14: return launch_k3<T, 14>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    case 29: return launch_k3<T, 29>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    case 49: return launch_k3<T, 49>(x, dout, ddx, A, F, ddout, dx2, N, C, Pp, stream);
    default: return -2;
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; backward 0 = K2a, 1 = K2b (dout used).
// A and F: [Pp, 4 ceil(K / 4)] float32, zero-padded, Pp % 32 == 0.
// Returns 0, a cudaError_t (> 0), -2 for a K with no instance, -3 for a dtype.
extern "C" int etq_s2act(int dtype, int backward, int K, const void* x,
                         const void* dout, const void* A, const void* F,
                         void* out, int N, int C, int Pp, void* stream) {
  const float* Af = static_cast<const float*>(A);
  const float* Ff = static_cast<const float*>(F);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(backward, K, x, dout, Af, Ff, out, N, C, Pp, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(backward, K, x, dout, Af, Ff, out, N, C, Pp, s);
  return -3;
}

// K2c: ddout and dx2 from x, dout and ddx (all [N, K, C] of one dtype);
// tables as for etq_s2act.  Returns as etq_s2act.
extern "C" int etq_s2act_k3(int dtype, int K, const void* x, const void* dout,
                            const void* ddx, const void* A, const void* F,
                            void* ddout, void* dx2, int N, int C, int Pp,
                            void* stream) {
  const float* Af = static_cast<const float*>(A);
  const float* Ff = static_cast<const float*>(F);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_k3<float>(K, x, dout, ddx, Af, Ff, ddout, dx2, N, C, Pp, s);
  if (dtype == 1)
    return dispatch_k3<__nv_bfloat16>(K, x, dout, ddx, Af, Ff, ddout, dx2, N, C, Pp, s);
  return -3;
}

extern "C" const char* etq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
