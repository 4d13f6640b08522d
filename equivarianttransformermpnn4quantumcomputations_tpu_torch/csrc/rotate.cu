// K4: fused factored-Wigner edge rotation, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rot_kernel` / `_call_rot` of
// equivarianttransformermpnn4quantumcomputations_tpu/ops/pallas/rotate.py.
//
// Per edge e and channel c, D = Xz(a) J Xz(b) J Xz(g) applied as
//   h[i]  = sum_k (W1[i, k] t1a[e, k] + W1[i, Ki + k] t1b[e, k]) x[e, k, c]
//   uv[r] = sum_j (W2[r, j] t2a[e, j] + W2[r, Km + j] t2b[e, j]) h[j]
//   y[e, o, c] = t3a[e, o] uv[o] + t3b[e, o] uv[Ko + o]
// (the JAX package's flip-folded algebra; ops/cuda/rotate.py:rot_plain is
// the same function with the dense W1 / W2).  Four kinds, as in K1:
//   kind 0 "to"      full (lmax+1)^2 rows -> reduced rows (|m| <= mmax)
//   kind 1 "from"    reduced rows -> full rows
//   kind 2 "to_m0"   full rows -> the lmax+1 m = 0 rows
//   kind 3 "from_m0" the lmax+1 m = 0 rows -> full rows
// Every factor maps degree l onto degree l, so only the degree-l blocks of
// W1 (two halves, [2l+1, in_w]) and W2 (two quarters, [out_w, 2l+1]) are
// nonzero, and W2's second half of rows is its first half flipped within
// each degree (m -> -m): uv[Ko + o] = uv[o'], o' the flip of o, so the kernel
// forms the first half only and pairs each output row with its flip.
// ops/cuda/rotate.py:kernel_pack packs the blocks, degree by degree, for
// every (lmax, mmax, kind) instance; they live in __constant__ memory
// (uploaded once per device by etq_rotate_set_consts), and since every loop
// below has constant trip counts and is fully unrolled, each constant is
// read at a compile-time address straight into its FFMA.
//
// Bound: memory.  Per edge the kernel reads x[e] once and writes y[e] once
// (at OC20's "to" [6400, 49, 256] -> [6400, 29, 256] in f32: 511 MB, 0.153 ms
// at 3.35 TB/s), while the algebra's per-degree blocks cost 910 + 940
// multiply-adds per (edge, channel) at lmax 6 / mmax 2, ~0.09 ms at the f32
// rate (the dense [49, 98] pair matrices would cost 0.51 ms).
// Design: one thread owns 4 channels of one edge (neighbouring threads, neighbouring channels: every
// load and store of x and y is coalesced); a block of 256 threads takes a
// tile of TE edges (TE = 256 / (C / 4), at most 32) and first stages the
// tile's six per-edge tables in shared memory, where the threads of one
// edge read each entry at the same address (broadcast).  Per degree, stage 1
// streams the input rows (the effective coefficient W1a t1a + W1b t1b is
// formed once per (i, k) and used for 4 channels) into the 2l+1 middle rows
// held in registers; stage 2 forms each pair (o, o') of flipped output rows
// from them (coefficient W2a t2a + W2b t2b once per (o, j)) and stores
// y[o] = t3a uv[o] + t3b uv[o'] and y[o'] = t3a uv[o'] + t3b uv[o].
// Math is f32 for both input types; the last tile is masked, nothing is
// padded.  The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 4;  // channels per thread
constexpr int THREADS = 256;
constexpr int MAX_TILE = 32;  // edges per block

template <typename T>
struct Pack4;

template <>
struct Pack4<float> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack4<__nv_bfloat16> {
  union U {
    uint2 u;
    __nv_bfloat162 h[2];
  };
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[4]) {
    U q;
    q.u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(q.h[0]);
    const float2 b = __bfloat1622float2(q.h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[4]) {
    U q;
    q.h[0] = __floats2bfloat162_rn(v[0], v[1]);
    q.h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = q.u;
  }
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// rows of degree l on the input and output side of each kind
__host__ __device__ constexpr int in_w(int l, int mmax, int kind) {
  return kind == 0 || kind == 2 ? 2 * l + 1 : kind == 1 ? 2 * imin(l, mmax) + 1 : 1;
}
__host__ __device__ constexpr int out_w(int l, int mmax, int kind) {
  return kind == 0 ? 2 * imin(l, mmax) + 1 : kind == 2 ? 1 : 2 * l + 1;
}
__host__ __device__ constexpr int n_in(int lmax, int mmax, int kind) {
  int n = 0;
  for (int l = 0; l <= lmax; ++l) n += in_w(l, mmax, kind);
  return n;
}
__host__ __device__ constexpr int n_out(int lmax, int mmax, int kind) {
  int n = 0;
  for (int l = 0; l <= lmax; ++l) n += out_w(l, mmax, kind);
  return n;
}
// constants of one (lmax, mmax, kind): per degree 2 (2l+1) (in_w + out_w)
__host__ __device__ constexpr int pack_size(int lmax, int mmax, int kind) {
  int n = 0;
  for (int l = 0; l <= lmax; ++l)
    n += 2 * (2 * l + 1) * (in_w(l, mmax, kind) + out_w(l, mmax, kind));
  return n;
}
__host__ __device__ constexpr int inst_size(int lmax, int mmax) {
  return pack_size(lmax, mmax, 0) + pack_size(lmax, mmax, 1) + pack_size(lmax, mmax, 2) +
         pack_size(lmax, mmax, 3);
}
// The (lmax, mmax) instances, in the order of their constants.  This list
// is the kernel's one copy; ops/cuda/rotate.py:INSTANCES must name the same
// pairs in the same order, and its upload checks every offset against
// etq_rotate_const_offset before it copies a constant.
#define ETQ_ROT_INSTANCES(X) X(2, 1) X(3, 2) X(4, 2) X(6, 2)

__host__ __device__ constexpr int inst_base(int lmax, int mmax) {
  int off = 0;
#define ETQ_BASE(L, M)                    \
  if (lmax == L && mmax == M) return off; \
  off += inst_size(L, M);
  ETQ_ROT_INSTANCES(ETQ_BASE)
#undef ETQ_BASE
  return -1;
}
__host__ __device__ constexpr int const_offset(int lmax, int mmax, int kind) {
  int off = inst_base(lmax, mmax);
  if (off < 0 || kind < 0 || kind > 3) return -1;
  for (int k = 0; k < kind; ++k) off += pack_size(lmax, mmax, k);
  return off;
}
#define ETQ_SIZE(L, M) +inst_size(L, M)
constexpr int CONST_FLOATS = 0 ETQ_ROT_INSTANCES(ETQ_SIZE);
#undef ETQ_SIZE
static_assert(CONST_FLOATS * 4 <= 65536, "the constants exceed 64 KB of __constant__ memory");

__constant__ float c_W[CONST_FLOATS];

template <typename T, int LMAX, int MMAX, int KIND, int WOFF>
__global__ void __launch_bounds__(THREADS)
rot_kernel(const T* __restrict__ x, const float* __restrict__ t1a,
           const float* __restrict__ t1b, const float* __restrict__ t2a,
           const float* __restrict__ t2b, const float* __restrict__ t3a,
           const float* __restrict__ t3b, T* __restrict__ y, int E, int C, int TE) {
  using PK = Pack4<T>;
  constexpr int KI = n_in(LMAX, MMAX, KIND);
  constexpr int KM = (LMAX + 1) * (LMAX + 1);
  constexpr int KO = n_out(LMAX, MMAX, KIND);
  constexpr int D = 2 * LMAX + 1;  // widest degree block

  extern __shared__ float smem[];
  float* s1a = smem;
  float* s1b = s1a + TE * KI;
  float* s2a = s1b + TE * KI;
  float* s2b = s2a + TE * KM;
  float* s3a = s2b + TE * KM;
  float* s3b = s3a + TE * KO;

  const long long e0 = (long long)blockIdx.x * TE;
  const int ne = (int)(E - e0 < TE ? E - e0 : TE);  // the last tile is ragged
  for (int i = threadIdx.x; i < ne * KI; i += THREADS) {
    s1a[i] = t1a[e0 * KI + i];
    s1b[i] = t1b[e0 * KI + i];
  }
  for (int i = threadIdx.x; i < ne * KM; i += THREADS) {
    s2a[i] = t2a[e0 * KM + i];
    s2b[i] = t2b[e0 * KM + i];
  }
  for (int i = threadIdx.x; i < ne * KO; i += THREADS) {
    s3a[i] = t3a[e0 * KO + i];
    s3b[i] = t3b[e0 * KO + i];
  }
  __syncthreads();

  const int groups = C / V;
  for (int g = threadIdx.x; g < ne * groups; g += THREADS) {
    const int el = g / groups;
    const int c0 = (g - el * groups) * V;
    const long long e = e0 + el;
    const T* xe = x + e * KI * C + c0;
    T* ye = y + e * KO * C + c0;
    const float* a1 = s1a + el * KI;
    const float* b1 = s1b + el * KI;
    const float* a2 = s2a + el * KM;
    const float* b2 = s2b + el * KM;
    const float* a3 = s3a + el * KO;
    const float* b3 = s3b + el * KO;

    int wp = WOFF;  // constant offset of degree l's pack: compile-time once unrolled
    int io = 0;     // first input row of degree l
    int oo = 0;     // first output row of degree l
#pragma unroll
    for (int l = 0; l <= LMAX; ++l) {
      const int d = 2 * l + 1;
      const int iw = in_w(l, MMAX, KIND);
      const int ow = out_w(l, MMAX, KIND);
      const int w1a = wp, w1b = wp + d * iw;
      const int w2a = wp + 2 * d * iw, w2b = w2a + ow * d;

      // stage 1: the 2l+1 middle rows of degree l
      float h[D][V];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) h[i][j] = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k < iw) {
          float xk[V];
          PK::load(xe + (long long)(io + k) * C, xk);
          const float pa = a1[io + k], pb = b1[io + k];
#pragma unroll
          for (int i = 0; i < D; ++i) {
            if (i < d) {
              const float coef = fmaf(c_W[w1a + i * iw + k], pa, c_W[w1b + i * iw + k] * pb);
#pragma unroll
              for (int j = 0; j < V; ++j) h[i][j] = fmaf(coef, xk[j], h[i][j]);
            }
          }
        }
      }

      // stage 2: each pair (o, f) of flipped output rows of degree l
      float qa[D], qb[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (j < d) {
          qa[j] = a2[l * l + j];
          qb[j] = b2[l * l + j];
        }
      }
#pragma unroll
      for (int o = 0; o < D; ++o) {
        const int f = ow - 1 - o;  // the flip of o within the degree
        if (o < ow && o <= f) {
          float uo[V] = {}, uf[V] = {};
#pragma unroll
          for (int j = 0; j < D; ++j) {
            if (j < d) {
              const float go = fmaf(c_W[w2a + o * d + j], qa[j], c_W[w2b + o * d + j] * qb[j]);
#pragma unroll
              for (int v = 0; v < V; ++v) uo[v] = fmaf(go, h[j][v], uo[v]);
              if (f != o) {
                const float gf = fmaf(c_W[w2a + f * d + j], qa[j], c_W[w2b + f * d + j] * qb[j]);
#pragma unroll
                for (int v = 0; v < V; ++v) uf[v] = fmaf(gf, h[j][v], uf[v]);
              }
            }
          }
          const float ra = a3[oo + o], rb = b3[oo + o];
          float yo[V];
          if (f == o) {
#pragma unroll
            for (int v = 0; v < V; ++v) yo[v] = (ra + rb) * uo[v];
          } else {
            const float sa = a3[oo + f], sb = b3[oo + f];
            float yf[V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              yo[v] = fmaf(ra, uo[v], rb * uf[v]);
              yf[v] = fmaf(sa, uf[v], sb * uo[v]);
            }
            PK::store(ye + (long long)(oo + f) * C, yf);
          }
          PK::store(ye + (long long)(oo + o) * C, yo);
        }
      }
      wp += 2 * d * (iw + ow);
      io += iw;
      oo += ow;
    }
  }
}

template <typename T, int LMAX, int MMAX, int KIND>
int launch_kind(const void* x, const float* const (&t)[6], void* y, int E, int C,
                cudaStream_t stream) {
  constexpr int KI = n_in(LMAX, MMAX, KIND);
  constexpr int KM = (LMAX + 1) * (LMAX + 1);
  constexpr int KO = n_out(LMAX, MMAX, KIND);
  constexpr int WOFF = const_offset(LMAX, MMAX, KIND);
  static_assert(WOFF >= 0, "no constants for this instance");
  const int groups = C / V;
  int te = THREADS / groups;
  te = te < 1 ? 1 : (te > MAX_TILE ? MAX_TILE : te);
  const size_t smem = (size_t)te * 2 * (KI + KM + KO) * sizeof(float);
  const unsigned blocks = (unsigned)((E + te - 1) / te);
  rot_kernel<T, LMAX, MMAX, KIND, WOFF><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), t[0], t[1], t[2], t[3], t[4], t[5], static_cast<T*>(y), E, C,
      te);
  return (int)cudaGetLastError();
}

template <typename T, int LMAX, int MMAX>
int launch(int kind, const void* x, const float* const (&t)[6], void* y, int E, int C,
           cudaStream_t stream) {
  switch (kind) {
    case 0: return launch_kind<T, LMAX, MMAX, 0>(x, t, y, E, C, stream);
    case 1: return launch_kind<T, LMAX, MMAX, 1>(x, t, y, E, C, stream);
    case 2: return launch_kind<T, LMAX, MMAX, 2>(x, t, y, E, C, stream);
    case 3: return launch_kind<T, LMAX, MMAX, 3>(x, t, y, E, C, stream);
    default: return -1;
  }
}

template <typename T>
int dispatch(int kind, int lmax, int mmax, const void* x, const float* const (&t)[6],
             void* y, int E, int C, cudaStream_t stream) {
#define ETQ_CASE(L, M) \
  if (lmax == L && mmax == M) return launch<T, L, M>(kind, x, t, y, E, C, stream);
  ETQ_ROT_INSTANCES(ETQ_CASE)
#undef ETQ_CASE
  return -2;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  x [E, Ki, C] and y [E, Ko, C] of that
// dtype; the six tables float32, [E, Ki] x2, [E, (lmax+1)^2] x2, [E, Ko] x2;
// C a multiple of 4.  Returns 0, a cudaError_t (> 0) from the launch, -1 for
// an unknown kind, -2 for an (lmax, mmax) with no instance, -3 for a dtype,
// -4 for a channel count that is not a multiple of 4.
extern "C" int etq_rotate(int dtype, int kind, int lmax, int mmax, const void* x,
                          const void* t1a, const void* t1b, const void* t2a, const void* t2b,
                          const void* t3a, const void* t3b, void* y, int E, int C,
                          void* stream) {
  if (C % V) return -4;
  if (E == 0 || C == 0) return 0;
  const float* const t[6] = {
      static_cast<const float*>(t1a), static_cast<const float*>(t1b),
      static_cast<const float*>(t2a), static_cast<const float*>(t2b),
      static_cast<const float*>(t3a), static_cast<const float*>(t3b)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(kind, lmax, mmax, x, t, y, E, C, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(kind, lmax, mmax, x, t, y, E, C, s);
  return -3;
}

// The constants' layout, for ops/cuda/rotate.py to check its packing.
extern "C" int etq_rotate_const_floats() { return CONST_FLOATS; }

extern "C" int etq_rotate_const_offset(int lmax, int mmax, int kind) {
  const int off = const_offset(lmax, mmax, kind);
  return off < 0 ? -2 : off;
}

// Copy the packed constants (n floats, host memory) into c_W of the current
// device.  Returns 0, a cudaError_t, or -4 when n is not CONST_FLOATS.
extern "C" int etq_rotate_set_consts(const void* host, int n) {
  if (n != CONST_FLOATS) return -4;
  return (int)cudaMemcpyToSymbol(c_W, host, sizeof(float) * (size_t)n);
}

extern "C" const char* etq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
