// K3: fused SO(2) convolution and its adjoint, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_adj_kernel` (launched
// by `_call_fwd` / `_call_adj`) of
// equivarianttransformermpnn4quantumcomputations_tpu/ops/pallas/so2conv.py.
//
// One SO(2)-conv site is a set of GEMMs, one per m-group g (g = 0 is m = 0,
// g = m > 0 the pair of +m / -m rows), each with a packed weight
// W_g [rows_g * Cin, N_g] (m = 0: N_0 = extra + rows_0 * Cout; m > 0 the
// complex butterfly [[wr, wi], [-wi, wr]], N_g = rows_g * Cout):
//
//   forward  acc[e, n]  = sum_j sum_c x[e, lrow_g(j), c] * W_g[j Cin + c, n]
//            n <  extra (g = 0)  -> extra_out[e, n]
//            n = base + j Cout + c -> y[e, lrow_g(j), c]
//   adjoint  dx[e, lrow_g(j), c] = sum_n dY_g[e, n] * W_g[j Cin + c, n],
//            dY_g = [dextra (g = 0) | dy[e, lrow_g(j), :] for each j]
//
// with lrow_g the l-primary rows of group g in the m-primary order of the
// packed weight (ops/cuda/so2conv.py:_row_maps).  Rows are gathered from and
// scattered to the l-primary tensors inside the kernel: there is no
// to_m / from_m permutation copy, no concatenation of outputs and no
// transposed copy of W (the adjoint reads W_g transposed from its forward
// layout).  One launch covers every group of a site: the grid is the
// concatenation of each group's (edge tile, column tile) blocks.
//
// Bound: arithmetic.  QM9's conv 1 (Cin 256 -> Cout 128 + 384 extra, 19
// rows) does 4.59 M multiply-adds per edge on 19 x 256 inputs: ~230 flops
// per byte moved, far above the card's 20 f32 flops per byte.  Design: a
// plain register-blocked f32 FFMA GEMM (no tensor cores yet): 128 x 128
// output tile per block of 256 threads, 8 x 8 outputs per thread, K-depth 8
// staged through double-buffered shared memory with the next tile's global
// loads held in registers while the current one is consumed.  Every
// segment of a gathered row (a Cin- or Cout-wide l-primary row, or the
// extra block) is a multiple of 8 wide, so one K-step of 8 never crosses a
// segment and the gather costs one row lookup per K-step.  bf16 inputs are
// widened to f32 on load; accumulation is f32 and the output is rounded
// once.  The ragged edge tail is masked (no padding of E).  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // edges per block tile
constexpr int BN = 128;     // output columns per block tile
constexpr int BK = 8;       // GEMM depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int MAXG = 8;     // m-groups (mmax <= 7)
constexpr int MAXR = 16;    // rows of one group (2 (lmax - m + 1) <= 16)

struct Group {
  int rows;              // l-primary rows of the group
  int lrow[MAXR];        // their indices, in the packed weight's order
  int in_extra;          // width of the leading extra block of an A row (adjoint, g = 0)
  int out_extra;         // width of the leading extra block of an output row (forward, g = 0)
  int kdim, ndim;        // GEMM depth and width
  int tiles_n;           // column tiles
  int tile0;             // first block of the group in the grid
  const void* w;         // packed weight [rows * Cin, N_g] (forward orientation)
};

struct Params {
  int n_groups, E, K;    // K: rows of the l-primary tensors
  int c_in, c_out;       // channels of the input / output l-primary rows
  const void* a;         // [E, K, c_in]
  const void* a_extra;   // [E, in_extra of group 0]
  void* out;             // [E, K, c_out]
  void* out_extra;       // [E, out_extra of group 0]
  Group g[MAXG];
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ADJ = false: the forward (B[k][n] = W[k][n]); true: the adjoint
// (B[k][n] = W[n][k], W read transposed in place).
template <typename T, bool ADJ>
__global__ void __launch_bounds__(THREADS, 2)
so2conv_kernel(const Params p) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ int s_lrow[MAXR];

  int g = 0;
#pragma unroll
  for (int i = 1; i < MAXG; ++i)
    if (i < p.n_groups && (int)blockIdx.x >= p.g[i].tile0) g = i;
  const int in_extra = p.g[g].in_extra, out_extra = p.g[g].out_extra;
  const int kdim = p.g[g].kdim, ndim = p.g[g].ndim, tiles_n = p.g[g].tiles_n;
  const int local = (int)blockIdx.x - p.g[g].tile0;
  const T* __restrict__ w = static_cast<const T*>(p.g[g].w);
  if (threadIdx.x < MAXR) s_lrow[threadIdx.x] = p.g[g].lrow[threadIdx.x];

  const int mt = local / tiles_n;
  const int m0 = mt * BM, n0 = (local - mt * tiles_n) * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ a_extra = static_cast<const T*>(p.a_extra);

  // loader roles: A tile [BM edges][BK], one float4 of a row per thread
  const int a_m = tid >> 1, a_k = (tid & 1) * 4;
  const int a_e = m0 + a_m;
  // B tile [BK][BN]: forward reads 4 columns of one W row; adjoint reads 4
  // depths of one W row (column n of the transposed view)
  const int b_k = ADJ ? (tid & 1) * 4 : tid >> 5;
  const int b_n = ADJ ? tid >> 1 : (tid & 31) * 4;
  const bool b_ok = n0 + b_n < ndim;

  auto load_a = [&](int k0) -> float4 {
    if (a_e >= p.E) return make_float4(0.f, 0.f, 0.f, 0.f);
    const int k = k0 + a_k;
    if (k < in_extra) return load4(a_extra + (size_t)a_e * in_extra + k);
    const int kk = k - in_extra;
    const int j = kk / p.c_in;
    return load4(a + ((size_t)a_e * p.K + s_lrow[j]) * p.c_in + (kk - j * p.c_in));
  };
  auto load_b = [&](int k0) -> float4 {
    if (!b_ok) return make_float4(0.f, 0.f, 0.f, 0.f);
    if (ADJ) return load4(w + (size_t)(n0 + b_n) * kdim + k0 + b_k);
    return load4(w + (size_t)(k0 + b_k) * ndim + n0 + b_n);
  };
  auto store_tiles = [&](int buf, float4 va, float4 vb) {
    As[buf][a_k + 0][a_m] = va.x;
    As[buf][a_k + 1][a_m] = va.y;
    As[buf][a_k + 2][a_m] = va.z;
    As[buf][a_k + 3][a_m] = va.w;
    if (ADJ) {
      Bs[buf][b_k + 0][b_n] = vb.x;
      Bs[buf][b_k + 1][b_n] = vb.y;
      Bs[buf][b_k + 2][b_n] = vb.z;
      Bs[buf][b_k + 3][b_n] = vb.w;
    } else {
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = vb;
    }
  };

  __syncthreads();  // s_lrow
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra = load_a(0), rb = load_b(0);
  store_tiles(0, ra, rb);
  __syncthreads();
  const int nk = kdim / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      ra = load_a((kt + 1) * BK);
      rb = load_b((kt + 1) * BK);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_tiles(cur ^ 1, ra, rb);
    __syncthreads();
  }

  T* __restrict__ out = static_cast<T*>(p.out);
  T* __restrict__ out_x = static_cast<T*>(p.out_extra);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (e >= p.E) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= ndim) continue;
      const float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                   acc[i][4 * h + 3]);
      if (n < out_extra) {
        store4(out_x + (size_t)e * out_extra + n, v);
      } else {
        const int nn = n - out_extra;
        const int j = nn / p.c_out;
        store4(out + ((size_t)e * p.K + s_lrow[j]) * p.c_out + (nn - j * p.c_out), v);
      }
    }
  }
}

template <typename T>
int launch(bool adjoint, const Params& prm, int blocks, cudaStream_t stream) {
  if (adjoint)
    so2conv_kernel<T, true><<<blocks, THREADS, 0, stream>>>(prm);
  else
    so2conv_kernel<T, false><<<blocks, THREADS, 0, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// One SO(2)-conv site, forward (adjoint = 0) or adjoint (adjoint = 1).
//   dtype 0 = float32, 1 = bfloat16 (inputs, weights and outputs alike).
//   a:  forward x [E, K, c_in];  adjoint dy [E, K, c_in] (c_in = the forward's Cout)
//   a_extra: adjoint dextra [E, extra] (unused by the forward)
//   w:  host array of n_groups device pointers, W_g [rows_g * Cin, N_g]
//   out: forward y [E, K, c_out];  adjoint dx [E, K, c_out] (c_out = the forward's Cin)
//   out_extra: forward extra [E, extra] (unused by the adjoint)
//   group_rows / lrows: host arrays, rows per group and their l-primary
//   indices, concatenated over groups.
// Returns 0, a cudaError_t (> 0), -2 for sizes the kernel does not take
// (widths not multiples of 8, too many groups or rows), -3 for a dtype.
extern "C" int etq_so2conv(int dtype, int adjoint, int E, int K, int c_in, int c_out,
                           int n_groups, const int* group_rows, const int* lrows,
                           int extra, const void* a, const void* a_extra,
                           const void* const* w, void* out, void* out_extra,
                           void* stream) {
  if (dtype != 0 && dtype != 1) return -3;
  if (n_groups < 1 || n_groups > MAXG || c_in % BK || c_out % BK || extra % BK) return -2;
  if (E == 0) return 0;
  Params prm = {};
  prm.n_groups = n_groups;
  prm.E = E;
  prm.K = K;
  prm.c_in = c_in;
  prm.c_out = c_out;
  prm.a = a;
  prm.a_extra = a_extra;
  prm.out = out;
  prm.out_extra = out_extra;
  const int tiles_m = (E + BM - 1) / BM;
  long long blocks = 0;
  int off = 0;
  for (int g = 0; g < n_groups; ++g) {
    Group& G = prm.g[g];
    G.rows = group_rows[g];
    if (G.rows < 1 || G.rows > MAXR) return -2;
    for (int j = 0; j < G.rows; ++j) {
      if (lrows[off + j] < 0 || lrows[off + j] >= K) return -2;
      G.lrow[j] = lrows[off + j];
    }
    off += G.rows;
    const int ex = g == 0 ? extra : 0;
    G.in_extra = adjoint ? ex : 0;
    G.out_extra = adjoint ? 0 : ex;
    G.kdim = G.in_extra + G.rows * c_in;
    G.ndim = G.out_extra + G.rows * c_out;
    G.tiles_n = (G.ndim + BN - 1) / BN;
    G.tile0 = (int)blocks;
    G.w = w[g];
    blocks += (long long)tiles_m * G.tiles_n;
  }
  if (blocks > 0x7fffffff) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(adjoint != 0, prm, (int)blocks, s);
  return launch<__nv_bfloat16>(adjoint != 0, prm, (int)blocks, s);
}

extern "C" const char* etq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
