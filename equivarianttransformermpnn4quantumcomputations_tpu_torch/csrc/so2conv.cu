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
// to_m / from_m permutation copy and no concatenation of outputs.  One
// launch covers every group of a site: the grid is the concatenation of
// each group's (edge tile, column tile) blocks.
//
// Bound: arithmetic.  QM9's conv 1 (Cin 256 -> Cout 128 + 384 extra, 19
// rows) does 4.59 M multiply-adds per edge on 19 x 256 inputs, ~290 flops
// per byte moved.  On FFMA (67 TFLOP/s) that site needs 2.68 ms; the card's
// tensor cores are faster, so the kernel runs there, on Hopper's warpgroup
// products (wgmma):
//   - float32: 3xTF32.  Each operand is split into a TF32 "big" part,
//     cvt.rna.tf32.f32(a), and a TF32 "small" part, cvt.rna.tf32.f32(a -
//     big); a b = big big + big small + small big (small small, ~2^-22
//     relative, is dropped): three TF32 products per f32 product, so the
//     bound is 3 flops / 495 TFLOP/s (1.09 ms at conv 1).  A single TF32
//     pass keeps ~11 bits and misses the f32 limit, so it is never taken.
//     The gathered A operand is split in registers (wgmma reads A from
//     registers); the B operand (the weight) is split once per call by
//     b_operand_kernel below, two tiles read from shared memory.
//     The tensor core's accumulation truncates; to keep that error from
//     growing with the depth, each 32-deep stage accumulates from zero and
//     is added to the running sum with an ordinary rounded f32 add.
//   - bfloat16: bf16 products with f32 accumulation, both operands read
//     from shared memory, one rounding on store; bound flops / 989 TFLOP/s.
// Design: 128 x 128 output tile per block, three warpgroups.  A producer
// warpgroup copies each stage (128-byte rows: K-depth 32 in f32, 64 in
// bf16) into a ring in dynamic shared memory (4 stages in f32, 192 KB; 6
// in bf16, 192 KB) with cp.async and signals a "full" mbarrier when they
// land; two consumer warpgroups (64 output rows each) issue the products
// and release the slot through an "empty" mbarrier, so no block-wide
// barrier stalls either side.  In f32 the consumers take turns to issue
// (named barriers): one warpgroup's products run while the other waits
// for its own, adds its stage's sum and splits its next A fragments, which
// keeps the tensor cores fed across the per-stage rounded add.  In bf16 a
// stage's products stay in flight while the next stage's are issued.  The
// tiles are stored in the 128-byte swizzle wgmma reads (16-byte piece q
// of row r at q ^ (r mod 8)), which also keeps ldmatrix and cp.async free
// of bank conflicts.  wgmma takes TF32 operands K-major only, so B is the
// weight with the GEMM depth contiguous: the adjoint's W_g as it lies, the
// forward's W_g^T (b_operand_kernel's copy, made with the split once per
// call).  Every segment of a gathered row (a Cin- or Cout-wide l-primary
// row, or the extra block) is a multiple of 8 wide, so each 16-byte piece
// of a stage lies in one 8-wide chunk with its own row lookup; pieces past
// the group's depth and rows past E are zero-filled by cp.async, never
// read.  The output is written straight from the accumulators, two
// adjacent columns per store, ragged rows and columns masked.  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace etq;  // the shared PTX helpers (csrc/hopper.cuh)

constexpr int BM = 128;          // edges per block tile
constexpr int BN = 128;          // output columns per block tile
constexpr int ROW = 128;         // bytes of one tile row: the swizzle atom's width
constexpr int TILE = BM * ROW;   // bytes of one [128][ROW] tile (BM == BN)
constexpr int CHUNK = 8;         // segment-width quantum: one row lookup per chunk
constexpr int CONSUMERS = 256;   // two warpgroups: the products, 64 output rows each
constexpr int PRODUCERS = 128;   // one warpgroup: the copies
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int MAXG = 8;          // m-groups (mmax <= 7)
constexpr int MAXR = 16;         // rows of one group (2 (lmax - m + 1) <= 16)

struct Group {
  int rows;              // l-primary rows of the group
  int lrow[MAXR];        // their indices, in the packed weight's order
  int in_extra;          // width of the leading extra block of an A row (adjoint, g = 0)
  int out_extra;         // width of the leading extra block of an output row (forward, g = 0)
  int kdim, ndim;        // GEMM depth and width
  int tiles_n;           // column tiles
  int tile0;             // first block of the group in the grid
  const void* b;         // B operand [ndim, kdim] (f32: its TF32 big part)
  const void* b_lo;      // f32: B's TF32 small part; bf16: unused
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

template <typename T>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int EP = 16 / (int)sizeof(T);            // elements per 16-byte piece
  static constexpr int BK = ROW / (int)sizeof(T);           // depth per stage: 32 f32, 64 bf16
  static constexpr int STAGES = F32 ? 4 : 6;                // ring depth
  static constexpr int STAGE_BYTES = (F32 ? 3 : 2) * TILE;  // A, B (, B small)
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment slack
  static_assert(CHUNK % EP == 0, "a 16-byte piece within one chunk");
};

// named barriers over the two consumer warpgroups (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
so2conv_kernel(const Params p) {
  using C = Cfg<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_lrow[MAXR];
  __shared__ __align__(8) uint64_t s_bar[2 * C::STAGES];  // full[s], empty[s]

  int g = 0;
#pragma unroll
  for (int i = 1; i < MAXG; ++i)
    if (i < p.n_groups && (int)blockIdx.x >= p.g[i].tile0) g = i;
  const int in_extra = p.g[g].in_extra, out_extra = p.g[g].out_extra;
  const int kdim = p.g[g].kdim, ndim = p.g[g].ndim, tiles_n = p.g[g].tiles_n;
  const int local = (int)blockIdx.x - p.g[g].tile0;
  const int mt = local / tiles_n;
  const int m0 = mt * BM, n0 = (local - mt * tiles_n) * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = smem_u32(&s_bar[0]), empty0 = smem_u32(&s_bar[C::STAGES]);
  const int nk = (kdim + C::BK - 1) / C::BK;
  if (tid < MAXR) s_lrow[tid] = p.g[g].lrow[tid];
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, PRODUCERS);           // the producer's threads
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);     // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // s_lrow, barriers

  if (warp >= CONSUMERS / 32) {
    // The producer warpgroup: stage kt's copies into slot kt % STAGES once
    // the consumers are done with the slot's previous stage.  Rows lr + 16 i
    // of each [128][ROW] tile, 16-byte piece q, in the 128-byte swizzle.
    const T* __restrict__ a = static_cast<const T*>(p.a);
    const T* __restrict__ a_extra = static_cast<const T*>(p.a_extra);
    const T* __restrict__ b_hi = static_cast<const T*>(p.g[g].b);
    const T* __restrict__ b_lo = static_cast<const T*>(p.g[g].b_lo);
    const int lr = (tid - CONSUMERS) >> 3, q = tid & 7;
    const uint32_t s_piece = (uint32_t)(lr * ROW + ((q ^ (lr & 7)) << 4));  // + 16 i ROW
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % C::STAGES;
      if (kt >= C::STAGES) mbar_wait(empty0 + 8 * slot, ((kt / C::STAGES) + 1) & 1);
      const uint32_t sa = s_base + slot * C::STAGE_BYTES;
      const int k = kt * C::BK + q * C::EP;
      const bool k_ok = k < kdim;
      // A: the gathered row segment of this piece's chunk
      const T* base = a;
      size_t stride = (size_t)p.K * p.c_in;
      int col = 0;
      if (k < in_extra) {
        base = a_extra;
        stride = (size_t)in_extra;
        col = k;
      } else if (k_ok) {
        const int kk = k - in_extra;
        const int j = kk / p.c_in;
        col = s_lrow[j] * p.c_in + (kk - j * p.c_in);
      }
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        const int e = m0 + lr + 16 * i;
        const bool ok = k_ok && e < p.E;
        cp_async16(sa + s_piece + i * 16 * ROW, ok ? base + (size_t)e * stride + col : a, ok);
      }
      // B: rows n of the K-major operand (and its small part in f32)
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int n = n0 + lr + 16 * i;
        const bool ok = k_ok && n < ndim;
        const size_t off = (size_t)n * kdim + k;
        const uint32_t dst = sa + TILE + s_piece + i * 16 * ROW;
        cp_async16(dst, ok ? b_hi + off : b_hi, ok);
        if constexpr (C::F32) cp_async16(dst + TILE, ok ? b_lo + off : b_lo, ok);
      }
      mbar_arrive_cp_async(full0 + 8 * slot);
    }
    cp_async_wait_all();  // no copy outlives its thread
    return;
  }

  // The consumers: warpgroup wg computes rows 64 wg .. of the tile.
  const int wg = warp >> 2;
  const int am = wg * 64 + (warp & 3) * 16 + (lane & 15);  // this lane's ldmatrix row
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float part[64];  // f32: one stage's sum
  if constexpr (C::F32) {
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  }
  if constexpr (C::F32) {
    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so one's products run while the other waits for
    // its own, adds its stage's sum and reads its next A fragments.
    uint32_t h[4][4], l[4][4];  // the stage's A fragments, split (big, small)
    if (wg == 1) bar_arrive(1);  // warpgroup 0 goes first
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % C::STAGES;
      const uint32_t sa = s_base + slot * C::STAGE_BYTES;
      mbar_wait(full0 + 8 * slot, (kt / C::STAGES) & 1);
      fence_proxy_async();  // the landed copies, to the tensor cores' reads
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        ldsm_x4(h[ks], sa + am * ROW + (((2 * ks + (lane >> 4)) ^ (am & 7)) << 4));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float f = __uint_as_float(h[ks][c]);
          h[ks][c] = to_tf32(f);
          l[ks][c] = to_tf32(f - __uint_as_float(h[ks][c]));
        }
      }
      bar_sync(1 + wg);  // this warpgroup's turn
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dh = desc_sw128(sa + TILE + ks * 32);
        const uint64_t dl = desc_sw128(sa + 2 * TILE + ks * 32);
        wgmma_tf32(part, l[ks], dh, ks > 0);
        wgmma_tf32(part, h[ks], dl, 1);
        wgmma_tf32(part, h[ks], dh, 1);
      }
      wgmma_commit();
      if (!(wg == 1 && kt == nk - 1)) bar_arrive(2 - wg);  // the other's turn
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        fence_regs(h[ks]);
        fence_regs(l[ks]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done with the slot
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];  // the stage's sum, rounded
    }
  } else {
    // bf16: stage kt's products stay in flight while stage kt + 1's are
    // issued; the slot of stage kt - 1 is released once they are done
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % C::STAGES;
      const uint32_t sa = s_base + slot * C::STAGE_BYTES;
      mbar_wait(full0 + 8 * slot, (kt / C::STAGES) & 1);
      fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_bf16(acc, desc_sw128(sa + wg * 64 * ROW + ks * 32),
                   desc_sw128(sa + TILE + ks * 32));
      wgmma_commit();
      wgmma_wait<1>();
      __syncwarp();
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % C::STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // epilogue: n8 block j holds (row g, columns 8j + 2t, + 1) in acc[4j],
  // acc[4j + 1] and row g + 8 in acc[4j + 2], acc[4j + 3]
  T* __restrict__ out = static_cast<T*>(p.out);
  T* __restrict__ out_x = static_cast<T*>(p.out_extra);
  const int e0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + j * 8 + 2 * (lane & 3);
    if (n >= ndim) continue;
    T* dst = out_x;
    size_t stride = (size_t)out_extra;
    int col = n;
    if (n >= out_extra) {
      const int nn = n - out_extra;
      const int jr = nn / p.c_out;
      dst = out;
      stride = (size_t)p.K * p.c_out;
      col = s_lrow[jr] * p.c_out + (nn - jr * p.c_out);
    }
    if (e0 < p.E) store2(dst + (size_t)e0 * stride + col, acc[4 * j], acc[4 * j + 1]);
    if (e0 + 8 < p.E)
      store2(dst + (size_t)(e0 + 8) * stride + col, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The B operand of one group for so2conv_kernel, from its packed weight
// w [R, N]: transpose = 1 (the forward) hi [N, R] = w^T, 0 (the adjoint)
// hi [R, N] = w; float32 is split into hi = tf32(w), lo = tf32(w - hi),
// bfloat16 copied (lo unused).  32 x 32 tiles through shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
b_operand_kernel(const T* __restrict__ w, T* __restrict__ hi, T* __restrict__ lo, int R,
                 int N, int transpose) {
  __shared__ T tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int j = ty; j < 32; j += 8)
    if (r0 + j < R && c0 + tx < N) tile[j][tx] = w[(size_t)(r0 + j) * N + c0 + tx];
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int r = transpose ? r0 + tx : r0 + j, c = transpose ? c0 + j : c0 + tx;
    if (r >= R || c >= N) continue;
    const T v = transpose ? tile[tx][j] : tile[j][tx];
    const size_t o = transpose ? (size_t)c * R + r : (size_t)r * N + c;
    if constexpr (sizeof(T) == 4) {
      const uint32_t h = to_tf32(v);
      hi[o] = __uint_as_float(h);
      lo[o] = __uint_as_float(to_tf32(v - __uint_as_float(h)));
    } else {
      hi[o] = v;
    }
  }
}

template <typename T>
int launch(const Params& prm, int blocks, cudaStream_t stream) {
  constexpr int smem = Cfg<T>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      so2conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  so2conv_kernel<T><<<blocks, THREADS, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// One SO(2)-conv site, forward (adjoint = 0) or adjoint (adjoint = 1).
//   dtype 0 = float32, 1 = bfloat16 (inputs, weights and outputs alike).
//   a:  forward x [E, K, c_in];  adjoint dy [E, K, c_in] (c_in = the forward's Cout)
//   a_extra: adjoint dextra [E, extra] (unused by the forward)
//   b:  host array of n_groups device pointers, the K-major B operand of
//       each group's GEMM, [ndim_g, kdim_g]: forward W_g^T [N_g, rows_g Cin],
//       adjoint W_g [rows_g Cin, N_g]; float32: its TF32 big part
//   b_lo: float32: host array of the TF32 small parts (b + b_lo ~ the
//       weight); bfloat16: unused (may be null)
//   out: forward y [E, K, c_out];  adjoint dx [E, K, c_out] (c_out = the forward's Cin)
//   out_extra: forward extra [E, extra] (unused by the adjoint)
//   group_rows / lrows: host arrays, rows per group and their l-primary
//   indices, concatenated over groups.
// Returns 0, a cudaError_t (> 0), -2 for sizes the kernel does not take
// (widths not multiples of 8, too many groups or rows), -3 for a dtype.
extern "C" int etq_so2conv(int dtype, int adjoint, int E, int K, int c_in, int c_out,
                           int n_groups, const int* group_rows, const int* lrows,
                           int extra, const void* a, const void* a_extra,
                           const void* const* b, const void* const* b_lo, void* out,
                           void* out_extra, void* stream) {
  if (dtype != 0 && dtype != 1) return -3;
  if (n_groups < 1 || n_groups > MAXG || c_in % CHUNK || c_out % CHUNK || extra % CHUNK)
    return -2;
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
    G.b = b[g];
    G.b_lo = dtype == 0 ? b_lo[g] : nullptr;
    blocks += (long long)tiles_m * G.tiles_n;
  }
  if (blocks > 0x7fffffff) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(prm, (int)blocks, s);
  return launch<__nv_bfloat16>(prm, (int)blocks, s);
}

// The B operand of one group (see b_operand_kernel): dtype 0 = float32
// (hi and lo written), 1 = bfloat16 (hi written).  Returns 0, a cudaError_t
// (> 0), -2 for sizes it does not take, -3 for a dtype.
extern "C" int etq_so2conv_b(int dtype, int transpose, int R, int N, const void* w, void* hi,
                             void* lo, void* stream) {
  if (dtype != 0 && dtype != 1) return -3;
  if (R <= 0 || N <= 0) return R == 0 || N == 0 ? 0 : -2;
  const dim3 grid((N + 31) / 32, (R + 31) / 32);
  if (grid.y > 65535) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    b_operand_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(w), static_cast<float*>(hi), static_cast<float*>(lo), R, N,
        transpose);
  else
    b_operand_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(hi), nullptr, R, N,
        transpose);
  return (int)cudaGetLastError();
}

extern "C" const char* etq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
