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

// ── K3-dW: the weight gradient of a site ──────────────────────────────────
//
// For every m-group g of a site, over the edge rows [0, live):
//
//   dW_g[k, n] = sum_e X_g[e, k] Y_g[e, n],   dW_g [kdim_g, ndim_g] = W_g's shape
//   X_g[e, j Cin + c]             = x[e, lrow_g(j), c]
//   Y_g[e, n]                     = y_extra[e, n]                 (g = 0, n < extra)
//   Y_g[e, extra_g + j Cout + c]  = y[e, lrow_g(j), c]
//
// the gradient of W_g in both directions of the site: (x, dy | dextra) in
// the forward's backward and (ddx, dy | dextra) in the adjoint's.  It
// replaces no Pallas kernel: the JAX package leaves dW to XLA (a per-group
// gather, concatenation and dot).
//
// Live rows: in the ragged layout the padding edges lie in rows [E_real, E)
// and take exactly zero cotangents (masked sums and softmax), so the
// wrapper passes a device scalar `live` (the last real row + 1, made once
// per forward without a host sync) and the kernel reduces [0, live) only:
// the same sum, ~30 % of the rows of a QM9 batch.  Without it (null) every
// row is reduced.  Block 0 adds (live, E) to a device counter pair.
//
// Bound: arithmetic.  QM9's conv 1 at 17,952 live rows: 2 x 17,952 x
// 4,587,520 = 165 GFLOP; in 3xTF32, 3 flops / 495 TFLOP/s = 1.00 ms against
// 0.17 ms for X, Y and dW moved once.
//
// Design: the GEMM depth is the edge axis, the slow axis of both X and Y, so
// both operands lie M- (N-) major, and wgmma takes TF32 operands K-major
// only.  The kernel issues warp-level mma.sync m16n8k8 TF32 products whose
// fragments are read straight from the natural layout: a stage holds 32
// edge rows of each operand's 128 columns, staged as they lie by cp.async
// (4 stages in flight) into rows of 136 elements, so a fragment's 32 reads
// (column g, depth row t) hit 32 distinct banks.
//   - float32: 3xTF32, as so2conv_kernel: each operand split into TF32 big
//     and small parts in registers (dw_split), a b ~ small big + big small
//     + big big.  Each 32-deep stage accumulates from zero and is added to
//     the running sum with a rounded f32 add: the depth (~18,000 rows)
//     would otherwise grow the tensor core's truncation error with it.
//   - bfloat16: a bf16 value is exact in TF32, so one TF32 product per
//     product is the bf16 product exactly, summed in f32 (the same
//     per-stage sums); one rounding to bf16 on the final store.
// Measured (H100, QM9's conv 1 over 17,952 of 59,520 rows): 2.64 ms, 38 %
// of the bound; without the copies (the stages never refilled) 2.31 ms,
// without the products 1.38 ms: the mma.sync TF32 pipe bounds it, at about
// a third of the tensor cores' TF32 rate (bf16, a third of the products,
// 1.02 ms alone).  A faster kernel takes wgmma: X's fragments can come from
// registers as read here, Y would be written K-major (transposed) and split
// into shared memory by a producer warpgroup.  Eight warps of 64 x 32 (213
// registers, 2.64 ms) beat sixteen of 32 x 32 (126 registers, 2.85 ms).
// One launch covers every group: the grid is each group's 128 x 128 output
// tiles times `slices` slices of the depth.  The tiles are few and deep
// (QM9's conv 1 has 280, conv 2 125, for 132 SMs), so each block reads
// `live` and takes an even share of [0, live), in 32-row stages, so no
// block walks over padding.  A block writes its partial tile to a workspace
// [slices][tiles][128 x 128] (float32, from the wrapper); so2conv_dw_reduce
// then adds the slices of each element in slice order and stores dW_g in
// the weight's type: no float atomics, the same bits every run.

constexpr int DW_BM = 128;          // rows of dW per block tile (X's columns)
constexpr int DW_BN = 128;          // columns of dW per block tile (Y's columns)
constexpr int DW_BK = 32;           // edge rows per stage: the GEMM's depth
constexpr int DW_LD = DW_BM + 8;    // elements per staged row: fragment reads free of conflicts
constexpr int DW_STAGES = 4;        // cp.async ring depth
constexpr int DW_WM = 2;            // warps along the tile's rows
constexpr int DW_WN = 4;            // warps along its columns
constexpr int DW_THREADS = 32 * DW_WM * DW_WN;
constexpr int DW_MI = DW_BM / DW_WM / 16;   // m16 fragments of a warp's rows
constexpr int DW_NJ = DW_BN / DW_WN / 8;    // n8 fragments of its columns
constexpr int DW_REDUCE = 256;      // threads of a reduce block, 4 elements each
static_assert(DW_BM == DW_BN, "one staging layout for both operands");

struct DwGroup {
  int rows;              // l-primary rows of the group
  int lrow[MAXR];        // their indices, in the packed weight's order
  int extra;             // leading columns of Y from y_extra (g = 0)
  int kdim, ndim;        // dW_g's shape
  int tiles_n;           // column tiles
  int tile0;             // first tile of the group
  void* out;             // dW_g [kdim, ndim], the operands' type
};

struct DwParams {
  int n_groups, E, K;    // K: rows of the l-primary tensors
  int c_in, c_out;       // channels of x's and y's rows
  int tiles, slices;     // output tiles of all groups; depth slices
  const void* x;         // [E, K, c_in]
  const void* y;         // [E, K, c_out]
  const void* y_extra;   // [E, extra of group 0]
  const int* live;       // device scalar: rows [0, *live) are reduced; null: all E
  unsigned long long* rows;  // device (rows reduced, rows offered), added to; null: none
  float* work;           // [slices][tiles][DW_BM * DW_BN] partial sums
  DwGroup g[MAXG];
};

template <typename T>
struct DwCfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int EP = 16 / (int)sizeof(T);      // elements per 16-byte piece
  static constexpr int PIECES = DW_BM / EP;            // pieces of a staged row
  static constexpr int RSTEP = DW_THREADS / PIECES;    // rows one pass of the threads copies
  static constexpr int TILE = DW_BK * DW_LD;           // elements of one staged operand
  static constexpr int SMEM = DW_STAGES * 2 * TILE * (int)sizeof(T);
  static_assert(DW_BK % RSTEP == 0 && CHUNK % EP == 0, "whole passes; a piece in one chunk");
};

__device__ __forceinline__ int dw_group(const DwParams& p, int tile) {
  int g = 0;
#pragma unroll
  for (int i = 1; i < MAXG; ++i)
    if (i < p.n_groups && tile >= p.g[i].tile0) g = i;
  return g;
}

// The 3xTF32 split in integer and FP32 instructions: big = v rounded to
// TF32 as cvt.rna.tf32.f32 rounds finite values (to nearest on the 13 low
// bits, ties away from zero), small = v - big exactly, handed to the tensor
// core as it is (which reads its top 19 bits).  Two cvt per element made
// the kernel 1.2x slower (3.19 against 2.64 ms at QM9's conv 1) for the
// same error.
__device__ __forceinline__ void dw_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ float dw_load(const float* s) { return *s; }
__device__ __forceinline__ float dw_load(const __nv_bfloat16* s) { return __bfloat162float(*s); }

template <typename T>
__global__ void __launch_bounds__(DW_THREADS, 1)
so2conv_dw_kernel(const DwParams p) {
  using C = DwCfg<T>;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  __shared__ int s_lrow[MAXR];

  const int tile = (int)blockIdx.x % p.tiles, slice = (int)blockIdx.x / p.tiles;
  const int g = dw_group(p, tile);
  const int extra = p.g[g].extra, kdim = p.g[g].kdim, ndim = p.g[g].ndim;
  const int local = tile - p.g[g].tile0, mt = local / p.g[g].tiles_n;
  const int m0 = mt * DW_BM, n0 = (local - mt * p.g[g].tiles_n) * DW_BN;
  const int tid = threadIdx.x;
  if (tid < MAXR) s_lrow[tid] = p.g[g].lrow[tid];
  const int live = p.live == nullptr ? p.E : min(max(__ldg(p.live), 0), p.E);
  if (blockIdx.x == 0 && tid == 0 && p.rows != nullptr) {
    atomicAdd(p.rows, (unsigned long long)live);
    atomicAdd(p.rows + 1, (unsigned long long)p.E);
  }
  // this block's share of the live rows, whole stages
  const int chunk = ((live + p.slices - 1) / p.slices + DW_BK - 1) / DW_BK * DW_BK;
  const int r0 = min(slice * chunk, live), r1 = min(r0 + chunk, live);
  const int nk = (r1 - r0 + DW_BK - 1) / DW_BK;
  __syncthreads();  // s_lrow

  // Copies: thread (row rr + i RSTEP, piece pc) of each staged operand.
  // Each piece's column lies in one 8-wide chunk: one row lookup per thread.
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ y = static_cast<const T*>(p.y);
  const int pc = tid % C::PIECES, rr = tid / C::PIECES;
  const int ka = m0 + pc * C::EP, kb = n0 + pc * C::EP;
  const bool a_ok = ka < kdim, b_ok = kb < ndim;
  const size_t a_stride = (size_t)p.K * p.c_in;
  size_t a_col = 0;
  if (a_ok) {
    const int j = ka / p.c_in;
    a_col = (size_t)s_lrow[j] * p.c_in + (ka - j * p.c_in);
  }
  const T* b_base = y;
  size_t b_stride = (size_t)p.K * p.c_out, b_col = 0;
  if (kb < extra) {
    b_base = static_cast<const T*>(p.y_extra);
    b_stride = (size_t)extra;
    b_col = kb;
  } else if (b_ok) {
    const int nn = kb - extra, j = nn / p.c_out;
    b_col = (size_t)s_lrow[j] * p.c_out + (nn - j * p.c_out);
  }
  const uint32_t s_base = smem_u32(dw_smem);
  auto load = [&](int kt) {
    const uint32_t sa = s_base + (uint32_t)((kt % DW_STAGES) * 2 * C::TILE * sizeof(T));
    const uint32_t sb = sa + (uint32_t)(C::TILE * sizeof(T));
    const int e0 = r0 + kt * DW_BK;
#pragma unroll
    for (int i = 0; i < DW_BK / C::RSTEP; ++i) {
      const int r = rr + i * C::RSTEP, e = e0 + r;
      const uint32_t off = (uint32_t)((r * DW_LD + pc * C::EP) * sizeof(T));
      const bool in = e < r1;
      cp_async16(sa + off, in && a_ok ? x + (size_t)e * a_stride + a_col : x, in && a_ok);
      cp_async16(sb + off, in && b_ok ? b_base + (size_t)e * b_stride + b_col : y, in && b_ok);
    }
  };

  // The products: warp (wm, wn) computes rows wm .. wm + 63, columns wn ..
  // wn + 31 of the tile, 4 x 4 m16n8 accumulators.
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wm = (warp % DW_WM) * (DW_BM / DW_WM), wn = (warp / DW_WM) * (DW_BN / DW_WN);
  const T* smem = reinterpret_cast<const T*>(dw_smem);
  float acc[DW_MI][DW_NJ][4];
#pragma unroll
  for (int i = 0; i < DW_MI; ++i)
#pragma unroll
    for (int j = 0; j < DW_NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_group<DW_STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();  // everyone's copies; everyone is done with stage kt - 1's slot
    if (kt + DW_STAGES - 1 < nk) load(kt + DW_STAGES - 1);
    cp_async_commit();
    const T* sa = smem + (kt % DW_STAGES) * 2 * C::TILE;
    const T* sb = sa + C::TILE;
    float part[DW_MI][DW_NJ][4];  // this stage's sum
#pragma unroll
    for (int i = 0; i < DW_MI; ++i)
#pragma unroll
      for (int j = 0; j < DW_NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DW_BK / 8; ++kk) {
      // A (16 x 8) = X^T: element (m, depth t) is staged row t, column m;
      // B (8 x 8) = Y: element (depth t, n) is staged row t, column n
      const T* ra = sa + (8 * kk + tq) * DW_LD;
      const T* rb = sb + (8 * kk + tq) * DW_LD;
      uint32_t ah[DW_MI][4], al[DW_MI][4], bh[DW_NJ][2], bl[DW_NJ][2];
#pragma unroll
      for (int i = 0; i < DW_MI; ++i) {
        const int m = wm + 16 * i + gq;
        const float v[4] = {dw_load(ra + m), dw_load(ra + m + 8), dw_load(ra + 4 * DW_LD + m),
                            dw_load(ra + 4 * DW_LD + m + 8)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (C::F32) dw_split(v[c], ah[i][c], al[i][c]);
          else ah[i][c] = __float_as_uint(v[c]);
        }
      }
#pragma unroll
      for (int j = 0; j < DW_NJ; ++j) {
        const int n = wn + 8 * j + gq;
        const float v[2] = {dw_load(rb + n), dw_load(rb + 4 * DW_LD + n)};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if constexpr (C::F32) dw_split(v[c], bh[j][c], bl[j][c]);
          else bh[j][c] = __float_as_uint(v[c]);
        }
      }
#pragma unroll
      for (int i = 0; i < DW_MI; ++i)
#pragma unroll
        for (int j = 0; j < DW_NJ; ++j) {
          if constexpr (C::F32) {
            mma_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
            mma_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
          }
          mma_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < DW_MI; ++i)
#pragma unroll
      for (int j = 0; j < DW_NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];  // the stage's sum, rounded
  }
  cp_async_wait_all();  // no copy outlives its thread

  // the partial tile: m16n8 block (i, j) holds (row gq, columns 2 tq, + 1) in
  // acc[i][j][0..1] and row gq + 8 in acc[i][j][2..3]
  float* w = p.work + ((size_t)slice * p.tiles + tile) * (DW_BM * DW_BN);
#pragma unroll
  for (int i = 0; i < DW_MI; ++i)
#pragma unroll
    for (int j = 0; j < DW_NJ; ++j) {
      const int m = wm + 16 * i + gq, n = wn + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(w + m * DW_BN + n) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(w + (m + 8) * DW_BN + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

__device__ __forceinline__ void dw_store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void dw_store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// dW_g from the partial tiles: block (tile, q) adds, for 4 adjacent elements
// a thread, the slices in slice order and stores them in the weight's type.
template <typename T>
__global__ void __launch_bounds__(DW_REDUCE)
so2conv_dw_reduce(const DwParams p) {
  const int tile = blockIdx.x, g = dw_group(p, tile);
  const int kdim = p.g[g].kdim, ndim = p.g[g].ndim;
  const int local = tile - p.g[g].tile0, mt = local / p.g[g].tiles_n;
  const int idx = ((int)blockIdx.y * DW_REDUCE + (int)threadIdx.x) * 4;
  const int m = mt * DW_BM + idx / DW_BN;
  const int n = (local - mt * p.g[g].tiles_n) * DW_BN + idx % DW_BN;
  if (m >= kdim || n >= ndim) return;  // ndim is a multiple of 8: 4 columns in or out
  const size_t step = (size_t)p.tiles * DW_BM * DW_BN;
  const float* w = p.work + (size_t)tile * DW_BM * DW_BN + idx;
  float4 s = *reinterpret_cast<const float4*>(w);
  for (int sl = 1; sl < p.slices; ++sl) {
    const float4 v = *reinterpret_cast<const float4*>(w + sl * step);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  dw_store4(static_cast<T*>(p.g[g].out) + (size_t)m * ndim + n, s);
}

template <typename T>
int launch_dw(const DwParams& prm, cudaStream_t stream) {
  constexpr int smem = DwCfg<T>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      so2conv_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  so2conv_dw_kernel<T><<<prm.tiles * prm.slices, DW_THREADS, smem, stream>>>(prm);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  so2conv_dw_reduce<T><<<dim3(prm.tiles, DW_BM * DW_BN / (4 * DW_REDUCE)), DW_REDUCE, 0,
                         stream>>>(prm);
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

// K3-dW of one site (see so2conv_dw_kernel): dW_g = X_g^T Y_g for every
// group, over the rows [0, *live) (live null: all E), then the reduce.
//   dtype 0 = float32, 1 = bfloat16 (x, y, y_extra and the outputs alike).
//   x [E, K, c_in]; y [E, K, c_out]; y_extra [E, extra] (extra 0: unused)
//   rows: device (rows reduced, rows offered) that block 0 adds to, or null
//   slices: depth slices per output tile (>= 1); work: float32 workspace of
//   slices x tiles x 128 x 128 (tiles: every group's 128 x 128 tiles of dW_g)
//   out: host array of n_groups device pointers, dW_g [rows_g c_in,
//   (g == 0 ? extra : 0) + rows_g c_out]
//   group_rows / lrows: as etq_so2conv.
// Returns 0, a cudaError_t (> 0), -2 for sizes the kernel does not take,
// -3 for a dtype.
extern "C" int etq_so2conv_dw(int dtype, int E, int K, int c_in, int c_out, int n_groups,
                              const int* group_rows, const int* lrows, int extra,
                              const void* x, const void* y, const void* y_extra,
                              const int* live, unsigned long long* rows, int slices,
                              float* work, void* const* out, void* stream) {
  if (dtype != 0 && dtype != 1) return -3;
  if (n_groups < 1 || n_groups > MAXG || c_in % CHUNK || c_out % CHUNK || extra % CHUNK ||
      slices < 1 || E < 0)
    return -2;
  DwParams prm = {};
  prm.n_groups = n_groups;
  prm.E = E;
  prm.K = K;
  prm.c_in = c_in;
  prm.c_out = c_out;
  prm.slices = slices;
  prm.x = x;
  prm.y = y;
  prm.y_extra = y_extra;
  prm.live = live;
  prm.rows = rows;
  prm.work = work;
  long long tiles = 0;
  int off = 0;
  for (int g = 0; g < n_groups; ++g) {
    DwGroup& G = prm.g[g];
    G.rows = group_rows[g];
    if (G.rows < 1 || G.rows > MAXR) return -2;
    for (int j = 0; j < G.rows; ++j) {
      if (lrows[off + j] < 0 || lrows[off + j] >= K) return -2;
      G.lrow[j] = lrows[off + j];
    }
    off += G.rows;
    G.extra = g == 0 ? extra : 0;
    G.kdim = G.rows * c_in;
    G.ndim = G.extra + G.rows * c_out;
    G.tiles_n = (G.ndim + DW_BN - 1) / DW_BN;
    G.tile0 = (int)tiles;
    G.out = out[g];
    tiles += (long long)((G.kdim + DW_BM - 1) / DW_BM) * G.tiles_n;
  }
  if (tiles * slices > 0x7fffffff) return -2;
  prm.tiles = (int)tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dw<float>(prm, s);
  return launch_dw<__nv_bfloat16>(prm, s);
}

extern "C" const char* etq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
