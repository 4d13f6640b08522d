// K2a / K2b / K2c: fused S2 point-sample activation and its first and
// second adjoints, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_k1`, `_k2` and `_k3` (launched by
// `_call`) of equivarianttransformermpnn4quantumcomputations_tpu/ops/pallas/
// s2act.py:
//
//   K2a  out   = F^T silu(A x)                      (to-grid, SiLU, from-grid;
//        s2act_tc_kernel<T, K, 0>, replaces `_k1`, s2act.py:122)
//   K2b  dx    = A^T (silu'(A x) * (F dout))        (the backward of K2a;
//        s2act_tc_kernel<T, K, 1>, replaces `_k2`, s2act.py:133)
//   K2c  ddout = F^T (silu'(A x) * (A ddx))         (the backward of K2b,
//        dx2   = A^T (silu''(A x) * (F dout) * (A ddx))   run by force training;
//        s2act_tc_kernel<T, K, 2>, replaces `_k3`, s2act.py:144)
//
// for every node n and channel c, with A (to-grid) and F (from-grid) the
// [P, K] tables of ops/s2grid.py (P = 324 grid points at resolution 18,
// K = 25 coefficients at lmax 4).  The grid tensor [N, P, C] is ~P/K = 13x
// the coefficient tensor; it never touches device memory here.
//
// Two to five products of small depth per node, on the tensor cores.  This
// is FlashAttention's shape with SiLU in place of softmax and no row
// normalisation: the "keys" are the P grid points, the head dimension is K.
// One warp owns a column tile, one node n and 16 MT channels c0 ..
// (x[n, 0:K, c0:c0+16 MT]; MT = 2 in bf16 up to K = 32, where
// the two 16-channel halves share every B fragment, else 1), and walks the
// grid points 16 at a time:
//   K2a  G^T [16 x 16] = X^T [16 x KP] A^T [KP x 16], S = silu(G) in
//        registers, Out^T [16 x KN] += S^T [16 x 16] F [16 x KN];
//   K2b  G^T = X^T A^T and H^T = dout^T F^T, W = silu'(G) H in registers,
//        dX^T += W^T A;
//   K2c  G^T = X^T A^T and U^T = ddx^T A^T (one A fragment feeds both),
//        H^T = dout^T F^T; from one sigmoid per point W1 = silu'(G) U and
//        W2 = silu''(G) H U in registers; ddout^T += W1^T F, dX2^T += W2^T A.
// The first products' accumulators become the second products' A operand
// in registers, never through shared memory (as FlashAttention-2 feeds P
// into P V).  bf16: accumulator pairs (columns 2t, 2t + 1) are converted
// to bf16x2 where they lie, the m16n8k16 A layout.  tf32: the m16n8k8 A
// fragment holds depth t and t + 4 where the accumulator holds columns 2t
// and 2t + 1, so depth slot t reads grid point 2t and slot t + 4 point
// 2t + 1 (the permutation pi = [0, 2, 4, 6, 1, 3, 5, 7] of each group of 8
// points), and the second products' B rows are read in that order: no
// shuffle.  KP pads K to the first products' depth step (8 in tf32, 16 in
// bf16), KN to the second products' width step (8).
//
// Route: mma.sync (m16n8k8 tf32, m16n8k16 bf16), not wgmma.  Its B
// fragments are loaded by the threads from shared memory in any layout, so
// ONE copy of each table part serves both products (wgmma reads tf32 B
// K-major only, which would need A and F in both majornesses: six f32 parts
// for K2b, 252 KB at the flagship, more than a block's 227 KB).  With
// mma.sync every table set is resident: a persistent grid (one block of
// 8-16 warps per SM, as many as the registers allow; no more blocks than
// the tiles need) loads the tables into shared memory once (cp.async, 16
// bytes a thread), then each warp walks column tiles b * WARPS + w,
// + grid * WARPS, ... with no further block barrier.  The kernel is bound
// by latency and shared-memory bytes, not by the tensor cores: 8 warps per
// block were 1.1-1.5x slower than 16, and splitting the 3xTF32 chains into
// two accumulators gained nothing (PERF.md §6).
// x (dout, ddx) fragments come straight from device memory, once per tile
// (8 neighbouring channels per 32-byte sector); outputs leave from the
// accumulators, masked on the ragged channel and coefficient edges.
// K2c in f32 holds its three operands' TF32 parts at every K (96
// registers at K = 25, 168 at K = 49, where ptxas spills a few bytes;
// 8 warps); PERF.md §6 times it against splitting them again at each
// 16-point chunk.  In bf16 K2c takes two 16-channel tiles per warp up to
// K = 32 at 8 warps (210 registers), as K2a / K2b do at 12.  K2c runs at
// 17-48 % of its recast bound on an H100 (PERF.md §6; flagship 27 % in
// f32, 17 % in bf16).  What holds it there,
// by count: in f32 the B fragments from shared memory (16 KB per 16-point
// chunk per warp, about a third of the flagship's time) and only 2 warps
// a scheduler to hide the dependent 3xTF32 chains; in bf16 the f32
// derivative arithmetic, the bf16 packs, the SFU (16 %) and latency.
//
// Shared memory (ops/cuda/s2act.py:tc_layout mirrors it; the host builds
// the tables in exactly this layout, once per grid, device and dtype):
//   float32, every kernel: A big, A small, F big, F small, each
//     [Pp, KP + 4] (TF32 parts);
//   bf16 K2a: A [Pp, KP] (pairs along k), F^T [KN, Pp] (pairs along p);
//   bf16 K2b: A [Pp, KP], F [Pp, KP], A^T [KN, Pp];
//   bf16 K2c: A [Pp, KP], F [Pp, KP], F^T [KN, Pp], A^T [KN, Pp];
// Pp = P padded to 16 with zero points (a zero grid point is an exact no-op:
// silu(0) = 0, and every K2b / K2c term carries a zero A or F row), rows
// padded to 4 mod 8 words so that every fragment read is free of bank
// conflicts.  Flagship f32: 193.5 KB; OC20 K = 49 f32: 215 KB; bf16 at most
// ~98 KB (K2c at the flagship).  A grid whose tables exceed 227 KB is
// refused (-4): none of the models'.
//
// Precision.  float32: 3xTF32, as K3 (csrc/so2conv.cu): each operand split
// into TF32 big and small parts (the tables on the host, x, dout, ddx and
// S / W in registers), big big + big small + small big.  The tensor core's
// accumulation truncates, so each 16-point chunk of a second product is
// summed from zero and added to the running sum with a rounded f32 add.
// A single TF32 pass keeps ~11 bits and misses the 1e-5 limit; it is never
// taken.  SiLU: sigmoid = rcp.approx(1 + __expf(-g)), two SFU operations per
// point.  bf16 follows the JAX kernel's bf16 semantics (ops/pallas/
// s2act.py:122-154): bf16 tables, f32 accumulation, SiLU and its
// derivatives in f32, S (W, W1, W2) rounded to bf16 before the second
// products; sigmoid(g) = (1 + tanh(g/2)) / 2 with tanh.approx.f32, one SFU
// operation per point.
//
// Bound (recast for the tensor cores): K2a does 4 P K N C flops (K2b 6,
// K2c 10), f32 at 3 flops per flop over 495 TFLOP/s (3xTF32), bf16 over
// 989 TFLOP/s, against the inputs read once and the outputs written once at
// 3.35 TB/s: operations bound every main-path site but the narrow edge
// ones (flagship K2c: 0.1247 ms f32, 0.0208 ms bf16).  Beside it the SFU
// floor, one transcendental per point per column at 16 per SM per clock:
// at the flagship in bf16 the sigmoid, not the products, sets the pace.
// Instances: K = 4, 7, 9, 16, 19, 25 (lmax <= 4) and 14, 29, 49 (the edge
// sites of lmax 3 and 6 at mmax 2, the node sites of lmax 6).
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace etq;  // the shared PTX helpers (csrc/hopper.cuh)

// ── the tensor-core kernel: KIND 0 = K2a, 1 = K2b, 2 = K2c ────────────────

constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most one block may take

template <typename T, int K, int KIND>
struct Tc {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int KP = F32 ? (K + 7) / 8 * 8 : (K + 15) / 16 * 16;  // first products' depth
  static constexpr int KN = (K + 7) / 8 * 8;                             // second product's width
  static constexpr int KS = F32 ? KP / 8 : KP / 16;                      // depth steps
  static constexpr int NB = KN / 8;                                      // n8 blocks
  static constexpr int SPK = F32 ? KP + 4 : KP / 2 + 4;  // words per row of a [Pp, .] table
  static constexpr int OUTS = KIND == 2 ? 2 : 1;          // outputs (second products)
  // 16-channel tiles per warp: in bf16 up to K = 32, two tiles share each
  // B fragment (half the shared-memory bytes per product); f32 keeps one
  // (two cost the flagship's f32 K2a a 20 % tail of unequal warps)
  static constexpr int MT = !F32 && KP <= 32 ? 2 : 1;
  // warps per block: as many as the registers of one thread's fragments allow
  static constexpr int WARPS = KIND == 2 ? (F32 || MT == 2 ? 8 : 12)
                               : MT == 2 ? 12 : !F32 ? 16 : KIND ? (KP <= 32 ? 12 : 8)
                                                                 : (KP <= 32 ? 16 : 12);
  static constexpr int THREADS = 32 * WARPS;
  // words per row of a bf16 [KN, Pp] table (pairs along p)
  __host__ __device__ static constexpr int skp(int Pp) { return Pp / 2 + 4; }
  __host__ __device__ static constexpr int table_words(int Pp) {
    return F32 ? 4 * Pp * SPK : (KIND ? 2 : 1) * Pp * SPK + OUTS * KN * skp(Pp);
  }
};

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float tanh_approx(float x) {
  float r;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
// f32: sigmoid with __expf and a fast reciprocal (exp(-g) = inf gives 0)
__device__ __forceinline__ float sigmoid_fast(float g) { return rcp_approx(1.0f + __expf(-g)); }

// x[k, c] of the tile's node (zero outside K x C)
template <int K, typename T>
__device__ __forceinline__ T ld(const T* __restrict__ p, int k, int c, int C) {
  return (k < K && c < C) ? p[(long long)k * C + c] : T(0);
}
template <int K>
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* __restrict__ p, int k, int c, int C) {
  return (uint32_t)ld<K>(p, k, c, C) | ((uint32_t)ld<K>(p, k + 1, c, C) << 16);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One warp's column tile in float32 (3xTF32): 16 channels from c0; this
// lane owns channels ca = c0 + g and cb = ca + 8.  x, dout: the node's
// [K, C] rows.
template <int K, int KIND, int NB>
__device__ __forceinline__ void tile_f32(const float* __restrict__ x,
                                         const float* __restrict__ dout,
                                         const float* __restrict__ sm, int C, int Pp, int c0,
                                         int gq, int tq, float (&acc)[1][NB][4]) {
  using G = Tc<float, K, KIND>;
  constexpr bool BWD = KIND == 1;
  constexpr int KS = G::KS, SPK = G::SPK;
  const int ca = c0 + gq, cb = ca + 8;
  // the first products' A operands (x^T, dout^T), split into TF32 parts
  uint32_t xh[KS][4], xl[KS][4], dh[BWD ? KS : 1][4], dl[BWD ? KS : 1][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = 8 * ks + tq, k1 = k0 + 4;
    const float v[4] = {ld<K>(x, k0, ca, C), ld<K>(x, k0, cb, C), ld<K>(x, k1, ca, C),
                        ld<K>(x, k1, cb, C)};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], xh[ks][i], xl[ks][i]);
    if constexpr (BWD) {
      const float u[4] = {ld<K>(dout, k0, ca, C), ld<K>(dout, k0, cb, C),
                          ld<K>(dout, k1, ca, C), ld<K>(dout, k1, cb, C)};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(u[i], dh[ks][i], dl[ks][i]);
    }
  }
  const uint32_t* Ah = reinterpret_cast<const uint32_t*>(sm);
  const uint32_t* Al = Ah + Pp * SPK;
  const uint32_t* Fh = Al + Pp * SPK;
  const uint32_t* Fl = Fh + Pp * SPK;
  const uint32_t* Bh = BWD ? Ah : Fh;  // the second product's B: A (K2b) or F (K2a)
  const uint32_t* Bl = BWD ? Al : Fl;
  for (int p0 = 0; p0 < Pp; p0 += 16) {
    // G^T (and H^T) of points p0 + 8 j .. + 7, j = 0, 1; small terms first
    float g[2][4] = {}, h[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = (p0 + 8 * j + gq) * SPK + 8 * ks + tq;  // B (row t: k, column g: p)
        mma_tf32(g[j], xl[ks], Ah[r], Ah[r + 4]);
        mma_tf32(g[j], xh[ks], Al[r], Al[r + 4]);
        mma_tf32(g[j], xh[ks], Ah[r], Ah[r + 4]);
        if constexpr (BWD) {
          mma_tf32(h[j], dl[ks], Fh[r], Fh[r + 4]);
          mma_tf32(h[j], dh[ks], Fl[r], Fl[r + 4]);
          mma_tf32(h[j], dh[ks], Fh[r], Fh[r + 4]);
        }
      }
    }
    // S (K2a) or W (K2b), split, as the second product's A: accumulator
    // columns 2t, 2t + 1 (d0, d1 at row g; d2, d3 at g + 8) are depth
    // slots t, t + 4
    uint32_t wh[2][4], wl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = sigmoid_fast(g[j][i]);
        w[i] = BWD ? s * (1.0f + g[j][i] * (1.0f - s)) * h[j][i] : g[j][i] * s;
      }
      split_tf32(w[0], wh[j][0], wl[j][0]);
      split_tf32(w[2], wh[j][1], wl[j][1]);
      split_tf32(w[1], wh[j][2], wl[j][2]);
      split_tf32(w[3], wh[j][3], wl[j][3]);
    }
    // the chunk's second product from zero, added with rounding
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float part[4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B rows: depth slot t = point 2t, slot t + 4 = point 2t + 1; column g
        const int r = (p0 + 8 * j + 2 * tq) * SPK + 8 * nb + gq;
        mma_tf32(part, wl[j], Bh[r], Bh[r + SPK]);
        mma_tf32(part, wh[j], Bl[r], Bl[r + SPK]);
        mma_tf32(part, wh[j], Bh[r], Bh[r + SPK]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][nb][i] += part[i];
    }
  }
}

// One warp's column tiles in bf16 (bf16 products, f32 accumulation): MT
// tiles of 16 channels, c0 + 16 m .. + 15; this lane owns channels
// c0 + 16 m + g and + 8 of each, and each B fragment serves the MT tiles.
template <int K, int KIND, int MT, int NB>
__device__ __forceinline__ void tile_bf16(const uint16_t* __restrict__ x,
                                          const uint16_t* __restrict__ dout,
                                          const uint32_t* __restrict__ sm, int C, int Pp,
                                          int c0, int gq, int tq, float (&acc)[MT][NB][4]) {
  using G = Tc<__nv_bfloat16, K, KIND>;
  constexpr bool BWD = KIND == 1;
  constexpr int KS = G::KS, SPK = G::SPK;
  const int SKP = G::skp(Pp);
  uint32_t xa[MT][KS][4], da[MT][BWD ? KS : 1][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int ca = c0 + 16 * m + gq, cb = ca + 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k0 = 16 * ks + 2 * tq;
      xa[m][ks][0] = ld_pair<K>(x, k0, ca, C);
      xa[m][ks][1] = ld_pair<K>(x, k0, cb, C);
      xa[m][ks][2] = ld_pair<K>(x, k0 + 8, ca, C);
      xa[m][ks][3] = ld_pair<K>(x, k0 + 8, cb, C);
      if constexpr (BWD) {
        da[m][ks][0] = ld_pair<K>(dout, k0, ca, C);
        da[m][ks][1] = ld_pair<K>(dout, k0, cb, C);
        da[m][ks][2] = ld_pair<K>(dout, k0 + 8, ca, C);
        da[m][ks][3] = ld_pair<K>(dout, k0 + 8, cb, C);
      }
    }
  }
  const uint32_t* Apk = sm;                                   // [Pp, SPK], pairs along k
  const uint32_t* Fpk = sm + Pp * SPK;                        // K2b only
  const uint32_t* Bkp = sm + (BWD ? 2 : 1) * Pp * SPK;        // F^T (K2a) / A^T (K2b), pairs along p
  for (int p0 = 0; p0 < Pp; p0 += 16) {
    float g[MT][2][4] = {}, h[MT][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = (p0 + 8 * j + gq) * SPK + 8 * ks + tq;  // B (rows 2t.., column g)
        const uint32_t a0 = Apk[r], a1 = Apk[r + 4];
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(g[m][j], xa[m][ks], a0, a1);
        if constexpr (BWD) {
          const uint32_t f0 = Fpk[r], f1 = Fpk[r + 4];
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(h[m][j], da[m][ks], f0, f1);
        }
      }
    }
    // S or W in bf16 as the m16n8k16 A fragment: points 2t, 2t + 1 of
    // block j at rows g (a[2j]) and g + 8 (a[2j + 1])
    uint32_t wa[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hg = 0.5f * g[m][j][i];
          const float t = tanh_approx(hg);
          if constexpr (BWD) {
            const float s = fmaf(0.5f, t, 0.5f);
            w[i] = s * (1.0f + g[m][j][i] * (1.0f - s)) * h[m][j][i];
          } else {
            w[i] = fmaf(hg, t, hg);
          }
        }
        wa[m][2 * j] = pack_bf16(w[0], w[1]);
        wa[m][2 * j + 1] = pack_bf16(w[2], w[3]);
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int r = (8 * nb + gq) * SKP + p0 / 2 + tq;
      const uint32_t b0 = Bkp[r], b1 = Bkp[r + 4];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_bf16(acc[m][nb], wa[m], b0, b1);
    }
  }
}

// K2c's silu' and silu'' from s = sigmoid(g): q = s (1 - s),
// d1 = s (1 + g (1 - s)) = s + g q,  d2 = q (2 + g (1 - 2 s))
__device__ __forceinline__ void dsilu12(float g, float s, float& d1, float& d2) {
  const float sc = 1.0f - s, q = s * sc;
  d1 = fmaf(g, q, s);
  d2 = q * fmaf(g, sc - s, 2.0f);
}

// One warp's column tile of K2c in float32 (3xTF32): 16 channels from c0;
// this lane owns channels ca = c0 + g and cb = ca + 8.  x, dout, ddx: the
// node's [K, C] rows; acc[0] sums ddout^T, acc[1] dx2^T.
template <int K, int NB>
__device__ __forceinline__ void tile3_f32(const float* __restrict__ x,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ ddx,
                                          const float* __restrict__ sm, int C, int Pp, int c0,
                                          int gq, int tq, float (&acc)[2][1][NB][4]) {
  using G = Tc<float, K, 2>;
  constexpr int KS = G::KS, SPK = G::SPK;
  const int ca = c0 + gq, cb = ca + 8;
  // the first products' A operands (x^T, ddx^T, dout^T), split into TF32
  // parts once and held (96 registers at K = 25, 168 at K = 49)
  uint32_t big[KS][3][4], small[KS][3][4];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float* src = o == 0 ? x : o == 1 ? ddx : dout;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k0 = 8 * ks + tq, k1 = k0 + 4;
      const float v[4] = {ld<K>(src, k0, ca, C), ld<K>(src, k0, cb, C), ld<K>(src, k1, ca, C),
                          ld<K>(src, k1, cb, C)};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], big[ks][o][i], small[ks][o][i]);
    }
  }
  const uint32_t* Ah = reinterpret_cast<const uint32_t*>(sm);
  const uint32_t* Al = Ah + Pp * SPK;
  const uint32_t* Fh = Al + Pp * SPK;
  const uint32_t* Fl = Fh + Pp * SPK;
  for (int p0 = 0; p0 < Pp; p0 += 16) {
    // G^T, U^T (one A fragment for both) and H^T of points p0 + 8 j .. + 7
    float g[2][4] = {}, u[2][4] = {}, h[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = (p0 + 8 * j + gq) * SPK + 8 * ks + tq;  // B (row t: k, column g: p)
        const uint32_t ah0 = Ah[r], ah1 = Ah[r + 4], al0 = Al[r], al1 = Al[r + 4];
        mma_tf32(g[j], small[ks][0], ah0, ah1);
        mma_tf32(g[j], big[ks][0], al0, al1);
        mma_tf32(g[j], big[ks][0], ah0, ah1);
        mma_tf32(u[j], small[ks][1], ah0, ah1);
        mma_tf32(u[j], big[ks][1], al0, al1);
        mma_tf32(u[j], big[ks][1], ah0, ah1);
        mma_tf32(h[j], small[ks][2], Fh[r], Fh[r + 4]);
        mma_tf32(h[j], big[ks][2], Fl[r], Fl[r + 4]);
        mma_tf32(h[j], big[ks][2], Fh[r], Fh[r + 4]);
      }
    }
    // W1 = silu'(g) u and W2 = silu''(g) h u, split, as the second
    // products' A in the depth order pi (as tile_f32)
    uint32_t w1h[2][4], w1l[2][4], w2h[2][4], w2l[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float w1[4], w2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float d1, d2;
        dsilu12(g[j][i], sigmoid_fast(g[j][i]), d1, d2);
        w1[i] = d1 * u[j][i];
        w2[i] = d2 * h[j][i] * u[j][i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = (i & 1) * 2 + (i >> 1);  // slot i holds accumulator element 0, 2, 1, 3
        split_tf32(w1[e], w1h[j][i], w1l[j][i]);
        split_tf32(w2[e], w2h[j][i], w2l[j][i]);
      }
    }
    // both second products of the chunk from zero, added with rounding
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float po[4] = {}, px[4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = (p0 + 8 * j + 2 * tq) * SPK + 8 * nb + gq;  // slot t: point 2t, t + 4: 2t + 1
        const uint32_t fh0 = Fh[r], fh1 = Fh[r + SPK], ah0 = Ah[r], ah1 = Ah[r + SPK];
        mma_tf32(po, w1l[j], fh0, fh1);
        mma_tf32(po, w1h[j], Fl[r], Fl[r + SPK]);
        mma_tf32(po, w1h[j], fh0, fh1);
        mma_tf32(px, w2l[j], ah0, ah1);
        mma_tf32(px, w2h[j], Al[r], Al[r + SPK]);
        mma_tf32(px, w2h[j], ah0, ah1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[0][0][nb][i] += po[i];
        acc[1][0][nb][i] += px[i];
      }
    }
  }
}

// One warp's column tiles of K2c in bf16 (bf16 products, f32 accumulation,
// W1 and W2 rounded to bf16 before the second products, as the JAX kernel):
// MT tiles of 16 channels from c0; acc[0] sums ddout^T, acc[1] dx2^T.
template <int K, int MT, int NB>
__device__ __forceinline__ void tile3_bf16(const uint16_t* __restrict__ x,
                                           const uint16_t* __restrict__ dout,
                                           const uint16_t* __restrict__ ddx,
                                           const uint32_t* __restrict__ sm, int C, int Pp,
                                           int c0, int gq, int tq, float (&acc)[2][MT][NB][4]) {
  using G = Tc<__nv_bfloat16, K, 2>;
  constexpr int KS = G::KS, SPK = G::SPK;
  const int SKP = G::skp(Pp);
  uint32_t a[3][MT][KS][4];  // [x, ddx, dout]: m16n8k16 A fragments
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const uint16_t* src = o == 0 ? x : o == 1 ? ddx : dout;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int ca = c0 + 16 * m + gq, cb = ca + 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k0 = 16 * ks + 2 * tq;
        a[o][m][ks][0] = ld_pair<K>(src, k0, ca, C);
        a[o][m][ks][1] = ld_pair<K>(src, k0, cb, C);
        a[o][m][ks][2] = ld_pair<K>(src, k0 + 8, ca, C);
        a[o][m][ks][3] = ld_pair<K>(src, k0 + 8, cb, C);
      }
    }
  }
  const uint32_t* Apk = sm;                    // [Pp, SPK], pairs along k
  const uint32_t* Fpk = sm + Pp * SPK;
  const uint32_t* Fkp = sm + 2 * Pp * SPK;     // F^T [KN, SKP], pairs along p
  const uint32_t* Akp = Fkp + G::KN * SKP;     // A^T
  for (int p0 = 0; p0 < Pp; p0 += 16) {
    float g[MT][2][4] = {}, u[MT][2][4] = {}, h[MT][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = (p0 + 8 * j + gq) * SPK + 8 * ks + tq;  // B (rows 2t.., column g)
        const uint32_t a0 = Apk[r], a1 = Apk[r + 4], f0 = Fpk[r], f1 = Fpk[r + 4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(g[m][j], a[0][m][ks], a0, a1);
          mma_bf16(u[m][j], a[1][m][ks], a0, a1);
          mma_bf16(h[m][j], a[2][m][ks], f0, f1);
        }
      }
    }
    // W1, W2 in bf16 as the m16n8k16 A fragment (as tile_bf16); one
    // tanh.approx per point: s = (1 + t) / 2, s (1 - s) = (1 - t^2) / 4,
    // 1 - 2 s = -t
    uint32_t w1[MT][4], w2[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v1[4], v2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gv = g[m][j][i], t = tanh_approx(0.5f * gv);
          const float s = fmaf(0.5f, t, 0.5f), q = fmaf(-0.25f * t, t, 0.25f);
          v1[i] = fmaf(gv, q, s) * u[m][j][i];
          v2[i] = q * fmaf(-gv, t, 2.0f) * h[m][j][i] * u[m][j][i];
        }
        w1[m][2 * j] = pack_bf16(v1[0], v1[1]);
        w1[m][2 * j + 1] = pack_bf16(v1[2], v1[3]);
        w2[m][2 * j] = pack_bf16(v2[0], v2[1]);
        w2[m][2 * j + 1] = pack_bf16(v2[2], v2[3]);
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int r = (8 * nb + gq) * SKP + p0 / 2 + tq;
      const uint32_t f0 = Fkp[r], f1 = Fkp[r + 4], a0 = Akp[r], a1 = Akp[r + 4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[0][m][nb], w1[m], f0, f1);
        mma_bf16(acc[1][m][nb], w2[m], a0, a1);
      }
    }
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// acc[m][nb]: (channel ca, coefficients 8 nb + 2t, + 1), then channel cb;
// masked on the ragged channel and coefficient edges
template <int K, int MT, int NB, typename T>
__device__ __forceinline__ void store_tile(T* o, const float (&acc)[MT][NB][4], int C, int c0,
                                           int gq, int tq) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int ca = c0 + 16 * m + gq, cb = ca + 8;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int k = 8 * nb + 2 * tq;
      if (k < K) {
        if (ca < C) store1(o + (long long)k * C + ca, acc[m][nb][0]);
        if (cb < C) store1(o + (long long)k * C + cb, acc[m][nb][2]);
      }
      if (k + 1 < K) {
        if (ca < C) store1(o + (long long)(k + 1) * C + ca, acc[m][nb][1]);
        if (cb < C) store1(o + (long long)(k + 1) * C + cb, acc[m][nb][3]);
      }
    }
  }
}

// KIND 0: K2a (out = F^T silu(A x)); 1: K2b (out = dx, from dout);
// 2: K2c (out = ddout, out2 = dx2, from dout and ddx).
// tables: the layout above, table_words 32-bit words (a multiple of 4).
template <typename T, int K, int KIND>
__global__ void __launch_bounds__(Tc<T, K, KIND>::THREADS, 1)
s2act_tc_kernel(const T* __restrict__ x, const T* __restrict__ dout, const T* __restrict__ ddx,
                const uint32_t* __restrict__ tables, int table_words, T* __restrict__ out,
                T* __restrict__ out2, int N, int C, int Pp) {
  using G = Tc<T, K, KIND>;
  constexpr int MT = G::MT, NB = G::NB, W = 16 * MT;  // channels per warp tile
  extern __shared__ __align__(16) uint32_t sm[];
  for (int i = 4 * (int)threadIdx.x; i < table_words; i += 4 * G::THREADS)
    cp_async16(smem_u32(sm + i), tables + i, true);
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int ctiles = (C + W - 1) / W;
  const long long tiles = (long long)N * ctiles;
  for (long long tile = (long long)blockIdx.x * G::WARPS + warp; tile < tiles;
       tile += (long long)gridDim.x * G::WARPS) {
    const long long n = tile / ctiles;
    const int c0 = (int)(tile - n * ctiles) * W;
    const long long base = n * K * C;
    float acc[G::OUTS][MT][NB][4];
#pragma unroll
    for (int o = 0; o < G::OUTS; ++o)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[o][m][nb][i] = 0.0f;
    if constexpr (G::F32 && KIND == 2) {
      tile3_f32<K>(x + base, dout + base, ddx + base, reinterpret_cast<const float*>(sm), C, Pp,
                   c0, gq, tq, acc);
    } else if constexpr (G::F32) {
      tile_f32<K, KIND>(x + base, KIND ? dout + base : nullptr,
                        reinterpret_cast<const float*>(sm), C, Pp, c0, gq, tq, acc[0]);
    } else if constexpr (KIND == 2) {
      tile3_bf16<K>(reinterpret_cast<const uint16_t*>(x + base),
                    reinterpret_cast<const uint16_t*>(dout + base),
                    reinterpret_cast<const uint16_t*>(ddx + base), sm, C, Pp, c0, gq, tq, acc);
    } else {
      tile_bf16<K, KIND>(reinterpret_cast<const uint16_t*>(x + base),
                         KIND ? reinterpret_cast<const uint16_t*>(dout + base) : nullptr, sm, C,
                         Pp, c0, gq, tq, acc[0]);
    }
    store_tile<K>(out + base, acc[0], C, c0, gq, tq);
    if constexpr (KIND == 2) store_tile<K>(out2 + base, acc[1], C, c0, gq, tq);
  }
}

template <typename T, int K, int KIND>
int launch_tc(const void* x, const void* dout, const void* ddx, const void* tables,
              int table_words, void* out, void* out2, int N, int C, int Pp, cudaStream_t stream) {
  using G = Tc<T, K, KIND>;
  if (Pp <= 0 || Pp % 16 || table_words != G::table_words(Pp)) return -4;
  const int smem = 4 * table_words;
  if (smem > SMEM_LIMIT) return -4;
  const long long tiles = (long long)N * ((C + 16 * G::MT - 1) / (16 * G::MT));
  if (tiles == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(s2act_tc_kernel<T, K, KIND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long want = (tiles + G::WARPS - 1) / G::WARPS;  // one tile per warp at most
  const int blocks = (int)(want < sms ? want : sms);
  s2act_tc_kernel<T, K, KIND><<<blocks, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(ddx),
      static_cast<const uint32_t*>(tables), table_words, static_cast<T*>(out),
      static_cast<T*>(out2), N, C, Pp);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch(int kernel, const void* x, const void* dout, const void* ddx, const void* tables,
           int words, void* out, void* out2, int N, int C, int Pp, cudaStream_t s) {
  switch (kernel) {
    case 0: return launch_tc<T, K, 0>(x, dout, ddx, tables, words, out, out2, N, C, Pp, s);
    case 1: return launch_tc<T, K, 1>(x, dout, ddx, tables, words, out, out2, N, C, Pp, s);
    case 2: return launch_tc<T, K, 2>(x, dout, ddx, tables, words, out, out2, N, C, Pp, s);
    default: return -1;
  }
}

template <typename T>
int dispatch(int kernel, int K, const void* x, const void* dout, const void* ddx,
             const void* tables, int words, void* out, void* out2, int N, int C, int Pp,
             cudaStream_t s) {
#define ETQ_S2ACT_K(k) \
  case k: return launch<T, k>(kernel, x, dout, ddx, tables, words, out, out2, N, C, Pp, s);
  switch (K) {
    ETQ_S2ACT_K(4) ETQ_S2ACT_K(7) ETQ_S2ACT_K(9) ETQ_S2ACT_K(16) ETQ_S2ACT_K(19)
    ETQ_S2ACT_K(25) ETQ_S2ACT_K(14) ETQ_S2ACT_K(29) ETQ_S2ACT_K(49)
    default: return -2;
  }
#undef ETQ_S2ACT_K
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; kernel 0 = K2a (x -> out), 1 = K2b
// (x, dout -> out), 2 = K2c (x, dout, ddx -> out = ddout, out2 = dx2); the
// pointers a kernel does not use may be null.  tables: table_words 32-bit
// words in the layout above (ops/cuda/s2act.py:tc_tables), Pp % 16 == 0.
// Returns 0, a cudaError_t (> 0), -1 for a kernel, -2 for a K with no
// instance, -3 for a dtype, -4 for tables that do not match the layout or
// exceed a block's shared memory.
extern "C" int etq_s2act(int dtype, int kernel, int K, const void* x, const void* dout,
                         const void* ddx, const void* tables, int table_words, void* out,
                         void* out2, int N, int C, int Pp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(kernel, K, x, dout, ddx, tables, table_words, out, out2, N, C, Pp, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(kernel, K, x, dout, ddx, tables, table_words, out, out2, N,
                                   C, Pp, s);
  return -3;
}

extern "C" const char* etq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
