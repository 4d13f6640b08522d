// K4: fused factored-Wigner edge rotation, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rot_kernel` / `_call_rot` of
// equivarianttransformermpnn4quantumcomputations_tpu/ops/pallas/rotate.py.
//
// Per edge e, D = Xz(a) J Xz(b) J Xz(g) is applied through six per-edge
// tables and two constant matrices (the JAX package's flip-folded algebra;
// ops/cuda/rotate.py:rot_plain is the same function with the dense W1 / W2):
//   h[i]  = sum_k (W1[i, k] t1a[e, k] + W1[i, Ki + k] t1b[e, k]) x[e, k, c]
//   uv[r] = sum_j (W2[r, j] t2a[e, j] + W2[r, Km + j] t2b[e, j]) h[j]
//   y[e, o, c] = t3a[e, o] uv[o] + t3b[e, o] uv[Ko + o]
// in four kinds, as in K1 ("to", "from", "to_m0", "from_m0").  Every
// factor maps degree l onto degree l, so only the degree-l blocks of W1
// (two halves, [2l+1, in_w]) and W2 (two quarters, [out_w, 2l+1]) are
// nonzero, and W2's second half of rows is its first half flipped within
// each degree (m -> -m): uv[Ko + o] = uv[f], f = out_w - 1 - o.
// ops/cuda/rotate.py:kernel_pack packs the blocks, degree by degree, for
// every (lmax, mmax, kind) instance into __constant__ memory (uploaded once
// per device by etq_rotate_set_consts).
//
// Bound: memory.  Per edge the kernel reads x[e] and the tables once and
// writes y[e] once (at OC20's "to" [6400, 49, 256] -> [6400, 29, 256] in
// f32: 511 MB, 0.153 ms at 3.35 TB/s).  Design: the chain is linear in x,
// so per tile the block first forms each edge's block-diagonal matrix
//   H = W1a diag(t1a) + W1b diag(t1b),  G = W2a diag(t2a) + W2b diag(t2b)
//   M[o, k] = t3a[o] (G H)[o, k] + t3b[o] (G H)[f, k]       (per degree)
// in shared memory, laid out in K1's pair order (~2.3 k multiply-adds per
// edge at lmax 6 / mmax 2 "from", shared by all its channels), and then
// applies M with K1's inner loop: 235 multiply-adds per (edge, channel)
// there, where the chain costs ~690.  The memory engine is K1's
// (csrc/edge_rotate.cuh): persistent grid, each tile's x in one bulk copy
// through a ring of stages with the six tables beside it, 16 bytes of
// channels per thread, streaming stores.  The block's constants are copied
// from __constant__ to shared memory once per block (the build reads them
// at data-dependent addresses).  Math is f32 for both input types; the
// last tile is masked, nothing is padded.  The kernel allocates nothing
// and launches on the caller's stream.
//
// bf16: the JAX package rounds h and uv to bf16 after each f32-accumulated
// product (ops/pallas/rotate.py:77-113, ops/rotation.py:367-378); this
// kernel keeps the whole chain, and the block build, in f32 and rounds
// once, on the store.  Measured on the CPU through rot_plain: one rotation
// differs from the JAX package's by at most 8.4e-3 of max |JAX| (lmax 4
// and 6, tests/test_torch_rotate.py), one bf16 OC20 step by 1.3e-3
// (energies), 5.3e-3 (forces), 6.7e-5 (loss) and 3.8e-3 (gradients, rel.
// L2; tests/test_torch_oc20.py), inside the bf16 limits 2e-2 / 5e-2.

#include "edge_rotate.cuh"

namespace {

using etq::Args;
using etq::in_w;
using etq::n_in;
using etq::n_out;
using etq::out_w;

// constants of one (lmax, mmax, kind): per degree 2 (2l+1) (in_w + out_w)
__host__ __device__ constexpr int pack_size(int lmax, int mmax, int kind) {
  int n = 0;
  for (int l = 0; l <= lmax; ++l)
    n += 2 * (2 * l + 1) * (in_w(l, mmax, kind) + out_w(l, mmax, kind));
  return n;
}
// per-edge scratch of the block build: every degree's H [d][in_w]
__host__ __device__ constexpr int h_size(int lmax, int mmax, int kind) {
  int n = 0;
  for (int l = 0; l <= lmax; ++l) n += (2 * l + 1) * in_w(l, mmax, kind);
  return n;
}
// pairs of flipped output rows (o, out_w - 1 - o) over all degrees
__host__ __device__ constexpr int row_pairs(int lmax, int mmax, int kind) {
  int n = 0;
  for (int l = 0; l <= lmax; ++l) n += (out_w(l, mmax, kind) + 1) / 2;
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

// K4's values: the six tables of a tile ([te][Ki] x 2, [te][Km] x 2,
// [te][Ko] x 2 in the stage), turned into the tile's [te][P] block in
// shared memory by all consumer threads.  Phase A forms every degree's
// H [d][iw], one entry per thread in turn.  Phase B gives each thread one
// (edge, degree, pair of flipped output rows o / f): it forms G's rows o
// and f in registers, then (G H)[o, :] and (G H)[f, :], and writes both
// rows of M in K1's pair order (per degree [ow][iw] row-major:
// ops/cuda/rotate.py:block_from_factors_plain is the same build in
// PyTorch).
template <int LMAX, int MMAX, int KIND, int WOFF>
struct FactoredBlock {
  static constexpr int KI = n_in(LMAX, MMAX, KIND);
  static constexpr int KM = (LMAX + 1) * (LMAX + 1);
  static constexpr int KO = n_out(LMAX, MMAX, KIND);
  static constexpr int P = etq::n_pairs(LMAX, MMAX, KIND);
  static constexpr int NH = h_size(LMAX, MMAX, KIND);  // sum_l d in_w
  static constexpr int ROWS = row_pairs(LMAX, MMAX, KIND);
  static constexpr int D = 2 * LMAX + 1;
  static constexpr int SEGS = 6;
  __host__ __device__ static constexpr int seg(int i) { return i < 2 ? KI : i < 4 ? KM : KO; }
  static constexpr int VALUES = 2 * (KI + KM + KO);
  static constexpr int SCRATCH = NH + P;
  static constexpr int FIXED = pack_size(LMAX, MMAX, KIND);

  __device__ static void prologue(float* w, int tid) {
    for (int i = tid; i < FIXED; i += etq::CONSUMERS) w[i] = c_W[WOFF + i];
  }

  __device__ static const float* block(const float* vals, const float* w, float* scratch,
                                       int te, int ne, int tid) {
    const float* t1a = vals;
    const float* t1b = t1a + te * KI;
    const float* t2a = t1b + te * KI;
    const float* t2b = t2a + te * KM;
    const float* t3a = t2b + te * KM;
    const float* t3b = t3a + te * KO;
    float* hs = scratch;           // [te][NH]
    float* m = scratch + te * NH;  // [te][P]
    {
      int hoff = 0, wp = 0, io = 0;
#pragma unroll
      for (int l = 0; l <= LMAX; ++l) {
        const int d = 2 * l + 1, iw = in_w(l, MMAX, KIND), ow = out_w(l, MMAX, KIND);
        const int n = d * iw;
        for (int q = tid; q < ne * n; q += etq::CONSUMERS) {
          const int el = q / n, idx = q - el * n, k = el * KI + io + idx % iw;
          hs[el * NH + hoff + idx] = fmaf(w[wp + idx], t1a[k], w[wp + n + idx] * t1b[k]);
        }
        hoff += n;
        wp += 2 * d * (iw + ow);
        io += iw;
      }
    }
    etq::consumers_sync(1);
    for (int q = tid; q < ne * ROWS; q += etq::CONSUMERS) {
      const int el = q / ROWS, r = q - el * ROWS;
      int base = 0, hoff = 0, wp = 0, poff = 0, oo = 0;
#pragma unroll
      for (int l = 0; l <= LMAX; ++l) {
        const int d = 2 * l + 1, iw = in_w(l, MMAX, KIND), ow = out_w(l, MMAX, KIND);
        const int np = (ow + 1) / 2;
        if (r >= base && r < base + np) {
          const int o = r - base, f = ow - 1 - o;
          const int w2a = wp + 2 * d * iw, w2b = w2a + ow * d;
          float go[D], gf[D];
#pragma unroll
          for (int j = 0; j < D; ++j) {
            if (j < d) {
              const float a = t2a[el * KM + l * l + j], b = t2b[el * KM + l * l + j];
              go[j] = fmaf(w[w2a + o * d + j], a, w[w2b + o * d + j] * b);
              gf[j] = fmaf(w[w2a + f * d + j], a, w[w2b + f * d + j] * b);
            }
          }
          const float ao = t3a[el * KO + oo + o], bo = t3b[el * KO + oo + o];
          const float af = t3a[el * KO + oo + f], bf = t3b[el * KO + oo + f];
          const float* h = hs + el * NH + hoff;
          float* mo = m + el * P + poff + o * iw;
          float* mf = m + el * P + poff + f * iw;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            if (k < iw) {
              float so = 0.0f, sf = 0.0f;
#pragma unroll
              for (int j = 0; j < D; ++j) {
                if (j < d) {
                  const float hj = h[j * iw + k];
                  so = fmaf(go[j], hj, so);
                  sf = fmaf(gf[j], hj, sf);
                }
              }
              mo[k] = fmaf(ao, so, bo * sf);  // f == o writes the same value twice
              mf[k] = fmaf(af, sf, bf * so);
            }
          }
        }
        base += np;
        hoff += d * iw;
        wp += 2 * d * (iw + ow);
        poff += ow * iw;
        oo += ow;
      }
    }
    etq::consumers_sync(1);
    return m;
  }
};

template <int LMAX, int MMAX, int KIND>
using Block = FactoredBlock<LMAX, MMAX, KIND, const_offset(LMAX, MMAX, KIND)>;

template <typename T, int LMAX, int MMAX, int KIND>
__global__ void ETQ_LAUNCH_BOUNDS rot_kernel(const Args a) {
  static_assert(const_offset(LMAX, MMAX, KIND) >= 0, "no constants for this instance");
  etq::run<T, LMAX, MMAX, KIND, Block<LMAX, MMAX, KIND>>(a);
}

template <typename T, int LMAX, int MMAX>
int launch(int kind, const void* x, const float* const* t, void* y, int E, int C,
           cudaStream_t stream) {
#define ETQ_KIND(K)                                                                \
  case K:                                                                          \
    return etq::launch<T, LMAX, MMAX, K, Block<LMAX, MMAX, K>>(rot_kernel<T, LMAX, MMAX, K>, \
                                                               x, t, y, E, C, stream);
  switch (kind) {
    ETQ_KIND(0)
    ETQ_KIND(1)
    ETQ_KIND(2)
    ETQ_KIND(3)
    default: return -1;
  }
#undef ETQ_KIND
}

template <typename T>
int dispatch(int kind, int lmax, int mmax, const void* x, const float* const* t, void* y,
             int E, int C, cudaStream_t stream) {
#define ETQ_CASE(L, M) \
  if (lmax == L && mmax == M) return launch<T, L, M>(kind, x, t, y, E, C, stream);
  ETQ_ROT_INSTANCES(ETQ_CASE)
#undef ETQ_CASE
  return -2;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  x [E, Ki, C] and y [E, Ko, C] of that
// dtype; the six tables float32, [E, Ki] x2, [E, (lmax+1)^2] x2, [E, Ko] x2;
// C a multiple of 16 bytes (4 f32, 8 bf16).  Returns 0, a cudaError_t (> 0)
// from the launch, -1 for an unknown kind, -2 for an (lmax, mmax) with no
// instance, -3 for a dtype, -4 for a channel count that is not a multiple
// of 16 bytes.
extern "C" int etq_rotate(int dtype, int kind, int lmax, int mmax, const void* x,
                          const void* t1a, const void* t1b, const void* t2a, const void* t2b,
                          const void* t3a, const void* t3b, void* y, int E, int C,
                          void* stream) {
  if (dtype != 0 && dtype != 1) return -3;
  if (C % (dtype == 0 ? 4 : 8)) return -4;
  const float* const t[6] = {
      static_cast<const float*>(t1a), static_cast<const float*>(t1b),
      static_cast<const float*>(t2a), static_cast<const float*>(t2b),
      static_cast<const float*>(t3a), static_cast<const float*>(t3b)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(kind, lmax, mmax, x, t, y, E, C, s);
  return dispatch<__nv_bfloat16>(kind, lmax, mmax, x, t, y, E, C, s);
}

// The tile plan of one launch, for ops/cuda/edge_rotate.py to check its
// mirror: out = {edges per tile, channels per tile, stages, shared-memory
// bytes}.  Returns 0, or -1 / -2 / -3 as above.
extern "C" int etq_rotate_plan(int dtype, int kind, int lmax, int mmax, int C, int* out) {
  if (dtype != 0 && dtype != 1) return -3;
  if (kind < 0 || kind > 3) return -1;
  if (inst_base(lmax, mmax) < 0) return -2;
  const int ki = n_in(lmax, mmax, kind), km = (lmax + 1) * (lmax + 1);
  const int ko = n_out(lmax, mmax, kind);
  const int scratch = h_size(lmax, mmax, kind) + etq::n_pairs(lmax, mmax, kind);
  const etq::Layout L = etq::plan(dtype == 0 ? 4 : 2, C, ki, 2 * (ki + km + ko), scratch,
                                  pack_size(lmax, mmax, kind));
  out[0] = L.te;
  out[1] = L.ct;
  out[2] = L.stages;
  out[3] = L.total;
  return 0;
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
