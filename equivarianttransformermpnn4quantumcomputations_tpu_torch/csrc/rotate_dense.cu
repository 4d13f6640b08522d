// K1: dense-Wigner pairs rotation, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pairs_kernel` / `_call_pairs` of
// equivarianttransformermpnn4quantumcomputations_tpu/ops/pallas/rotate_dense.py.
//
//   y[e, ko, c] = sum_{p : ko_p = ko} v[e, p] * x[e, ki_p, c]
//
// over the static pair list of the block-diagonal, m-truncated Wigner-D of
// each edge (P = 115 pairs at lmax 4 / mmax 2), in four kinds ("to",
// "from", "to_m0", "from_m0").  Each list is ordered exactly as
// ops/cuda/rotate_dense.py:_pair_info builds it; `kernel_pair_order` there
// mirrors the loops of csrc/edge_rotate.cuh:apply_item and a CPU test holds
// the two equal.
//
// Bound: memory.  Per edge the kernel reads x[e] and v[e] once and writes
// y[e] once; the arithmetic (2 P C flops per edge) is ~1 % of what the card
// could do in that time.  Design: the memory engine of
// csrc/edge_rotate.cuh (persistent grid, each tile's x in one bulk copy
// through a ring of stages, v beside it in the same stage and read as
// shared-memory broadcasts, 16 bytes of channels per thread, streaming
// stores); the pair list is specialised at compile time for each (lmax,
// mmax), so every loop has constant trip counts and each v index is a
// constant.  Accumulation is always in f32.  The kernel allocates nothing
// and launches on the caller's stream.

#include "edge_rotate.cuh"

namespace {

using etq::Args;

// K1's values: v[e, :] as it lies in memory, one table of P floats per edge
template <int P>
struct DenseValues {
  static constexpr int SEGS = 1;
  __host__ __device__ static constexpr int seg(int) { return P; }
  static constexpr int VALUES = P, SCRATCH = 0, FIXED = 0;
  __device__ static void prologue(float*, int) {}
  __device__ static const float* block(const float* vals, const float*, float*, int, int,
                                       int) {
    return vals;
  }
};

template <int LMAX, int MMAX, int KIND>
using Values = DenseValues<etq::n_pairs(LMAX, MMAX, KIND)>;

template <typename T, int LMAX, int MMAX, int KIND>
__global__ void ETQ_LAUNCH_BOUNDS pairs_kernel(const Args a) {
  etq::run<T, LMAX, MMAX, KIND, Values<LMAX, MMAX, KIND>>(a);
}

template <typename T, int LMAX, int MMAX, int KIND>
int launch_kind(const void* x, const float* v, void* y, int E, int C, cudaStream_t stream) {
  return etq::launch<T, LMAX, MMAX, KIND, Values<LMAX, MMAX, KIND>>(
      pairs_kernel<T, LMAX, MMAX, KIND>, x, &v, y, E, C, stream);
}

template <typename T, int LMAX, int MMAX>
int launch(int kind, const void* x, const float* v, void* y, int E, int C,
           cudaStream_t stream) {
  switch (kind) {
    case 0: return launch_kind<T, LMAX, MMAX, 0>(x, v, y, E, C, stream);
    case 1: return launch_kind<T, LMAX, MMAX, 1>(x, v, y, E, C, stream);
    case 2: return launch_kind<T, LMAX, MMAX, 2>(x, v, y, E, C, stream);
    case 3: return launch_kind<T, LMAX, MMAX, 3>(x, v, y, E, C, stream);
    default: return -1;
  }
}

#define ETQ_PAIRS_INSTANCES(X) \
  X(1, 1) X(2, 1) X(2, 2) X(3, 1) X(3, 2) X(3, 3) X(4, 2) X(4, 4) X(6, 2)

template <typename T>
int dispatch(int kind, int lmax, int mmax, const void* x, const float* v, void* y, int E,
             int C, cudaStream_t stream) {
#define ETQ_CASE(L, M) \
  if (lmax == L && mmax == M) return launch<T, L, M>(kind, x, v, y, E, C, stream);
  ETQ_PAIRS_INSTANCES(ETQ_CASE)
#undef ETQ_CASE
  return -2;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t (> 0) from the
// launch, -1 for an unknown kind, -2 for an (lmax, mmax) with no instance.
extern "C" int etq_rotate_pairs(int dtype, int kind, int lmax, int mmax,
                                const void* x, const void* v, void* y, int E,
                                int C, void* stream) {
  const float* vf = static_cast<const float*>(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(kind, lmax, mmax, x, vf, y, E, C, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(kind, lmax, mmax, x, vf, y, E, C, s);
  return -3;
}

// The tile plan of one launch, for ops/cuda/edge_rotate.py to check its
// mirror: out = {edges per tile, channels per tile, stages, shared-memory
// bytes}.  Returns 0, or -1 / -2 / -3 as above.
extern "C" int etq_rotate_pairs_plan(int dtype, int kind, int lmax, int mmax, int C,
                                     int* out) {
  if (dtype != 0 && dtype != 1) return -3;
  if (kind < 0 || kind > 3) return -1;
  bool known = false;
#define ETQ_KNOWN(L, M) known = known || (lmax == L && mmax == M);
  ETQ_PAIRS_INSTANCES(ETQ_KNOWN)
#undef ETQ_KNOWN
  if (!known) return -2;
  const int P = etq::n_pairs(lmax, mmax, kind);
  const etq::Layout L = etq::plan(dtype == 0 ? 4 : 2, C, etq::n_in(lmax, mmax, kind), P, 0, 0);
  out[0] = L.te;
  out[1] = L.ct;
  out[2] = L.stages;
  out[3] = L.total;
  return 0;
}

extern "C" const char* etq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
