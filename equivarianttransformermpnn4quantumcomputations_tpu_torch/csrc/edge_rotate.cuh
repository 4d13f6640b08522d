// The memory engine shared by the two edge-rotation kernels, K1
// (csrc/rotate_dense.cu, dense-Wigner pairs) and K4 (csrc/rotate.cu,
// factored Wigner), for Hopper (sm_90a).
//
// Both compute, per edge e and channel c,
//   y[e, ko, c] = sum_{p : ko_p = ko} M[e, p] * x[e, ki_p, c]
// over the static pair list of the block-diagonal, m-truncated Wigner-D
// (P pairs; ops/cuda/rotate_dense.py:kernel_pair_order is the order).  K1
// reads M = v[e, :] from memory; K4 forms M per edge from its six factor
// tables first (csrc/rotate.cu).  Four kinds:
//   kind 0 "to"      full (lmax+1)^2 rows -> reduced rows (|m| <= mmax)
//   kind 1 "from"    reduced rows -> full rows (adjoint of "to")
//   kind 2 "to_m0"   full rows -> the lmax+1 m = 0 rows
//   kind 3 "from_m0" the lmax+1 m = 0 rows -> full rows (adjoint of "to_m0")
//
// Bound: memory.  Each edge reads x[e] once and writes y[e] once; the
// arithmetic is a few percent of what the card does in that time.  So the
// design keeps loads in flight while the block computes:
//   - a persistent grid (about SMs x blocks-per-SM blocks, from the
//     occupancy calculator); block b walks tiles b, b + grid, ...;
//   - a tile is TE consecutive edges x CT channels.  When CT = C the tile's
//     x is one contiguous range, and one producer thread copies it with a
//     single 1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes,
//     no tensor map) into a ring of S >= 2 stages behind full / empty
//     mbarriers; a ragged last tile expects the bytes it has, nothing is
//     padded.  Only a width whose edge does not fit two stages is cut into
//     channel chunks (CT < C), copied row by row;
//   - the per-edge values (K1's v, K4's tables) are not 16-byte multiples
//     per edge, so the producer warp moves them with 4-byte cp.async into
//     the same stage and the full barrier also waits for those;
//   - the consumers (four warps) own 16 bytes of channels (4 f32 or 8 bf16)
//     of one edge each: neighbouring threads read neighbouring 16 B of the
//     stage (no bank conflicts) and read each M[e, p] as a broadcast from
//     shared memory; sums are in f32, in the pair order;
//   - outputs leave as streaming stores from registers (st.global.cs).
// The tile plan (TE, CT, S, shared memory) is `plan` below; the wrappers'
// ops/cuda/edge_rotate.py:tile_plan mirrors it and a test on the card holds
// the two equal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// The kernels' launch bounds promise ptxas one block per SM: with the
// default of none it capped a few instances at 64 registers and spilled.
#define ETQ_LAUNCH_BOUNDS __launch_bounds__(etq::THREADS, 1)

namespace etq {

// ops/cuda/edge_rotate.py mirrors these constants.
constexpr int CONSUMERS = 128;           // four consumer warps
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int MAX_STAGES = 4;            // the ring's deepest
// a block's shared-memory share when two share an SM
// ((228 KB - 2 x 1 KB the card reserves per block) / 2)
constexpr int BLOCK_SMEM = 115712;
constexpr int SMEM_LIMIT = 232448;       // 227 KB, the most one block may take
constexpr int BAR_BYTES = 128;           // full[S] and empty[S] mbarriers
static_assert(16 * MAX_STAGES <= BAR_BYTES, "the barriers outgrow their bytes");

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int align128(int b) { return (b + 127) & ~127; }

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
__host__ __device__ constexpr int n_pairs(int lmax, int mmax, int kind) {
  int n = 0;
  for (int l = 0; l <= lmax; ++l) n += in_w(l, mmax, kind) * out_w(l, mmax, kind);
  return n;
}
__host__ __device__ constexpr int max_in_w(int lmax, int mmax, int kind) {
  int n = 0;
  for (int l = 0; l <= lmax; ++l) n = imax(n, in_w(l, mmax, kind));
  return n;
}

// ── the tile plan ──────────────────────────────────────────────────────────

// The shared memory of one block (offsets in bytes from the dynamic base):
// the barriers, `fixed` floats (K4's constants), `scratch` floats per edge
// (K4's block build), and S stages of [x tile | per-edge values].
struct Layout {
  int te, ct, stages;
  int fixed_off, scratch_off, ring_off, x_bytes, stage_bytes, total;
};

__host__ __device__ inline Layout layout(int te, int ct, int stages, int elt, int ki,
                                         int values, int scratch, int fixed) {
  Layout L{};
  L.te = te;
  L.ct = ct;
  L.stages = stages;
  L.fixed_off = BAR_BYTES;
  L.scratch_off = L.fixed_off + align128(4 * fixed);
  L.ring_off = L.scratch_off + align128(4 * te * scratch);
  L.x_bytes = align128(te * ki * ct * elt);
  L.stage_bytes = L.x_bytes + align128(4 * te * values);
  L.total = L.ring_off + stages * L.stage_bytes;
  return L;
}

// Channels per tile: all C unless two stages of one edge exceed 227 KB,
// then the widest divisor of the 16-byte groups that fits.  Edges per tile:
// enough for every consumer thread to own one 16-byte group (one edge when
// the channels are cut), fewer only while two stages exceed 227 KB.
// Stages: as many (2 to 4) as fit beside another block on the SM when two
// do, else as many as fit in 227 KB (one block per SM).
inline Layout plan(int elt, int C, int ki, int values, int scratch, int fixed) {
  const int vec = 16 / elt, groups = C / vec;
  auto smem = [&](int te, int ct, int s) {
    return layout(te, ct, s, elt, ki, values, scratch, fixed).total;
  };
  int g = groups;
  while (g > 1 && (groups % g || smem(1, g * vec, 2) > SMEM_LIMIT)) --g;
  const int ct = g * vec;
  int te = ct == C ? (CONSUMERS + g - 1) / g : 1;
  while (te > 1 && smem(te, ct, 2) > SMEM_LIMIT) --te;
  const int budget = smem(te, ct, 2) <= BLOCK_SMEM ? BLOCK_SMEM : SMEM_LIMIT;
  int s = 2;
  while (s < MAX_STAGES && smem(te, ct, s + 1) <= budget) ++s;
  return layout(te, ct, s, elt, ki, values, scratch, fixed);
}

// ── PTX helpers ────────────────────────────────────────────────────────────

// smem_u32, the mbarrier, bulk-copy and cp.async helpers: hopper.cuh
// named barrier over the consumer warps (id 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void st_cs(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// 16 bytes of channels: 4 f32 or 8 bf16, converted to / from f32
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  union U {
    uint4 u;
    __nv_bfloat162 h[4];
  };
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    U q;
    q.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(q.h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[8]) {
    U q;
#pragma unroll
    for (int i = 0; i < 4; ++i) q.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q.u;
  }
};

// ── the kernel ─────────────────────────────────────────────────────────────

struct Args {
  const void* x;
  void* y;
  const float* vals[6];  // per-edge value tables (K1: v; K4: the six factors)
  int E, C;
  Layout L;
  int chunks;  // channel chunks per edge tile: C / CT
  int tiles;   // edge tiles x chunks
};

// One (edge, 16-byte channel group) of a tile: y rows from x rows in
// shared memory (`xs`, row stride `ct`) and the edge's P values `m`, in the
// pair order of ops/cuda/rotate_dense.py:kernel_pair_order.  Per degree l,
// the in_w input rows stay in registers and each output row is one
// unrolled sum over them, so every m index is a compile-time constant.
template <typename T, int LMAX, int MMAX, int KIND, class Out>
__device__ __forceinline__ void apply_item(const T* xs, int ct, const float* m, Out& out) {
  constexpr int V = Pack<T>::N;
  constexpr int IW = max_in_w(LMAX, MMAX, KIND);
  constexpr int D = 2 * LMAX + 1;
  int p = 0, io = 0, oo = 0;
#pragma unroll
  for (int l = 0; l <= LMAX; ++l) {
    const int iw = in_w(l, MMAX, KIND), ow = out_w(l, MMAX, KIND);
    float xl[IW][V];
#pragma unroll
    for (int k = 0; k < IW; ++k)
      if (k < iw) Pack<T>::load(xs + (io + k) * ct, xl[k]);
#pragma unroll
    for (int o = 0; o < D; ++o) {
      if (o < ow) {
        float acc[V] = {};
#pragma unroll
        for (int k = 0; k < IW; ++k) {
          if (k < iw) {
            const float s = m[p];
            ++p;
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(s, xl[k][j], acc[j]);
          }
        }
        out(oo + o, acc);
      }
    }
    io += iw;
    oo += ow;
  }
}

// The body of both kernels (each source wraps it in its own __global__
// function, so K1 and K4 keep their names in ptxas and profiler output).
// `Coef` supplies the per-edge values: its value tables (SEGS of them,
// seg(i) floats per edge, VALUES in all), the floats it keeps per block
// (FIXED) and per edge (SCRATCH), a `prologue` run once per block and
// `block`, which returns the tile's [te][P] values in shared memory.
template <typename T, int LMAX, int MMAX, int KIND, class Coef>
__device__ __forceinline__ void run(const Args& a) {
  using PK = Pack<T>;
  constexpr int V = PK::N;
  constexpr int KI = n_in(LMAX, MMAX, KIND);
  constexpr int KO = n_out(LMAX, MMAX, KIND);
  constexpr int P = n_pairs(LMAX, MMAX, KIND);
  constexpr int ELT = (int)sizeof(T);
  const Layout& L = a.L;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar0 = smem_u32(smem);  // full[s] at 8 s, empty[s] at 8 (MAX_STAGES + s)
  float* fixed = reinterpret_cast<float*>(smem + L.fixed_off);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off);
  unsigned char* ring = smem + L.ring_off;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(bar0 + 8 * s, 1 + 32);                       // producer: tx + 32 cp.async
      mbar_init(bar0 + 8 * (MAX_STAGES + s), CONSUMERS / 32); // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < CONSUMERS) Coef::prologue(fixed, tid);
  __syncthreads();

  if (tid >= CONSUMERS) {
    // The producer warp: tile k into stage k % S once the consumers have
    // released the stage's previous tile.
    const T* __restrict__ x = static_cast<const T*>(a.x);
    int k = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++k) {
      const int slot = k % L.stages;
      const uint32_t full = bar0 + 8 * slot;
      if (k >= L.stages) mbar_wait(bar0 + 8 * (MAX_STAGES + slot), ((k / L.stages) + 1) & 1);
      const int et = t / a.chunks;
      const long long e0 = (long long)et * L.te;
      const int ne = (int)(a.E - e0 < L.te ? a.E - e0 : L.te);  // the last tile is ragged
      const int c0 = (t - et * a.chunks) * L.ct;
      const uint32_t xs = smem_u32(ring + slot * L.stage_bytes);
      const uint32_t row_bytes = (uint32_t)(L.ct * ELT);
      if (lane == 0) mbar_arrive_expect_tx(full, (uint32_t)(ne * KI) * row_bytes);
      __syncwarp();
      if (L.ct == a.C) {
        if (lane == 0) bulk_load(xs, x + e0 * KI * a.C, (uint32_t)(ne * KI) * row_bytes, full);
      } else {
        for (int r = lane; r < ne * KI; r += 32)
          bulk_load(xs + r * row_bytes, x + (e0 * KI + r) * a.C + c0, row_bytes, full);
      }
      uint32_t vs = xs + L.x_bytes;
#pragma unroll
      for (int i = 0; i < Coef::SEGS; ++i) {
        const float* src = a.vals[i] + e0 * Coef::seg(i);
        for (int j = lane; j < ne * Coef::seg(i); j += 32) cp_async4(vs + 4 * j, src + j);
        vs += 4 * L.te * Coef::seg(i);
      }
      mbar_arrive_cp_async(full);
    }
    cp_async_wait_all();  // no copy outlives its thread
    return;
  }

  // The consumers: item it of a tile is edge it / G, 16-byte group it % G.
  T* __restrict__ y = static_cast<T*>(a.y);
  const int G = L.ct / V;
  int k = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++k) {
    const int slot = k % L.stages;
    mbar_wait(bar0 + 8 * slot, (k / L.stages) & 1);
    const int et = t / a.chunks;
    const long long e0 = (long long)et * L.te;
    const int ne = (int)(a.E - e0 < L.te ? a.E - e0 : L.te);
    const int c0 = (t - et * a.chunks) * L.ct;
    const unsigned char* stage = ring + slot * L.stage_bytes;
    const T* xt = reinterpret_cast<const T*>(stage);
    const float* m = Coef::block(reinterpret_cast<const float*>(stage + L.x_bytes), fixed,
                                 scratch, L.te, ne, tid);
    for (int it = tid; it < ne * G; it += CONSUMERS) {
      const int el = it / G;
      const int cg = (it - el * G) * V;
      T* yo = y + (e0 + el) * KO * a.C + c0 + cg;
      auto out = [&](int row, const float (&acc)[V]) {
        st_cs(yo + (long long)row * a.C, PK::pack(acc));
      };
      apply_item<T, LMAX, MMAX, KIND>(xt + el * KI * L.ct + cg, L.ct, m + el * P, out);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar0 + 8 * (MAX_STAGES + slot));  // this warp is done with it
  }
}

// Launch one instance of `kern` (a kernel that calls `run`) on the
// persistent grid.  Its dynamic shared memory may grow to 227 KB (set once
// per device), and the grid is SMs x the occupancy calculator's blocks per
// SM for the plan's shared memory (cached per instance, device and size).
template <typename T, int LMAX, int MMAX, int KIND, class Coef>
int launch(void (*kern)(Args), const void* x, const float* const* vals, void* y, int E,
           int C, cudaStream_t stream) {
  constexpr int KI = n_in(LMAX, MMAX, KIND);
  if (E == 0 || C == 0) return 0;
  Args a{};
  a.x = x;
  a.y = y;
  for (int i = 0; i < Coef::SEGS; ++i) a.vals[i] = vals[i];
  a.E = E;
  a.C = C;
  a.L = plan((int)sizeof(T), C, KI, Coef::VALUES, Coef::SCRATCH, Coef::FIXED);
  a.chunks = C / a.L.ct;
  a.tiles = (E + a.L.te - 1) / a.L.te * a.chunks;

  struct Grid { int dev, smem, blocks; };
  static Grid cache[4] = {{-1, 0, 0}, {-1, 0, 0}, {-1, 0, 0}, {-1, 0, 0}};
  static unsigned raised = 0;  // devices whose limit is set (bit per device)
  static int next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  for (const Grid& g : cache)
    if (g.dev == dev && g.smem == a.L.total) blocks = g.blocks;
  if (blocks == 0) {
    if (dev >= 32 || !(raised >> dev & 1u)) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
      if (err != cudaSuccess) return (int)err;
      if (dev < 32) raised |= 1u << dev;
    }
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                             a.L.total)) != cudaSuccess)
      return (int)err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    cache[next] = {dev, a.L.total, blocks};
    next = (next + 1) % 4;
  }
  kern<<<a.tiles < blocks ? a.tiles : blocks, THREADS, a.L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace etq
