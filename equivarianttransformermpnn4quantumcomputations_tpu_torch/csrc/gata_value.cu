// K5a / K5b / K5c: GATA-V2's value activation and its first and second
// adjoints, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this elementwise body of
// nn/gata.py:GATAValueActivation to XLA's fusion.  Eagerly it is ~1,500
// launches a MatPES force-training step (column slices of the gates, row
// slices of the projected neighbour features, broadcast products, a cat,
// and autograd's zero-fill / copy / add for each slice's backward, all
// through a second-order graph), about a quarter of the step's eager device
// time.  Here each pass is one launch.
//
// With S = 1 + 2 L chunks of C channels in a, r, g, p ([E, S C]; p absent
// reads as 1), the K - 1 = L (L + 2) rows of xp ([E, K - 1, C]) and rl
// ([E, K - 1]), w(l) = min(2 l + 1, 2 mmax + 1) and off(l) = l^2 - 1:
//
//   comb_j = a_j + r_j silu(g_j) p_j                          (chunk j)
//   K5a  out[0]          = silu(comb_0)
//        out[R(l, i)]    = comb_l rl[off(l) + i] + comb_{L+l} xp[off(l) + i],  i < w(l)
//   K5b  from dout [E, K_red, C]: da, dr, dg, dp [E, S C], dxp [E, K - 1, C]
//        (its unused rows zero), drl [E, K - 1]:
//        D_0 = dout[0] silu'(comb_0), D_l = sum_i dout[R] rl, D_{L+l} = sum_i dout[R] xp,
//        da = D, dr = D s p, dg = D r p s', dp = D r s   (s = silu(g), s' = silu'(g)),
//        dxp[off + i] = dout[R] comb_{L+l},  drl[off + i] = sum_c dout[R] comb_l
//   K5c  the vjp of K5b for the cotangents (Ga, Gr, Gg, Gp, Gxp, Grl) of its outputs:
//        H_j = Ga_j + Gr_j s p + Gg_j r p s' + Gp_j r s   (the cotangent of D_j),
//        Gc_0 = H_0 dout[0] silu''(comb_0), Gc_l = sum_i Grl dout[R],
//        Gc_{L+l} = sum_i Gxp dout[R]                     (the cotangent of comb_j),
//        a: Gc;  r: Gc s p + D (Gg p s' + Gp s);  g: Gc r p s' + D (Gr p s' + Gg r p s'' + Gp r s');
//        p: Gc r s + D (Gr s + Gg r s');  xp[off + i]: H_{L+l} dout[R];
//        rl[off + i]: sum_c H_l dout[R];  dout[0]: H_0 silu'(comb_0);
//        dout[R]: H_l rl + H_{L+l} xp + Gxp comb_{L+l} + Grl comb_l
//
// (ops/cuda/gata_value.py has the same arithmetic in plain PyTorch.)
//
// Bound: memory.  Each input is read once and each output written once
// (K5a ~64 C values an edge at lmax 4 / mmax 2, K5b ~115 C, K5c ~185 C),
// against a few flops per value.  Design: one group of G lanes per edge
// (G = C / V rounded up to a power of two, at most 32), each lane holding
// V channels as one load (CHANNELS below: 4 f32 in 16 bytes; 8 bf16 in 16
// bytes, 4 in 8 in K5c), so a group reads a chunk or a row of an edge as
// one contiguous run.  The degrees and their
// rows are loops unrolled at compile time (L and a cap M on mmax are
// template parameters; mmax <= M is a run-time bound): every load of a
// degree (its two gate chunks, in K5c their cotangents, and its rows) is
// issued into registers as one batch, raw, before any of them is used, so
// a lane keeps ~10-30 loads in flight (a first version that loaded as it
// computed kept about one and ran at 40 % of the bound).  Sums
// over rows (D, Gc) stay in each lane's registers; sums over channels
// (drl, the rl gradient) are a butterfly of __shfl_xor_sync within the
// group, in f32, in a fixed order.  A persistent grid of warps walks the
// edges with no atomics, so a step's bits repeat run to run.  Every value
// is computed in f32; bf16 rounds once, at each output.  a may have a row
// stride (a column slice of conv 1's outputs).  Absent inputs (p, a
// cotangent) are null pointers and read as 1 (p) or 0; absent outputs are
// null pointers and not written.  The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Threads a block, and the blocks an SM must hold, which caps the registers
// of a thread at 65,536 / (THREADS MIN_BLOCKS), at most 255: K5a 128, K5b
// 170, K5c in f32 255 (a degree's chunks, cotangents and rows, 16 bytes
// each, held at once), in bf16 170
constexpr int THREADS = 128;
template <typename T, int KIND>
constexpr int MIN_BLOCKS = KIND == 0 ? 4 : KIND == 1 || !std::is_same_v<T, float> ? 3 : 2;

// the pointer slots of the C entry's `ptrs` (ops/cuda/gata_value.py:IN_SLOTS, OUT_SLOTS)
enum { I_A, I_R, I_G, I_P, I_XP, I_RL, I_DOUT, I_GA, I_GR, I_GG, I_GP, I_GXP, I_GRL, N_IN };
enum { O_A, O_R, O_G, O_P, O_XP, O_RL, O_DOUT, N_OUT };

template <typename T>
struct Args {
  const T* in[N_IN];
  T* out[N_OUT];  // K5a writes its output, which has dout's shape, at O_DOUT
  long long a_stride;  // elements between two edges' rows of a
  int E, C, mmax, kred, group_shift;
};

// Channels a lane holds: 4 f32 (one 16-byte load); in bf16 8 (16 bytes)
// in K5a and K5b, 4 (8 bytes) in K5c, whose working set of f32 values per
// channel would not fit a thread's registers at 8 (it spilled 2.5 KB and
// ran at 23 % of the bound)
template <typename T, int KIND>
constexpr int CHANNELS = std::is_same_v<T, float> || KIND == 2 ? 4 : 8;

template <int N>
using V = float[N];

// N channels of one row, as loaded: 16 or 8 bytes
template <typename T, int N>
using Raw = std::conditional_t<N * sizeof(T) == 16, uint4, uint2>;

template <typename T, int N>
__device__ __forceinline__ Raw<T, N> ld(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T, N>*>(p));
}

template <typename T, int N>
__device__ __forceinline__ Raw<T, N> zero_raw() {
  Raw<T, N> z;
  if constexpr (sizeof(z) == 16) z = make_uint4(0u, 0u, 0u, 0u);
  else z = make_uint2(0u, 0u);
  return z;
}

template <typename T, int N>
__device__ __forceinline__ void unpack(const Raw<T, N>& u, V<N>& v) {
  if constexpr (std::is_same_v<T, float>) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    uint32_t w[N / 2];
    w[0] = u.x;
    w[1] = u.y;
    if constexpr (N == 8) {
      w[2] = u.z;
      w[3] = u.w;
    }
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const V<N>& v) {
  Raw<T, N> u;
  if constexpr (std::is_same_v<T, float>) {
    u = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                   __float_as_uint(v[3]));
  } else if constexpr (N == 8) {
    u = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                   pack_bf16(v[6], v[7]));
  } else {
    u = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
  *reinterpret_cast<Raw<T, N>*>(p) = u;
}

template <typename T>
__device__ __forceinline__ float scalar(const T* p) {
  if constexpr (std::is_same_v<T, float>) return __ldg(p);
  else return __bfloat162float(__ldg(p));
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same_v<T, float>) return x;
  else return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.0f + __expf(-x)); }

// silu and its first two derivatives at x
struct Silu {
  float f, d1, d2;
  __device__ __forceinline__ explicit Silu(float x) {
    const float s = sigmoid(x);
    f = x * s;
    d1 = s * (1.0f + x * (1.0f - s));
    d2 = s * (1.0f - s) * (2.0f + x * (1.0f - 2.0f * s));
  }
};

// the sum of v over the lanes of a group of G (a power of two) lanes
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One lane of one edge: element offsets of its channels in the [E, S C]
// chunks (ch), in a (a), in the [E, K - 1, C] rows (rows), in the
// [E, K_red, C] rows (out) and of the edge's [E, K - 1] scalars (rl).
struct Lane {
  long long ch, a, rows, out, rl;
  bool st;   // this lane's channels exist: it stores
  bool wr;   // this lane writes the group's per-row sums (drl, the rl gradient)
  float ok;  // 1 where st, else 0 (the lane's share of a group sum)
};

template <typename T, int N>
__device__ __forceinline__ void store_if(const Args<T>& A, int slot, long long off, bool st,
                                         const V<N>& v) {
  if (A.out[slot] && st) store<T, N>(A.out[slot] + off, v);
}

// a gate chunk's inputs, as loaded (p only where given)
template <typename T, int N>
struct ChunkRaw {
  Raw<T, N> a, r, g, p;
};

template <typename T, int N>
__device__ __forceinline__ void load_chunk(const Args<T>& A, const Lane& ln, int j, ChunkRaw<T, N>& c,
                                           bool with_a) {
  const int o = j * A.C;
  if (with_a) c.a = ld<T, N>(A.in[I_A] + ln.a + o);
  c.r = ld<T, N>(A.in[I_R] + ln.ch + o);
  c.g = ld<T, N>(A.in[I_G] + ln.ch + o);
  if (A.in[I_P]) c.p = ld<T, N>(A.in[I_P] + ln.ch + o);
}

template <typename T, int N>
__device__ __forceinline__ void unpack_p(const Args<T>& A, const ChunkRaw<T, N>& c, V<N>& p) {
  if (A.in[I_P]) {
    unpack<T, N>(c.p, p);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = 1.0f;
  }
}

// comb_j = a + r silu(g) p of a loaded chunk
template <typename T, int N>
__device__ __forceinline__ void combined(const Args<T>& A, const ChunkRaw<T, N>& c, V<N>& out) {
  V<N> a, r, g, p;
  unpack<T, N>(c.a, a);
  unpack<T, N>(c.r, r);
  unpack<T, N>(c.g, g);
  unpack_p(A, c, p);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = a[k] + r[k] * Silu(g[k]).f * p[k];
}

// K5b's gradients of chunk j from D_j: da, dr, dg, dp
template <typename T, int N>
__device__ __forceinline__ void chunk_grads(const Args<T>& A, const Lane& ln, int j,
                                            const ChunkRaw<T, N>& c, const V<N>& D) {
  const long long o = ln.ch + j * A.C;
  V<N> r, g, p, xr, xg, xp;
  unpack<T, N>(c.r, r);
  unpack<T, N>(c.g, g);
  unpack_p(A, c, p);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const Silu s(g[k]);
    xr[k] = D[k] * s.f * p[k];
    xg[k] = D[k] * r[k] * p[k] * s.d1;
    xp[k] = D[k] * r[k] * s.f;
  }
  store_if(A, O_A, o, ln.st, D);
  store_if(A, O_R, o, ln.st, xr);
  store_if(A, O_G, o, ln.st, xg);
  store_if(A, O_P, o, ln.st, xp);
}

// the cotangents of a gate chunk's K5b outputs, as loaded (absent: zero)
template <typename T, int N>
struct CotRaw {
  Raw<T, N> a, r, g, p;
};

template <typename T, int N>
__device__ __forceinline__ void load_cot(const Args<T>& A, const Lane& ln, int j, CotRaw<T, N>& c) {
  const long long o = ln.ch + j * A.C;
  const Raw<T, N> z = zero_raw<T, N>();
  c.a = A.in[I_GA] ? ld<T, N>(A.in[I_GA] + o) : z;
  c.r = A.in[I_GR] ? ld<T, N>(A.in[I_GR] + o) : z;
  c.g = A.in[I_GG] ? ld<T, N>(A.in[I_GG] + o) : z;
  c.p = A.in[I_GP] ? ld<T, N>(A.in[I_GP] + o) : z;
}

// K5c's gradients of chunk j from D_j and the cotangent of comb_j, which
// `gc(k, H_k)` gives; returns H_j (the cotangent of D_j) in H
template <typename T, int N, typename Gc>
__device__ __forceinline__ void chunk_grads2(const Args<T>& A, const Lane& ln, int j,
                                             const ChunkRaw<T, N>& c, const CotRaw<T, N>& G, const V<N>& D,
                                             Gc gc, V<N>& H) {
  const long long o = ln.ch + j * A.C;
  V<N> r, g, p, Ga, Gr, Gg, Gp, xa, xr, xg, xp;
  unpack<T, N>(c.r, r);
  unpack<T, N>(c.g, g);
  unpack_p(A, c, p);
  unpack<T, N>(G.a, Ga);
  unpack<T, N>(G.r, Gr);
  unpack<T, N>(G.g, Gg);
  unpack<T, N>(G.p, Gp);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const Silu s(g[k]);
    H[k] = Ga[k] + Gr[k] * s.f * p[k] + Gg[k] * r[k] * p[k] * s.d1 + Gp[k] * r[k] * s.f;
    const float cc = gc(k, H[k]);
    xa[k] = cc;
    xr[k] = cc * s.f * p[k] + D[k] * (Gg[k] * p[k] * s.d1 + Gp[k] * s.f);
    xg[k] = cc * r[k] * p[k] * s.d1 +
            D[k] * (Gr[k] * p[k] * s.d1 + Gg[k] * r[k] * p[k] * s.d2 + Gp[k] * r[k] * s.d1);
    xp[k] = cc * r[k] * s.f + D[k] * (Gr[k] * s.f + Gg[k] * r[k] * s.d1);
  }
  store_if(A, O_A, o, ln.st, xa);
  store_if(A, O_R, o, ln.st, xr);
  store_if(A, O_G, o, ln.st, xg);
  store_if(A, O_P, o, ln.st, xp);
}

// The rows one degree keeps, at most (M: the cap on mmax of the instance)
template <int L, int M>
constexpr int WMAX = (2 * L + 1 < 2 * M + 1) ? 2 * L + 1 : 2 * M + 1;

template <typename T, int N, int L, int M>
__device__ __forceinline__ void k5a(const Args<T>& A, const Lane& ln) {
  constexpr int W = WMAX<L, M>;
  const int C = A.C;
  {
    ChunkRaw<T, N> c;
    load_chunk(A, ln, 0, c, true);
    V<N> v;
    combined(A, c, v);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = Silu(v[k]).f;
    store_if(A, O_DOUT, ln.out, ln.st, v);
  }
  int rb = 1;
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    const int w = min(2 * l + 1, 2 * A.mmax + 1), off = l * l - 1;
    ChunkRaw<T, N> cl_raw, ct_raw;
    load_chunk(A, ln, l, cl_raw, true);
    load_chunk(A, ln, L + l, ct_raw, true);
    Raw<T, N> xr[W];
    float q[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < 2 * l + 1 && i < w) {
        xr[i] = ld<T, N>(A.in[I_XP] + ln.rows + (off + i) * C);
        q[i] = scalar(A.in[I_RL] + ln.rl + off + i);
      }
    }
    V<N> cl, ct;
    combined(A, cl_raw, cl);
    combined(A, ct_raw, ct);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < 2 * l + 1 && i < w) {
        V<N> x, o;
        unpack<T, N>(xr[i], x);
#pragma unroll
        for (int k = 0; k < N; ++k) o[k] = cl[k] * q[i] + ct[k] * x[k];
        store_if(A, O_DOUT, ln.out + (rb + i) * C, ln.st, o);
      }
    }
    rb += w;
  }
}

// zero the rows of dxp (and drl) past w in degree l
template <typename T, int N>
__device__ __forceinline__ void zero_rows(const Args<T>& A, const Lane& ln, int l, int w) {
  V<N> z;
#pragma unroll
  for (int k = 0; k < N; ++k) z[k] = 0.0f;
  const int off = l * l - 1;
#pragma unroll
  for (int i = 0; i < 2 * l + 1; ++i) {
    if (i >= w) {
      store_if(A, O_XP, ln.rows + (off + i) * A.C, ln.st, z);
      if (A.out[O_RL] && ln.wr) A.out[O_RL][ln.rl + off + i] = from_float<T>(0.0f);
    }
  }
}

template <typename T, int N, int L, int M>
__device__ __forceinline__ void k5b(const Args<T>& A, const Lane& ln, int G) {
  constexpr int W = WMAX<L, M>;
  const int C = A.C;
  {
    ChunkRaw<T, N> c;
    load_chunk(A, ln, 0, c, true);
    const Raw<T, N> dr = ld<T, N>(A.in[I_DOUT] + ln.out);
    V<N> cm, d, D;
    combined(A, c, cm);
    unpack<T, N>(dr, d);
#pragma unroll
    for (int k = 0; k < N; ++k) D[k] = d[k] * Silu(cm[k]).d1;
    chunk_grads(A, ln, 0, c, D);
  }
  int rb = 1;
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    const int w = min(2 * l + 1, 2 * A.mmax + 1), off = l * l - 1;
    ChunkRaw<T, N> cl_raw, ct_raw;
    load_chunk(A, ln, l, cl_raw, true);
    load_chunk(A, ln, L + l, ct_raw, true);
    Raw<T, N> dr[W], xr[W];
    float q[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < 2 * l + 1 && i < w) {
        dr[i] = ld<T, N>(A.in[I_DOUT] + ln.out + (rb + i) * C);
        xr[i] = ld<T, N>(A.in[I_XP] + ln.rows + (off + i) * C);
        q[i] = scalar(A.in[I_RL] + ln.rl + off + i);
      }
    }
    V<N> cl, ct, Dl, Dt;
    combined(A, cl_raw, cl);
    combined(A, ct_raw, ct);
#pragma unroll
    for (int k = 0; k < N; ++k) Dl[k] = Dt[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < 2 * l + 1 && i < w) {
        V<N> d, x, t;
        unpack<T, N>(dr[i], d);
        unpack<T, N>(xr[i], x);
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          Dl[k] += d[k] * q[i];
          Dt[k] += d[k] * x[k];
          t[k] = d[k] * ct[k];
          s += d[k] * cl[k];
        }
        store_if(A, O_XP, ln.rows + (off + i) * C, ln.st, t);
        if (A.out[O_RL]) {
          s = group_sum(s * ln.ok, G);
          if (ln.wr) A.out[O_RL][ln.rl + off + i] = from_float<T>(s);
        }
      }
    }
    zero_rows<T, N>(A, ln, l, w);
    chunk_grads(A, ln, l, cl_raw, Dl);
    chunk_grads(A, ln, L + l, ct_raw, Dt);
    rb += w;
  }
}

template <typename T, int N, int L, int M>
__device__ __forceinline__ void k5c(const Args<T>& A, const Lane& ln, int G) {
  constexpr int W = WMAX<L, M>;
  const int C = A.C;
  const Raw<T, N> z = zero_raw<T, N>();
  {
    // chunk 0: Gc_0 = H_0 dout[0] silu''(comb_0); dout[0]'s gradient H_0 silu'(comb_0)
    ChunkRaw<T, N> c;
    CotRaw<T, N> g;
    load_chunk(A, ln, 0, c, true);
    const Raw<T, N> dr = ld<T, N>(A.in[I_DOUT] + ln.out);
    load_cot(A, ln, 0, g);
    V<N> cm, d, D, s1, s2, H, t;
    combined(A, c, cm);
    unpack<T, N>(dr, d);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const Silu s(cm[k]);
      s1[k] = s.d1;
      s2[k] = s.d2;
      D[k] = d[k] * s.d1;
    }
    chunk_grads2(A, ln, 0, c, g, D, [&](int k, float h) { return h * d[k] * s2[k]; }, H);
#pragma unroll
    for (int k = 0; k < N; ++k) t[k] = H[k] * s1[k];
    store_if(A, O_DOUT, ln.out, ln.st, t);
  }
  int rb = 1;
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    const int w = min(2 * l + 1, 2 * A.mmax + 1), off = l * l - 1;
    // one batch of loads: both gate chunks, their cotangents, the rows
    ChunkRaw<T, N> cl_raw, ct_raw;
    CotRaw<T, N> gl, gt;
    Raw<T, N> dr[W], xr[W], gx[W];
    float q[W], gq[W];
    load_chunk(A, ln, l, cl_raw, true);
    load_chunk(A, ln, L + l, ct_raw, true);
    load_cot(A, ln, l, gl);
    load_cot(A, ln, L + l, gt);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < 2 * l + 1 && i < w) {
        dr[i] = ld<T, N>(A.in[I_DOUT] + ln.out + (rb + i) * C);
        xr[i] = ld<T, N>(A.in[I_XP] + ln.rows + (off + i) * C);
        gx[i] = A.in[I_GXP] ? ld<T, N>(A.in[I_GXP] + ln.rows + (off + i) * C) : z;
        q[i] = scalar(A.in[I_RL] + ln.rl + off + i);
        gq[i] = A.in[I_GRL] ? scalar(A.in[I_GRL] + ln.rl + off + i) : 0.0f;
      }
    }
    V<N> cl, ct, Dl, Dt, Gl, Gt, Hl, Ht;
    combined(A, cl_raw, cl);
    combined(A, ct_raw, ct);
    // first pass over the rows: D and the cotangents of comb_l, comb_{L+l}
#pragma unroll
    for (int k = 0; k < N; ++k) Dl[k] = Dt[k] = Gl[k] = Gt[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < 2 * l + 1 && i < w) {
        V<N> d, x, y;
        unpack<T, N>(dr[i], d);
        unpack<T, N>(xr[i], x);
        unpack<T, N>(gx[i], y);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          Dl[k] += d[k] * q[i];
          Dt[k] += d[k] * x[k];
          Gl[k] += gq[i] * d[k];
          Gt[k] += y[k] * d[k];
        }
      }
    }
    chunk_grads2(A, ln, l, cl_raw, gl, Dl, [&](int k, float) { return Gl[k]; }, Hl);
    chunk_grads2(A, ln, L + l, ct_raw, gt, Dt, [&](int k, float) { return Gt[k]; }, Ht);
    // second pass over the rows, still in registers: the gradients of xp,
    // rl and dout
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < 2 * l + 1 && i < w) {
        V<N> d, x, y, t, u;
        unpack<T, N>(dr[i], d);
        unpack<T, N>(xr[i], x);
        unpack<T, N>(gx[i], y);
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          t[k] = Ht[k] * d[k];
          s += Hl[k] * d[k];
          u[k] = Hl[k] * q[i] + Ht[k] * x[k] + y[k] * ct[k] + gq[i] * cl[k];
        }
        store_if(A, O_XP, ln.rows + (off + i) * C, ln.st, t);
        store_if(A, O_DOUT, ln.out + (rb + i) * C, ln.st, u);
        if (A.out[O_RL]) {
          s = group_sum(s * ln.ok, G);
          if (ln.wr) A.out[O_RL][ln.rl + off + i] = from_float<T>(s);
        }
      }
    }
    zero_rows<T, N>(A, ln, l, w);
    rb += w;
  }
}

// KIND 0: K5a, 1: K5b, 2: K5c, for lmax L and mmax <= M.  A persistent
// grid of warps; each warp takes 32 / G edges at a time, a group of G
// lanes each.
template <typename T, int L, int M, int KIND>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<T, KIND>)
    gata_value_kernel(const Args<T> A) {
  constexpr int S = 1 + 2 * L, KM = L * (L + 2), N = CHANNELS<T, KIND>;
  const int gs = A.group_shift, G = 1 << gs;
  const int lane = threadIdx.x & 31, sub = lane >> gs, cv = lane & (G - 1);
  const bool lane_ok = cv * N < A.C;
  const int c0 = lane_ok ? cv * N : 0;
  const long long per = 32 >> gs;
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * THREADS) >> 5;
  for (long long base = warp * per; base < A.E; base += warps * per) {
    const long long e0 = base + sub;
    const bool in = e0 < A.E;
    // a lane past the last edge or the last channel computes on valid
    // memory (the last edge, the first channels) and stores nothing
    const long long e = in ? e0 : A.E - 1;
    Lane ln;
    ln.ch = e * S * A.C + c0;
    ln.a = e * A.a_stride + c0;
    ln.rows = e * KM * A.C + c0;
    ln.out = e * A.kred * A.C + c0;
    ln.rl = e * KM;
    ln.st = in && lane_ok;
    ln.wr = in && cv == 0;
    ln.ok = ln.st ? 1.0f : 0.0f;
    if constexpr (KIND == 0) k5a<T, N, L, M>(A, ln);
    else if constexpr (KIND == 1) k5b<T, N, L, M>(A, ln, G);
    else k5c<T, N, L, M>(A, ln, G);
  }
}

template <typename T, int L, int M, int KIND>
int launch(const Args<T>& A, cudaStream_t stream) {
  if (A.E == 0) return 0;
  static int sms = 0, per_sm = 0;  // per instance: the card's and the kernel's
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gata_value_kernel<T, L, M, KIND>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  const long long per_block = (long long)(THREADS / 32) * (32 >> A.group_shift);
  const long long want = (A.E + per_block - 1) / per_block;
  const long long most = (long long)sms * per_sm;
  gata_value_kernel<T, L, M, KIND><<<(int)(want < most ? want : most), THREADS, 0, stream>>>(A);
  return (int)cudaGetLastError();
}

template <typename T, int L, int M>
int by_kind(int kernel, const Args<T>& A, cudaStream_t s) {
  switch (kernel) {
    case 0: return launch<T, L, M, 0>(A, s);
    case 1: return launch<T, L, M, 1>(A, s);
    case 2: return launch<T, L, M, 2>(A, s);
    default: return -1;
  }
}

// the instance for lmax L: the cap M = 2 (the configurations' mmax) where
// mmax <= 2, else M = L
template <typename T, int L>
int by_mmax(int kernel, const Args<T>& A, cudaStream_t s) {
  if constexpr (L > 2) {
    if (A.mmax <= 2) return by_kind<T, L, 2>(kernel, A, s);
  }
  return by_kind<T, L, L>(kernel, A, s);
}

template <typename T>
int dispatch(int kernel, int lmax, int mmax, int E, int C, long long a_stride,
             const unsigned long long* ptrs, cudaStream_t s) {
  const int NV = kernel == 0 ? CHANNELS<T, 0> : kernel == 1 ? CHANNELS<T, 1> : CHANNELS<T, 2>;
  // the lanes that hold one edge's C channels, rounded up to a power of two
  int group_shift = 0;
  while ((1 << group_shift) * NV < C) ++group_shift;
  if (E < 0 || C <= 0 || C % 8 || group_shift > 5 || mmax < 0 || mmax > lmax || a_stride % 8)
    return -4;
  Args<T> A;
  for (int i = 0; i < N_IN; ++i) A.in[i] = reinterpret_cast<const T*>(ptrs[i]);
  for (int i = 0; i < N_OUT; ++i) A.out[i] = reinterpret_cast<T*>(ptrs[N_IN + i]);
  A.a_stride = a_stride;
  A.E = E;
  A.C = C;
  A.mmax = mmax;
  A.group_shift = group_shift;
  A.kred = 1;
  for (int l = 1; l <= lmax; ++l) A.kred += min(2 * l + 1, 2 * mmax + 1);
  switch (lmax) {
    case 1: return by_mmax<T, 1>(kernel, A, s);
    case 2: return by_mmax<T, 2>(kernel, A, s);
    case 3: return by_mmax<T, 3>(kernel, A, s);
    case 4: return by_mmax<T, 4>(kernel, A, s);
    case 6: return by_mmax<T, 6>(kernel, A, s);
    default: return -2;
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; kernel 0 = K5a, 1 = K5b, 2 = K5c.
// ptrs: 20 device pointers, inputs a, r, g, p, xp, rl, dout, ga, gr, gg,
// gp, gxp, grl then outputs da, dr, dg, dp, dxp, drl, ddout (K5a writes its
// output in the last), 0 for an absent one; a_stride: elements between two
// rows of a, a multiple of 8; every row 16-byte aligned; C a multiple of 8,
// at most 128.  Returns 0, a cudaError_t (> 0), -1 for a kernel, -2 for an
// lmax with no instance, -3 for a dtype, -4 for sizes the kernel does not
// take.
extern "C" int etq_gata_value(int dtype, int kernel, int lmax, int mmax, int E, int C,
                              long long a_stride, const void* ptrs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const unsigned long long*>(ptrs);
  if (dtype == 0) return dispatch<float>(kernel, lmax, mmax, E, C, a_stride, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(kernel, lmax, mmax, E, C, a_stride, p, s);
  return -3;
}

extern "C" const char* etq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
