// The one-block-per-chain Metropolis site loops of K1 (float32 and float64,
// site_sweep.cu), K5 (K1 two sites at a time, site_sweep.cu), K8
// (complex64, site_sweep_cx.cu) and K13 (K1 with the slice's wrap fused
// in, site_sweep_wrap.cu), with G of the chain spread over the block's
// registers.
//
// Layout. The block's NT = TR x TC threads cover G_f (N x N, padded to
// NP x NP, NP = TR*RT = TC*CT) in tiles: thread (ty, tx) = (tid / TC,
// tid % TC) owns the RT rows row(ty, k) and the CT columns col(tx, j), in
// chunks of up to 16 bytes of consecutive indices (4 floats or 2 doubles:
// vector reads and writes of the staged vectors without bank conflicts,
// vector loads and stores of G). G's planes are numbered q = f*NV + v
// (flavor f, plane v: complex has a real and an imaginary plane). The
// thread's RT x CT elements of each plane q < QR live in registers; the
// planes QR..F*NV-1 (F = 2 past NP = 64 in complex64 and in float64, the
// imaginary plane of complex128 at F = 1 past NP = 64: G that does not fit
// a register file) live in shared memory private to the thread, element e
// at priv[e*NT + tid], so consecutive threads touch consecutive words.
// Padded rows and columns start at 0 and are never written back.
//
// One block barrier per site (sweep_chain). Only row i and column i of
// every flavor go through shared memory, staged in a double buffer: the
// owners of row i+1 and column i+1 publish them into the other buffer right
// after their own update of site i (after no update, when site i was
// rejected: G did not change), and one barrier later every thread takes
// site i+1's decision from the staged row, which holds G_f[i+1, i+1], and
// reads the staged values of its own rows and columns for the update.
// Buffer i&1 is read at site i while buffer (i+1)&1 is written; the barrier
// at the end of site i keeps site i+1's writers off buffer i&1 until every
// thread has read it. The decision stays block-uniform: every thread
// computes it from the same staged values, in the same operations, so no
// flag is broadcast. sigma and u are read once into shared memory, and what
// the loop records per site (the flipped sigma; complex: the accept flag
// and det) goes to shared memory and out after the loop: nothing leaves the
// SM inside it. exp of the two field values' weights is taken once per
// launch.
//
// One block barrier per pair of sites (sweep_chain_pair, K5): a staging
// buffer holds rows and columns i and j = i+1, published together after
// the previous pair's update; every thread decides site i from G[i,i],
// corrects G[j,j] with site i's rank-1 terms (G[j,i], G[i,j]) and decides
// site j, corrects row j and column j at its own columns and rows, and
// applies both rank-1 terms to its tile in one pass.
//
// Rounding. Every operation is a separately rounded _rn intrinsic (__f*_rn
// in float32, __d*_rn in float64), in the order of the plain PyTorch
// versions (ops/site_sweep.py::site_sweep_plain and site_sweep_pair_plain,
// ops/site_sweep_cx.py::site_sweep_cx_plain), which nvcc never contracts
// into an FMA: the kernels are bit-equal to them.
//
// Register arrays are indexed only with compile-time indices (the tile
// loops are unrolled; the owner of row or column n is found by unrolled
// compare-and-select), so they stay in registers.
//
// A wrap (K13) gets the thread tiles of G before the loop and after it,
// with sigma in and out in shared memory: sweep_chain's Wrap argument.
//
// The flavors of a chain may also live in two blocks of a cluster, one
// flavor each (K8-c128 at F = 2 past NP = 64, site_sweep_cx.cu: G of 512 KB
// at NP = 128 fits no SM): sweep_chain's Xch argument. The flavors meet
// only in the decision, det = (r_0 r_1)^det_power, so the owner of G_f[n, n]
// also writes it into the peer block's shared memory when it publishes row
// n, the site's barrier is a cluster barrier, and both blocks take the same
// decision from the same two diagonal entries in the same operations.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "phase_clock.cuh"

namespace tiled {

// separately rounded operations of each element type
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log10_(float x) { return log10f(x); }
__device__ __forceinline__ double log10_(double x) { return log10(x); }

// 4 consecutive elements of T, moved with 16-byte accesses (one float4, or
// two double2): the delayed sweeps' (K6, K9) register tiles and replays
template <class T>
struct V4 {
  T x, y, z, w;
};

template <class T>
__device__ __forceinline__ V4<T> ld4(const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    return {t.x, t.y, t.z, t.w};
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    return {a.x, a.y, b.x, b.y};
  }
}

template <class T>
__device__ __forceinline__ void st4(T* p, const V4<T>& v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.x, v.y, v.z, v.w);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v.x, v.y);
    reinterpret_cast<double2*>(p)[1] = make_double2(v.z, v.w);
  }
}

// A block of TR x TC threads, each owning RT rows and CT columns of the
// NP x NP padded G of element type T (NP = TR*RT = TC*CT).
template <int TR_, int TC_, int RT_, int CT_, class T_ = float>
struct Geom {
  using T = T_;
  static constexpr int TR = TR_, TC = TC_, RT = RT_, CT = CT_;
  static constexpr int NT = TR * TC, NP = TR * RT;
  // chunk widths: consecutive indices a thread owns, 16 bytes at most
  static constexpr int VW = 16 / (int)sizeof(T);
  static constexpr int WR = RT < VW ? RT : VW, WC = CT < VW ? CT : VW;
  static_assert(TC * CT == NP && RT % WR == 0 && CT % WC == 0,
                "a square padded G in whole chunks");
  __device__ static __forceinline__ int row(int ty, int k) {
    return (k / WR) * (TR * WR) + ty * WR + k % WR;
  }
  __device__ static __forceinline__ int col(int tx, int j) {
    return (j / WC) * (TC * WC) + tx * WC + j % WC;
  }
};

// Calls fn(Gm{}) with the layout of N for elements of type T: a block of
// 256 threads (16 x 16) per chain, each thread a tile of (NP/16) x (NP/16)
// elements of G padded to NP = 32, 64 or 128 (ops/site_sweep.py::padded).
// 256 threads per chain was the fastest of 128 to 1024 at every shape timed
// (PERF.md).
template <class T = float, class Fn>
int with_layout(int N, Fn&& fn) {
  if (N <= 32) return fn(Geom<16, 16, 2, 2, T>{});
  if (N <= 64) return fn(Geom<16, 16, 4, 4, T>{});
  return fn(Geom<16, 16, 8, 8, T>{});
}

// Planes in registers: every plane where the tiles of all of them take a
// thread at most 128 registers of with_layout's 256 threads, else as many
// whole planes as 128 registers hold (complex64 and float64 at F = 2 past
// NP = 64: flavor 0; complex128 at F = 1 past NP = 64: the real plane; G
// of 256 KB at NP = 128, as large as a register file)
template <bool CX, int F, int NP, class T = float>
__host__ __device__ constexpr int planes_in_registers() {
  constexpr int words = (int)(sizeof(T) / 4) * (NP * NP / 256);  // a plane
  constexpr int planes = F * (CX ? 2 : 1);
  return planes * words <= 128 ? planes : 128 / words;
}

// Shared memory of one block, in bytes: the staging double buffer (row and
// column of every flavor and plane, for S sites: K5 stages two), u, the
// complex det per site, the thread-private planes QR..F*NV-1 (all of them
// elements of T), and sigma in and out (complex: the accept flags).
// ops/site_sweep.py::tiled_smem_bytes mirrors it.
template <bool CX, int F, int QR, int NP, class T = float, int S = 1>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int NV = CX ? 2 : 1;
  return (int)sizeof(T) * (2 * 2 * S * NV * F * NP + NP + (CX ? 2 * NP : 0) +
                           (F * NV - QR) * NP * NP) +
         NP * (CX ? 3 : 2);
}

// W consecutive elements of type T (W * sizeof(T) = 8 or 16 bytes, or one
// element) with one vector access
template <int W, class T>
__device__ __forceinline__ void ld_vec(const T* p, T* v) {
  if constexpr (sizeof(T) == 4 && W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (sizeof(T) == 4 && W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else if constexpr (sizeof(T) == 8 && W == 2) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    static_assert(W == 1, "a chunk of at most 16 bytes");
    v[0] = p[0];
  }
}

template <int W, class T>
__device__ __forceinline__ void st_vec(T* p, const T* v) {
  if constexpr (sizeof(T) == 4 && W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (sizeof(T) == 4 && W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else if constexpr (sizeof(T) == 8 && W == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    static_assert(W == 1, "a chunk of at most 16 bytes");
    p[0] = v[0];
  }
}

// W consecutive elements (complex: interleaved planes, up to 32 bytes) with
// vector accesses of 16 bytes
template <int W, class T>
__device__ __forceinline__ void ld_span(const T* p, T* v) {
  constexpr int V = 16 / (int)sizeof(T);
  if constexpr (W > V) {
    ld_vec<V>(p, v);
    ld_span<W - V>(p + V, v + V);
  } else {
    ld_vec<W>(p, v);
  }
}

template <int W, class T>
__device__ __forceinline__ void st_span(T* p, const T* v) {
  constexpr int V = 16 / (int)sizeof(T);
  if constexpr (W > V) {
    st_vec<V>(p, v);
    st_span<W - V>(p + V, v + V);
  } else {
    st_vec<W>(p, v);
  }
}

// A thread's elements of G: plane v (complex: 0 real, 1 imaginary) of
// flavor f at tile position (k, j); planes q = f*NV + v < QR in registers.
template <int NV, int F, int QR, class Gm>
struct Tile {
  using T = typename Gm::T;
  T r[QR][Gm::RT][Gm::CT];
  T* s;  // the thread's first private element of planes QR..F*NV-1
  __device__ __forceinline__ T& at(int f, int v, int k, int j) {
    const int q = f * NV + v;
    if (q < QR) return r[q][k][j];
    return s[(((q - QR) * Gm::RT + k) * Gm::CT + j) * Gm::NT];
  }
};

// One buffer of the staging double buffer: row n of plane v and flavor f
// at row(v, f, s), column n at col(v, f, s), NP elements each, for each of
// S sites s (K5: 0 site i, 1 site j).
template <class T, int NV, int F, int NP, int S = 1>
struct Stage {
  static constexpr int SIZE = 2 * S * NV * F * NP;  // elements
  T* vec;
  __device__ __forceinline__ T* row(int v, int f, int s = 0) const {
    return vec + (2 * (s * NV + v) * F + f) * NP;
  }
  __device__ __forceinline__ T* col(int v, int f, int s = 0) const {
    return vec + ((2 * (s * NV + v) + 1) * F + f) * NP;
  }
};

// The owners of row n and column n of every flavor write them into site
// s of the staging buffer st. A thread finds whether it owns row n from its
// ty alone (column n: its tx), and which of its rows that is by unrolled
// compare-and-select.
template <int NV, int F, int QR, class Gm, class St>
__device__ __forceinline__ void publish(Tile<NV, F, QR, Gm>& g, const St& st,
                                        int n, int ty, int tx, int s = 0) {
  using T = typename Gm::T;
  constexpr int RT = Gm::RT, CT = Gm::CT;
  constexpr int WR = Gm::WR, WC = Gm::WC;
  constexpr int SR = Gm::TR * WR, SC = Gm::TC * WC;  // rows, columns a chunk
  // row n: tile row kn of the threads with ty = (n % SR) / WR
  if ((n % SR) / WR == ty) {
    const int kn = n / SR * WR + n % WR;
#pragma unroll
    for (int k = 0; k < RT; ++k)
      if (k == kn) {
#pragma unroll
        for (int f = 0; f < F; ++f)
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int j0 = 0; j0 < CT; j0 += WC) {
              T t[WC];
#pragma unroll
              for (int w = 0; w < WC; ++w) t[w] = g.at(f, v, k, j0 + w);
              st_vec<WC>(st.row(v, f, s) + Gm::col(tx, j0), t);
            }
      }
  }
  // column n: tile column jn of the threads with tx = (n % SC) / WC
  if ((n % SC) / WC == tx) {
    const int jn = n / SC * WC + n % WC;
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (j == jn) {
#pragma unroll
        for (int f = 0; f < F; ++f)
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int k0 = 0; k0 < RT; k0 += WR) {
              T t[WR];
#pragma unroll
              for (int w = 0; w < WR; ++w) t[w] = g.at(f, v, k0 + w, j);
              st_vec<WR>(st.col(v, f, s) + Gm::row(ty, k0), t);
            }
      }
  }
}

// The thread's tiles of G (F x N x N at G_in, NV interleaved planes) into
// g, padded rows and columns 0; whole: N keeps every chunk whole and
// aligned, so chunks move with vector loads
template <int NV, int F, int QR, class Gm>
__device__ __forceinline__ void load_tile(Tile<NV, F, QR, Gm>& g,
                                          const typename Gm::T* __restrict__
                                              G_in,
                                          int N, bool whole, int ty, int tx) {
  using T = typename Gm::T;
  constexpr int RT = Gm::RT, CT = Gm::CT, WC = Gm::WC;
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int j0 = 0; j0 < CT; j0 += WC) {
        const int a = Gm::row(ty, k), b = Gm::col(tx, j0);
        T t[NV * WC];
        if (a < N && b < N && whole) {
          ld_span<NV * WC>(G_in + NV * ((size_t)(f * N + a) * N + b), t);
        } else {
#pragma unroll
          for (int w = 0; w < WC; ++w)
#pragma unroll
            for (int v = 0; v < NV; ++v)
              t[NV * w + v] =
                  a < N && b + w < N
                      ? G_in[NV * ((size_t)(f * N + a) * N + b + w) + v]
                      : T(0);
        }
#pragma unroll
        for (int w = 0; w < WC; ++w)
#pragma unroll
          for (int v = 0; v < NV; ++v) g.at(f, v, k, j0 + w) = t[NV * w + v];
      }
}

// The thread's tiles of g out to G_out, padded rows and columns left out
template <int NV, int F, int QR, class Gm>
__device__ __forceinline__ void store_tile(Tile<NV, F, QR, Gm>& g,
                                           typename Gm::T* __restrict__ G_out,
                                           int N, bool whole, int ty, int tx) {
  using T = typename Gm::T;
  constexpr int RT = Gm::RT, CT = Gm::CT, WC = Gm::WC;
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int j0 = 0; j0 < CT; j0 += WC) {
        const int a = Gm::row(ty, k), b = Gm::col(tx, j0);
        T t[NV * WC];
#pragma unroll
        for (int w = 0; w < WC; ++w)
#pragma unroll
          for (int v = 0; v < NV; ++v) t[NV * w + v] = g.at(f, v, k, j0 + w);
        if (a < N && b < N && whole) {
          st_span<NV * WC>(G_out + NV * ((size_t)(f * N + a) * N + b), t);
        } else if (a < N) {
#pragma unroll
          for (int w = 0; w < WC; ++w)
#pragma unroll
            for (int v = 0; v < NV; ++v)
              if (b + w < N)
                G_out[NV * ((size_t)(f * N + a) * N + b + w) + v] =
                    t[NV * w + v];
        }
      }
}

// The Metropolis decision of a site from the flavors' current diagonal
// entries g[f][v] (v: planes), in the plain versions' operations.
template <bool CX, int F, class T = float>
struct Decision {
  static constexpr int NV = CX ? 2 : 1;
  T dp[F], dm[F], wp, wm;  // per field value: delta_f, boson weight

  // delta_f = exp(sign_f dEb) - 1 and exp(-dEb), dEb = -2 lamb sigma, for
  // sigma = +1 (p) and -1 (m), as the plain versions compute them per site:
  // sign_f dEb is +-2 lamb exactly, so each value is the plain version's
  __device__ __forceinline__ Decision(T lamb, T sign0, T sign1,
                                      int use_boson) {
    const T one = 1;
    const T neg2lamb = mul_rn(T(-2), lamb);
    const T ep = mul_rn(neg2lamb, one), em = mul_rn(neg2lamb, -one);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const T sg = f == 0 ? sign0 : sign1;
      dp[f] = sub_rn(exp_(mul_rn(sg, ep)), one);
      dm[f] = sub_rn(exp_(mul_rn(sg, em)), one);
    }
    wp = use_boson ? exp_(-ep) : one;
    wm = use_boson ? exp_(-em) : one;
  }

  // accept; sets x (x_f; complex: its real and imaginary parts) and the
  // detratio (complex: its real and imaginary parts)
  __device__ __forceinline__ bool operator()(const T (&g)[F][NV], int8_t s8,
                                             T u_i, int det_power,
                                             T (&x)[F][NV],
                                             T (&det)[NV]) const {
    const T one = 1;
    const bool up = s8 > 0;
    if constexpr (CX) {
      T rr[F], ri[F], pr = 0, pi = 0;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const T d = up ? dp[f] : dm[f];
        rr[f] = add_rn(one, mul_rn(d, sub_rn(one, g[f][0])));
        ri[f] = -mul_rn(d, g[f][1]);
        if (f == 0) {
          pr = rr[0];
          pi = ri[0];
        } else {
          const T npr = sub_rn(mul_rn(pr, rr[f]), mul_rn(pi, ri[f]));
          const T npi = add_rn(mul_rn(pr, ri[f]), mul_rn(pi, rr[f]));
          pr = npr;
          pi = npi;
        }
      }
      det[0] = pr;
      det[1] = pi;
      if (det_power == 2) {
        det[0] = sub_rn(mul_rn(pr, pr), mul_rn(pi, pi));
        det[1] = mul_rn(mul_rn(T(2), pr), pi);
      }
      // x = delta conj(r) / |r|^2
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const T d = up ? dp[f] : dm[f];
        const T inv = div_rn(
            one, add_rn(mul_rn(rr[f], rr[f]), mul_rn(ri[f], ri[f])));
        x[f][0] = mul_rn(mul_rn(d, rr[f]), inv);
        x[f][1] = -mul_rn(mul_rn(d, ri[f]), inv);
      }
      return u_i < mul_rn(up ? wp : wm, det[0]);
    } else {
      T rprod = one;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const T d = up ? dp[f] : dm[f];
        const T r = add_rn(one, mul_rn(d, sub_rn(one, g[f][0])));
        rprod = f == 0 ? r : mul_rn(rprod, r);
        x[f][0] = div_rn(d, r);  // x = delta / r
      }
      if (det_power == 2) {
        det[0] = mul_rn(rprod, rprod);
      } else {
        det[0] = rprod;
        for (int k = 1; k < det_power; ++k) det[0] = mul_rn(det[0], rprod);
      }
      return u_i < mul_rn(up ? wp : wm, det[0]);
    }
  }
};

// G_f[n, n] (every plane) of the thread that owns it into dst[0..NV-1]
template <int NV, int F, int QR, class Gm>
__device__ __forceinline__ void publish_diag(Tile<NV, F, QR, Gm>& g,
                                             typename Gm::T* dst, int n,
                                             int ty, int tx, int f = 0) {
  constexpr int WR = Gm::WR, WC = Gm::WC;
  constexpr int SR = Gm::TR * WR, SC = Gm::TC * WC;
  if ((n % SR) / WR != ty || (n % SC) / WC != tx) return;
  const int kn = n / SR * WR + n % WR, jn = n / SC * WC + n % WC;
#pragma unroll
  for (int k = 0; k < Gm::RT; ++k)
    if (k == kn) {
#pragma unroll
      for (int j = 0; j < Gm::CT; ++j)
        if (j == jn) {
#pragma unroll
          for (int v = 0; v < NV; ++v) dst[v] = g.at(f, v, k, j);
        }
    }
}

// Every flavor of the chain in one block (K1, K8, K13): the site's barrier
// is the block's, and every block writes its chain's results.
struct Solo {
  static constexpr bool kPair = false;
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ bool writer() const { return true; }
};

// No wrap around the site loop (K1, K8). A wrap's before(g, sigma, clk)
// runs on the tiles of G after the load, with sigma_in in shared memory (no
// barrier yet after its writes), and after(g, sigma, clk) after the site
// loop with the updated sigma; each is called by every thread.
struct NoWrap {
  template <class TileT>
  __device__ __forceinline__ void before(TileT&, const int8_t*,
                                         phase_clock::Clock&) const {}
  template <class TileT>
  __device__ __forceinline__ void after(TileT&, const int8_t*,
                                        phase_clock::Clock&) const {}
};

// The site loop of one chain, run by a block of Gm::NT threads. G_in and
// G_out point at the chain's F x N x N elements of Gm::T (complex64 as
// interleaved (re, im) float pairs), sigma_in, sigma_out and u at its N
// entries. Real (K1): acc_out and nneg_out at its counts of accepted and
// negative-detratio proposals; given neg_out (K1 in float64), thread 0
// also folds log10(max(|det|, 1e-38)) of the negative detratios, in site
// order, into their min, max and sum at neg_out[0..2], as the JAX package's
// XLA loop does (_push_mag). Complex (K8): accept_out and det_out at its N
// accept flags and complex detratios. QR planes of G in registers
// (planes_in_registers). Thread 0 laps clk: 0 load, 1 decision, 2 update,
// 3 publish, 4 barrier, 5 store (a wrap: 6 and 7). wrap (K13) runs before
// or after the loop. xch: Solo, or a flavor pair (kPair: F = 1 here, the
// block's flavor xch.rank of the two, xch.start() and sync() cluster-wide,
// the peer's G_f[n, n] at xch.local[(n & 1) * NV ...] after the barrier
// that follows its publish into xch.remote; only xch.writer() writes
// sigma_out, accept_out and det_out).
template <bool CX, int F, int QR, class Gm, class Wrap = NoWrap,
          class Xch = Solo>
__device__ __forceinline__ void sweep_chain(
    typename Gm::T* smem, const typename Gm::T* __restrict__ G_in,
    typename Gm::T* __restrict__ G_out, const int8_t* __restrict__ sigma_in,
    int8_t* __restrict__ sigma_out, const typename Gm::T* __restrict__ u,
    int* __restrict__ acc_out, int* __restrict__ nneg_out,
    uint8_t* __restrict__ accept_out, typename Gm::T* __restrict__ det_out,
    typename Gm::T* __restrict__ neg_out, int N, typename Gm::T lamb,
    typename Gm::T sign0, typename Gm::T sign1, int det_power,
    int use_boson, phase_clock::Clock& clk, const Wrap& wrap = Wrap{},
    const Xch& xch = Xch{}) {
  using T = typename Gm::T;
  constexpr int NV = CX ? 2 : 1;
  constexpr int NP = Gm::NP, NT = Gm::NT, RT = Gm::RT, CT = Gm::CT;
  constexpr int WR = Gm::WR, WC = Gm::WC;
  using St = Stage<T, NV, F, NP>;
  static_assert(QR >= 1 && QR <= F * NV, "layout");
  static_assert(!Xch::kPair || F == 1, "a flavor pair: one flavor a block");
  // the flavors of the decision
  constexpr int FD = Xch::kPair ? 2 : F;
  // flavors whose planes all live in registers
  constexpr int FR = QR / NV;
  const int tid = threadIdx.x, ty = tid / Gm::TC, tx = tid % Gm::TC;
  T* u_s = smem + 2 * St::SIZE;
  T* det_s = u_s + NP;  // complex: (re, im) per site
  T* priv = det_s + (CX ? 2 * NP : 0);
  int8_t* sig_s = reinterpret_cast<int8_t*>(priv + (F * NV - QR) * NP * NP);
  int8_t* sig_o = sig_s + NP;
  uint8_t* acc_s = reinterpret_cast<uint8_t*>(sig_o + NP);
  auto stage = [&](int i) { return St{smem + (i & 1) * St::SIZE}; };
  // chunks of G move with vector accesses where N keeps them whole and
  // aligned
  const bool whole = N % WC == 0 && (uintptr_t)G_in % 16 == 0 &&
                     (uintptr_t)G_out % 16 == 0;

  if (tid == 0) clk.start();
  Tile<NV, F, QR, Gm> g;
  g.s = priv + tid;
  load_tile(g, G_in, N, whole, ty, tx);
  for (int a = tid; a < N; a += NT) {
    sig_s[a] = sigma_in[a];
    u_s[a] = u[a];
  }
  wrap.before(g, sig_s, clk);
  if constexpr (Xch::kPair) {
    xch.start();  // the peer block runs before its shared memory is written
    publish_diag(g, xch.remote, 0, ty, tx);
  }
  publish(g, stage(0), 0, ty, tx);
  const Decision<CX, FD, T> decide(lamb, sign0, sign1, use_boson);
  int acc = 0, nneg = 0;  // thread 0's counts
  // thread 0's negative-detratio magnitudes (neg_out): min, max, sum
  T neg_min = T(INFINITY), neg_max = T(-INFINITY), neg_sum = T(0);
  if (tid == 0) clk.lap(0);
  xch.sync();
  if (tid == 0) clk.lap(4);

  for (int i = 0; i < N; ++i) {
    const St sb = stage(i);
    // the staged column at the thread's rows and row at its columns: read
    // before the decision, which they do not depend on, for the flavors in
    // registers; in the update for the others, which have no registers to
    // spare
    T cv[F][NV][RT], rv[F][NV][CT];
    auto load_staged = [&](int f) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int k0 = 0; k0 < RT; k0 += WR)
          ld_vec<WR>(sb.col(v, f) + Gm::row(ty, k0), &cv[f][v][k0]);
#pragma unroll
        for (int j0 = 0; j0 < CT; j0 += WC)
          ld_vec<WC>(sb.row(v, f) + Gm::col(tx, j0), &rv[f][v][j0]);
      }
    };
#pragma unroll
    for (int f = 0; f < FR; ++f) load_staged(f);
    // site i from G_f[i, i] in the staged row (a flavor pair: the own
    // flavor's, and the peer's from xch.local): the same decision in every
    // thread
    T gii[FD][NV], xd[FD][NV], det[NV], x[F][NV];
    if constexpr (Xch::kPair) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T own = sb.row(v, 0)[i], peer = xch.local[(i & 1) * NV + v];
        gii[0][v] = xch.rank == 0 ? own : peer;
        gii[1][v] = xch.rank == 0 ? peer : own;
      }
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f)
#pragma unroll
        for (int v = 0; v < NV; ++v) gii[f][v] = sb.row(v, f)[i];
    }
    const int8_t s8 = sig_s[i];
    const bool accept = decide(gii, s8, u_s[i], det_power, xd, det);
    // x of the block's own flavors
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if constexpr (Xch::kPair)
          x[f][v] = xch.rank == 0 ? xd[0][v] : xd[FD - 1][v];
        else
          x[f][v] = xd[f][v];
      }
    if (tid == 0) {
      sig_o[i] = accept ? (int8_t)(-s8) : s8;
      if constexpr (CX) {
        acc_s[i] = accept;
        det_s[2 * i] = det[0];
        det_s[2 * i + 1] = det[1];
      } else {
        acc += accept;
        nneg += det[0] < T(0);
        if (neg_out != nullptr && det[0] < T(0)) {
          const T lv = log10_(fmax(fabs(det[0]), T(1e-38)));
          neg_min = fmin(neg_min, lv);
          neg_max = fmax(neg_max, lv);
          neg_sum = add_rn(neg_sum, lv);
        }
      }
      clk.lap(1);
    }

    if (accept) {  // block-uniform: every thread decided the same
      const T one = 1, zero = 0;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (f >= FR) load_staged(f);
        if constexpr (CX) {
          // y = x (e_i - G[:, i]) at the rows
          const T xr = x[f][0], xi = x[f][1];
          T yr[RT], yi[RT];
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            const T igr = sub_rn(Gm::row(ty, k) == i ? one : zero,
                                 cv[f][0][k]);
            const T igi = -cv[f][1][k];
            yr[k] = sub_rn(mul_rn(xr, igr), mul_rn(xi, igi));
            yi[k] = add_rn(mul_rn(xr, igi), mul_rn(xi, igr));
          }
#pragma unroll
          for (int k = 0; k < RT; ++k)
#pragma unroll
            for (int j = 0; j < CT; ++j) {
              const T br = rv[f][0][j], bi = rv[f][1][j];
              T& gr = g.at(f, 0, k, j);
              T& gi = g.at(f, 1, k, j);
              gr = sub_rn(gr, sub_rn(mul_rn(yr[k], br), mul_rn(yi[k], bi)));
              gi = sub_rn(gi, add_rn(mul_rn(yr[k], bi), mul_rn(yi[k], br)));
            }
        } else {
          T y[RT];
#pragma unroll
          for (int k = 0; k < RT; ++k)
            y[k] = mul_rn(x[f][0], sub_rn(Gm::row(ty, k) == i ? one : zero,
                                          cv[f][0][k]));
#pragma unroll
          for (int k = 0; k < RT; ++k)
#pragma unroll
            for (int j = 0; j < CT; ++j) {
              T& e = g.at(f, 0, k, j);
              e = sub_rn(e, mul_rn(y[k], rv[f][0][j]));
            }
        }
      }
    }
    if (tid == 0) clk.lap(2);
    if (i + 1 < N) {
      publish(g, stage(i + 1), i + 1, ty, tx);
      if constexpr (Xch::kPair)
        publish_diag(g, xch.remote + ((i + 1) & 1) * NV, i + 1, ty, tx);
    }
    if (tid == 0) clk.lap(3);
    xch.sync();
    if (tid == 0) clk.lap(4);
  }
  wrap.after(g, sig_o, clk);

  store_tile(g, G_out, N, whole, ty, tx);
  for (int a = tid; a < N && xch.writer(); a += NT) {
    sigma_out[a] = sig_o[a];
    if constexpr (CX) {
      accept_out[a] = acc_s[a];
      det_out[2 * a] = det_s[2 * a];
      det_out[2 * a + 1] = det_s[2 * a + 1];
    }
  }
  if constexpr (!CX) {
    if (tid == 0) {
      *acc_out = acc;
      *nneg_out = nneg;
      if (neg_out != nullptr) {
        neg_out[0] = neg_min;
        neg_out[1] = neg_max;
        neg_out[2] = neg_sum;
      }
    }
  }
  if (tid == 0) clk.lap(5);
}

// K5's loop: the real site loop of one chain (every flavor in registers),
// two sites (i, j = i+1) per round and one block barrier per pair; even N.
// Arguments and laps as sweep_chain's (no neg_out). Per pair, in the plain
// version's operations (ops/site_sweep.py::site_sweep_pair_plain): site i
// from G[i,i]; site j from G[j,j] - xIG_i[j] G[i,j], xIG_i[j] =
// x_i (0 - G[j,i]); then row'_j = row_j - xIG_i[j] row_i and col'_j =
// col_j - xIG_i G[i,j] at the thread's columns and rows (where site i was
// accepted), and G <- (G - xIG_i (x) row_i) - xIG_j (x) row'_j.
template <int F, class Gm>
__device__ __forceinline__ void sweep_chain_pair(
    typename Gm::T* smem, const typename Gm::T* __restrict__ G_in,
    typename Gm::T* __restrict__ G_out, const int8_t* __restrict__ sigma_in,
    int8_t* __restrict__ sigma_out, const typename Gm::T* __restrict__ u,
    int* __restrict__ acc_out, int* __restrict__ nneg_out, int N,
    typename Gm::T lamb, typename Gm::T sign0, typename Gm::T sign1,
    int det_power, int use_boson, phase_clock::Clock& clk) {
  using T = typename Gm::T;
  constexpr int NP = Gm::NP, NT = Gm::NT, RT = Gm::RT, CT = Gm::CT;
  constexpr int WR = Gm::WR, WC = Gm::WC;
  using St = Stage<T, 1, F, NP, 2>;
  // the staged vectors of every flavor read before the decisions where
  // they fit beside G (not at F = 2, NP = 128: 64 more registers beside
  // G's 128); else each flavor's in its update
  constexpr bool kEarly = 2 * F * (RT + CT) <= 32;
  const int tid = threadIdx.x, ty = tid / Gm::TC, tx = tid % Gm::TC;
  T* u_s = smem + 2 * St::SIZE;
  int8_t* sig_s = reinterpret_cast<int8_t*>(u_s + NP);
  int8_t* sig_o = sig_s + NP;
  auto stage = [&](int p) { return St{smem + (p & 1) * St::SIZE}; };
  const bool whole = N % WC == 0 && (uintptr_t)G_in % 16 == 0 &&
                     (uintptr_t)G_out % 16 == 0;

  if (tid == 0) clk.start();
  Tile<1, F, F, Gm> g;
  g.s = nullptr;  // no flavor in shared memory
  load_tile(g, G_in, N, whole, ty, tx);
  for (int a = tid; a < N; a += NT) {
    sig_s[a] = sigma_in[a];
    u_s[a] = u[a];
  }
  publish(g, stage(0), 0, ty, tx, 0);
  publish(g, stage(0), 1, ty, tx, 1);
  const Decision<false, F, T> decide(lamb, sign0, sign1, use_boson);
  int acc = 0, nneg = 0;  // thread 0's counts
  if (tid == 0) clk.lap(0);
  __syncthreads();
  if (tid == 0) clk.lap(4);

  for (int i = 0; i < N; i += 2) {
    const int j = i + 1;
    const St sb = stage(i >> 1);
    // columns i, j at the thread's rows, rows i, j at its columns
    T cvi[F][RT], cvj[F][RT], rvi[F][CT], rvj[F][CT];
    auto load_staged = [&](int f) {
#pragma unroll
      for (int k0 = 0; k0 < RT; k0 += WR) {
        ld_vec<WR>(sb.col(0, f, 0) + Gm::row(ty, k0), &cvi[f][k0]);
        ld_vec<WR>(sb.col(0, f, 1) + Gm::row(ty, k0), &cvj[f][k0]);
      }
#pragma unroll
      for (int j0 = 0; j0 < CT; j0 += WC) {
        ld_vec<WC>(sb.row(0, f, 0) + Gm::col(tx, j0), &rvi[f][j0]);
        ld_vec<WC>(sb.row(0, f, 1) + Gm::col(tx, j0), &rvj[f][j0]);
      }
    };
    if constexpr (kEarly) {
#pragma unroll
      for (int f = 0; f < F; ++f) load_staged(f);
    }
    // both decisions from four staged scalars per flavor, the same in every
    // thread: cj = xIG_i[j], ri = G[i, j]
    T gd[F][1], xi[F][1], xj[F][1], det_i[1], det_j[1], cj[F], ri[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gd[f][0] = sb.row(0, f, 0)[i];
    const int8_t si = sig_s[i], sj = sig_s[j];
    const bool acc_i = decide(gd, si, u_s[i], det_power, xi, det_i);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      cj[f] = mul_rn(xi[f][0], sub_rn(T(0), sb.col(0, f, 0)[j]));
      ri[f] = sb.row(0, f, 0)[j];
      const T gjj = sb.row(0, f, 1)[j];
      gd[f][0] = acc_i ? sub_rn(gjj, mul_rn(cj[f], ri[f])) : gjj;
    }
    const bool acc_j = decide(gd, sj, u_s[j], det_power, xj, det_j);
    if (tid == 0) {
      sig_o[i] = acc_i ? (int8_t)(-si) : si;
      sig_o[j] = acc_j ? (int8_t)(-sj) : sj;
      acc += acc_i + acc_j;
      nneg += (det_i[0] < T(0)) + (det_j[0] < T(0));
      clk.lap(1);
    }

    // both rank-1 terms in one pass over the tile, AI and AJ: whether
    // sites i and j were accepted (block-uniform)
    auto update = [&](auto ai, auto aj) {
      constexpr bool AI = decltype(ai)::value, AJ = decltype(aj)::value;
      const T one = 1, zero = 0;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if constexpr (!kEarly) {
          // keeps the next flavor's loads below this one's update
          if (f > 0) __syncwarp();
          load_staged(f);
        }
        // yi = xIG_i, yj = xIG_j at the thread's rows, rj = row'_j at its
        // columns
        T yi[RT], yj[RT], rj[CT];
#pragma unroll
        for (int k = 0; k < RT; ++k)
          yi[k] = mul_rn(xi[f][0], sub_rn(Gm::row(ty, k) == i ? one : zero,
                                          cvi[f][k]));
        if constexpr (AJ) {
#pragma unroll
          for (int c = 0; c < CT; ++c)
            rj[c] = AI ? sub_rn(rvj[f][c], mul_rn(cj[f], rvi[f][c]))
                       : rvj[f][c];
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            const T colj =
                AI ? sub_rn(cvj[f][k], mul_rn(yi[k], ri[f])) : cvj[f][k];
            yj[k] = mul_rn(xj[f][0],
                           sub_rn(Gm::row(ty, k) == j ? one : zero, colj));
          }
        }
#pragma unroll
        for (int k = 0; k < RT; ++k)
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            T& e = g.at(f, 0, k, c);
            if constexpr (AI) e = sub_rn(e, mul_rn(yi[k], rvi[f][c]));
            if constexpr (AJ) e = sub_rn(e, mul_rn(yj[k], rj[c]));
          }
      }
    };
    if (acc_i && acc_j)
      update(std::true_type{}, std::true_type{});
    else if (acc_i)
      update(std::true_type{}, std::false_type{});
    else if (acc_j)
      update(std::false_type{}, std::true_type{});
    if (tid == 0) clk.lap(2);
    if (i + 2 < N) {
      publish(g, stage((i >> 1) + 1), i + 2, ty, tx, 0);
      publish(g, stage((i >> 1) + 1), i + 3, ty, tx, 1);
    }
    if (tid == 0) clk.lap(3);
    __syncthreads();
    if (tid == 0) clk.lap(4);
  }

  store_tile(g, G_out, N, whole, ty, tx);
  for (int a = tid; a < N; a += NT) sigma_out[a] = sig_o[a];
  if (tid == 0) {
    *acc_out = acc;
    *nneg_out = nneg;
  }
  if (tid == 0) clk.lap(5);
}

}  // namespace tiled
