// The one-block-per-chain Metropolis site loop of K1 (float32,
// site_sweep.cu), K8 (complex64, site_sweep_cx.cu) and K13 (K1 with the
// slice's wrap fused in, site_sweep_wrap.cu), with G of the chain spread
// over the block's registers.
//
// Layout. The block's NT = TR x TC threads cover G_f (N x N, padded to
// NP x NP, NP = TR*RT = TC*CT) in tiles: thread (ty, tx) = (tid / TC,
// tid % TC) owns the RT rows row(ty, k) and the CT columns col(tx, j), in
// chunks of up to 4 consecutive indices (float4 reads and writes of the
// staged vectors without bank conflicts, vector loads and stores of G).
// Its RT x CT elements of each flavor f < FR live in registers; the flavors
// FR..F-1 (the complex F = 2 layout past NP = 64, whose G does not fit a
// register file) live in shared memory private to the thread, element e at
// priv[e*NT + tid], so consecutive threads touch consecutive words. Padded
// rows and columns start at 0 and are never written back.
//
// One block barrier per site. Only row i and column i of every flavor go
// through shared memory, staged in a double buffer: the owners of row i+1
// and column i+1 publish them into the other buffer right after their own
// update of site i (after no update, when site i was rejected: G did not
// change), and one barrier later every thread takes site i+1's decision
// from the staged row, which holds G_f[i+1, i+1], and reads the staged
// values of its own rows and columns for the update. Buffer i&1 is read at
// site i while buffer (i+1)&1 is written; the barrier at the end of site i
// keeps site i+1's writers off buffer i&1 until every thread has read it.
// The decision stays block-uniform: every thread computes it from the same
// staged values, in the same operations, so no flag is broadcast. sigma and
// u are read once into shared memory, and what the loop records per site
// (the flipped sigma; complex: the accept flag and det) goes to shared
// memory and out after the loop: nothing leaves the SM inside it. exp of
// the two field values' weights is taken once per launch.
//
// Rounding. Every operation is a separately rounded __f*_rn intrinsic, in
// the order of the plain PyTorch versions (ops/site_sweep.py::
// site_sweep_plain, ops/site_sweep_cx.py::site_sweep_cx_plain), which nvcc
// never contracts into an FMA: the kernels are bit-equal to them.
//
// Register arrays are indexed only with compile-time indices (the tile
// loops are unrolled; the owner of row or column i+1 is found by unrolled
// compare-and-select), so they stay in registers.
//
// A wrap (K13) gets the thread tiles of G before the loop and after it,
// with sigma in and out in shared memory: sweep_chain's Wrap argument.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase_clock.cuh"

namespace tiled {

// A block of TR x TC threads, each owning RT rows and CT columns of the
// NP x NP padded G (NP = TR*RT = TC*CT).
template <int TR_, int TC_, int RT_, int CT_>
struct Geom {
  static constexpr int TR = TR_, TC = TC_, RT = RT_, CT = CT_;
  static constexpr int NT = TR * TC, NP = TR * RT;
  // chunk widths: consecutive indices a thread owns
  static constexpr int WR = RT < 4 ? RT : 4, WC = CT < 4 ? CT : 4;
  static_assert(TC * CT == NP && RT % WR == 0 && CT % WC == 0,
                "a square padded G in whole chunks");
  __device__ static __forceinline__ int row(int ty, int k) {
    return (k / WR) * (TR * WR) + ty * WR + k % WR;
  }
  __device__ static __forceinline__ int col(int tx, int j) {
    return (j / WC) * (TC * WC) + tx * WC + j % WC;
  }
};

// Calls fn(Gm{}) with the layout of N: a block of 256 threads (16 x 16)
// per chain, each thread a tile of (NP/16) x (NP/16) elements of G padded
// to NP = 32, 64 or 128 (ops/site_sweep.py::padded). 256 threads per chain
// was the fastest of 128 to 1024 at every shape timed (PERF.md).
template <class Fn>
int with_layout(int N, Fn&& fn) {
  if (N <= 32) return fn(Geom<16, 16, 2, 2>{});
  if (N <= 64) return fn(Geom<16, 16, 4, 4>{});
  return fn(Geom<16, 16, 8, 8>{});
}

// Flavors in registers: all but one for complex F = 2 past NP = 64, whose
// G (256 KB at NP = 128) does not fit a register file
template <bool CX, int F, int NP>
__host__ __device__ constexpr int flavors_in_registers() {
  return CX && F == 2 && NP > 64 ? 1 : F;
}

// Shared memory of one block, in bytes: the staging double buffer (row and
// column of every flavor and plane), u, the complex det per site, the
// thread-private flavors FR..F-1, and sigma in and out (complex: the accept
// flags). ops/site_sweep.py::tiled_smem_bytes mirrors it.
template <bool CX, int F, int FR, int NP>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int NV = CX ? 2 : 1;
  return 4 * (2 * 2 * NV * F * NP + NP + (CX ? 2 * NP : 0) +
              (F - FR) * NV * NP * NP) +
         NP * (CX ? 3 : 2);
}

template <int W>
__device__ __forceinline__ void ld_vec(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int W>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// W consecutive floats (W = 1, 2, 4 or 8) with vector accesses
template <int W>
__device__ __forceinline__ void ld_span(const float* p, float* v) {
  if constexpr (W == 8) {
    ld_vec<4>(p, v);
    ld_vec<4>(p + 4, v + 4);
  } else {
    ld_vec<W>(p, v);
  }
}

template <int W>
__device__ __forceinline__ void st_span(float* p, const float* v) {
  if constexpr (W == 8) {
    st_vec<4>(p, v);
    st_vec<4>(p + 4, v + 4);
  } else {
    st_vec<W>(p, v);
  }
}

// A thread's elements of G: plane v (complex: 0 real, 1 imaginary) of
// flavor f at tile position (k, j).
template <int NV, int F, int FR, class Gm>
struct Tile {
  float r[FR][NV][Gm::RT][Gm::CT];
  float* s;  // the thread's first private element of flavors FR..F-1
  __device__ __forceinline__ float& at(int f, int v, int k, int j) {
    if (f < FR) return r[f][v][k][j];
    return s[((((f - FR) * NV + v) * Gm::RT + k) * Gm::CT + j) * Gm::NT];
  }
};

// One buffer of the staging double buffer: row i of plane v and flavor f
// at row(v, f), column i at col(v, f), NP floats each.
template <int NV, int F, int NP>
struct Stage {
  static constexpr int FLOATS = 2 * NV * F * NP;
  float* vec;
  __device__ __forceinline__ float* row(int v, int f) const {
    return vec + (2 * v * F + f) * NP;
  }
  __device__ __forceinline__ float* col(int v, int f) const {
    return vec + ((2 * v + 1) * F + f) * NP;
  }
};

// The owners of row n and column n of every flavor write them into the
// staging buffer st. A thread finds whether it owns row n from its ty alone
// (column n: its tx), and which of its rows that is by unrolled
// compare-and-select.
template <int NV, int F, int FR, class Gm>
__device__ __forceinline__ void publish(Tile<NV, F, FR, Gm>& g,
                                        const Stage<NV, F, Gm::NP>& st, int n,
                                        int ty, int tx) {
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
              float t[WC];
#pragma unroll
              for (int w = 0; w < WC; ++w) t[w] = g.at(f, v, k, j0 + w);
              st_vec<WC>(st.row(v, f) + Gm::col(tx, j0), t);
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
              float t[WR];
#pragma unroll
              for (int w = 0; w < WR; ++w) t[w] = g.at(f, v, k0 + w, j);
              st_vec<WR>(st.col(v, f) + Gm::row(ty, k0), t);
            }
      }
  }
}

// The Metropolis decision of a site from the flavors' current diagonal
// entries g[f][v] (v: planes), in the plain versions' operations; K5
// (site_sweep.cu) takes its two sites' decisions from it too.
template <bool CX, int F>
struct Decision {
  static constexpr int NV = CX ? 2 : 1;
  float dp[F], dm[F], wp, wm;  // per field value: delta_f, boson weight

  // delta_f = exp(sign_f dEb) - 1 and exp(-dEb), dEb = -2 lamb sigma, for
  // sigma = +1 (p) and -1 (m), as the plain versions compute them
  __device__ __forceinline__ Decision(float lamb, float sign0, float sign1,
                                      int use_boson) {
    const float neg2lamb = __fmul_rn(-2.f, lamb);
    const float ep = __fmul_rn(neg2lamb, 1.f), em = __fmul_rn(neg2lamb, -1.f);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float sg = f == 0 ? sign0 : sign1;
      dp[f] = __fsub_rn(expf(__fmul_rn(sg, ep)), 1.f);
      dm[f] = __fsub_rn(expf(__fmul_rn(sg, em)), 1.f);
    }
    wp = use_boson ? expf(-ep) : 1.f;
    wm = use_boson ? expf(-em) : 1.f;
  }

  // accept; sets x (x_f; complex: its real and imaginary parts) and the
  // detratio (complex: its real and imaginary parts)
  __device__ __forceinline__ bool operator()(const float (&g)[F][NV],
                                             int8_t s8, float u_i,
                                             int det_power, float (&x)[F][NV],
                                             float (&det)[NV]) const {
    const bool up = s8 > 0;
    if constexpr (CX) {
      float rr[F], ri[F], pr = 0.f, pi = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float d = up ? dp[f] : dm[f];
        rr[f] = __fadd_rn(1.f, __fmul_rn(d, __fsub_rn(1.f, g[f][0])));
        ri[f] = -__fmul_rn(d, g[f][1]);
        if (f == 0) {
          pr = rr[0];
          pi = ri[0];
        } else {
          const float npr =
              __fsub_rn(__fmul_rn(pr, rr[f]), __fmul_rn(pi, ri[f]));
          const float npi =
              __fadd_rn(__fmul_rn(pr, ri[f]), __fmul_rn(pi, rr[f]));
          pr = npr;
          pi = npi;
        }
      }
      det[0] = pr;
      det[1] = pi;
      if (det_power == 2) {
        det[0] = __fsub_rn(__fmul_rn(pr, pr), __fmul_rn(pi, pi));
        det[1] = __fmul_rn(__fmul_rn(2.f, pr), pi);
      }
      // x = delta conj(r) / |r|^2
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float d = up ? dp[f] : dm[f];
        const float inv = __fdiv_rn(
            1.f, __fadd_rn(__fmul_rn(rr[f], rr[f]), __fmul_rn(ri[f], ri[f])));
        x[f][0] = __fmul_rn(__fmul_rn(d, rr[f]), inv);
        x[f][1] = -__fmul_rn(__fmul_rn(d, ri[f]), inv);
      }
      return u_i < __fmul_rn(up ? wp : wm, det[0]);
    } else {
      float rprod = 1.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float d = up ? dp[f] : dm[f];
        const float r = __fadd_rn(1.f, __fmul_rn(d, __fsub_rn(1.f, g[f][0])));
        rprod = f == 0 ? r : __fmul_rn(rprod, r);
        x[f][0] = __fdiv_rn(d, r);  // x = delta / r
      }
      if (det_power == 2) {
        det[0] = __fmul_rn(rprod, rprod);
      } else {
        det[0] = rprod;
        for (int k = 1; k < det_power; ++k) det[0] = __fmul_rn(det[0], rprod);
      }
      return u_i < __fmul_rn(up ? wp : wm, det[0]);
    }
  }
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
// G_out point at the chain's F x N x N elements (float32; complex64 as
// interleaved (re, im) pairs), sigma_in, sigma_out and u at its N entries.
// Real (K1): acc_out and nneg_out at its counts of accepted and
// negative-detratio proposals. Complex (K8): accept_out and det_out at its
// N accept flags and complex detratios. Thread 0 laps clk: 0 load,
// 1 decision, 2 update, 3 publish, 4 barrier, 5 store (a wrap: 6 and 7).
// wrap (K13) runs before or after the loop.
template <bool CX, int F, int FR, class Gm, class Wrap = NoWrap>
__device__ __forceinline__ void sweep_chain(
    float* smem, const float* __restrict__ G_in, float* __restrict__ G_out,
    const int8_t* __restrict__ sigma_in, int8_t* __restrict__ sigma_out,
    const float* __restrict__ u, int* __restrict__ acc_out,
    int* __restrict__ nneg_out, uint8_t* __restrict__ accept_out,
    float* __restrict__ det_out, int N, float lamb, float sign0, float sign1,
    int det_power, int use_boson, phase_clock::Clock& clk,
    const Wrap& wrap = Wrap{}) {
  constexpr int NV = CX ? 2 : 1;
  constexpr int NP = Gm::NP, NT = Gm::NT, RT = Gm::RT, CT = Gm::CT;
  constexpr int WR = Gm::WR, WC = Gm::WC;
  using St = Stage<NV, F, NP>;
  static_assert(FR >= 1 && FR <= F, "layout");
  const int tid = threadIdx.x, ty = tid / Gm::TC, tx = tid % Gm::TC;
  float* u_s = smem + 2 * St::FLOATS;
  float* det_s = u_s + NP;  // complex: (re, im) per site
  float* priv = det_s + (CX ? 2 * NP : 0);
  int8_t* sig_s = reinterpret_cast<int8_t*>(priv + (F - FR) * NV * NP * NP);
  int8_t* sig_o = sig_s + NP;
  uint8_t* acc_s = reinterpret_cast<uint8_t*>(sig_o + NP);
  auto stage = [&](int i) { return St{smem + (i & 1) * St::FLOATS}; };
  // chunks of G move with vector accesses where N keeps them whole and
  // aligned
  const bool whole = N % WC == 0 && (uintptr_t)G_in % 16 == 0 &&
                     (uintptr_t)G_out % 16 == 0;

  if (tid == 0) clk.start();
  Tile<NV, F, FR, Gm> g;
  g.s = priv + tid;
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int j0 = 0; j0 < CT; j0 += WC) {
        const int a = Gm::row(ty, k), b = Gm::col(tx, j0);
        float t[NV * WC];
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
                      : 0.f;
        }
#pragma unroll
        for (int w = 0; w < WC; ++w)
#pragma unroll
          for (int v = 0; v < NV; ++v) g.at(f, v, k, j0 + w) = t[NV * w + v];
      }
  for (int a = tid; a < N; a += NT) {
    sig_s[a] = sigma_in[a];
    u_s[a] = u[a];
  }
  wrap.before(g, sig_s, clk);
  publish<NV, F, FR, Gm>(g, stage(0), 0, ty, tx);
  const Decision<CX, F> decide(lamb, sign0, sign1, use_boson);
  int acc = 0, nneg = 0;  // thread 0's counts
  if (tid == 0) clk.lap(0);
  __syncthreads();
  if (tid == 0) clk.lap(4);

  for (int i = 0; i < N; ++i) {
    const St sb = stage(i);
    // the staged column at the thread's rows and row at its columns: read
    // before the decision, which they do not depend on, for the flavors in
    // registers; in the update for the others, which have no registers to
    // spare
    float cv[F][NV][RT], rv[F][NV][CT];
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
    // site i from G_f[i, i] in the staged row: the same decision in every
    // thread
    float gii[F][NV], x[F][NV], det[NV];
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int v = 0; v < NV; ++v) gii[f][v] = sb.row(v, f)[i];
    const int8_t s8 = sig_s[i];
    const bool accept = decide(gii, s8, u_s[i], det_power, x, det);
    if (tid == 0) {
      sig_o[i] = accept ? (int8_t)(-s8) : s8;
      if constexpr (CX) {
        acc_s[i] = accept;
        det_s[2 * i] = det[0];
        det_s[2 * i + 1] = det[1];
      } else {
        acc += accept;
        nneg += det[0] < 0.f;
      }
      clk.lap(1);
    }

    if (accept) {  // block-uniform: every thread decided the same
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (f >= FR) load_staged(f);
        if constexpr (CX) {
          // y = x (e_i - G[:, i]) at the rows
          const float xr = x[f][0], xi = x[f][1];
          float yr[RT], yi[RT];
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            const float igr =
                __fsub_rn(Gm::row(ty, k) == i ? 1.f : 0.f, cv[f][0][k]);
            const float igi = -cv[f][1][k];
            yr[k] = __fsub_rn(__fmul_rn(xr, igr), __fmul_rn(xi, igi));
            yi[k] = __fadd_rn(__fmul_rn(xr, igi), __fmul_rn(xi, igr));
          }
#pragma unroll
          for (int k = 0; k < RT; ++k)
#pragma unroll
            for (int j = 0; j < CT; ++j) {
              const float br = rv[f][0][j], bi = rv[f][1][j];
              float& gr = g.at(f, 0, k, j);
              float& gi = g.at(f, 1, k, j);
              gr = __fsub_rn(
                  gr, __fsub_rn(__fmul_rn(yr[k], br), __fmul_rn(yi[k], bi)));
              gi = __fsub_rn(
                  gi, __fadd_rn(__fmul_rn(yr[k], bi), __fmul_rn(yi[k], br)));
            }
        } else {
          float y[RT];
#pragma unroll
          for (int k = 0; k < RT; ++k)
            y[k] = __fmul_rn(x[f][0],
                             __fsub_rn(Gm::row(ty, k) == i ? 1.f : 0.f,
                                       cv[f][0][k]));
#pragma unroll
          for (int k = 0; k < RT; ++k)
#pragma unroll
            for (int j = 0; j < CT; ++j) {
              float& e = g.at(f, 0, k, j);
              e = __fsub_rn(e, __fmul_rn(y[k], rv[f][0][j]));
            }
        }
      }
    }
    if (tid == 0) clk.lap(2);
    if (i + 1 < N) publish<NV, F, FR, Gm>(g, stage(i + 1), i + 1, ty, tx);
    if (tid == 0) clk.lap(3);
    __syncthreads();
    if (tid == 0) clk.lap(4);
  }
  wrap.after(g, sig_o, clk);

#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int j0 = 0; j0 < CT; j0 += WC) {
        const int a = Gm::row(ty, k), b = Gm::col(tx, j0);
        float t[NV * WC];
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
  for (int a = tid; a < N; a += NT) {
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
    }
  }
  if (tid == 0) clk.lap(5);
}

}  // namespace tiled
