// The register-column Householder loop of K2, K3, K4 and K14
// (csrc/udt_qr.cu, whose header comment describes the layout, the barrier
// protocol and what bounds it) and of the A/B variants K15 and K16
// (csrc/qr_ab.cu). Everything here has internal linkage in each file that
// includes it.
//
// The loop takes KC reflectors per block barrier (K16: KC = 2 or 4; every
// other kernel KC = 1). The KC columns of a step lie in one warp and in one
// group of four rows (KC divides 4). The warp that owns the next KC columns
// builds their reflectors in turn, applying each to its own later columns
// of the panel before it builds the next, and publishes the panel into a
// double buffer of 2 KC reflectors; after the barrier every warp applies
// the panel's reflectors in order to its columns past the panel, and to
// Q^T. Each column thus sees the same operations in the same order as at
// KC = 1 (a column step that skips the row chunks above the panel, which
// hold zeros of v, adds exact zeros), so R and Q are bit-equal at every KC.
#pragma once

#include <cfloat>

#include <cuda_runtime.h>

#include "phase_clock.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kFloor = 0x1p-70f;

// UDT (K2), SOLVE (K3), QR (K4, K16), VTAU (K14, K15's reflector phase),
// NOQ (K15's R alone)
enum class Mode { UDT, SOLVE, QR, VTAU, NOQ };

// K2 and K3: floored diagonal, A in and Rs or X out through shared memory
__host__ __device__ constexpr bool fused(Mode md) {
  return md == Mode::UDT || md == Mode::SOLVE;
}

// the modes that accumulate Q^T
__host__ __device__ constexpr bool has_q(Mode md) {
  return md != Mode::VTAU && md != Mode::NOQ;
}

#ifdef MC_PHASE_STAMPS
// phases of K4 and K14 (csrc/udt_qr.cu copies them out)
__device__ long long g_stamps_hh[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

// Block geometry of one N: N / 8 warps of 8 column lanes x 4 row groups;
// NM chunks of 4 rows per lane, rows padded to NP. Blocks of up to 256
// threads (N <= 64) run two per SM, of 512 (N <= 128) one.
template <int N>
struct Geom {
  static constexpr int NW = N / 8, NT = 32 * NW;
  static constexpr int NP = (N + 15) / 16 * 16, NM = NP / 16, LD = N + 1;
  static constexpr int MAX_THREADS = NT <= 256 ? 256 : 512;
  static constexpr int MIN_BLOCKS = NT <= 256 ? 2 : 1;
  __device__ static __forceinline__ int row(int rg, int m, int e) {
    return 4 * (rg + 4 * m) + e;
  }
};

// A lane's column of A (becoming R; K14: R above the diagonal, v's tail
// below), of Q^T (not K14, K15) and (K3) of X; K14: v and tau at the
// diagonal
template <Mode MD, int N>
struct Regs {
  static constexpr int NM = Geom<N>::NM;
  static constexpr int MQ = has_q(MD) ? NM : 1;
  static constexpr int MX = MD == Mode::SOLVE ? NM : 1;
  float a[NM][4];
  float q[MQ][4];
  float x[MX][4];  // K3: the accumulators of X, then X
  float vd, tc;
};

// Shared memory of one block: the double-buffered panel of KC reflectors
// and (K3) X column, their tau, and K2's and K3's d, staging matrix (A in,
// Rs or X out) and K3's Z / mx.
template <Mode MD, int N, int KC = 1>
struct Smem {
  static constexpr int NP = Geom<N>::NP, LD = Geom<N>::LD;
  static constexpr bool F = fused(MD), S = MD == Mode::SOLVE;
  alignas(16) float v[2][KC][NP];
  alignas(16) float xcol[2][S ? NP : 4];
  float tau[2][KC];
  float d[F ? N : 1];
  float stage[F ? N * LD : 1];
  float zs[S ? N * LD : 1];
};

// The lane's rows of a vector in shared memory, as float4 chunks M0..NM-1
template <int NM, int M0 = 0>
__device__ __forceinline__ void ld_rows(const float* vec, int rg,
                                        float (&o)[NM][4]) {
#pragma unroll
  for (int m = M0; m < NM; ++m) {
    const float4 t = *reinterpret_cast<const float4*>(vec + 4 * (rg + 4 * m));
    o[m][0] = t.x, o[m][1] = t.y, o[m][2] = t.z, o[m][3] = t.w;
  }
}

// The lane's part of a column's dot with the staged rows, chunks M0..NM-1
template <int NM, int M0 = 0>
__device__ __forceinline__ float dot_rows(const float (&a)[NM][4],
                                          const float (&b)[NM][4]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int m = M0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] += a[m][e] * b[m][e];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Sum over the four row groups of a column (lanes cs + 8 rg)
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}

// Reflector of column jj from its tail below row jj, in the warp that owns
// it (every lane computes it for its own column; the four lanes of column
// jj keep it). an is the lane's entry at row jj, which lane cs + 8 rgj
// holds; the rows of chunks below M0 lie above jj. Published into slot kk
// of buffer nb: v (zero above row jj, over chunks M0.., which every reader
// of it reads), tau, and K3's X column jj, final; the column is finalized
// as R (exact zeros below the diagonal, K14: v's tail kept there; K2, K3:
// floored diagonal, d_jj recorded).
template <int M0, Mode MD, int N, int KC>
__device__ __forceinline__ void reflect(Regs<MD, N>& g, Smem<MD, N, KC>& sm,
                                        int jj, float an, int rgj, int nb,
                                        int kk, int lane) {
  using Gm = Geom<N>;
  constexpr int NM = Gm::NM, LD = Gm::LD;
  const int cs = lane & 7, rg = lane >> 3;
  float part = 0.f;
#pragma unroll
  for (int m = M0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (Gm::row(rg, m, e) > jj) part += g.a[m][e] * g.a[m][e];
  const float sigma = group_sum(part);
  const float alpha = __shfl_sync(kFull, an, cs + 8 * rgj);
  if (cs != (jj & 7)) return;
  const float normx = sqrtf(alpha * alpha + sigma);
  const float s = alpha >= 0.f ? 1.f : -1.f;
  const float vj = alpha + s * normx;
  const float vtv = sigma + vj * vj;
  const float tau = vtv >= FLT_MIN ? 2.f / vtv : 0.f;
  const float rjj = -s * normx;
  const float absr = fabsf(rjj);
  const float rjj_eff = fused(MD) && absr < kFloor ? kFloor : rjj;
  const float inv = 1.f / rjj_eff;
#pragma unroll
  for (int m = M0; m < NM; ++m) {
    float t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = Gm::row(rg, m, e);
      t[e] = r == jj ? vj : (r > jj ? g.a[m][e] : 0.f);
      g.a[m][e] = r == jj ? rjj_eff
                          : (r > jj && MD != Mode::VTAU ? 0.f : g.a[m][e]);
    }
    *reinterpret_cast<float4*>(sm.v[nb][kk] + 4 * (rg + 4 * m)) =
        make_float4(t[0], t[1], t[2], t[3]);
    if constexpr (MD == Mode::SOLVE) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = Gm::row(rg, m, e);
        t[e] = r < N ? (sm.zs[r * LD + jj] - g.x[m][e]) * inv : 0.f;
        g.x[m][e] = t[e];
      }
      *reinterpret_cast<float4*>(sm.xcol[nb] + 4 * (rg + 4 * m)) =
          make_float4(t[0], t[1], t[2], t[3]);
    }
  }
  if (rg == 0) {
    sm.tau[nb][kk] = tau;
    if constexpr (fused(MD)) sm.d[jj] = fmaxf(absr, kFloor);
  }
  g.vd = vj, g.tc = tau;
}

// The panel of reflectors jn .. jn + KC - 1 into buffer nb, in the warp
// that owns it: row jn + kk is entry (MB, EA + kk) of the lanes of row
// group rgj where hi, else (MA, EA + kk). Each reflector but the last is
// applied to the panel's later columns before the next is built.
template <Mode MD, int N, int KC, int M0, int MA, int MB, int EA>
__device__ __forceinline__ void build_panel(Regs<MD, N>& g,
                                            Smem<MD, N, KC>& sm, int jn,
                                            bool hi, int rgj, int nb,
                                            int lane) {
  constexpr int NM = Geom<N>::NM;
  const int c = 8 * (jn >> 3) + (lane & 7), rg = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    reflect<M0>(g, sm, jn + kk, hi ? g.a[MB][EA + kk] : g.a[MA][EA + kk],
                rgj, nb, kk, lane);
    if (kk + 1 < KC) {
      __syncwarp();
      float vv[NM][4];
      ld_rows<NM, M0>(sm.v[nb][kk], rg, vv);
      const float p = group_sum(dot_rows<NM, M0>(g.a, vv));
      const float ta = c > jn + kk && c < jn + KC ? sm.tau[nb][kk] * p : 0.f;
#pragma unroll
      for (int m = M0; m < NM; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) g.a[m][e] -= ta * vv[m][e];
    }
  }
}

// Column step of reflectors j .. j + KC - 1, j = 16 M + 4 rj + E: row j + kk
// is entry (M, E + kk) of the lanes of row group rj; row jn = j + KC is
// entry (M, E + KC), or (M, 0) of row group rj + 1, or (M + 1, 0) of row
// group 0.
template <Mode MD, int N, int KC, int M, int E>
__device__ __forceinline__ void column_step(Regs<MD, N>& g,
                                            Smem<MD, N, KC>& sm, int rj,
                                            int lane, int w, bool t0,
                                            phase_clock::Clock& clk) {
  static_assert(KC == 1 || !fused(MD), "K2 and K3 take one column a step");
  using Gm = Geom<N>;
  constexpr int NM = Gm::NM, M1 = M + 1 < NM ? M + 1 : M, EN = E + KC;
  // K4, K14, K15, K16: rows of the chunks below M lie above row j, where v
  // is zero
  constexpr int M0 = fused(MD) ? 0 : M;
  const int cs = lane & 7, rg = lane >> 3, c = 8 * w + cs;
  // jl: the panel's last column; c > jl is, at KC = 1, the one-column
  // loop's c > j
  const int j = 4 * (rj + 4 * M) + E, cb = (j / KC) & 1, jn = j + KC,
            jl = jn - 1;
  float vv[NM][4];
  ld_rows<NM, M0>(sm.v[cb][0], rg, vv);
  float tau = sm.tau[cb][0];

  // H_j .. H_jl on the columns c > jl of A (a warp whose columns are all
  // final skips it)
  if (8 * w + 7 > jl) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (kk > 0) {
        ld_rows<NM, M0>(sm.v[cb][kk], rg, vv);
        tau = sm.tau[cb][kk];
      }
      const float p = group_sum(dot_rows<NM, M0>(g.a, vv));  // every lane
      const float ta = c > jl ? tau * p : 0.f;
#pragma unroll
      for (int m = M0; m < NM; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) g.a[m][e] -= ta * vv[m][e];
      if constexpr (MD == Mode::SOLVE) {
        // fold R[j, c] x_j into X's accumulator of column c
        float xj[NM][4];
        ld_rows<NM>(sm.xcol[cb], rg, xj);
        const float r = __shfl_sync(kFull, g.a[M][E], cs + 8 * rj);
        const float f = c > jl ? r : 0.f;
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) g.x[m][e] += f * xj[m][e];
      }
    }
  }
  if (t0) clk.lap(1);

  // the owner of columns jn .. jn + KC - 1 publishes their reflectors
  // before its update of Q^T
  if (jn < N && w == (jn >> 3)) {
    if constexpr (EN < 4) {
      build_panel<MD, N, KC, M0, M, M, EN>(g, sm, jn, false, rj, cb ^ 1,
                                           lane);
    } else {
      build_panel<MD, N, KC, M0, M, M1, 0>(g, sm, jn, rj == 3, (rj + 1) & 3,
                                           cb ^ 1, lane);
    }
  }
  if (t0) clk.lap(2);

  if constexpr (has_q(MD)) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      // K4 at NP = 128 (N = 120, 128) reads reflector j again here, so that
      // 32 rows of it do not stay live beside 32 of A and 32 of Q^T across
      // the owner's reflector (which spilled at 128 registers a thread)
      if constexpr (KC > 1 || (MD == Mode::QR && NM == 8))
        ld_rows<NM, M0>(sm.v[cb][kk], rg, vv);
      if constexpr (KC > 1) tau = sm.tau[cb][kk];
      const float tq = tau * group_sum(dot_rows<NM, M0>(g.q, vv));
#pragma unroll
      for (int m = M0; m < NM; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) g.q[m][e] -= tq * vv[m][e];
    }
  }
  if (t0) clk.lap(3);
  if (jn < N) __syncthreads();
  if (t0) clk.lap(4);
}

// The column steps of one group of four rows, from row E of it on
template <Mode MD, int N, int KC, int M, int E>
__device__ __forceinline__ void group_steps(Regs<MD, N>& g,
                                            Smem<MD, N, KC>& sm, int rj,
                                            int lane, int w, bool t0,
                                            phase_clock::Clock& clk) {
  column_step<MD, N, KC, M, E>(g, sm, rj, lane, w, t0, clk);
  if constexpr (E + KC < 4)
    group_steps<MD, N, KC, M, E + KC>(g, sm, rj, lane, w, t0, clk);
}

// Column steps of rows 16 M .. 16 M + 15 (those below N), then the next
// chunk of rows
template <Mode MD, int N, int KC, int M>
__device__ __forceinline__ void column_steps(Regs<MD, N>& g,
                                             Smem<MD, N, KC>& sm, int lane,
                                             int w, bool t0,
                                             phase_clock::Clock& clk) {
  // N is a multiple of 8: every step of a row group or none
  for (int rj = 0; rj < 4 && 4 * (rj + 4 * M) < N; ++rj)
    group_steps<MD, N, KC, M, 0>(g, sm, rj, lane, w, t0, clk);
  if constexpr (M + 1 < Geom<N>::NM)
    column_steps<MD, N, KC, M + 1>(g, sm, lane, w, t0, clk);
}

// Q[c, r] = Q^T[r, c]: each lane writes its chunks of row c of Q
template <Mode MD, int N>
__device__ __forceinline__ void store_q(const Regs<MD, N>& g, float* Q_out,
                                        int c, int rg) {
#pragma unroll
  for (int m = 0; m < Geom<N>::NM; ++m) {
    const int r = Geom<N>::row(rg, m, 0);
    if (r < N)
      *reinterpret_cast<float4*>(Q_out + (size_t)c * N + r) =
          make_float4(g.q[m][0], g.q[m][1], g.q[m][2], g.q[m][3]);
  }
}

// The factorization of the unfused modes (K4, K14, K15, K16): column c of
// A (one matrix, row-major) into the lane's registers, each warp access
// eight consecutive floats of four rows; the first panel; the column
// steps. R (K14: and v's tails) stays in g.a, Q^T in g.q.
template <Mode MD, int N, int KC>
__device__ __forceinline__ void factor(Regs<MD, N>& g, Smem<MD, N, KC>& sm,
                                       const float* __restrict__ A, int lane,
                                       int w, bool t0,
                                       phase_clock::Clock& clk) {
  using Gm = Geom<N>;
  const int rg = lane >> 3, c = 8 * w + (lane & 7);
  g.vd = 0.f, g.tc = 0.f;
#pragma unroll
  for (int m = 0; m < Gm::NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = Gm::row(rg, m, e);
      g.a[m][e] = r < N ? A[(size_t)r * N + c] : 0.f;
      if constexpr (has_q(MD)) g.q[m][e] = r == c ? 1.f : 0.f;
    }
  if (w == 0)
    build_panel<MD, N, KC, 0, 0, 0, 0>(g, sm, 0, false, 0, 0, lane);
  __syncthreads();
  if (t0) clk.lap(0);
  column_steps<MD, N, KC, 0>(g, sm, lane, w, t0, clk);
}

// The block of one matrix in K4 and K16 (QR: Q into QV_out), K14 (VTAU: V
// into QV_out, tau into tau_out) and K15's R alone (NOQ), at KC reflectors
// per barrier; the kernels (csrc/udt_qr.cu's qr_f32_kernel, csrc/qr_ab.cu)
// are this function, under names of their own
template <Mode MD, int N, int KC>
__device__ __forceinline__ void qr_block(const float* __restrict__ A,
                                         float* __restrict__ QV_out,
                                         float* __restrict__ R_out,
                                         float* __restrict__ tau_out) {
  static_assert(!fused(MD), "K2 and K3 are udt_kernel");
  using Gm = Geom<N>;
  constexpr int NM = Gm::NM, NT = Gm::NT;
  __shared__ Smem<MD, N, KC> sm;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5, cs = lane & 7, rg = lane >> 3;
  const int c = 8 * w + cs;
  const bool t0 = tid == NT - 32;
  const size_t base = (size_t)b * N * N;
  phase_clock::Clock clk;
  if (t0) clk.start();

  Regs<MD, N> g;
  factor<MD, N, KC>(g, sm, A + base, lane, w, t0, clk);

  // R (and K14's V) by columns, split at the diagonal
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = Gm::row(rg, m, e);
      if (r >= N) continue;
      const size_t o = base + (size_t)r * N + c;
      if constexpr (MD == Mode::VTAU) {
        R_out[o] = r <= c ? g.a[m][e] : 0.f;
        QV_out[o] = g.tc == 0.f || r < c ? 0.f
                                         : (r == c ? g.vd : g.a[m][e]);
      } else {
        R_out[o] = g.a[m][e];
      }
    }
  if constexpr (MD == Mode::VTAU) {
    if (rg == 0) tau_out[(size_t)b * N + c] = g.tc;
  } else if constexpr (MD == Mode::QR) {
    store_q<MD, N>(g, QV_out + base, c, rg);
  }
  if (t0) clk.lap(5);
#ifdef MC_PHASE_STAMPS
  if (t0) clk.store(g_stamps_hh, b);
#endif
}

}  // namespace
