// Householder QR in float64 (kernel K11, qr_f64).
//
// Replaces montecarlo_tpu/ops/pallas_qr.py::_qr_df_kernel (reached through
// _qr_df_batched / qr_lanes_df / maybe_qr for float64). The plain PyTorch
// version with the same algorithm is montecarlo_tpu_torch/ops/
// qr_householder.py::householder_qr_plain, which K4 (csrc/udt_qr.cu)
// shares.
//
// Input: A (B, N, N) float64 row-major, prescaled and column-pivoted by the
// caller (ops/linalg.py::udt_dirty, or column-normalized by
// udt_dirty_colscaled), 8 | N <= 64. Output: Q, R with A = Q R, Q
// orthogonal, R upper triangular with exact zeros below the diagonal and
// R_jj = -sign(alpha) ||x|| (LAPACK signs). No floor and no postscale:
// ops/linalg.py applies them. Column by column, with the LAPACK-normalized
// reflector H = I - tau v v^T, v = (1, x_tail / v_j), v_j = alpha + s ||x||,
// tau = v_j / (s ||x||), and H = I (v = 0, tau = 0) where ||x||^2 is below
// DBL_MIN. The TPU kernel runs it in double-float (hi + lo float32 pairs)
// because the TPU has no float64, and takes H = I where ||x||^2 = 0, which
// its flush of subnormals extends to a subnormal ||x||^2; a reflector built
// from a subnormal ||x||^2 has lost its precision and is not orthogonal
// (Q^T Q - I of 0.09 on such a column), so the rule here is H = I below the
// smallest normal number. Hopper has native FP64, so the reflector runs in
// double, without the pairs.
//
// Layout (the one of K2 and K3, csrc/udt_qr.cu, in FP64). A block of NT
// threads per matrix, RG row groups: lane cs + CPW rg (CPW = 32 / RG column
// lanes) of warp w holds column c = CPW w + cs of A and of Q^T in
// registers for the whole factorization, rows 2 (rg + RG m) + e (chunk
// m < NM = NP / (2 RG), e < 2; rows padded to NP hold zeros and stay zero).
// Q is accumulated as Q^T <- H_j Q^T, the plain version's Q <- Q H_j stored
// transposed, so the reflector's update of A and of Q is one column
// operation on one register layout. A column's dot with v is a lane's own
// sum over its rows plus log2(RG) double shuffles across the row groups.
// Reflector j is zero above row j, so column step j touches only the
// chunks m >= j / (2 RG): the column loop runs in chunks of 2 RG steps
// (template recursion over the chunk M), whose chunks below M are skipped
// at compile time (about half of the FP64 work and of the reflector reads
// at N = 64). It runs RG = 4 (N / 8 warps, N / 4 rows per lane), which
// took 0.038 ms at (128, 64, 64) on an H100 where RG = 8 (N / 4 warps,
// half the rows per lane, one shuffle stage more per dot) took 0.042
// (PERF.md).
//
// One block barrier per column. Reflector j sits in a double buffer in
// shared memory (v with zeros above row j, and tau), which lanes read as
// double2 chunks of their rows. After the barrier that publishes it, every
// warp applies H_j to its columns c > j of A; the warp that owns column j+1
// then builds reflector j+1 from it (tail norm with its own shuffles, a
// square root and one division) and publishes it into the other buffer
// before its update of Q^T; the one barrier at the end of step j publishes
// reflector j+1 and keeps its writers off the buffer of step j until all
// have read it. A comes in and R goes out as columns (eight or four
// consecutive doubles of a row per warp access), Q as rows of Q from Q^T's
// columns, all from registers. Register arrays are indexed with
// compile-time indices only: the row of step j within its chunk is unrolled
// (E), so the lane holding row j is a runtime choice among RG and the
// register holding it a compile-time one.
//
// What bounds it: ~0.7 MFLOP per matrix (FP64) with device memory touched
// once (A in, Q and R out), so neither FP64 FLOPs nor bytes (0.004 ms at
// (128, 64, 64)). Per column step each lane does 2 FP64 FMAs per active row
// it holds for A and 2 for Q^T, its double shuffles (two 32-bit shuffles
// each, at one warp-wide shuffle per SM clock) and its reads of reflector j
// (double2 chunks); the owner of the next column runs a chain of its
// update, the tail norm, a square root and a division before the
// barrier. At the f64 run's 128 matrices there is one block per SM, so
// that chain is not hidden behind a second block: the column step is
// latency-bound inside one block. The TPU kernel's transposed
// chain-on-lanes layout, its grid-as-column-loop and its double-float
// pairs are Mosaic and TPU workarounds and are not carried over.

#include <cfloat>

#include <cuda_runtime.h>

#include "phase_clock.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowGroups = 4;

#ifdef MC_PHASE_STAMPS
// phases (lane 0 of the last warp, whose columns stay live longest): 0 load
// and the first reflector, 1 read of reflector j and the update of A, 2 the
// next reflector (the owner warp only), 3 the update of Q^T, 4 the barrier,
// 5 store
__device__ long long g_stamps[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

// Block geometry of one N and RG: N / CPW warps of CPW column lanes x RG
// row groups; NM chunks of 2 rows per lane, rows padded to NP.
template <int N, int RG>
struct Geom {
  static constexpr int CPW = 32 / RG, NW = N / CPW, NT = 32 * NW;
  static constexpr int NP = (N + 2 * RG - 1) / (2 * RG) * (2 * RG);
  static constexpr int NM = NP / (2 * RG);
  static_assert(N % CPW == 0, "whole warps of columns");
  __device__ static __forceinline__ int row(int rg, int m, int e) {
    return 2 * (rg + RG * m) + e;
  }
};

// A lane's column of A (becoming R) and of Q^T
template <int N, int RG>
struct Regs {
  static constexpr int NM = Geom<N, RG>::NM;
  double a[NM][2];
  double q[NM][2];
};

// The double-buffered reflector (v, zero above its row, and tau)
template <int N, int RG>
struct Smem {
  alignas(16) double v[2][Geom<N, RG>::NP];
  double tau[2];
};

// Sum over the RG row groups of a column (lanes cs + CPW rg)
template <int RG>
__device__ __forceinline__ double group_sum(double x) {
#pragma unroll
  for (int off = 32 / RG; off < 32; off <<= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The lane's part of a column's dot with the staged rows, chunks M0..NM-1
template <int NM, int M0>
__device__ __forceinline__ double dot_rows(const double (&a)[NM][2],
                                           const double (&b)[NM][2]) {
  double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int m = M0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) s[2 * (m & 1) + e] += a[m][e] * b[m][e];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Reflector of column jj from its tail below row jj, in the warp that owns
// it (every lane computes the tail norm of its own column; the RG lanes of
// column jj go on). an is the lane's entry at row jj, which lane
// cs + CPW rgj holds. Published into buffer nb (v zero above row jj, over
// chunks M0.. which every reader of it reads; tau), and the column is
// finalized as R (R_jj, exact zeros below the diagonal). Rows of chunks
// below M0 lie above jj.
template <int N, int RG, int M0>
__device__ __forceinline__ void reflect(Regs<N, RG>& g, Smem<N, RG>& sm,
                                        int jj, double an, int rgj, int nb,
                                        int lane) {
  using Gm = Geom<N, RG>;
  constexpr int NM = Gm::NM, CPW = Gm::CPW;
  const int cs = lane % CPW, rg = lane / CPW;
  double part[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int m = M0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (Gm::row(rg, m, e) > jj)
        part[2 * (m & 1) + e] += g.a[m][e] * g.a[m][e];
  const double sigma =
      group_sum<RG>((part[0] + part[1]) + (part[2] + part[3]));
  const double alpha = __shfl_sync(kFull, an, cs + CPW * rgj);
  if (cs != jj % CPW) return;
  const double n2 = alpha * alpha + sigma;
  const double normx = sqrt(n2);
  const double s = alpha >= 0.0 ? 1.0 : -1.0;
  const double vj = alpha + s * normx;
  const bool live = n2 >= DBL_MIN;
  // one division on the owner's chain: 1 / v_j = s ||x|| / (v_j s ||x||)
  // and tau = v_j / (s ||x||) = v_j^2 / (v_j s ||x||), within a few
  // roundings of the plain version's two
  const double sn = s * normx;
  const double inv = live ? 1.0 / (vj * sn) : 0.0;
  const double vscale = sn * inv;
  const double tau = vj * vj * inv;
  const double rjj = -s * normx;
#pragma unroll
  for (int m = M0; m < NM; ++m) {
    double t[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = Gm::row(rg, m, e);
      t[e] = r == jj ? (live ? 1.0 : 0.0)
                     : (r > jj ? g.a[m][e] * vscale : 0.0);
      g.a[m][e] = r == jj ? rjj : (r > jj ? 0.0 : g.a[m][e]);
    }
    *reinterpret_cast<double2*>(sm.v[nb] + 2 * (rg + RG * m)) =
        make_double2(t[0], t[1]);
  }
  if (rg == 0) sm.tau[nb] = tau;
}

// Column step j = 2 (rj + RG M) + E: row j is entry (M, E) of the lanes of
// row group rj; row j+1 is entry (M, 1) there, or (M, 0) of row group
// rj + 1, or (M + 1, 0) of row group 0.
template <int N, int RG, int M, int E>
__device__ __forceinline__ void column_step(Regs<N, RG>& g, Smem<N, RG>& sm,
                                            int rj, int lane, int w, bool t0,
                                            phase_clock::Clock& clk) {
  using Gm = Geom<N, RG>;
  constexpr int NM = Gm::NM, CPW = Gm::CPW, M1 = M + 1 < NM ? M + 1 : M;
  const int cs = lane % CPW, rg = lane / CPW, c = CPW * w + cs;
  const int j = 2 * (rj + RG * M) + E, cb = j & 1, jn = j + 1;
  double vv[NM][2];
#pragma unroll
  for (int m = M; m < NM; ++m) {
    const double2 t =
        *reinterpret_cast<const double2*>(sm.v[cb] + 2 * (rg + RG * m));
    vv[m][0] = t.x, vv[m][1] = t.y;
  }
  const double tau = sm.tau[cb];

  // H_j on the columns c > j of A (a warp whose columns are all final
  // skips it)
  if (CPW * w + CPW - 1 > j) {
    const double p = group_sum<RG>(dot_rows<NM, M>(g.a, vv));
    const double ta = c > j ? tau * p : 0.0;
#pragma unroll
    for (int m = M; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) g.a[m][e] -= ta * vv[m][e];
  }
  if (t0) clk.lap(1);

  // the owner of column j+1 publishes reflector j+1 before its update of
  // Q^T
  if (jn < N && w == jn / CPW) {
    if constexpr (E == 0) {
      reflect<N, RG, M>(g, sm, jn, g.a[M][1], rj, cb ^ 1, lane);
    } else {
      reflect<N, RG, M>(g, sm, jn, rj < RG - 1 ? g.a[M][0] : g.a[M1][0],
                        (rj + 1) % RG, cb ^ 1, lane);
    }
  }
  if (t0) clk.lap(2);

  const double tq = tau * group_sum<RG>(dot_rows<NM, M>(g.q, vv));
#pragma unroll
  for (int m = M; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) g.q[m][e] -= tq * vv[m][e];
  if (t0) clk.lap(3);
  if (jn < N) __syncthreads();
  if (t0) clk.lap(4);
}

// Column steps of rows 2 RG M .. 2 RG M + 2 RG - 1 (those below N), then
// the next chunk of rows
template <int N, int RG, int M>
__device__ __forceinline__ void column_steps(Regs<N, RG>& g, Smem<N, RG>& sm,
                                             int lane, int w, bool t0,
                                             phase_clock::Clock& clk) {
  // N is even: both steps of a row group or none
  for (int rj = 0; rj < RG && 2 * (rj + RG * M) < N; ++rj) {
    column_step<N, RG, M, 0>(g, sm, rj, lane, w, t0, clk);
    column_step<N, RG, M, 1>(g, sm, rj, lane, w, t0, clk);
  }
  if constexpr (M + 1 < Geom<N, RG>::NM)
    column_steps<N, RG, M + 1>(g, sm, lane, w, t0, clk);
}

template <int N, int RG>
__global__ void __launch_bounds__(Geom<N, RG>::NT)
qr_f64_kernel(const double* __restrict__ A, double* __restrict__ Q_out,
              double* __restrict__ R_out) {
  using Gm = Geom<N, RG>;
  constexpr int NM = Gm::NM, NT = Gm::NT, CPW = Gm::CPW;
  __shared__ Smem<N, RG> sm;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5, cs = lane % CPW, rg = lane / CPW;
  const int c = CPW * w + cs;
  const bool t0 = tid == NT - 32;
  const size_t base = (size_t)b * N * N;
  phase_clock::Clock clk;
  if (t0) clk.start();

  // column c of A: each warp access reads CPW consecutive doubles of a row
  Regs<N, RG> g;
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = Gm::row(rg, m, e);
      g.a[m][e] = r < N ? A[base + (size_t)r * N + c] : 0.0;
      g.q[m][e] = r == c ? 1.0 : 0.0;
    }
  if (w == 0) reflect<N, RG, 0>(g, sm, 0, g.a[0][0], 0, 0, lane);
  __syncthreads();
  if (t0) clk.lap(0);

  column_steps<N, RG, 0>(g, sm, lane, w, t0, clk);

  // Q[c, r] = Q^T[r, c]: each lane writes its chunks of row c of Q; R by
  // columns
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int r = Gm::row(rg, m, 0);
    if (r < N) {
      *reinterpret_cast<double2*>(Q_out + base + (size_t)c * N + r) =
          make_double2(g.q[m][0], g.q[m][1]);
      R_out[base + (size_t)r * N + c] = g.a[m][0];
      R_out[base + (size_t)(r + 1) * N + c] = g.a[m][1];
    }
  }
  if (t0) clk.lap(5);
#ifdef MC_PHASE_STAMPS
  if (t0) clk.store(g_stamps, b);
#endif
}

template <int N, int RG>
int launch_n(const double* A, double* Q, double* R, int B,
             cudaStream_t stream) {
  qr_f64_kernel<N, RG><<<B, Geom<N, RG>::NT, 0, stream>>>(A, Q, R);
  return (int)cudaGetLastError();
}

}  // namespace

// Return the cudaError_t of the launch (0 = success). A, Q, R (B, N, N)
// float64 row-major, 8 | N <= 64.
extern "C" int qr_f64(const double* A, double* Q, double* R, int B, int N,
                      void* stream) {
  if (B == 0) return 0;
  if (N < 8 || N > 64 || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int RG = kRowGroups;
  switch (N) {
    case 8: return launch_n<8, RG>(A, Q, R, B, st);
    case 16: return launch_n<16, RG>(A, Q, R, B, st);
    case 24: return launch_n<24, RG>(A, Q, R, B, st);
    case 32: return launch_n<32, RG>(A, Q, R, B, st);
    case 40: return launch_n<40, RG>(A, Q, R, B, st);
    case 48: return launch_n<48, RG>(A, Q, R, B, st);
    case 56: return launch_n<56, RG>(A, Q, R, B, st);
    default: return launch_n<64, RG>(A, Q, R, B, st);
  }
}

// Phase stamps of the last K11 launch's first n_blocks blocks (kPhases
// cycle sums each) into dst on the host: a build with -DMC_PHASE_STAMPS
// only.
extern "C" int qr_f64_stamps(void* dst, int n_blocks, void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
