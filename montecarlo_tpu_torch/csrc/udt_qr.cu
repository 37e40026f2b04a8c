// Householder QR kernels on one register-column loop: the fused UDT K2 and
// K3, the float32 QR K4 and K14, K4 emitting its reflectors.
//
// Replace montecarlo_tpu/ops/pallas_qr.py::_udt_kernel (K2, reached through
// _udt_fused_batched / udt_fused_lanes), ::_udt_solve_kernel (K3, reached
// through _udt_solve_batched / udt_solve_lanes), ::_qr_kernel and its KB=8
// panel variant ::_blocked_kernel (K4, reached through _qr_batched /
// qr_lanes / maybe_qr) and ::_qr_kernel_vtau and its panel variant
// ::_blocked_kernel_vtau (K14, reached through _qr_batched_vtau /
// qr_lanes_wy / maybe_qr under MC_TPU_QR_WY=1). The panel variants compute
// the same functions and exist because the TPU's VMEM could not hold
// N = 128 otherwise. The plain PyTorch versions with the same algorithm are
// montecarlo_tpu_torch/ops/qr.py::udt_qr_plain and ::udt_qr_solve_plain,
// and ops/qr_householder.py::householder_qr_plain and
// ::householder_qr_vtau_plain.
//
// Column-by-column Householder QR of A (B, N, N) row-major, LAPACK signs,
// the reflector H = I - tau v v^T with v = (alpha + s ||x||, x_tail) and
// tau = 2 / v.v, tau = 0 on a zero tail, exact zero fill below the
// diagonal. What the loop emits is its mode:
//   UDT (K2, udt_qr_f32, 8 | N <= 64): the prescaled, column-pivoted A and
//     its power-of-two prescale mx (B,); floored diagonal (d_j =
//     max(|R_jj|, 2^-70), R_jj = +2^-70 for flushed modes); Q, Rs = R / d
//     (row-normalized), d * mx.
//   SOLVE (K3, udt_qr_solve_f32, 8 | N <= 64): K2's floored R and Q, and
//     X = (Z / mx) * R^-1 with the back-substitution pipelined into the
//     column loop: column j of X is final at step j (rows <= j of R are
//     final there) and is folded into the later columns at once.
//   QR (K4, qr_f32, 8 | N <= 128): Q and R, R_jj = -s ||x|| unfloored; A is
//     prescaled and pivoted (ops/linalg.py::udt_dirty) or column-normalized
//     (udt_dirty_colscaled) by the caller, who applies floor and postscale.
//   VTAU (K14, qr_vtau_f32, 8 | N <= 128): K4's R, and the reflectors in
//     place of Q: V (B, N, N), column j = v_j with zeros above row j, and
//     tau (B, N); V's column is all zeros where tau_j = 0, so that the
//     caller's assembly Q = I - V T V^T (ops/qr_householder.py::
//     wy_assemble_q) drops it exactly, as the TPU's flushed v does.
// A reflector with v.v below FLT_MIN gets tau = 0 as well: the TPU flushes
// such subnormals to zero, while CUDA keeps them (this file is built without
// -ftz) and 2 / v.v would overflow to inf (seen on float32 operands at
// beta = 10).
//
// Layout. One block of N / 8 warps per matrix (16 warps at N = 128). Lane
// cs + 8 rg of warp w holds column c = 8 w + cs of A, of Q^T (not K14) and
// (K3) of X in registers for the whole factorization: rows 4 (rg + 4 m) + e
// (row group rg < 4, chunk m < NP / 16, e < 4; rows padded to NP, a
// multiple of 16, hold zeros and stay zero). Q is accumulated as
// Q^T <- H_j Q^T, the plain version's Q <- Q H_j stored transposed, so the
// reflector's update of A and of Q is one column operation on one register
// layout. A column's dot with v is a lane's own sum over its rows plus two
// shuffles across the row groups: ~5 shuffles per warp and column step,
// where lanes mapped to rows need a butterfly over the warp's columns (~40;
// shuffles are issued at one warp instruction per SM clock, so those
// bounded the step).
//
// One block barrier per column. Reflector j sits in a double buffer in
// shared memory (v with zeros above row j, tau; K3: X's column j), which
// lanes read as float4 chunks of their rows. After the barrier that
// publishes it, every warp applies H_j to its columns c > j of A (K3: folds
// R[j, c] x_j into its accumulators, R[j, c] shuffled from the lane that
// holds row j); the warp that owns column j+1 then builds reflector j+1
// from it (tail norm with its own shuffles) and publishes it (K3: with
// x_{j+1} = (Z[:, j+1] / mx - acc) * (1 / R_jj), where the plain version
// divides: one rounding more) into the other buffer before its update of
// Q^T. The one barrier at the end of step j publishes reflector
// j+1 and keeps its writers off the buffer of step j until all have read
// it. K4 and K14 skip, at compile time, the row chunks above the reflector
// in their column steps (v is zero there), as K11 (csrc/qr_f64.cu) does:
// the loop runs in chunks of 16 steps (template recursion over m), so the
// chunks below m are known. K2 and K3 keep their full-height sums, bit for
// bit as before. K14 keeps each tail x_tail in A's registers below the
// diagonal in place of R's zeros (LAPACK's compact form; v_j and tau_j in
// two registers of the column's lanes): the updates of later steps leave
// those columns as they are (c <= j), and V and R are split at the store.
//
// Device memory: K2 and K3 take A and Z, and give Rs or X, through shared
// memory once, in coalesced copies (Z times 1/mx, exact, off the column
// loop's critical path). K4 and K14 load A and store R and V by columns
// straight from and to their registers: each warp access is eight
// consecutive floats of four rows, whole 32-byte sectors, with no N x N
// staging buffer (66 KB at N = 128, past the static limit). Q rows go out
// from registers as float4 chunks. Register arrays are indexed with
// compile-time indices only: the row of step j within its chunk is unrolled
// (E), so the lane of row j is a runtime choice among four and the register
// holding it a compile-time one.
//
// What bounds it: ~0.5 MFLOP per matrix at N = 64 (4 at N = 128) and
// device memory touched once (A and Z in, Q and Rs, R, X or V out), so
// neither FLOPs nor bytes. Per column step each lane does 2 (K3: 3) FMAs
// per row it holds for A and 2 for Q^T (16 rows at N = 64, 32 at 128), and
// ~5 shuffles; every warp reads reflector j from shared memory (float4
// chunks of its rows: the same floats for the eight lanes of a row group),
// and the owner of the next column runs a chain of its update, the tail
// norm, a square root and a division before the barrier. At two blocks per
// SM that is ~1,200 SM cycles per column for K2 and ~1,500 for K3
// (PERF.md), most of it in the update of A right after the barrier, where
// all warps read reflector j at once and the owner's chain waits behind
// them; K14, with no Q^T update, waits on that chain alone. Past N = 64 a
// block is 512 threads, one per SM. The TPU kernels' transposed
// chain-on-lanes layout and grid-as-column-loop are Mosaic workarounds and
// are not carried over.
//
// The loop itself (register layout, reflector, column steps, the block of
// the unfused modes) is csrc/udt_qr_loop.cuh, shared with the A/B variants
// K15 and K16 (csrc/qr_ab.cu); this file holds the kernels K2, K3, K4 and
// K14 and their launchers.

#include <cuda_runtime.h>

#include "phase_clock.cuh"
#include "udt_qr_loop.cuh"

namespace {

#ifdef MC_PHASE_STAMPS
// phases (lane 0 of the last warp, whose columns stay live longest): 0 load
// and the first reflector, 1 read of reflector j and the update of A (K3:
// and the fold), 2 the next reflector (the owner warp only), 3 the update
// of Q^T (none in K14), 4 the barrier, 5 store. K2 and K3 each into an
// array of their own, K4 and K14 into udt_qr_loop.cuh's g_stamps_hh.
__device__ long long g_stamps_qr[phase_clock::kMaxBlocks * phase_clock::kPhases];
__device__ long long g_stamps_solve[phase_clock::kMaxBlocks *
                                    phase_clock::kPhases];
#endif

// K2 (SOLVE false) and K3
template <bool SOLVE, int N>
__global__ void __launch_bounds__(Geom<N>::MAX_THREADS, Geom<N>::MIN_BLOCKS)
udt_kernel(const float* __restrict__ A, const float* __restrict__ Z,
           const float* __restrict__ mx, float* __restrict__ Q_out,
           float* __restrict__ Rs_out, float* __restrict__ d_out,
           float* __restrict__ X_out) {
  constexpr Mode MD = SOLVE ? Mode::SOLVE : Mode::UDT;
  using Gm = Geom<N>;
  constexpr int NM = Gm::NM, NT = Gm::NT, LD = Gm::LD;
  __shared__ Smem<MD, N> sm;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5, cs = lane & 7, rg = lane >> 3;
  const int c = 8 * w + cs;
  const bool t0 = tid == NT - 32;
  const size_t base = (size_t)b * N * N;
  const float mxb = mx[b];
  const float invmx = 1.f / mxb;
  phase_clock::Clock clk;
  if (t0) clk.start();

  // coalesced loads into padded rows (4 | N: a float4 stays in one row)
  for (int e = 4 * tid; e < N * N; e += 4 * NT) {
    const int r = e / N, o = r * LD + e - r * N;
    const float4 t = *reinterpret_cast<const float4*>(A + base + e);
    sm.stage[o] = t.x, sm.stage[o + 1] = t.y;
    sm.stage[o + 2] = t.z, sm.stage[o + 3] = t.w;
    if constexpr (SOLVE) {
      const float4 z = *reinterpret_cast<const float4*>(Z + base + e);
      sm.zs[o] = z.x * invmx, sm.zs[o + 1] = z.y * invmx;
      sm.zs[o + 2] = z.z * invmx, sm.zs[o + 3] = z.w * invmx;
    }
  }
  __syncthreads();
  Regs<MD, N> g;
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = Gm::row(rg, m, e);
      g.a[m][e] = r < N ? sm.stage[r * LD + c] : 0.f;
      g.q[m][e] = r == c ? 1.f : 0.f;
      g.x[m % Regs<MD, N>::MX][e] = 0.f;
    }
  if (w == 0) reflect<0>(g, sm, 0, g.a[0][0], 0, 0, 0, lane);
  __syncthreads();
  if (t0) clk.lap(0);

  column_steps<MD, N, 1, 0>(g, sm, lane, w, t0, clk);

  store_q<MD, N>(g, Q_out + base, c, rg);
  __syncthreads();  // every d_j written
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = Gm::row(rg, m, e);
      if (r < N)
        sm.stage[r * LD + c] = SOLVE ? g.x[m % Regs<MD, N>::MX][e]
                                     : g.a[m][e] / sm.d[r];
    }
  if (!SOLVE && tid < N) d_out[(size_t)b * N + tid] = sm.d[tid] * mxb;
  __syncthreads();
  float* out = SOLVE ? X_out : Rs_out;
  for (int e = 4 * tid; e < N * N; e += 4 * NT) {
    const int r = e / N, o = r * LD + e - r * N;
    *reinterpret_cast<float4*>(out + base + e) =
        make_float4(sm.stage[o], sm.stage[o + 1], sm.stage[o + 2],
                    sm.stage[o + 3]);
  }
  if (t0) clk.lap(5);
#ifdef MC_PHASE_STAMPS
  if (t0) clk.store(SOLVE ? g_stamps_solve : g_stamps_qr, b);
#endif
}

// K4 (VTAU false: Q into QV_out) and K14 (V into QV_out, tau into tau_out)
template <bool VTAU, int N>
__global__ void __launch_bounds__(Geom<N>::MAX_THREADS, Geom<N>::MIN_BLOCKS)
qr_f32_kernel(const float* __restrict__ A, float* __restrict__ QV_out,
              float* __restrict__ R_out, float* __restrict__ tau_out) {
  qr_block<VTAU ? Mode::VTAU : Mode::QR, N, 1>(A, QV_out, R_out, tau_out);
}

template <bool SOLVE, int N>
int launch_n(const float* A, const float* Z, const float* mx, float* Q,
             float* Rs, float* d, float* X, int B, cudaStream_t stream) {
  udt_kernel<SOLVE, N><<<B, Geom<N>::NT, 0, stream>>>(A, Z, mx, Q, Rs, d, X);
  return (int)cudaGetLastError();
}

template <bool SOLVE>
int launch(const float* A, const float* Z, const float* mx, float* Q,
           float* Rs, float* d, float* X, int B, int N, cudaStream_t stream) {
  if (B == 0) return 0;
  if (N < 8 || N > 64 || N % 8) return (int)cudaErrorInvalidValue;
  switch (N) {
    case 8: return launch_n<SOLVE, 8>(A, Z, mx, Q, Rs, d, X, B, stream);
    case 16: return launch_n<SOLVE, 16>(A, Z, mx, Q, Rs, d, X, B, stream);
    case 24: return launch_n<SOLVE, 24>(A, Z, mx, Q, Rs, d, X, B, stream);
    case 32: return launch_n<SOLVE, 32>(A, Z, mx, Q, Rs, d, X, B, stream);
    case 40: return launch_n<SOLVE, 40>(A, Z, mx, Q, Rs, d, X, B, stream);
    case 48: return launch_n<SOLVE, 48>(A, Z, mx, Q, Rs, d, X, B, stream);
    case 56: return launch_n<SOLVE, 56>(A, Z, mx, Q, Rs, d, X, B, stream);
    default: return launch_n<SOLVE, 64>(A, Z, mx, Q, Rs, d, X, B, stream);
  }
}

// K4 or K14 at the instantiation of N = n (8 | n <= 128)
template <bool VTAU, int N = 8>
int launch_qr(const float* A, float* QV, float* R, float* tau, int B, int n,
              cudaStream_t stream) {
  if (n == N) {
    qr_f32_kernel<VTAU, N><<<B, Geom<N>::NT, 0, stream>>>(A, QV, R, tau);
    return (int)cudaGetLastError();
  }
  if constexpr (N < 128)
    return launch_qr<VTAU, N + 8>(A, QV, R, tau, B, n, stream);
  return (int)cudaErrorInvalidValue;
}

// Phase stamps of the last launch of K2 (UDT), K3 (SOLVE) or K4 and K14,
// its first n_blocks blocks (kPhases cycle sums each), into dst on the
// host: a build with -DMC_PHASE_STAMPS only.
int copy_stamps(Mode md, void* dst, int n_blocks, void* stream) {
#ifdef MC_PHASE_STAMPS
  switch (md) {
    case Mode::UDT:
      return phase_clock::copy_rows(g_stamps_qr, dst, n_blocks, stream);
    case Mode::SOLVE:
      return phase_clock::copy_rows(g_stamps_solve, dst, n_blocks, stream);
    default:
      return phase_clock::copy_rows(g_stamps_hh, dst, n_blocks, stream);
  }
#else
  (void)md, (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}

}  // namespace

// Return the cudaError_t of the launch (0 = success). 8 | N <= 64.
extern "C" int udt_qr_f32(const float* A, const float* mx, float* Q,
                          float* Rs, float* d, int B, int N, void* stream) {
  return launch<false>(A, nullptr, mx, Q, Rs, d, nullptr, B, N,
                       (cudaStream_t)stream);
}

extern "C" int udt_qr_solve_f32(const float* A, const float* Z,
                                const float* mx, float* Q, float* X, int B,
                                int N, void* stream) {
  return launch<true>(A, Z, mx, Q, nullptr, nullptr, X, B, N,
                      (cudaStream_t)stream);
}

// A, Q, R (B, N, N) row-major. K4: float32, 8 | N <= 128.
extern "C" int qr_f32(const float* A, float* Q, float* R, int B, int N,
                      void* stream) {
  if (B == 0) return 0;
  if (N < 8 || N > 128 || N % 8) return (int)cudaErrorInvalidValue;
  return launch_qr<false>(A, Q, R, nullptr, B, N, (cudaStream_t)stream);
}

// K14: K4 without Q; V (B, N, N) row-major, tau (B, N). float32,
// 8 | N <= 128.
extern "C" int qr_vtau_f32(const float* A, float* V, float* tau, float* R,
                           int B, int N, void* stream) {
  if (B == 0) return 0;
  if (N < 8 || N > 128 || N % 8) return (int)cudaErrorInvalidValue;
  return launch_qr<true>(A, V, R, tau, B, N, (cudaStream_t)stream);
}

extern "C" int udt_qr_f32_stamps(void* dst, int n_blocks, void* stream) {
  return copy_stamps(Mode::UDT, dst, n_blocks, stream);
}

extern "C" int udt_qr_solve_f32_stamps(void* dst, int n_blocks,
                                       void* stream) {
  return copy_stamps(Mode::SOLVE, dst, n_blocks, stream);
}

// K4's or K14's, whichever launched last
extern "C" int qr_f32_stamps(void* dst, int n_blocks, void* stream) {
  return copy_stamps(Mode::QR, dst, n_blocks, stream);
}
