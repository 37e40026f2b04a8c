// The A/B variants of the fused QR's column loop: K15 (R without Q, and Q
// formed backward from the stored reflectors) and K16 (several Householder
// columns per block barrier), float32, 8 | N <= 64.
//
// Replace benchmarks/q_backward_ab.py::_kernel_noq (K15-noq, reached
// through run_noq), ::_kernel_backward (K15-backward, through run_backward)
// and benchmarks/qr_step_shape_ab.py::_kernel (K16, through make_run). The
// plain PyTorch versions with the same algorithm are montecarlo_tpu_torch/
// ops/qr_ab.py::householder_r_plain, ::householder_qr_backward_plain and
// ::householder_qr_kcol_plain. The TPU scripts ask how K2's column loop
// should be shaped: how much of its time goes to forming Q, and whether
// fewer grid steps (here: block barriers) shorten it.
//
// All three run K4's column loop (csrc/udt_qr_loop.cuh: one block of N / 8
// warps per matrix, a lane's column of A in registers, rows in float4
// chunks, column steps that skip the row chunks above the reflector), on
// A as given: no prescale and no pivot, LAPACK signs, tau = 0 where v.v is
// below FLT_MIN (the port's rule for the TPU's flush of subnormals).
//   qr_r_f32 (K15-noq): the loop in the mode NOQ, K4's QR mode with the
//     update of Q^T removed at compile time: R only (K14 without its V and
//     tau stores). Its R is bit-equal to K4's.
//   qr_backward_f32 (K15-backward): phase 1 is K14's loop (v_j's tail kept
//     below the diagonal in A's registers, v_jj and tau_j in two registers
//     of column j's lanes); R goes out, V and tau go to shared memory
//     (16.6 KB at N = 64) behind one block barrier. Phase 2 forms
//     Q = H_0 ... H_{N-1} backward, P <- H_j P for j = N-1 .. 0 from P = I:
//     each lane owns column c of P and applies H_j only where c >= j (P
//     differs from I only in its trailing block), over the row chunks from
//     row j's down, known at compile time. A column of P is changed by its
//     own lanes alone, so phase 2 needs no block barrier: the dot is a
//     lane's sum over its rows and two shuffles (group_sum), as in the
//     loop. Q is stored row-major by columns. The TPU kernel's two static
//     halves of the Q phase are a VMEM workaround and are not carried over.
//   qr_kcol_f32 (K16): the loop in K4's QR mode with KC in {1, 2, 4}
//     reflectors per block barrier (udt_qr_loop.cuh's header says how):
//     R and Q bit-equal to K4's at every KC. KC = 1 is K4 itself; the
//     wrapper launches K4's kernel there and counts it as K4's.
//     The TPU script's other lever, the lane-block width CB, is a Mosaic
//     layout width and has no counterpart here.
//
// What bounds them: device memory touched once (A in; R, and Q for K15-
// backward and K16, out: 0.00250 ms without Q and 0.00376 ms with it at
// (256, 64, 64) and 3.35 TB/s); as for K4, the time goes to the column
// loop's chain (PERF.md: K4 runs at ~11% of that bound), the owner warp's
// reflector before each barrier. K15-backward's phase 2 does half the
// FLOPs of the forward update of Q^T and waits on no other warp; K16
// divides the barriers by KC but leaves the owner's chain of KC reflectors
// in a row. None of these is tuned: they answer the TPU scripts' questions
// on this card.

#include <cuda_runtime.h>

#include "phase_clock.cuh"
#include "udt_qr_loop.cuh"

namespace {

// K15-backward's reflectors: v_j over the rows (zeros above row j, all
// zeros where tau_j = 0) and tau_j
template <int N>
struct Reflectors {
  alignas(16) float v[N][Geom<N>::NP];
  float tau[N];
};

// Phase 2 of K15-backward for the reflectors j of row chunk M, from the
// last down, then those of the chunks above: p is the lane's column c of P
// (rows in chunks).
template <int N, int M>
__device__ __forceinline__ void q_backward_steps(float (&p)[Geom<N>::NM][4],
                                                 const Reflectors<N>& rs,
                                                 int lane, int w) {
  constexpr int NM = Geom<N>::NM;
  const int rg = lane >> 3, c = 8 * w + (lane & 7);
  const int top = 16 * M + 15 < N - 1 ? 16 * M + 15 : N - 1;
  for (int j = top; j >= 16 * M; --j) {
    if (8 * w + 7 < j) continue;  // every column of the warp lies left of j
    float vv[NM][4];
    ld_rows<NM, M>(rs.v[j], rg, vv);
    const float pd = group_sum(dot_rows<NM, M>(p, vv));
    const float t = c >= j ? rs.tau[j] * pd : 0.f;
#pragma unroll
    for (int m = M; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[m][e] -= t * vv[m][e];
  }
  if constexpr (M > 0) q_backward_steps<N, M - 1>(p, rs, lane, w);
}

// K15-backward: R, then Q formed backward from the reflectors
template <int N>
__global__ void __launch_bounds__(Geom<N>::MAX_THREADS, Geom<N>::MIN_BLOCKS)
qr_backward_kernel(const float* __restrict__ A, float* __restrict__ Q_out,
                   float* __restrict__ R_out) {
  constexpr Mode MD = Mode::VTAU;
  using Gm = Geom<N>;
  constexpr int NM = Gm::NM, NT = Gm::NT;
  __shared__ Smem<MD, N> sm;
  __shared__ Reflectors<N> rs;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5, cs = lane & 7, rg = lane >> 3;
  const int c = 8 * w + cs;
  const bool t0 = tid == NT - 32;
  const size_t base = (size_t)b * N * N;
  phase_clock::Clock clk;
  if (t0) clk.start();

  Regs<MD, N> g;
  factor<MD, N, 1>(g, sm, A + base, lane, w, t0, clk);

  // R above the diagonal out; v_c (all zeros where tau_c = 0) and tau_c
  // into shared memory
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    float t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = Gm::row(rg, m, e);
      if (r < N) R_out[base + (size_t)r * N + c] = r <= c ? g.a[m][e] : 0.f;
      t[e] = g.tc == 0.f || r < c ? 0.f : (r == c ? g.vd : g.a[m][e]);
    }
    *reinterpret_cast<float4*>(&rs.v[c][4 * (rg + 4 * m)]) =
        make_float4(t[0], t[1], t[2], t[3]);
  }
  if (rg == 0) rs.tau[c] = g.tc;
  __syncthreads();

  // P = I, then P <- H_j P for j = N-1 .. 0
  float p[NM][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[m][e] = Gm::row(rg, m, e) == c ? 1.f : 0.f;
  q_backward_steps<N, NM - 1>(p, rs, lane, w);

  // Q row-major, by columns: each warp access is eight consecutive floats
  // of four rows
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = Gm::row(rg, m, e);
      if (r < N) Q_out[base + (size_t)r * N + c] = p[m][e];
    }
}

// K15-noq: R alone
template <int N>
__global__ void __launch_bounds__(Geom<N>::MAX_THREADS, Geom<N>::MIN_BLOCKS)
qr_r_kernel(const float* __restrict__ A, float* __restrict__ R_out) {
  qr_block<Mode::NOQ, N, 1>(A, nullptr, R_out, nullptr);
}

// K16 at KC = 2 or 4 (KC = 1 is K4's qr_f32_kernel)
template <int N, int KC>
__global__ void __launch_bounds__(Geom<N>::MAX_THREADS, Geom<N>::MIN_BLOCKS)
qr_kcol_kernel(const float* __restrict__ A, float* __restrict__ Q_out,
               float* __restrict__ R_out) {
  qr_block<Mode::QR, N, KC>(A, Q_out, R_out, nullptr);
}

enum class Kernel { NOQ, BACKWARD, KCOL2, KCOL4 };

// One of the kernels at the instantiation of N = n (8 | n <= 64)
template <Kernel K, int N = 8>
int launch(const float* A, float* Q, float* R, int B, int n,
           cudaStream_t stream) {
  if (n == N) {
    const int NT = Geom<N>::NT;
    if constexpr (K == Kernel::NOQ)
      qr_r_kernel<N><<<B, NT, 0, stream>>>(A, R);
    else if constexpr (K == Kernel::BACKWARD)
      qr_backward_kernel<N><<<B, NT, 0, stream>>>(A, Q, R);
    else
      qr_kcol_kernel<N, K == Kernel::KCOL2 ? 2 : 4>
          <<<B, NT, 0, stream>>>(A, Q, R);
    return (int)cudaGetLastError();
  }
  if constexpr (N < 64)
    return launch<K, N + 8>(A, Q, R, B, n, stream);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int N) { return N < 8 || N > 64 || N % 8; }

}  // namespace

// Return the cudaError_t of the launch (0 = success). A, Q, R (B, N, N)
// row-major float32, 8 | N <= 64.

// K15-noq: R of A
extern "C" int qr_r_f32(const float* A, float* R, int B, int N,
                        void* stream) {
  if (B == 0) return 0;
  if (bad_shape(N)) return (int)cudaErrorInvalidValue;
  return launch<Kernel::NOQ>(A, nullptr, R, B, N, (cudaStream_t)stream);
}

// K15-backward: Q (formed backward) and R
extern "C" int qr_backward_f32(const float* A, float* Q, float* R, int B,
                               int N, void* stream) {
  if (B == 0) return 0;
  if (bad_shape(N)) return (int)cudaErrorInvalidValue;
  return launch<Kernel::BACKWARD>(A, Q, R, B, N, (cudaStream_t)stream);
}

// K16: Q and R at KC in {2, 4} reflectors per block barrier (KC = 1 is
// K4, csrc/udt_qr.cu::qr_f32)
extern "C" int qr_kcol_f32(const float* A, float* Q, float* R, int B, int N,
                           int KC, void* stream) {
  if (B == 0) return 0;
  if (bad_shape(N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (KC) {
    case 2: return launch<Kernel::KCOL2>(A, Q, R, B, N, st);
    case 4: return launch<Kernel::KCOL4>(A, Q, R, B, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
