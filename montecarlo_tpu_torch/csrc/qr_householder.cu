// Unfused Householder QR in float32: kernel K4, and K14, K4 emitting its
// reflectors. (K11, the float64 QR, has a layout of its own in
// csrc/qr_f64.cu.)
//
// K4 replaces montecarlo_tpu/ops/pallas_qr.py::_qr_kernel and its KB=8 panel
// variant ::_blocked_kernel (reached through _qr_batched / qr_lanes /
// maybe_qr). The plain PyTorch version with the same algorithm is
// montecarlo_tpu_torch/ops/qr_householder.py::householder_qr_plain.
//
// Input: A (B, N, N) row-major, prescaled and column-pivoted by the caller
// (ops/linalg.py::udt_dirty, or column-normalized by udt_dirty_colscaled).
// Output: Q, R with A = Q R, Q orthogonal, R upper triangular with exact
// zeros below the diagonal and R_jj = -sign(alpha) * ||x|| exactly (LAPACK
// signs). No floor and no postscale: ops/linalg.py applies them. Column by
// column, with the TPU kernel's reflector H = I - tau v v^T,
// v = (alpha + s ||x||, x_tail), tau = 2 / v.v; a v.v below FLT_MIN gets
// tau = 0 (H = I). The TPU kernel computes 2 / v.v for any v.v > 0 and
// relies on the TPU flushing subnormals to zero; CUDA keeps them (this file
// is built without -ftz), where 2 / v.v would be inf and fill the matrix
// with NaN (the trap K2, K7 and K10 guard as well).
// Trailing columns: a -= (tau (v.a)) v; Q <- Q H:
// Q[r, :] -= (tau (Q[r, :].v)) v.
//
// K14 (qr_vtau_f32) is K4 with the Q accumulation dropped: it emits the
// reflectors instead, V (B, N, N) with column j = v_j (zeros above row j)
// and tau (B, N), and R. It replaces montecarlo_tpu/ops/pallas_qr.py::
// _qr_kernel_vtau and its KB=8 panel variant ::_blocked_kernel_vtau (reached
// through _qr_batched_vtau / qr_lanes_wy / maybe_qr under MC_TPU_QR_WY=1);
// the caller assembles Q = I - V T V^T outside (ops/qr_householder.py::
// wy_assemble_q). Where v.v is below FLT_MIN the reflector is H = I (tau =
// 0) but v need not be 0; V's column is written as 0 there, so that the
// assembly drops it exactly, as the TPU's flushed v does. Its plain version
// is ops/qr_householder.py::householder_qr_vtau_plain. Its bound is K4's
// without the Q half of the column steps: still barrier latency inside the
// block.
//
// What bounds it: each of the N column steps is O(N^2) shared-memory work
// (the reflector applied to the trailing columns and to Q) separated by
// barriers; at N = 64 the factorization is ~0.7 MFLOP per matrix, at
// N = 128 ~5.6 MFLOP, so the kernel is bound by barrier latency
// and shared-memory bandwidth inside one block, not by FLOPs or device
// memory (A is read once, Q and R written once). With one block per matrix,
// 128-256 matrices give one or two blocks per SM.
//
// Design: one 256-thread block per matrix; A (becoming R) and Q stay in
// dynamic shared memory for all N steps, rows padded to N+1 elements
// (2 x 128 x 129 x 4 B = 129 KB at N = 128). Per column: one warp reduces
// the tail norm; each warp then owns whole trailing columns (dot with v and
// update, reduced with warp shuffles, no barrier between them) and whole
// rows of Q; the reflector's own column is finalized in the same phase.
// The TPU kernels' transposed chain-on-lanes layout, their
// grid-as-column-loop and K4's KB=8 panels (which exist only because VMEM
// could not hold N = 128 otherwise) are Mosaic workarounds and are not
// carried over.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The reflector of one column from alpha = x_j and sigma = ||x_tail||^2, in
// LAPACK's raw form: v_j (the tail entries are x's own), tau and R_jj.
struct Reflector {
  float vj, tau, rjj;
  __device__ Reflector(float alpha, float sigma) {
    const float normx = sqrtf(alpha * alpha + sigma);
    const float s = alpha >= 0.f ? 1.f : -1.f;
    vj = alpha + s * normx;
    const float vtv = sigma + vj * vj;
    tau = vtv >= FLT_MIN ? 2.f / vtv : 0.f;
    rjj = -s * normx;
  }
};

// VTAU (K14): the Q loop is skipped; Q_out receives V instead of Q (column
// j = v_j, zeros above row j, all zeros where tau_j = 0) and tau_out the
// tau_j. Otherwise tau_out is unused.
template <bool VTAU>
__global__ void __launch_bounds__(kThreads)
qr_kernel(const float* __restrict__ A, float* __restrict__ Q_out,
          float* __restrict__ R_out, float* __restrict__ tau_out, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // A -> R, at r*LD + c
  const int LD = N + 1;
  float* Qs = As + N * LD;  // Q (VTAU: V), [r][c]
  float* v = Qs + N * LD;   // reflector (rows >= j)
  float* red = v + N;       // tail norm^2 of the current column
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const size_t base = (size_t)b * N * N;

  for (int e = tid; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e - r * N;
    As[r * LD + c] = A[base + e];
    Qs[r * LD + c] = r == c && !VTAU ? 1.f : 0.f;
  }
  __syncthreads();

  for (int j = 0; j < N; ++j) {
    if (warp == 0) {
      float part = 0;
      for (int r = j + 1 + lane; r < N; r += 32) {
        const float x = As[r * LD + j];
        part += x * x;
      }
      part = warp_sum(part);
      if (lane == 0) red[0] = part;
    }
    __syncthreads();
    const Reflector h(As[j * LD + j], red[0]);
    for (int r = j + tid; r < N; r += blockDim.x)
      v[r] = r == j ? h.vj : As[r * LD + j];
    __syncthreads();

    // H applied to the trailing columns c > j (columns < j have zero tails,
    // column j is finalized below) and accumulated into Q
    for (int c = j + 1 + warp; c < N; c += nwarps) {
      float part = 0;
      for (int r = j + lane; r < N; r += 32) part += As[r * LD + c] * v[r];
      const float tw = h.tau * warp_sum(part);
      for (int r = j + lane; r < N; r += 32) As[r * LD + c] -= tw * v[r];
    }
    if (VTAU) {
      for (int r = j + tid; r < N; r += blockDim.x)
        Qs[r * LD + j] = h.tau != 0.f ? v[r] : 0.f;
      if (tid == 0) tau_out[(size_t)b * N + j] = h.tau;
    } else {
      for (int r = warp; r < N; r += nwarps) {
        float part = 0;
        for (int k = j + lane; k < N; k += 32) part += Qs[r * LD + k] * v[k];
        const float tw = h.tau * warp_sum(part);
        for (int k = j + lane; k < N; k += 32) Qs[r * LD + k] -= tw * v[k];
      }
    }
    for (int r = j + tid; r < N; r += blockDim.x)
      As[r * LD + j] = r == j ? h.rjj : 0.f;
    __syncthreads();
  }

  for (int e = tid; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e - r * N;
    Q_out[base + e] = Qs[r * LD + c];
    R_out[base + e] = As[r * LD + c];
  }
}

template <bool VTAU = false>
int launch(const float* A, float* Q, float* R, float* tau, int B, int N,
           cudaStream_t stream) {
  if (B == 0) return 0;
  if (N < 8 || N > 128 || N % 8) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * N * (N + 1) + N + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qr_kernel<VTAU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_kernel<VTAU><<<B, kThreads, smem, stream>>>(A, Q, R, tau, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Return the cudaError_t of the launch (0 = success). A, Q, R (B, N, N)
// row-major. K4: float32, 8 | N <= 128.
extern "C" int qr_f32(const float* A, float* Q, float* R, int B, int N,
                      void* stream) {
  return launch(A, Q, R, nullptr, B, N, (cudaStream_t)stream);
}

// K14: K4 without the Q accumulation; V (B, N, N) row-major, tau (B, N).
// float32, 8 | N <= 128.
extern "C" int qr_vtau_f32(const float* A, float* V, float* tau, float* R,
                           int B, int N, void* stream) {
  return launch<true>(A, V, R, tau, B, N, (cudaStream_t)stream);
}
