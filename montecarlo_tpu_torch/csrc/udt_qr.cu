// Fused Householder UDT kernels (K2 and K3).
//
// Replace montecarlo_tpu/ops/pallas_qr.py::_udt_kernel (K2, reached through
// _udt_fused_batched / udt_fused_lanes) and ::_udt_solve_kernel (K3, reached
// through _udt_solve_batched / udt_solve_lanes). The plain PyTorch versions
// with the same algorithm are montecarlo_tpu_torch/ops/qr.py::udt_qr_plain
// and ::udt_qr_solve_plain.
//
// Input: the prescaled, column-pivoted A (B, N, N) row-major and its power-
// of-two prescale mx (B,). Column-by-column Householder QR, LAPACK signs,
// tau = 0 on a zero tail, exact zero fill below the diagonal, floored
// diagonal (d_j = max(|R_jj|, 2^-70), R_jj = +2^-70 for flushed modes).
//   K2 (udt_qr_f32):       Q, Rs = R / d (row-normalized), d * mx.
//   K3 (udt_qr_solve_f32): Q, X = (Z / mx) * R^-1 with the back-substitution
//                          pipelined into the column loop: column j of X is
//                          final at step j (rows <= j of R are final there)
//                          and is folded into the later columns at once.
// A reflector with v.v below FLT_MIN gets tau = 0 as well: the TPU flushes
// such subnormals to zero, while CUDA keeps them (this file is built without
// -ftz) and 2 / v.v would overflow to inf (seen on float32 operands at
// beta = 10).
//
// What bounds it: each of the N column steps is O(N^2) shared-memory work
// (the reflector applied to the trailing columns and to Q) separated by
// barriers; at N = 64 the whole factorization is ~0.5 MFLOP per matrix, so
// the kernel is bound by barrier latency and shared-memory bandwidth inside
// one block, not by FLOPs or device memory (A is read once, Q/Rs/X written
// once). With one block per matrix, 256 matrices give ~2 blocks per SM.
//
// Design: one 256-thread block per matrix; A (becoming R), Q (and X for
// K3) stay in dynamic shared memory for all N steps, with rows padded to
// N+1 floats so column reads are free of bank conflicts. Per column: one
// warp reduces the tail norm; each warp then owns whole trailing columns
// (dot with v and update, reduced with warp shuffles, no barrier between
// them) and whole rows of Q; the reflector's own column is finalized in
// the same phase. The TPU kernels' transposed chain-on-lanes layout and
// grid-as-column-loop are Mosaic workarounds and are not carried over.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFloor = 0x1p-70f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <bool SOLVE>
__global__ void __launch_bounds__(kThreads)
udt_kernel(const float* __restrict__ A, const float* __restrict__ Z,
           const float* __restrict__ mx, float* __restrict__ Q_out,
           float* __restrict__ Rs_out, float* __restrict__ d_out,
           float* __restrict__ X_out, int N) {
  extern __shared__ float smem[];
  const int LD = N + 1;
  float* As = smem;           // A -> R, [r][c] at r*LD + c
  float* Qs = As + N * LD;    // Q, [r][c]
  float* v = Qs + N * LD;     // reflector (rows >= j); K3 reuses it for X[:, j]
  float* dsub = v + N;        // floored |R_jj| (prescaled domain)
  float* red = dsub + N;      // tail norm^2 of the current column
  float* Xs = red + 1;        // K3 only: X, [r][c]
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const size_t base = (size_t)b * N * N;
  const float mxb = mx[b];
  const float invmx = 1.f / mxb;

  for (int e = tid; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e - r * N;
    As[r * LD + c] = A[base + e];
    Qs[r * LD + c] = r == c ? 1.f : 0.f;
    if (SOLVE) Xs[r * LD + c] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < N; ++j) {
    if (warp == 0) {
      float part = 0.f;
      for (int r = j + 1 + lane; r < N; r += 32) {
        const float x = As[r * LD + j];
        part += x * x;
      }
      part = warp_sum(part);
      if (lane == 0) red[0] = part;
    }
    __syncthreads();
    const float alpha = As[j * LD + j];
    const float sigma = red[0];
    const float normx = sqrtf(alpha * alpha + sigma);
    const float s = alpha >= 0.f ? 1.f : -1.f;
    const float vj = alpha + s * normx;
    const float vtv = sigma + vj * vj;
    const float tau = vtv >= FLT_MIN ? 2.f / vtv : 0.f;
    for (int r = j + tid; r < N; r += blockDim.x)
      v[r] = r == j ? vj : As[r * LD + j];
    __syncthreads();

    // H = I - tau v v^T applied to the trailing columns c > j (columns < j
    // have zero tails, column j is finalized below) and accumulated into Q
    for (int c = j + 1 + warp; c < N; c += nwarps) {
      float part = 0.f;
      for (int r = j + lane; r < N; r += 32) part += As[r * LD + c] * v[r];
      const float tw = tau * warp_sum(part);
      for (int r = j + lane; r < N; r += 32) As[r * LD + c] -= tw * v[r];
    }
    for (int r = warp; r < N; r += nwarps) {
      float part = 0.f;
      for (int k = j + lane; k < N; k += 32) part += Qs[r * LD + k] * v[k];
      const float tw = tau * warp_sum(part);
      for (int k = j + lane; k < N; k += 32) Qs[r * LD + k] -= tw * v[k];
    }
    const float rjj = -s * normx;
    const float absr = fabsf(rjj);
    const float rjj_eff = absr < kFloor ? kFloor : rjj;
    for (int r = j + tid; r < N; r += blockDim.x)
      As[r * LD + j] = r == j ? rjj_eff : 0.f;
    if (!SOLVE && tid == 0) {
      const float dj = fmaxf(absr, kFloor);
      dsub[j] = dj;
      d_out[(size_t)b * N + j] = dj * mxb;
    }
    __syncthreads();

    if (SOLVE) {
      // X R = Z / mx, column j: X[:, j] = (Z[:, j] / mx - ACC_j) / R_jj
      for (int r = tid; r < N; r += blockDim.x)
        v[r] = (Z[base + (size_t)r * N + j] * invmx - Xs[r * LD + j]) / rjj_eff;
      __syncthreads();
      const int w = N - j;
      for (int e = tid; e < N * w; e += blockDim.x) {
        const int r = e / w, c = j + (e - r * w);
        if (c == j)
          Xs[r * LD + j] = v[r];
        else
          Xs[r * LD + c] += As[j * LD + c] * v[r];
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e - r * N;
    Q_out[base + e] = Qs[r * LD + c];
    if (SOLVE)
      X_out[base + e] = Xs[r * LD + c];
    else
      Rs_out[base + e] = As[r * LD + c] / dsub[r];
  }
}

template <bool SOLVE>
int launch(const float* A, const float* Z, const float* mx, float* Q,
           float* Rs, float* d, float* X, int B, int N, cudaStream_t stream) {
  if (B == 0) return 0;
  if (N < 8 || N > 64 || N % 8) return (int)cudaErrorInvalidValue;
  const int mats = SOLVE ? 3 : 2;
  const size_t smem = (size_t)(mats * N * (N + 1) + 2 * N + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      udt_kernel<SOLVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  udt_kernel<SOLVE><<<B, kThreads, smem, stream>>>(A, Z, mx, Q, Rs, d, X, N);
  return (int)cudaGetLastError();
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
