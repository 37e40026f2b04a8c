// Complex64 Householder QR (kernel K10), 8 | N <= 128.
//
// Replaces montecarlo_tpu/ops/pallas_qr.py::_qr_kernel_cx (reached through
// _qr_batched_cx / qr_lanes_cx / maybe_qr for complex64 at 8 | N <= 128).
// The plain PyTorch version with the same algorithm is
// montecarlo_tpu_torch/ops/qr_cx.py::qr_cx_backward_plain.
//
// Input: A (B, N, N) complex64 row-major (interleaved re, im); the caller
// prescales and pivots it (ops/linalg.py::udt_dirty). Output: Q, R with
// A = Q R, Q unitary, R upper triangular with exact zeros below the
// diagonal. Column by column, the zgeqrf reflector up to the phase of the
// diagonal (udt_dirty takes |R_jj|, so the phase is free):
//   alpha = x_j, phase = alpha / |alpha| (1 if alpha = 0),
//   v = x on the tail, v_j = alpha + phase * ||x||,
//   tau = 2 / (v^H v) (real), H = I - tau v v^H,  R_jj = -phase * ||x||.
//   trailing columns: a -= (tau * (v^H a)) * v  (tau folded into the dot
//   first: v^H a can reach ~1e30 on prescaled graded columns and its
//   product with v would overflow float32);  then Q = H_0 (H_1 (... (H_{N-1}
//   I))), formed backward from the stored reflectors.
// A reflector with v^H v below FLT_MIN gets tau = 0, as a zero tail does.
// The TPU kernel sets tau = 2 / v^H v for any v^H v > 0 and relies on the TPU
// flushing subnormals to zero; CUDA keeps them (this file is built without
// -ftz), where 2 / v^H v would be inf and fill the matrix with NaN.
//
// What bounds it: each of the 2N column steps is O(N^2) complex
// shared-memory work (a reflector applied to the trailing columns of A, then
// of Q), separated by barriers; at N = 64 the factorization is ~3.5 MFLOP per matrix, so the
// kernel is bound by barrier latency and shared-memory bandwidth inside one
// block, not by FLOPs or device memory (A read once, Q and R written once).
// With one block per matrix, 256 matrices give ~2 blocks per SM.
//
// Design: K2's (csrc/udt_qr.cu) in complex. One 256-thread block per matrix;
// A transposed (each column contiguous, becoming R) as float2 in dynamic
// shared memory for all N steps, with the leading dimension padded to N+1.
// Per column: one warp reduces the tail norm; each warp then owns whole
// trailing columns (dot with conj(v) and update, reduced with warp shuffles,
// no barrier between them); the reflector's own column is finalized in the
// same phase. Q is formed backward: A and Q of one matrix at N = 128 would
// take 2 x 129 KB, more than the 227 KB a block may use, so the column steps
// keep only the reflectors, packed column by column (v_j..v_{N-1} of
// reflector j, 64.5 KB at N = 128), and tau; R is written out, and Q = H_0
// (H_1 (... (H_{N-1} I))) is formed in A's place (each column contiguous),
// step j touching only the trailing block Q[j:, j:] (Q is the identity
// elsewhere), each warp applying H_j to whole columns: 194 KB at N = 128,
// 50 KB at N = 64. The TPU kernel accumulates Q forward in the column steps
// (Q <- Q H_j); both give the same Q up to rounding, and rounding turns the
// phase of a small alpha, so factorizations are compared phase-normalized
// (ops/qr_cx.py::phase_normalized).
// The TPU kernel's two-plane chain-on-lanes layout and grid-as-column-loop
// are Mosaic workarounds and are not carried over.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Offset of reflector j in the packed reflector store: column j holds
// v_j..v_{N-1} (N - j entries).
__device__ __forceinline__ int packed(int j, int N) {
  return j * N - j * (j - 1) / 2;
}

// a[j..N-1] -= (tau * (v^H a)) * v over the rows r >= j, by one warp
__device__ __forceinline__ void reflect(float2* a, const float2* v, float tau,
                                        int j, int N, int lane) {
  float wr = 0.f, wi = 0.f;
  for (int r = j + lane; r < N; r += 32) {
    const float2 vr = v[r], ar = a[r];
    wr += vr.x * ar.x + vr.y * ar.y;
    wi += vr.x * ar.y - vr.y * ar.x;
  }
  const float twr = tau * warp_sum(wr), twi = tau * warp_sum(wi);
  for (int r = j + lane; r < N; r += 32) {
    const float2 vr = v[r];
    a[r].x -= twr * vr.x - twi * vr.y;
    a[r].y -= twr * vr.y + twi * vr.x;
  }
}

__global__ void __launch_bounds__(kThreads)
qr_cx_kernel(const float2* __restrict__ A, float2* __restrict__ Q_out,
             float2* __restrict__ R_out, int N) {
  extern __shared__ float2 smem2[];
  const int LD = N + 1;
  float2* At = smem2;          // A -> R transposed: A[r, c] at c*LD + r
  float2* vstore = At + N * LD;              // the packed reflectors
  float* taus = (float*)(vstore + packed(N, N));
  float* red = taus + N;       // tail norm^2 of the current column
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const size_t base = (size_t)b * N * N;

  for (int e = tid; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e - r * N;
    At[c * LD + r] = A[base + e];
  }
  __syncthreads();

  for (int j = 0; j < N; ++j) {
    const float2* x = At + j * LD;
    if (warp == 0) {
      float part = 0.f;
      for (int r = j + 1 + lane; r < N; r += 32)
        part += x[r].x * x[r].x + x[r].y * x[r].y;
      part = warp_sum(part);
      if (lane == 0) red[0] = part;
    }
    __syncthreads();
    const float2 alpha = x[j];
    const float sigma = red[0];
    const float amag2 = alpha.x * alpha.x + alpha.y * alpha.y;
    const float normx = sqrtf(amag2 + sigma);
    const float amag = sqrtf(amag2);
    const float ph_r = amag > 0.f ? alpha.x / amag : 1.f;
    const float ph_i = amag > 0.f ? alpha.y / amag : 0.f;
    const float2 vj = make_float2(alpha.x + ph_r * normx,
                                  alpha.y + ph_i * normx);
    const float vtv = sigma + vj.x * vj.x + vj.y * vj.y;
    const float tau = vtv >= FLT_MIN ? 2.f / vtv : 0.f;
    // v[r] for the rows r >= j
    float2* v = vstore + packed(j, N) - j;
    for (int r = j + tid; r < N; r += blockDim.x) v[r] = r == j ? vj : x[r];
    if (tid == 0) taus[j] = tau;
    __syncthreads();

    // H = I - tau v v^H on the trailing columns c > j (columns < j have zero
    // tails, column j is finalized below)
    for (int c = j + 1 + warp; c < N; c += nwarps)
      reflect(At + c * LD, v, tau, j, N, lane);
    for (int r = j + tid; r < N; r += blockDim.x)
      At[j * LD + r] = r == j ? make_float2(-(ph_r * normx), -(ph_i * normx))
                              : make_float2(0.f, 0.f);
    __syncthreads();
  }

  for (int e = tid; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e - r * N;
    R_out[base + e] = At[c * LD + r];
  }

  // Q = H_0 (H_1 (... (H_{N-1} I))) in A's place, each column contiguous
  // (Q[r, c] at c*LD + r); step j changes only Q[j:, j:]
  float2* Qt = At;
  __syncthreads();
  for (int e = tid; e < N * N; e += blockDim.x) {
    const int c = e / N, r = e - c * N;
    Qt[c * LD + r] = make_float2(r == c ? 1.f : 0.f, 0.f);
  }
  __syncthreads();
  for (int j = N - 1; j >= 0; --j) {
    const float2* v = vstore + packed(j, N) - j;
    for (int c = j + warp; c < N; c += nwarps)
      reflect(Qt + c * LD, v, taus[j], j, N, lane);
    __syncthreads();
  }
  for (int e = tid; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e - r * N;
    Q_out[base + e] = Qt[c * LD + r];
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). A, Q, R complex64
// (B, N, N) row-major, 8 | N <= 128.
extern "C" int qr_cx_c64(const void* A, void* Q, void* R, int B, int N,
                         void* stream) {
  if (B == 0) return 0;
  if (N < 8 || N > 128 || N % 8) return (int)cudaErrorInvalidValue;
  // A (Q later in its place), the packed reflectors, tau and the tail norm
  const size_t smem = (size_t)(N * (N + 1) + N * (N + 1) / 2) * sizeof(float2)
                      + (N + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qr_cx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_cx_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)A, (float2*)Q, (float2*)R, N);
  return (int)cudaGetLastError();
}
