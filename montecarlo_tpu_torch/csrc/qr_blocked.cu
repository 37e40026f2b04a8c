// Blocked compact-WY Householder QR for N > 128 (kernel K7).
//
// Replaces montecarlo_tpu/ops/pallas_qr.py::_qr_mxu_kernel (reached through
// _qr_batched_mxu_chunk / qr_lanes_mxu). The plain PyTorch version with the
// same algorithm and blocking is
// montecarlo_tpu_torch/ops/qr_blocked.py::qr_blocked_plain.
//
// Input A (B, N, N) row-major; outputs Q and R (B, N, N) row-major and a
// work buffer (B, N, N) that holds A^T while it is factored. Conventions of
// the TPU kernel: LAPACK signs, tau = 0 when v.v is zero, exact zero fill
// below the diagonal, no floor. A reflector whose v.v is below FLT_MIN gets
// tau = 0 as well: the TPU flushes such subnormals to zero, while CUDA keeps
// them (this file is built without -ftz) and 2 / v.v would overflow to inf.
//
// What bounds it: at N = 256, A and Q are 256 KB each and do not fit one
// block's 227 KB of shared memory, so they live in global memory (L2 at 64
// matrices: 32 MB). Column by column, Householder QR would pass over the
// trailing matrix and Q once per column; the compact-WY form passes over
// them once per panel of KB columns, cutting that traffic by KB, and turns
// the update into 4 * KB FP32 operations per element and panel. The N
// sequential column steps of each panel factorization, with their
// barriers, set the floor underneath.
//
// Design: one block of 512 threads per matrix. A is transposed into the
// work buffer first, so every column of A -- and every row of Q -- is a
// contiguous vector. Per panel of KB columns (KB = 32 where 32 | N, else 16
// or 8): the panel (KB x N) is loaded into shared memory and factored there
// column by column (one warp reduces the tail norm, one warp per later
// panel column applies the reflector); its reflectors V and the forward-
// LARFT T (H_1...H_KB = I - V T V^T, from the Gram matrix V V^T) stay in
// shared memory. Then each warp takes whole vectors x -- the trailing
// columns of A and the rows of Q -- and applies x -= V^T-form in registers:
// y = V x (KB warp reductions), z = T^T y (lane n computes z_n), x -= V^T z.
// Both updates are that one formula: A <- (I - V T V^T)^T A column by
// column, Q <- Q (I - V T V^T) row by row. FP32 loops in the kernel: no
// tensor cores and no cuBLAS. R is the work buffer transposed back; its
// entries below the diagonal are the exact zeros of the fill. The TPU
// kernel's chains-on-sublanes layout, per-chain dot loops and KB0 = 16 base
// panels merged into KB = 64 are Mosaic workarounds and are not carried over.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// dst[c * N + r] = src[r * N + c] through 32 x 33 shared tiles (512 threads)
__device__ void transpose(const float* __restrict__ src,
                          float* __restrict__ dst, int N, float* tile) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r0 = 0; r0 < N; r0 += 32)
    for (int c0 = 0; c0 < N; c0 += 32) {
      for (int y = ty; y < 32; y += kThreads / 32)
        if (r0 + y < N && c0 + tx < N)
          tile[y * 33 + tx] = src[(size_t)(r0 + y) * N + c0 + tx];
      __syncthreads();
      for (int y = ty; y < 32; y += kThreads / 32)
        if (c0 + y < N && r0 + tx < N)
          dst[(size_t)(c0 + y) * N + r0 + tx] = tile[tx * 33 + y];
      __syncthreads();
    }
}

// x[lo:N] -= V^T (T^T (V x[lo:N])) for one vector x, by one warp.
// V: KB x N (row m = reflector m, zero below its pivot), T: KB x KB.
template <int KB>
__device__ void apply_wy(float* __restrict__ x, int lo, int N,
                         const float* __restrict__ V,
                         const float* __restrict__ T, int lane) {
  float y[KB];
#pragma unroll
  for (int m = 0; m < KB; ++m) y[m] = 0.f;
  for (int r = lo + lane; r < N; r += 32) {
    const float xr = x[r];
#pragma unroll
    for (int m = 0; m < KB; ++m) y[m] = fmaf(xr, V[m * N + r], y[m]);
  }
#pragma unroll
  for (int m = 0; m < KB; ++m) y[m] = warp_sum(y[m]);
  float z = 0.f;
  if (lane < KB) {
#pragma unroll
    for (int m = 0; m < KB; ++m) z = fmaf(T[m * KB + lane], y[m], z);
  }
#pragma unroll
  for (int n = 0; n < KB; ++n) y[n] = __shfl_sync(kFull, z, n);
  for (int r = lo + lane; r < N; r += 32) {
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < KB; ++n) acc = fmaf(V[n * N + r], y[n], acc);
    x[r] -= acc;
  }
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
qr_blocked_kernel(const float* __restrict__ A, float* __restrict__ Q,
                  float* __restrict__ R, float* __restrict__ work, int N) {
  extern __shared__ float smem[];
  float* P = smem;             // [k][r]: the panel's columns
  float* V = P + KB * N;       // [k][r]: its reflectors
  float* T = V + KB * N;       // [m][n]: compact-WY T, upper triangular
  float* Gm = T + KB * KB;     // [m][n]: V V^T
  float* tau = Gm + KB * KB;   // [k]
  float* red = tau + KB;       // tail norm^2 of the current column
  float* tile = red + 1;       // 32 x 33 transpose tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const size_t base = (size_t)blockIdx.x * N * N;
  float* W = work + base;      // W[c * N + r] = A[r][c], factored in place
  float* Qb = Q + base;

  transpose(A + base, W, N, tile);
  for (int e = tid; e < N * N; e += kThreads) {
    const int r = e / N;
    Qb[e] = r == e - r * N ? 1.f : 0.f;
  }

  for (int j0 = 0; j0 < N; j0 += KB) {
    for (int e = tid; e < KB * N; e += kThreads) {
      P[e] = W[(size_t)j0 * N + e];
      V[e] = 0.f;
    }
    __syncthreads();

    // ---- panel factorization, column by column
    for (int k = 0; k < KB; ++k) {
      const int j = j0 + k;
      if (warp == 0) {
        float part = 0.f;
        for (int r = j + 1 + lane; r < N; r += 32) {
          const float x = P[k * N + r];
          part += x * x;
        }
        part = warp_sum(part);
        if (lane == 0) red[0] = part;
      }
      __syncthreads();
      const float alpha = P[k * N + j];
      const float sigma = red[0];
      const float normx = sqrtf(alpha * alpha + sigma);
      const float s = alpha >= 0.f ? 1.f : -1.f;
      const float vj = alpha + s * normx;
      const float vtv = sigma + vj * vj;
      const float tk = vtv >= FLT_MIN ? 2.f / vtv : 0.f;
      for (int r = j + tid; r < N; r += kThreads)
        V[k * N + r] = r == j ? vj : P[k * N + r];
      if (tid == 0) tau[k] = tk;
      __syncthreads();
      // the panel's later columns c: P[c] -= (tau * (P[c] . v)) * v
      for (int c = k + 1 + warp; c < KB; c += nwarps) {
        float part = 0.f;
        for (int r = j + lane; r < N; r += 32)
          part += P[c * N + r] * V[k * N + r];
        const float tw = tk * warp_sum(part);
        for (int r = j + lane; r < N; r += 32) P[c * N + r] -= tw * V[k * N + r];
      }
      for (int r = j + tid; r < N; r += kThreads)
        P[k * N + r] = r == j ? -s * normx : 0.f;
      __syncthreads();
    }

    // ---- forward LARFT: T[:k, k] = -tau_k T[:k, :k] (V[:k] . v_k)
    for (int p = warp; p < KB * KB; p += nwarps) {
      const int m = p / KB, n = p - m * KB;
      float part = 0.f;
      for (int r = j0 + lane; r < N; r += 32) part += V[m * N + r] * V[n * N + r];
      part = warp_sum(part);
      if (lane == 0) {
        Gm[p] = part;
        T[p] = m == n ? tau[m] : 0.f;
      }
    }
    __syncthreads();
    for (int k = 1; k < KB; ++k) {
      if (tid < k) {
        float acc = 0.f;
        for (int m = tid; m < k; ++m) acc += T[tid * KB + m] * Gm[m * KB + k];
        T[tid * KB + k] = -tau[k] * acc;
      }
      __syncthreads();
    }

    // ---- the panel back to W; trailing columns of A and all rows of Q
    for (int e = tid; e < KB * N; e += kThreads) W[(size_t)j0 * N + e] = P[e];
    const int ntrail = N - j0 - KB;
    for (int v = warp; v < ntrail + N; v += nwarps) {
      float* x = v < ntrail ? W + (size_t)(j0 + KB + v) * N
                            : Qb + (size_t)(v - ntrail) * N;
      apply_wy<KB>(x, j0, N, V, T, lane);
    }
    __syncthreads();
  }

  transpose(W, R + base, N, tile);
}

template <int KB>
int launch(const float* A, float* Q, float* R, float* work, int B, int N,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * KB * N + 2 * KB * KB + KB + 1 + 32 * 33) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qr_blocked_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_blocked_kernel<KB><<<B, kThreads, smem, stream>>>(A, Q, R, work, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). 8 | N; the panel
// width KB is 32 where 32 | N, else 16 where 16 | N, else 8.
extern "C" int qr_blocked_f32(const float* A, float* Q, float* R, float* work,
                              int B, int N, void* stream) {
  if (B == 0) return 0;
  if (N < 8 || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N % 32 == 0) return launch<32>(A, Q, R, work, B, N, st);
  if (N % 16 == 0) return launch<16>(A, Q, R, work, B, N, st);
  return launch<8>(A, Q, R, work, B, N, st);
}
