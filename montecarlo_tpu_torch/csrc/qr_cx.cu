// Complex64 Householder QR (kernel K10), 8 | N <= 128, as a blocked
// compact-WY factorization.
//
// Replaces montecarlo_tpu/ops/pallas_qr.py::_qr_kernel_cx (reached through
// _qr_batched_cx / qr_lanes_cx / maybe_qr for complex64 at 8 | N <= 128).
// The plain PyTorch version with the same algorithm and blocking is
// montecarlo_tpu_torch/ops/qr_cx.py::qr_cx_blocked_plain.
//
// Input: A (B, N, N) complex64 row-major (interleaved re, im); the caller
// prescales and pivots it (ops/linalg.py::udt_dirty). Output: Q, R with
// A = Q R, Q unitary, R upper triangular with exact zeros below the
// diagonal. Column by column, the zgeqrf reflector up to the phase of the
// diagonal (udt_dirty takes |R_jj|, so the phase is free):
//   alpha = x_j, phase = alpha / |alpha| (1 if alpha = 0),
//   v = x on the tail, v_j = alpha + phase * ||x||,
//   tau = 2 / (v^H v) (real), H = I - tau v v^H,  R_jj = -phase * ||x||.
// A reflector with v^H v below FLT_MIN gets tau = 0, as a zero tail does.
// The TPU kernel sets tau = 2 / v^H v for any v^H v > 0 and relies on the TPU
// flushing subnormals to zero; CUDA keeps them (this file is built without
// -ftz), where 2 / v^H v would be inf and fill the matrix with NaN.
//
// What bounds it: ~11 M real FMAs per matrix at N = 128 (2.8 M at N = 64)
// against 3 N^2 complex words of device traffic, so FP32 issue on one SM;
// one 512-thread block per matrix at N = 128 (A alone is 132 KB of shared
// memory, so one block per SM and 256 matrices take two waves), 256-thread
// blocks, three per SM, at N <= 64.
//
// Design: the columns are taken in panels of KB = 8 (kPanel). Panels of 16
// take 8% less time at (256, 128, 128) on an H100, but the WY form of Q
// rounds more the more reflectors it gathers: with them a complex64 flux
// sweep pair's running phase drifts from the float64 one by twice as much
// as with the unblocked QR (median over 64 chains 1.1e-4 against 3.6e-5;
// 5.5e-5 with panels of 8).
//  - A lives in shared memory, row-major with the row length padded to N+1
//    (a column read by the lanes of a warp falls in distinct banks). The
//    panel is factored in place column by column: warp w owns the panel
//    columns k = w (mod warps); at step k each owner applies H_{k-1} to its
//    columns and the owner of column k then forms reflector k from its
//    updated column (tail norm, v_j, tau, R_jj), so one block barrier
//    separates two column steps. The reflectors stay in A's strict lower
//    part with v_j and tau beside it (LAPACK's storage).
//  - The panel's V is copied to a buffer (zeros above the pivot, v_j on
//    it) as unit reflectors, v / ||v|| = v sqrt(tau / 2) with tau = 2: with
//    the raw v, whose norms span the grading of the columns, T's entries
//    would span its square and the WY form lose accuracy. The Gram matrix
//    V^H V is a register-tiled product, and the forward LARFT T
//    (H_1...H_KB = I - V T V^H, T[:k, k] = -tau_k T[:k, :k] (V[:, :k]^H
//    v_k)) takes one warp whose lane i keeps row i of T in registers, so
//    the recurrence needs no barrier. T is kept per panel.
//  - The trailing columns X = A[j0:, j0+KB:] get A <- (I - V T V^H)^H A as
//    three register-tiled products: W = V^H X (each thread a 4 x 2 tile of
//    W over every eighth row, the eight partial sums of a tile reduced with
//    warp shuffles), Z = T^H W (one thread per column, in place), and
//    X -= V Z (each thread a 4-row x 2-column tile of X, so a shared-memory
//    load of V or Z feeds 2 or 4 complex FMAs).
//  - R is written out. Q is formed backward by panels in A's place, last
//    panel first: the panel's V is copied out of A's lower part, its
//    columns set to the identity, and Q[j0:, j0:] <- (I - V T V^H)
//    Q[j0:, j0:] with the same three products (Z = T W).
// Plain FP32 FMAs: no tensor cores (their FP32 input is TF32), no library.
// The TPU kernel accumulates Q forward column by column; both give the same
// Q up to rounding, and rounding turns the phase of a small alpha, so
// factorizations are compared phase-normalized (ops/qr_cx.py::
// phase_normalized). The TPU kernel's two-plane chain-on-lanes layout and
// grid-as-column-loop are Mosaic workarounds and are not carried over.

#include <cfloat>

#include <cuda_runtime.h>

#include "phase_clock.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPanel = 8;  // KB, ops/qr_cx.py::PANEL

#ifdef MC_PHASE_STAMPS
// phases: 0 load, 1 panel column steps, 2 V, Gram and T, 3 trailing update,
// 4 store R, 5 form Q, 6 store Q
__device__ long long g_stamps[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// acc += conj(a) * b
__device__ __forceinline__ void cfma_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
}

// acc += a * b
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// acc -= a * b
__device__ __forceinline__ void cfms(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(-a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(-a.x, b.y, fmaf(-a.y, b.x, acc.y));
}

// Shared memory of one block, in float2 words: A (N rows of N + 1), T of
// every panel, W (KB x N), V (N rows of KB + 1), the KB x KB Gram matrix,
// v_j of every column, then tau (N floats, counted as N / 2 words).
__host__ __device__ inline int smem_words(int N, int KB) {
  return N * (N + 1) + N * KB + KB * N + N * (KB + 1) + KB * KB + N + N / 2;
}

// W[k][c] = sum_{r >= j0} conj(V[r][k]) X[r][x0 + c] for k < KB, c < nt
// (nt even): a 4 (k) x 2 (column) tile per eight lanes, lane & 7 taking
// every eighth row, the eight partial sums reduced by warp shuffles. V:
// rows of KB + 1 (absolute row index), X: rows of ldx, W: rows of ldw.
template <int KB, int THREADS>
__device__ void vh_x(const float2* __restrict__ Vb, const float2* X, int ldx,
                     int x0, int nt, int j0, int N, float2* W, int ldw) {
  constexpr int KBP = KB + 1, NKT = KB / 4;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nct = nt / 2, tiles = NKT * nct;
  const int rg = lane & 7, slot = tid >> 3;
  for (int base = 0; base < tiles; base += THREADS / 8) {
    const int tile = base + slot;
    const bool valid = tile < tiles;
    const int kt = valid ? tile / nct : 0, ct = valid ? tile % nct : 0;
    const int k0 = 4 * kt, cc = x0 + 2 * ct;
    float2 acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = make_float2(0.f, 0.f);
    if (valid)
#pragma unroll 4
      for (int r = j0 + rg; r < N; r += 8) {
        const float2* vr = Vb + r * KBP + k0;
        const float2 x0v = X[r * ldx + cc], x1v = X[r * ldx + cc + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = vr[i];
          cfma_conj(acc[i][0], v, x0v);
          cfma_conj(acc[i][1], v, x1v);
        }
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          acc[i][s].x += __shfl_xor_sync(kFull, acc[i][s].x, off);
          acc[i][s].y += __shfl_xor_sync(kFull, acc[i][s].y, off);
        }
    if (valid && rg == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        W[(k0 + i) * ldw + 2 * ct] = acc[i][0];
        W[(k0 + i) * ldw + 2 * ct + 1] = acc[i][1];
      }
  }
}

// X -= V op(T) V^H X on the rows [j0, N) and columns [c0, N) of A (row
// stride LD), op(T) = T^H (TRANS: the trailing update of the factorization)
// or T (forming Q). V: rows of KB + 1 in Vb (absolute row index), T: KB x
// KB row-major, W: KB rows of N.
template <int KB, int THREADS, bool TRANS>
__device__ void apply_block(float2* As, int LD, int N, int j0, int c0,
                            const float2* __restrict__ Vb,
                            const float2* __restrict__ T, float2* W) {
  constexpr int KBP = KB + 1;
  const int tid = threadIdx.x;
  const int nt = N - c0, m = N - j0;
  vh_x<KB, THREADS>(Vb, As, LD, c0, nt, j0, N, W, N);
  __syncthreads();
  // ---- Z = op(T) W in place, one thread per column
  for (int c = tid; c < nt; c += THREADS) {
    float2 w[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) w[k] = W[k * N + c];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      float2 z = make_float2(0.f, 0.f);
      if (TRANS) {  // Z[k] = sum_{i <= k} conj(T[i][k]) W[i]
#pragma unroll
        for (int i = 0; i <= k; ++i) cfma_conj(z, T[i * KB + k], w[i]);
      } else {      // Z[k] = sum_{i >= k} T[k][i] W[i]
#pragma unroll
        for (int i = k; i < KB; ++i) cfma(z, T[k * KB + i], w[i]);
      }
      W[k * N + c] = z;
    }
  }
  __syncthreads();
  // ---- X -= V Z: a tile of rows r0 + i * RS (i < 4) by 2 columns per
  // thread (consecutive threads on consecutive rows)
  {
    const int RS = m / 4, nct = nt / 2, tiles = RS * nct;
    for (int tile = tid; tile < tiles; tile += THREADS) {
      const int rl = tile % RS, ct = tile / RS;
      const int cc = c0 + 2 * ct;
      float2 x[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = j0 + rl + i * RS;
        x[i][0] = As[r * LD + cc];
        x[i][1] = As[r * LD + cc + 1];
      }
#pragma unroll 4
      for (int k = 0; k < KB; ++k) {
        const float4 z = *reinterpret_cast<const float4*>(W + k * N + 2 * ct);
        const float2 z0 = make_float2(z.x, z.y), z1 = make_float2(z.z, z.w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = Vb[(j0 + rl + i * RS) * KBP + k];
          cfms(x[i][0], v, z0);
          cfms(x[i][1], v, z1);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = j0 + rl + i * RS;
        As[r * LD + cc] = x[i][0];
        As[r * LD + cc + 1] = x[i][1];
      }
    }
  }
  __syncthreads();
}

// Vb[r][k] = v_{j0+k}[r] / ||v_{j0+k}|| for the rows r >= j0: zero above
// the pivot, v_j on it, A's lower part below it, times sqrt(tau / 2) (0
// where tau = 0): unit reflectors, H = I - 2 v v^H, keep T well scaled.
template <int KB, int THREADS>
__device__ void copy_v(const float2* As, int LD, int N, int j0,
                       const float2* vj, const float* taus, float2* Vb) {
  for (int e = threadIdx.x; e < (N - j0) * KB; e += THREADS) {
    const int r = j0 + e / KB, k = e % KB, j = j0 + k;
    const float2 v = r < j ? make_float2(0.f, 0.f)
                           : r == j ? vj[j] : As[r * LD + j];
    const float sc = sqrtf(0.5f * taus[j]);
    Vb[r * (KB + 1) + k] = make_float2(v.x * sc, v.y * sc);
  }
}

template <int KB, int THREADS>
__global__ void __launch_bounds__(THREADS)
qr_cx_kernel(const float2* __restrict__ A, float2* __restrict__ Q_out,
             float2* __restrict__ R_out, int N) {
  extern __shared__ __align__(16) float2 smem2[];
  constexpr int NW = THREADS / 32, CPW = (KB + NW - 1) / NW;
  const int LD = N + 1;
  float2* As = smem2;                  // A[r][c] at r * LD + c
  float2* Ts = As + N * LD;            // T of panel p at p * KB * KB
  float2* W = Ts + N * KB;             // [k][c]
  float2* Vb = W + KB * N;             // [r][k], rows of KB + 1
  float2* Gm = Vb + N * (KB + 1);      // [m][n]
  float2* vj = Gm + KB * KB;           // v_j of every column
  float* taus = reinterpret_cast<float*>(vj + N);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)b * N * N;
  phase_clock::Clock clk;
  if (tid == 0) clk.start();

  for (int e = tid; e < N * N; e += THREADS) {
    const int r = e / N, c = e - r * N;
    As[r * LD + c] = A[base + e];
  }
  __syncthreads();
  if (tid == 0) clk.lap(0);

  for (int j0 = 0; j0 < N; j0 += KB) {
    // ---- panel: one barrier per column step; each warp keeps its panel
    // columns' rows j0 + lane + 32 i in registers
    float2 a[CPW][4];
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = j0 + warp + q * NW;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = j0 + lane + 32 * i;
        a[q][i] = c < j0 + KB && r < N ? As[r * LD + c]
                                       : make_float2(0.f, 0.f);
      }
    }
    for (int k = 0; k < KB; ++k) {
      const int j = j0 + k;
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        const int kc = warp + q * NW;
        if (kc < k || kc >= KB) continue;
        if (k > 0) {  // H_{j-1} on this column, rows j-1..N-1
          const int jp = j - 1;
          const float t = taus[jp];
          float2 v[4];
          float wr = 0.f, wi = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = j0 + lane + 32 * i;
            v[i] = r == jp ? vj[jp]
                 : r > jp && r < N ? As[r * LD + jp] : make_float2(0.f, 0.f);
            wr += v[i].x * a[q][i].x + v[i].y * a[q][i].y;
            wi += v[i].x * a[q][i].y - v[i].y * a[q][i].x;
          }
          const float twr = t * warp_sum(wr), twi = t * warp_sum(wi);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[q][i].x -= twr * v[i].x - twi * v[i].y;
            a[q][i].y -= twr * v[i].y + twi * v[i].x;
          }
        }
        if (kc == k) {  // reflector j from the updated column j
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (j0 + lane + 32 * i > j)
              part += a[q][i].x * a[q][i].x + a[q][i].y * a[q][i].y;
          const float sigma = warp_sum(part);
          // row j = j0 + k is lane k's first register (k < KB <= 32)
          const float2 alpha = make_float2(__shfl_sync(kFull, a[q][0].x, k),
                                           __shfl_sync(kFull, a[q][0].y, k));
          const float amag2 = alpha.x * alpha.x + alpha.y * alpha.y;
          const float normx = sqrtf(amag2 + sigma);
          const float amag = sqrtf(amag2);
          const float ph_r = amag > 0.f ? alpha.x / amag : 1.f;
          const float ph_i = amag > 0.f ? alpha.y / amag : 0.f;
          const float2 v0 = make_float2(alpha.x + ph_r * normx,
                                        alpha.y + ph_i * normx);
          const float vtv = sigma + v0.x * v0.x + v0.y * v0.y;
          if (lane == k)
            a[q][0] = make_float2(-(ph_r * normx), -(ph_i * normx));
          // the finished column: R above and on the diagonal, v's tail below
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = j0 + lane + 32 * i;
            if (r < N) As[r * LD + j] = a[q][i];
          }
          if (lane == 0) {
            vj[j] = v0;
            taus[j] = vtv >= FLT_MIN ? 2.f / vtv : 0.f;
          }
        }
      }
      __syncthreads();
    }
    if (tid == 0) clk.lap(1);

    // ---- V, its Gram matrix V^H V and T
    copy_v<KB, THREADS>(As, LD, N, j0, vj, taus, Vb);
    __syncthreads();
    vh_x<KB, THREADS>(Vb, Vb, KB + 1, 0, KB, j0, N, Gm, KB);
    __syncthreads();
    if (warp == 0) {
      // lane i keeps row i of T: T[i][n] = -tau_n sum_{m<n} T[i][m] G[m][n],
      // tau_n = 2 (0 where the reflector is the identity) for the unit V
      const int i = lane;
      float2 t[KB];
#pragma unroll
      for (int n = 0; n < KB; ++n)
        t[n] = make_float2(n == i && taus[j0 + n] > 0.f ? 2.f : 0.f, 0.f);
#pragma unroll
      for (int n = 1; n < KB; ++n) {
        float2 acc[4] = {};
#pragma unroll
        for (int mm = 0; mm < n; ++mm)
          cfma(acc[mm & 3], t[mm], Gm[mm * KB + n]);
        const float tn = taus[j0 + n] > 0.f ? 2.f : 0.f;
        const float ar = (acc[0].x + acc[1].x) + (acc[2].x + acc[3].x);
        const float ai = (acc[0].y + acc[1].y) + (acc[2].y + acc[3].y);
        if (n > i) t[n] = make_float2(-tn * ar, -tn * ai);
      }
      if (i < KB) {
        float2* Tp = Ts + j0 * KB + i * KB;
#pragma unroll
        for (int n = 0; n < KB; ++n) Tp[n] = t[n];
      }
    }
    __syncthreads();
    if (tid == 0) clk.lap(2);

    // ---- A <- (I - V T V^H)^H A on the trailing columns
    if (j0 + KB < N)
      apply_block<KB, THREADS, true>(As, LD, N, j0, j0 + KB, Vb, Ts + j0 * KB,
                                     W);
    if (tid == 0) clk.lap(3);
  }

  for (int e = tid; e < N * N; e += THREADS) {
    const int r = e / N, c = e - r * N;
    R_out[base + e] = c >= r ? As[r * LD + c] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  if (tid == 0) clk.lap(4);

  // ---- Q = Hb_0 (Hb_1 (... (Hb_last I))) in A's place, by panels
  for (int j0 = N - KB; j0 >= 0; j0 -= KB) {
    copy_v<KB, THREADS>(As, LD, N, j0, vj, taus, Vb);
    __syncthreads();
    for (int e = tid; e < N * KB; e += THREADS) {
      const int r = e / KB, c = j0 + e % KB;
      As[r * LD + c] = make_float2(r == c ? 1.f : 0.f, 0.f);
    }
    __syncthreads();
    apply_block<KB, THREADS, false>(As, LD, N, j0, j0, Vb, Ts + j0 * KB, W);
  }
  if (tid == 0) clk.lap(5);
  for (int e = tid; e < N * N; e += THREADS) {
    const int r = e / N, c = e - r * N;
    Q_out[base + e] = As[r * LD + c];
  }
  if (tid == 0) clk.lap(6);
#ifdef MC_PHASE_STAMPS
  if (tid == 0) clk.store(g_stamps, b);
#endif
}

template <int KB, int THREADS>
int launch(const float2* A, float2* Q, float2* R, int B, int N,
           cudaStream_t stream) {
  const size_t smem = (size_t)smem_words(N, KB) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      qr_cx_kernel<KB, THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_cx_kernel<KB, THREADS><<<B, THREADS, smem, stream>>>(A, Q, R, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). A, Q, R complex64
// (B, N, N) row-major, 8 | N <= 128. KB, the panel width the caller's plain
// version uses (ops/qr_cx.py::PANEL), must be kPanel; 512 threads per
// matrix past N = 64, 256 up to it.
extern "C" int qr_cx_c64(const void* A, void* Q, void* R, int B, int N,
                         int KB, void* stream) {
  if (KB != kPanel || N < 8 || N > 128 || N % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const float2* a = (const float2*)A;
  float2 *q = (float2*)Q, *r = (float2*)R;
  cudaStream_t st = (cudaStream_t)stream;
  return N > 64 ? launch<kPanel, 512>(a, q, r, B, N, st)
                : launch<kPanel, 256>(a, q, r, B, N, st);
}

// Phase stamps of the last launch's first n_blocks blocks (kPhases cycle
// sums each) into dst on the host: a build with -DMC_PHASE_STAMPS only.
extern "C" int qr_cx_c64_stamps(void* dst, int n_blocks, void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
