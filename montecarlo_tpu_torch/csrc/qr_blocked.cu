// Blocked compact-WY Householder QR for N > 128 (kernel K7), one
// thread-block cluster per matrix.
//
// Replaces montecarlo_tpu/ops/pallas_qr.py::_qr_mxu_kernel (reached through
// _qr_batched_mxu_chunk / qr_lanes_mxu). The plain PyTorch version with the
// same algorithm and blocking is
// montecarlo_tpu_torch/ops/qr_blocked.py::qr_blocked_plain.
//
// Input A (B, N, N) row-major; outputs Q and R (B, N, N) row-major and a
// work buffer (B, N * (N + KB)) that holds each panel's reflectors V and T.
// Conventions of the TPU kernel: LAPACK signs, tau = 0 when v.v is zero,
// exact zero fill below the diagonal, no floor. A reflector whose v.v is
// below FLT_MIN gets tau = 0 as well: the TPU flushes such subnormals to
// zero, while CUDA keeps them (this file is built without -ftz) and 2 / v.v
// would overflow to inf.
//
// What bounds it: at N = 256 a matrix is 256 KB, so A (factored in place
// in R) and Q live in global memory, in L2 at 64 matrices (48 MB with the
// work buffers); ~24 M FP32 FMAs per matrix (the factorization, Q formed
// backward), so FP32 issue on the SMs that work, and the N sequential
// column steps of the panels, with their barriers, underneath.
//
// Design (ops/qr_blocked.py::cluster_plan picks CS = 2 blocks of 512
// threads per matrix where 2 B fit the SMs, so that 64 matrices keep 128 of
// 132 SMs busy, else 1):
//  - Panels of KB columns (32 where 32 | N, else 16 or 8). Every block of
//    the cluster loads the panel from R into shared memory (rows of KB + 1,
//    so a column read by a warp falls in distinct banks) and factors it
//    itself, identically: warp w owns the panel columns k = w (mod 16); at
//    step k each owner applies H_{k-1} to its columns and the owner of
//    column k forms reflector k from its updated column, one block barrier
//    per column step. The redundant factorization costs no time (the
//    blocks would wait for it) and no exchange of V.
//  - V in place of the panel (zeros above the pivot, v_j on it) as unit
//    reflectors, v / ||v|| = v sqrt(tau / 2) with tau = 2 (with the raw v,
//    whose norms span the grading of the columns, T would span its square),
//    the upper tiles of its Gram matrix V^T V as a register-tiled product,
//    and the forward-LARFT T (H_1...H_KB = I - V T V^T, T[:k, k] = -tau_k
//    T[:k, :k] (V[:, :k]^T v_k)) in one warp whose lane i keeps row i of T
//    in registers. Block p % CS writes the panel's R (zeros below the
//    diagonal) and its V and T to the work buffer. Every block reads the
//    panel from R before the owner overwrites it: a cluster barrier split
//    around the factorization (arrive after the load, wait before R is
//    written) orders the two at no cost.
//  - The trailing columns, in chunks of TC columns (chunk i to block
//    i % CS), get A <- (I - V T V^T)^T A: each chunk X = A[j0:, chunk] is
//    staged from L2 into shared memory with cp.async while the previous one
//    computes (two buffers of rows of TC + 4; past N ~ 1000 at KB = 32,
//    ~1400 at 16 and ~1750 at 8, where two do not fit beside the panel,
//    TC = 4 in one unpadded buffer, staged after the previous chunk), and
//    updated by three register-tiled products:
//    W = V^T X (each thread a 4 x 4 tile over every eighth row, the eight
//    partial sums reduced by warp shuffles), Z = T^T W (a thread per entry)
//    and X -= V Z (each thread 4 rows x 4 columns, so a shared-memory load
//    of V feeds 4 FMAs and a float4 of Z 16). A cluster barrier ends the
//    panel.
//  - Q is formed backward by panels, last panel first, from the identity:
//    Q[j0:, chunk] <- (I - V T V^T) Q[j0:, chunk] with the same chunk loop,
//    V and T read back from the work buffer. A column of Q depends on no
//    other, so each block forms its own chunks with no cluster barrier.
// Plain FP32 FMAs: no tensor cores (their FP32 input is TF32), no library.
// The TPU kernel's chains-on-sublanes layout, per-chain dot loops and
// KB0 = 16 base panels merged into KB = 64 are Mosaic workarounds and are
// not carried over; it accumulates Q forward over all rows.

#include <cfloat>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "phase_clock.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

#ifdef MC_PHASE_STAMPS
// phases: 0 copy A and Q = I, 1 panel load, 2 panel column steps, 3 R out,
// V in place and to the work buffer, 4 trailing update, 5 cluster barriers,
// 6 form Q, 7 Gram and T
__device__ long long g_stamps[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A staged chunk of TC columns: rows of TC + 4 floats (a column that eight
// lanes read at once falls in distinct banks) in two buffers, the next
// chunk staged while one computes; TC = 4 (the largest N): one buffer of
// unpadded rows.
__host__ __device__ constexpr int chunk_pitch(int TC) {
  return TC > 4 ? TC + 4 : TC;
}
__host__ __device__ constexpr int chunk_bufs(int TC) { return TC > 4 ? 2 : 1; }

// Shared memory of one block in floats (ops/qr_blocked.py::_smem_floats):
// the panel / V (N rows of KB + 1), the chunk buffers, W and Z (KB x TC
// each), T and the Gram matrix (KB x KB each), v_j and tau.
__host__ __device__ inline int smem_floats(int N, int KB, int TC) {
  return N * (KB + 1) + chunk_bufs(TC) * N * chunk_pitch(TC) + 2 * KB * TC +
         2 * KB * KB + 2 * KB;
}

template <int CS>
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  if (CS > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The two halves of a cluster barrier, for work that may run between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stage the chunk M[j0:N, cc:cc+TC] (row stride N) into X (rows of
// chunk_pitch(TC), absolute row index) with cp.async.
template <int TC>
__device__ void stage_chunk(float* X, const float* M, int N, int j0, int cc) {
  constexpr int Q4 = TC / 4;
  for (int e = threadIdx.x; e < (N - j0) * Q4; e += kThreads) {
    const int r = j0 + e / Q4, q = e % Q4;
    cp_async16(X + r * chunk_pitch(TC) + 4 * q,
               M + (size_t)r * N + cc + 4 * q);
  }
  cp_async_commit();
}

// X -= V op(T) V^T X on the staged chunk (rows [j0, N)), op(T) = T^T
// (TRANS: the trailing update) or T (forming Q); then the chunk back to
// M[j0:N, cc:cc+TC].
template <int KB, int TC, bool TRANS>
__device__ void apply_chunk(float* X, const float* __restrict__ V,
                            const float* __restrict__ T, float* W, float* Z,
                            float* M, int N, int j0, int cc) {
  constexpr int KBP = KB + 1, TCP = chunk_pitch(TC);
  const int tid = threadIdx.x, lane = tid & 31;
  // ---- W = V^T X: a 4 x 4 tile per eight lanes, lane & 7 taking every
  // eighth row
  {
    constexpr int NCT = TC / 4, TILES = (KB / 4) * NCT;
    const int rg = lane & 7, slot = tid >> 3;
    for (int base = 0; base < TILES; base += kThreads / 8) {
      const int tile = base + slot;
      const bool valid = tile < TILES;
      const int k0 = valid ? 4 * (tile / NCT) : 0;
      const int c0 = valid ? 4 * (tile % NCT) : 0;
      float acc[4][4] = {};
      if (valid)
#pragma unroll 4
        for (int r = j0 + rg; r < N; r += 8) {
          const float* vr = V + r * KBP + k0;
          const float4 x = *reinterpret_cast<const float4*>(X + r * TCP + c0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = vr[i];
            acc[i][0] = fmaf(v, x.x, acc[i][0]);
            acc[i][1] = fmaf(v, x.y, acc[i][1]);
            acc[i][2] = fmaf(v, x.z, acc[i][2]);
            acc[i][3] = fmaf(v, x.w, acc[i][3]);
          }
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            acc[i][s] += __shfl_xor_sync(kFull, acc[i][s], off);
      if (valid && rg == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(W + (k0 + i) * TC + c0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  // ---- Z = op(T) W, a thread per entry
  for (int e = tid; e < KB * TC; e += kThreads) {
    const int k = e / TC, c = e % TC;
    float z = 0.f;
    if (TRANS) {  // Z[k] = sum_{i <= k} T[i][k] W[i]
      for (int i = 0; i <= k; ++i) z = fmaf(T[i * KB + k], W[i * TC + c], z);
    } else {      // Z[k] = sum_{i >= k} T[k][i] W[i]
      for (int i = k; i < KB; ++i) z = fmaf(T[k * KB + i], W[i * TC + c], z);
    }
    Z[e] = z;
  }
  __syncthreads();
  // ---- X -= V Z: rows rb + rl + i * RQ (i < 4) by 4 columns per thread;
  // then the updated tile back to M
  {
    constexpr int NCT = TC / 4, RQ = kThreads / NCT;
    const int ct = tid % NCT, rl = tid / NCT, c0 = 4 * ct;
    for (int rb = j0; rb < N; rb += 4 * RQ) {
      float4 x[4];
      int rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rows[i] = min(rb + rl + i * RQ, N - 1);
        x[i] = *reinterpret_cast<const float4*>(X + rows[i] * TCP + c0);
      }
#pragma unroll 8
      for (int k = 0; k < KB; ++k) {
        const float4 z = *reinterpret_cast<const float4*>(Z + k * TC + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = V[rows[i] * KBP + k];
          x[i].x = fmaf(-v, z.x, x[i].x);
          x[i].y = fmaf(-v, z.y, x[i].y);
          x[i].z = fmaf(-v, z.z, x[i].z);
          x[i].w = fmaf(-v, z.w, x[i].w);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (rb + rl + i * RQ < N)
          *reinterpret_cast<float4*>(M + (size_t)rows[i] * N + cc + c0) = x[i];
    }
  }
}

// Every chunk i of the columns [c_lo, N) with i % CS == rank, through
// apply_chunk; with two buffers the next one is staged while the current
// one computes, with one after it.
template <int KB, int TC, int CS, bool TRANS>
__device__ void apply_chunks(float* Xbuf, const float* V, const float* T,
                             float* W, float* Z, float* M, int N, int j0,
                             int c_lo, int rank) {
  constexpr int NB = chunk_bufs(TC);
  const int XS = N * chunk_pitch(TC);
  int i = c_lo / TC;
  while (i % CS != rank) ++i;
  if (i * TC >= N) return;
  stage_chunk<TC>(Xbuf, M, N, j0, i * TC);
  for (int n = 0; i * TC < N; i += CS, ++n) {
    float* X = Xbuf + (n % NB) * XS;
    const bool more = (i + CS) * TC < N;
    if (NB == 2 && more) {
      stage_chunk<TC>(Xbuf + ((n + 1) % NB) * XS, M, N, j0, (i + CS) * TC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    apply_chunk<KB, TC, TRANS>(X, V, T, W, Z, M, N, j0, i * TC);
    __syncthreads();
    if (NB == 1 && more) stage_chunk<TC>(Xbuf, M, N, j0, (i + CS) * TC);
  }
}

// Rows per lane of panel_regs: panels of up to 256 rows keep their columns
// in registers.
constexpr int kRegRows = 8;

// The panel P (rows [j0, N) of KB + 1, absolute row index) factored column
// by column, one block barrier per column step: at step k the owners of
// the columns >= k apply H_{k-1}, and the owner of column k then forms
// reflector k from its updated column; warp w owns the columns w (mod 16)
// and keeps their rows j0 + lane + 32 i in registers. On return the column
// holds R above and on the diagonal and v's tail below it; v_j and tau in
// vj, tau. N - j0 <= 32 * kRegRows.
template <int KB>
__device__ void panel_regs(float* P, float* vj, float* tau, int N, int j0) {
  constexpr int KBP = KB + 1, CPW = (KB + kWarps - 1) / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a[CPW][kRegRows];
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int c = warp + q * kWarps;
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {
      const int r = j0 + lane + 32 * i;
      a[q][i] = c < KB && r < N ? P[r * KBP + c] : 0.f;
    }
  }
  for (int k = 0; k < KB; ++k) {
    const int j = j0 + k;
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = warp + q * kWarps;
      if (c < k || c >= KB) continue;
      if (k > 0) {  // H_{j-1} on column c, rows j-1..N-1
        const int kp = k - 1, jp = j - 1;
        float v[kRegRows], part = 0.f;
#pragma unroll
        for (int i = 0; i < kRegRows; ++i) {
          const int r = j0 + lane + 32 * i;
          v[i] = r == jp ? vj[kp] : r > jp && r < N ? P[r * KBP + kp] : 0.f;
          part = fmaf(v[i], a[q][i], part);
        }
        const float tw = tau[kp] * warp_sum(part);
#pragma unroll
        for (int i = 0; i < kRegRows; ++i) a[q][i] -= tw * v[i];
      }
      if (c == k) {  // reflector j from the updated column
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kRegRows; ++i)
          if (j0 + lane + 32 * i > j) part += a[q][i] * a[q][i];
        const float sigma = warp_sum(part);
        // row j = j0 + k is lane k's first register (k < KB <= 32)
        const float alpha = __shfl_sync(kFull, a[q][0], k);
        const float normx = sqrtf(alpha * alpha + sigma);
        const float sg = alpha >= 0.f ? 1.f : -1.f;
        const float v0 = alpha + sg * normx;
        const float vtv = sigma + v0 * v0;
        if (lane == k) a[q][0] = -sg * normx;
#pragma unroll
        for (int i = 0; i < kRegRows; ++i) {
          const int r = j0 + lane + 32 * i;
          if (r < N) P[r * KBP + k] = a[q][i];
        }
        if (lane == 0) {
          vj[k] = v0;
          tau[k] = vtv >= FLT_MIN ? 2.f / vtv : 0.f;
        }
      }
    }
    __syncthreads();
  }
}

// panel_regs for panels of any height, the columns kept in shared memory.
template <int KB>
__device__ void panel_smem(float* P, float* vj, float* tau, int N, int j0) {
  constexpr int KBP = KB + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < KB; ++k) {
    const int j = j0 + k;
    for (int c = warp; c < KB; c += kWarps) {
      if (c < k) continue;
      if (k > 0) {  // H_{j-1} on column c, rows j-1..N-1
        const int kp = k - 1, jp = j - 1;
        float part = 0.f;
        for (int r = jp + lane; r < N; r += 32) {
          const float v = r == jp ? vj[kp] : P[r * KBP + kp];
          part = fmaf(v, P[r * KBP + c], part);
        }
        const float tw = tau[kp] * warp_sum(part);
        for (int r = jp + lane; r < N; r += 32) {
          const float v = r == jp ? vj[kp] : P[r * KBP + kp];
          P[r * KBP + c] -= tw * v;
        }
        __syncwarp();
      }
      if (c == k) {  // reflector j from the updated column
        float part = 0.f;
        for (int r = j + 1 + lane; r < N; r += 32) {
          const float x = P[r * KBP + k];
          part += x * x;
        }
        const float sigma = warp_sum(part);
        const float alpha = P[j * KBP + k];
        const float normx = sqrtf(alpha * alpha + sigma);
        const float sg = alpha >= 0.f ? 1.f : -1.f;
        const float v0 = alpha + sg * normx;
        const float vtv = sigma + v0 * v0;
        __syncwarp();
        if (lane == 0) {
          vj[k] = v0;
          tau[k] = vtv >= FLT_MIN ? 2.f / vtv : 0.f;
          P[j * KBP + k] = -sg * normx;
        }
      }
    }
    __syncthreads();
  }
}

// The upper tiles of G = V^T V (KB x KB) over the rows [j0, N) of V (rows
// of KB + 1), which T reads: a 4 x 4 tile per eight lanes, lane & 7 taking
// every eighth row, the partial sums reduced by warp shuffles.
template <int KB>
__device__ void gram(const float* __restrict__ V, int N, int j0, float* G) {
  constexpr int KBP = KB + 1, NT = KB / 4, TILES = NT * NT;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = lane & 7, slot = tid >> 3;
  for (int base = 0; base < TILES; base += kThreads / 8) {
    const int tile = base + slot;
    const bool valid = tile < TILES && tile / NT <= tile % NT;
    const int k0 = valid ? 4 * (tile / NT) : 0;
    const int c0 = valid ? 4 * (tile % NT) : 0;
    float acc[4][4] = {};
    if (valid)
#pragma unroll 4
      for (int r = j0 + rg; r < N; r += 8) {
        const float* vr = V + r * KBP;
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = vr[k0 + i];
          y[i] = vr[c0 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[i][s] = fmaf(x[i], y[s], acc[i][s]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          acc[i][s] += __shfl_xor_sync(kFull, acc[i][s], off);
    if (valid && rg == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int s = 0; s < 4; ++s) G[(k0 + i) * KB + c0 + s] = acc[i][s];
  }
}

template <int KB, int TC, int CS>
__global__ void __launch_bounds__(kThreads, 1)
qr_blocked_kernel(const float* __restrict__ A, float* __restrict__ Q,
                  float* __restrict__ R, float* __restrict__ work, int N) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KBP = KB + 1;
  float* Pv = smem;                    // [r][k]: the panel, then V
  float* Xbuf = Pv + N * KBP;          // the chunks [r][c]
  float* W = Xbuf + chunk_bufs(TC) * N * chunk_pitch(TC);  // [k][c]
  float* Z = W + KB * TC;              // [k][c]
  float* T = Z + KB * TC;              // [m][n]
  float* Gm = T + KB * KB;             // [m][n]
  float* vj = Gm + KB * KB;            // [k]
  float* tau = vj + KB;                // [k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / CS, rank = blockIdx.x % CS;
  const size_t base = (size_t)b * N * N;
  float* M = R + base;                 // A, factored in place
  float* Qb = Q + base;
  float* Vg = work + (size_t)b * N * (N + KB);   // V[r][j] at r * N + j
  float* Tg = Vg + (size_t)N * N;                // T of the panel at j0 * KB
  phase_clock::Clock clk;
  if (tid == 0) clk.start();

  for (int e = rank * kThreads + tid; e < N * N / 4; e += CS * kThreads) {
    reinterpret_cast<float4*>(M)[e] =
        __ldcs(reinterpret_cast<const float4*>(A + base) + e);
    const int r = 4 * e / N, c = 4 * e - r * N;
    reinterpret_cast<float4*>(Qb)[e] =
        make_float4(r == c, r == c + 1, r == c + 2, r == c + 3);
  }
  if (tid == 0) clk.lap(0);
  cluster_barrier<CS>();
  if (tid == 0) clk.lap(5);

  for (int j0 = 0; j0 < N; j0 += KB) {
    const bool owner = (j0 / KB) % CS == rank;
    for (int e = tid; e < (N - j0) * KB; e += kThreads) {
      const int r = j0 + e / KB, k = e % KB;
      Pv[r * KBP + k] = __ldcg(M + (size_t)r * N + j0 + k);
    }
    __syncthreads();
    // every block has read the panel's columns of M before the owner
    // overwrites them with R below: the cluster barrier's wait comes after
    // the factorization, which the blocks run anyway
    if (CS > 1) cluster_arrive();
    if (tid == 0) clk.lap(1);

    // ---- panel: one barrier per column step
    if (N - j0 <= 32 * kRegRows)
      panel_regs<KB>(Pv, vj, tau, N, j0);
    else
      panel_smem<KB>(Pv, vj, tau, N, j0);
    if (tid == 0) clk.lap(2);
    if (CS > 1) cluster_wait();

    // ---- R of the panel out (zeros below the diagonal); V in its place
    if (owner)
      for (int e = tid; e < (N - j0) * KB; e += kThreads) {
        const int r = j0 + e / KB, k = e % KB;
        M[(size_t)r * N + j0 + k] = r <= j0 + k ? Pv[r * KBP + k] : 0.f;
      }
    __syncthreads();
    // V in place, as unit reflectors: v / ||v|| = v sqrt(tau / 2) (0 where
    // tau = 0), H = I - 2 v v^T, which keeps T well scaled
    for (int e = tid; e < (N - j0) * KB; e += kThreads) {
      const int r = j0 + e / KB, k = e % KB;
      const float v = r < j0 + k ? 0.f : r == j0 + k ? vj[k] : Pv[r * KBP + k];
      Pv[r * KBP + k] = v * sqrtf(0.5f * tau[k]);
    }
    __syncthreads();
    if (tid == 0) clk.lap(3);
    gram<KB>(Pv, N, j0, Gm);
    __syncthreads();
    if (warp == 0) {
      // lane i keeps row i of T: T[i][n] = -tau_n sum_{m<n} T[i][m] G[m][n],
      // tau_n = 2 (0 where the reflector is the identity) for the unit V
      const int i = lane;
      float t[KB];
#pragma unroll
      for (int n = 0; n < KB; ++n) t[n] = n == i && tau[n] > 0.f ? 2.f : 0.f;
#pragma unroll
      for (int n = 1; n < KB; ++n) {
        float acc[4] = {};
#pragma unroll
        for (int mm = 0; mm < n; ++mm)
          acc[mm & 3] = fmaf(t[mm], Gm[mm * KB + n], acc[mm & 3]);
        if (n > i)
          t[n] = (tau[n] > 0.f ? -2.f : 0.f) *
                 ((acc[0] + acc[1]) + (acc[2] + acc[3]));
      }
      if (i < KB)
#pragma unroll
        for (int n = 0; n < KB; ++n) {
          T[i * KB + n] = t[n];
          if (owner) Tg[j0 * KB + i * KB + n] = t[n];
        }
      if (tid == 0) clk.lap(7);
    }
    if (owner)
      for (int e = tid; e < (N - j0) * KB; e += kThreads) {
        const int r = j0 + e / KB, k = e % KB;
        Vg[(size_t)r * N + j0 + k] = Pv[r * KBP + k];
      }
    __syncthreads();
    if (tid == 0) clk.lap(3);

    // ---- A <- (I - V T V^T)^T A on this block's trailing chunks
    if (j0 + KB < N)
      apply_chunks<KB, TC, CS, true>(Xbuf, Pv, T, W, Z, M, N, j0, j0 + KB,
                                     rank);
    if (tid == 0) clk.lap(4);
    cluster_barrier<CS>();
    if (tid == 0) clk.lap(5);
  }

  // ---- Q = Hb_0 (Hb_1 (... (Hb_last I))) on this block's chunks of Q's
  // columns; V and T of each panel from the work buffer
  for (int j0 = N - KB; j0 >= 0; j0 -= KB) {
    for (int e = tid; e < (N - j0) * KB; e += kThreads) {
      const int r = j0 + e / KB, k = e % KB;
      Pv[r * KBP + k] = __ldcg(Vg + (size_t)r * N + j0 + k);
    }
    for (int e = tid; e < KB * KB; e += kThreads)
      T[e] = __ldcg(Tg + j0 * KB + e);
    __syncthreads();
    apply_chunks<KB, TC, CS, false>(Xbuf, Pv, T, W, Z, Qb, N, j0, j0, rank);
  }
  if (tid == 0) clk.lap(6);
#ifdef MC_PHASE_STAMPS
  if (tid == 0) clk.store(g_stamps, blockIdx.x);
#endif
}

template <int KB, int TC, int CS>
int launch(const float* A, float* Q, float* R, float* work, int B, int N,
           cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(N, KB, TC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qr_blocked_kernel<KB, TC, CS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qr_blocked_kernel<KB, TC, CS>, A, Q, R,
                           work, N);
  return err ? (int)err : (int)cudaGetLastError();
}

// The instance for chunk width tc (at most TC) and CS = 1 or 2.
template <int KB, int TC>
int launch_tc(int tc, const float* A, float* Q, float* R, float* work, int B,
              int N, int CS, cudaStream_t st) {
  if constexpr (TC > 4)
    if (tc < TC) return launch_tc<KB, TC / 2>(tc, A, Q, R, work, B, N, CS, st);
  if (CS == 1) return launch<KB, TC, 1>(A, Q, R, work, B, N, st);
  if (CS == 2) return launch<KB, TC, 2>(A, Q, R, work, B, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). 8 | N; the panel
// width KB is 32 where 32 | N, else 16 where 16 | N, else 8; the chunk
// width TC the widest of 32, 16, 8 (at most KB) whose two buffers fit one
// block's shared memory, else 4 in one buffer; CS = 1 or 2 blocks per
// matrix. work holds B * N * (N + KB) floats.
extern "C" int qr_blocked_f32(const float* A, float* Q, float* R, float* work,
                              int B, int N, int CS, void* stream) {
  if (B == 0) return 0;
  if (N < 8 || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int KB = N % 32 == 0 ? 32 : N % 16 == 0 ? 16 : 8;
  int TC = 0;
  for (int tc = 32; tc >= 4 && !TC; tc /= 2)
    if (tc <= KB && smem_floats(N, KB, tc) * 4 <= 232448) TC = tc;
  if (!TC) return (int)cudaErrorInvalidValue;
  if (KB == 32) return launch_tc<32, 32>(TC, A, Q, R, work, B, N, CS, st);
  if (KB == 16) return launch_tc<16, 16>(TC, A, Q, R, work, B, N, CS, st);
  return launch_tc<8, 8>(TC, A, Q, R, work, B, N, CS, st);
}

// Phase stamps of the last launch's first n_blocks blocks (kPhases cycle
// sums each) into dst on the host: a build with -DMC_PHASE_STAMPS only.
extern "C" int qr_blocked_f32_stamps(void* dst, int n_blocks, void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
