// Sequential Metropolis site sweep over one DQMC time slice (kernel K1), in
// float32 and in float64.
//
// The float32 instance (site_sweep_f32) replaces
// montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel in col_read mode
// (reached through _site_sweep_batched / get_fused_site_sweep); at one chain
// it is also K12 (site_sweep_pallas's _kernel). The float64 instance
// (site_sweep_f64) replaces the XLA site loop the JAX package runs for
// float64 updates (montecarlo_tpu/dqmc/core.py::sweep_slice, the
// lax.fori_loop over sites): Mosaic is float32-only, so there is no TPU
// kernel for it. The plain PyTorch version with the same op order, for
// both, is montecarlo_tpu_torch/ops/site_sweep.py::site_sweep_plain.
//
// What bounds it: the N decisions of a chain are sequential, and each
// accepted one is an O(F*N^2) rank-1 update of G: at the DQMC sizes
// (F*N*N = 4096 elements) a few thousand FP32 operations per site, spread
// over one block. The kernel is bound by the latency of the site chain
// (decision, update, hand-over of the next row and column, barrier), not by
// device memory or FLOPs.
//
// float32 design (site_sweep_tiled_f32, the loop in site_sweep_tiled.cuh):
// one block per chain with G spread over the block's registers, each
// thread a tile of it; only row i and column i go through shared memory,
// published by their owners into a double buffer, so a site costs one
// block barrier; sigma and u in shared memory; 256 threads per chain.
//
// float64 design (site_sweep_kernel<double>, the loop in
// site_sweep_loop.cuh): one block per chain; G of the
// chain (F x N x N) lives in dynamic shared memory for the whole site loop,
// rows padded to N+1 elements so the column read G[:, i] is free of bank
// conflicts. Every thread computes the accept decision itself from the same
// shared values (no broadcast barrier); only accepted sites stage row i and
// the scaled column x*(e_i - G[:, i]) -- both read BEFORE the update
// overwrites them -- and apply the rank-1 update, two barriers per
// accepted site. float64 doubles the shared memory: F*N*(N+1)*8 bytes must
// fit one block's 227 KB, so N <= 128 at F = 1 and N <= 119 at F = 2.
//
// All arithmetic uses the _rn intrinsics (__f*_rn in float32, __d*_rn in
// float64), which nvcc never fuses into FMAs, so every value matches the
// plain PyTorch version's separately rounded operations.
//
// Given a neg_out pointer (the float64 entry point), thread 0 also records
// how large the chain's negative detratios were, as the XLA loop's
// _push_mag does: the min, max and sum of log10(max(|det|, 1e-38)) over
// them, in site order, into neg_out[3c .. 3c+2]. The float32 entry passes
// NULL: the Pallas kernels it replaces count the negative detratios alone.
//
// The TPU kernel's chain-on-lanes layout, one-hot contractions and
// grid-as-site-loop are Mosaic workarounds and are not carried over.
//
// The delay-2 paired-site instance (site_sweep_pair_f32, kernel K5)
// replaces montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel_pair,
// which the JAX package runs for every float32 session with F >= 2 and even
// N <= 128. Its plain PyTorch version is
// montecarlo_tpu_torch/ops/site_sweep.py::site_sweep_pair_plain. It computes
// K1's Markov chain two sites (i, j = i+1) at a time: site i is decided from
// the current G; site j's row, column and diagonal are corrected exactly from
// site i's rank-1 terms (row'_j = row_j - xIG_i[j]*row_i, col'_j = col_j -
// xIG_i*row_i[j]) and site j is decided from them; both updates then land in
// one read-modify-write pass, G <- (G - xIG_i (x) row_i) - xIG_j (x) row'_j.
// Same bound as the one-block shared-memory loop of K1 in float64
// (shared-memory RMW traffic and barriers inside one block); the pairing
// halves what an accepted pair costs: one staging pass, one RMW pass and
// two barriers instead of two of each. Every thread decides
// both sites from the shared values before anything is written (G[i,i],
// G[j,i], G[i,j], G[j,j] are four scalars per flavor) with K1's
// tiled::Decision, and every operation is K1's _rn operation in K1's
// order, so K5 is bit-equal to K1.

#include "site_sweep_loop.cuh"
#include "site_sweep_tiled.cuh"

namespace {

#ifdef MC_PHASE_STAMPS
// site_sweep_tiled_f32's phases (thread 0 of each block), as
// tiled::sweep_chain laps them
__device__ long long g_stamps[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

// K1 in float32: one block of Gm::NT threads per chain
template <int F, class Gm>
__global__ void __launch_bounds__(Gm::NT)
site_sweep_tiled_f32(const float* __restrict__ G_in, float* __restrict__ G_out,
                     const int8_t* __restrict__ sigma_in,
                     int8_t* __restrict__ sigma_out,
                     const float* __restrict__ u, int* __restrict__ acc_out,
                     int* __restrict__ nneg_out, int N, float lamb,
                     float sign0, float sign1, int det_power, int use_boson) {
  extern __shared__ __align__(16) float smem_tiled[];
  const int c = blockIdx.x;
  const size_t base = (size_t)c * F * N * N;
  phase_clock::Clock clk;
  tiled::sweep_chain<false, F, F, Gm>(
      smem_tiled, G_in + base, G_out + base, sigma_in + (size_t)c * N,
      sigma_out + (size_t)c * N, u + (size_t)c * N, acc_out + c,
      nneg_out + c, nullptr, nullptr, N, lamb, sign0, sign1, det_power,
      use_boson, clk);
#ifdef MC_PHASE_STAMPS
  if (threadIdx.x == 0) clk.store(g_stamps, c);
#endif
}

template <int F, class Gm>
int launch_tiled(const float* G_in, float* G_out, const int8_t* sigma_in,
                 int8_t* sigma_out, const float* u, int* acc, int* nneg,
                 int C, int N, float lamb, float sign0, float sign1,
                 int det_power, int use_boson, cudaStream_t stream) {
  constexpr int smem = tiled::smem_bytes<false, F, F, Gm::NP>();
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_tiled_f32<F, Gm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_tiled_f32<F, Gm><<<C, Gm::NT, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, acc, nneg, N, lamb, sign0, sign1,
      det_power, use_boson);
  return (int)cudaGetLastError();
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_kernel(const T* __restrict__ G_in, T* __restrict__ G_out,
                  const int8_t* __restrict__ sigma_in,
                  int8_t* __restrict__ sigma_out, const T* __restrict__ u,
                  int* __restrict__ acc_out, int* __restrict__ nneg_out,
                  T* __restrict__ neg_out, int N, T lamb, T sign0, T sign1,
                  int det_power, int use_boson) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = N + 1;
  T* Gs = reinterpret_cast<T*>(smem_raw);  // [f][a][b] at (f*N + a)*LD + b
  T* rows = Gs + F * N * LD;               // [f][b]: G_f[i, b]
  T* cols = rows + F * N;      // [f][a]: x_f * (e_i - G_f[:, i])[a]
  const int c = blockIdx.x;
  const size_t base = (size_t)c * F * N * N;

  load_g<T, F>(G_in + base, Gs, N);
  __syncthreads();
  int acc = 0, nneg = 0;
  // log10 |det| over the negative detratios: min, max, sum (thread 0)
  T neg_min = T(INFINITY), neg_max = T(-INFINITY), neg_sum = T(0);
  sweep_sites<T, F>(Gs, rows, cols, N, sigma_in + c * N, sigma_out + c * N,
                    u + c * N, lamb, sign0, sign1, det_power, use_boson,
                    neg_out != nullptr, acc, nneg, neg_min, neg_max, neg_sum);
  __syncthreads();
  store_g<T, F>(Gs, G_out + base, N);
  if (threadIdx.x == 0) {
    acc_out[c] = acc;
    nneg_out[c] = nneg;
    if (neg_out != nullptr) {
      neg_out[3 * c] = neg_min;
      neg_out[3 * c + 1] = neg_max;
      neg_out[3 * c + 2] = neg_sum;
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_pair_kernel(const float* __restrict__ G_in,
                       float* __restrict__ G_out,
                       const int8_t* __restrict__ sigma_in,
                       int8_t* __restrict__ sigma_out,
                       const float* __restrict__ u, int* __restrict__ acc_out,
                       int* __restrict__ nneg_out, int N, float lamb,
                       float sign0, float sign1, int det_power,
                       int use_boson) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = N + 1;
  float* Gs = reinterpret_cast<float*>(smem_raw);  // [f][a][b], as K1
  float* rows_i = Gs + F * N * LD;  // [f][b]: G_f[i, b]
  float* cols_i = rows_i + F * N;   // [f][a]: xIG_i = x_i (e_i - G_f[:, i])
  float* rows_j = cols_i + F * N;   // [f][b]: row'_j
  float* cols_j = rows_j + F * N;   // [f][a]: xIG_j = x_j (e_j - col'_j)
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % N, ty = tid / N, rstep = blockDim.x / N;
  const bool active = ty < rstep;
  const size_t base = (size_t)c * F * N * N;

  if (active) {
    for (int f = 0; f < F; ++f)
      for (int a = ty; a < N; a += rstep)
        Gs[(f * N + a) * LD + tx] = G_in[base + (size_t)(f * N + a) * N + tx];
  }
  __syncthreads();

  // K1's decision in float32 (site_sweep_tiled.cuh): x_f = delta_f / r_f
  // and the detratio in its op order
  const tiled::Decision<false, F> decide(lamb, sign0, sign1, use_boson);
  int acc = 0, nneg = 0;
  for (int i = 0; i < N; i += 2) {
    const int j = i + 1;
    const int8_t si = sigma_in[c * N + i], sj = sigma_in[c * N + j];
    // ---- site i from the current G
    float g[F][1], xi[F][1], xj[F][1], det_i[1], det_j[1];
    for (int f = 0; f < F; ++f) g[f][0] = Gs[(f * N + i) * LD + i];
    const bool acc_i = decide(g, si, u[c * N + i], det_power, xi, det_i);
    // ---- site j from its diagonal corrected by site i's rank-1 terms:
    // cj = xIG_i[j] (e_i[j] = 0), ri = row_i[j]
    float cj[F], ri[F];
    for (int f = 0; f < F; ++f) {
      cj[f] = mul_rn(xi[f][0], sub_rn(0.f, Gs[(f * N + j) * LD + i]));
      ri[f] = Gs[(f * N + i) * LD + j];
      const float gjj = Gs[(f * N + j) * LD + j];
      g[f][0] = acc_i ? sub_rn(gjj, mul_rn(cj[f], ri[f])) : gjj;
    }
    const bool acc_j = decide(g, sj, u[c * N + j], det_power, xj, det_j);
    if (tid == 0) {
      acc += acc_i + acc_j;
      nneg += (det_i[0] < 0.f) + (det_j[0] < 0.f);
      sigma_out[c * N + i] = acc_i ? (int8_t)(-si) : si;
      sigma_out[c * N + j] = acc_j ? (int8_t)(-sj) : sj;
    }
    if (!acc_i && !acc_j) continue;  // block-uniform, as in K1
    // ---- stage both rank-1 terms from the pre-update G (one pass)
    for (int e = tid; e < F * N; e += blockDim.x) {
      const int f = e / N, a = e - f * N;
      // constant indices keep the per-flavor scalars in registers
      const float x_i = f == 0 ? xi[0][0] : xi[F - 1][0];
      const float x_j = f == 0 ? xj[0][0] : xj[F - 1][0];
      const float c_j = f == 0 ? cj[0] : cj[F - 1];
      const float r_i = f == 0 ? ri[0] : ri[F - 1];
      const float gi = Gs[(f * N + i) * LD + a];  // row_i[a]
      const float ci = mul_rn(x_i, sub_rn(a == i ? 1.f : 0.f,
                                          Gs[(f * N + a) * LD + i]));
      rows_i[e] = gi;
      cols_i[e] = ci;
      if (acc_j) {
        float rj = Gs[(f * N + j) * LD + a];  // row_j[a]
        float colj = Gs[(f * N + a) * LD + j];  // col_j[a]
        if (acc_i) {
          rj = sub_rn(rj, mul_rn(c_j, gi));
          colj = sub_rn(colj, mul_rn(ci, r_i));
        }
        rows_j[e] = rj;
        cols_j[e] = mul_rn(x_j, sub_rn(a == j ? 1.f : 0.f, colj));
      }
    }
    __syncthreads();
    // ---- both updates in one read-modify-write pass
    if (active) {
      for (int f = 0; f < F; ++f) {
        const float rbi = rows_i[f * N + tx], rbj = rows_j[f * N + tx];
        for (int a = ty; a < N; a += rstep) {
          float* gp = &Gs[(f * N + a) * LD + tx];
          float v = *gp;
          if (acc_i) v = sub_rn(v, mul_rn(cols_i[f * N + a], rbi));
          if (acc_j) v = sub_rn(v, mul_rn(cols_j[f * N + a], rbj));
          *gp = v;
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    for (int f = 0; f < F; ++f)
      for (int a = ty; a < N; a += rstep)
        G_out[base + (size_t)(f * N + a) * N + tx] = Gs[(f * N + a) * LD + tx];
  }
  if (tid == 0) {
    acc_out[c] = acc;
    nneg_out[c] = nneg;
  }
}

template <int F>
int launch_pair(const float* G_in, float* G_out, const int8_t* sigma_in,
                int8_t* sigma_out, const float* u, int* acc, int* nneg, int C,
                int N, float lamb, float sign0, float sign1, int det_power,
                int use_boson, cudaStream_t stream) {
  const size_t smem = (size_t)(F * N * (N + 1) + 4 * F * N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_pair_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_pair_kernel<F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, acc, nneg, N, lamb, sign0, sign1,
      det_power, use_boson);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int launch(const T* G_in, T* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const T* u, int* acc, int* nneg, T* neg,
           int C, int N, T lamb, T sign0, T sign1, int det_power,
           int use_boson, cudaStream_t stream) {
  const size_t smem = (size_t)(F * N * (N + 1) + 2 * F * N) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_kernel<T, F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, acc, nneg, neg, N, lamb, sign0,
      sign1, det_power, use_boson);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* G_in, T* G_out, const int8_t* sigma_in,
             int8_t* sigma_out, const T* u, int* acc, int* nneg, T* neg, int C,
             int F, int N, T lamb, T sign0, T sign1, int det_power,
             int use_boson, void* stream) {
  if (C == 0) return 0;
  if (N < 1 || N > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (F == 1)
    return launch<T, 1>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, neg,
                        C, N, lamb, sign0, sign1, det_power, use_boson, st);
  if (F == 2)
    return launch<T, 2>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, neg,
                        C, N, lamb, sign0, sign1, det_power, use_boson, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Return the cudaError_t of the launch (0 = success). N <= 128, F in {1,2}.
extern "C" int site_sweep_f32(const float* G_in, float* G_out,
                              const int8_t* sigma_in, int8_t* sigma_out,
                              const float* u, int* acc, int* nneg, int C,
                              int F, int N, float lamb, float sign0,
                              float sign1, int det_power, int use_boson,
                              void* stream) {
  if (C == 0) return 0;
  if (N < 1 || N > 128 || F < 1 || F > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return tiled::with_layout(N, [&](auto gm) {
    using Gm = decltype(gm);
    if (F == 1)
      return launch_tiled<1, Gm>(
          G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, N, lamb, sign0,
          sign1, det_power, use_boson, st);
    return launch_tiled<2, Gm>(
        G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, N, lamb, sign0,
        sign1, det_power, use_boson, st);
  });
}

// K5: even N <= 128, F in {1,2}, float32.
extern "C" int site_sweep_pair_f32(const float* G_in, float* G_out,
                                   const int8_t* sigma_in, int8_t* sigma_out,
                                   const float* u, int* acc, int* nneg, int C,
                                   int F, int N, float lamb, float sign0,
                                   float sign1, int det_power, int use_boson,
                                   void* stream) {
  if (C == 0) return 0;
  if (N < 2 || N > 128 || N % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (F == 1)
    return launch_pair<1>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C,
                          N, lamb, sign0, sign1, det_power, use_boson, st);
  if (F == 2)
    return launch_pair<2>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C,
                          N, lamb, sign0, sign1, det_power, use_boson, st);
  return (int)cudaErrorInvalidValue;
}

// neg: (C, 3) float64 negative-weight statistics.
extern "C" int site_sweep_f64(const double* G_in, double* G_out,
                              const int8_t* sigma_in, int8_t* sigma_out,
                              const double* u, int* acc, int* nneg,
                              double* neg, int C, int F, int N, double lamb,
                              double sign0, double sign1, int det_power,
                              int use_boson, void* stream) {
  return dispatch<double>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, neg,
                          C, F, N, lamb, sign0, sign1, det_power, use_boson,
                          stream);
}

// Phase stamps of the last float32 K1 launch's first n_blocks blocks
// (kPhases cycle sums each) into dst on the host: a build with
// -DMC_PHASE_STAMPS only.
extern "C" int site_sweep_f32_stamps(void* dst, int n_blocks, void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
