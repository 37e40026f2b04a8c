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
// Design (site_sweep_tiled.cuh): one block of 256 threads per chain with G
// spread over the block's registers, each thread a tile of it; only row i
// and column i go through shared memory, published by their owners into a
// double buffer, so a site costs one block barrier; sigma and u in shared
// memory. float32 (site_sweep_tiled_f32) and float64 (site_sweep_tiled_f64)
// run the same loop (tiled::sweep_chain) on tiles of their element type,
// G's chunks 16 bytes wide (4 floats, 2 doubles). At F = 2 past N = 64 in
// float64, G's two flavors would take 256 registers of each thread, so
// flavor 1 lives in shared memory private to each thread (128 KB at
// N = 128), as in K8's complex F = 2 layout: every N <= 128 at F <= 2.
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
// The delay-2 paired-site instance (site_sweep_pair_tiled, kernel K5)
// replaces montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel_pair,
// which the JAX package runs for every float32 session with F >= 2 and even
// N <= 128. Its plain PyTorch version is
// montecarlo_tpu_torch/ops/site_sweep.py::site_sweep_pair_plain. It computes
// K1's Markov chain two sites (i, j = i+1) at a time: site i is decided from
// the current G; site j's row, column and diagonal are corrected exactly from
// site i's rank-1 terms (row'_j = row_j - xIG_i[j]*row_i, col'_j = col_j -
// xIG_i*row_i[j]) and site j is decided from them; both updates then land in
// one pass over each thread's tile, G <- (G - xIG_i (x) row_i) - xIG_j (x)
// row'_j. It runs on K1's tiles (tiled::sweep_chain_pair): rows and columns
// i and j are staged together, so a pair of sites costs one block barrier
// and one staging round where K1 pays two. Every thread decides both sites
// from four staged scalars per flavor (G[i,i], G[j,i], G[i,j], G[j,j]) with
// K1's tiled::Decision, and every operation is K1's _rn operation in K1's
// order, so K5 is bit-equal to K1.

#include "site_sweep_tiled.cuh"

namespace {

#ifdef MC_PHASE_STAMPS
// the phases of the last launch of any kernel of this file (thread 0 of
// each block), as tiled::sweep_chain and sweep_chain_pair lap them
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
      nneg_out + c, nullptr, nullptr, nullptr, N, lamb, sign0, sign1,
      det_power, use_boson, clk);
#ifdef MC_PHASE_STAMPS
  if (threadIdx.x == 0) clk.store(g_stamps, c);
#endif
}

// K1 in float64: the same loop on tiles of doubles, with the
// negative-weight statistics
template <int F, class Gm>
__global__ void __launch_bounds__(Gm::NT)
site_sweep_tiled_f64(const double* __restrict__ G_in,
                     double* __restrict__ G_out,
                     const int8_t* __restrict__ sigma_in,
                     int8_t* __restrict__ sigma_out,
                     const double* __restrict__ u, int* __restrict__ acc_out,
                     int* __restrict__ nneg_out, double* __restrict__ neg_out,
                     int N, double lamb, double sign0, double sign1,
                     int det_power, int use_boson) {
  constexpr int QR = tiled::planes_in_registers<false, F, Gm::NP, double>();
  extern __shared__ __align__(16) double smem_tiled64[];
  const int c = blockIdx.x;
  const size_t base = (size_t)c * F * N * N;
  phase_clock::Clock clk;
  tiled::sweep_chain<false, F, QR, Gm>(
      smem_tiled64, G_in + base, G_out + base, sigma_in + (size_t)c * N,
      sigma_out + (size_t)c * N, u + (size_t)c * N, acc_out + c,
      nneg_out + c, nullptr, nullptr, neg_out + 3 * (size_t)c, N, lamb,
      sign0, sign1, det_power, use_boson, clk);
#ifdef MC_PHASE_STAMPS
  if (threadIdx.x == 0) clk.store(g_stamps, c);
#endif
}

// K5: the paired-site loop on K1's float32 tiles
template <int F, class Gm>
__global__ void __launch_bounds__(Gm::NT)
site_sweep_pair_tiled(const float* __restrict__ G_in,
                      float* __restrict__ G_out,
                      const int8_t* __restrict__ sigma_in,
                      int8_t* __restrict__ sigma_out,
                      const float* __restrict__ u, int* __restrict__ acc_out,
                      int* __restrict__ nneg_out, int N, float lamb,
                      float sign0, float sign1, int det_power,
                      int use_boson) {
  extern __shared__ __align__(16) float smem_pair[];
  const int c = blockIdx.x;
  const size_t base = (size_t)c * F * N * N;
  phase_clock::Clock clk;
  tiled::sweep_chain_pair<F, Gm>(
      smem_pair, G_in + base, G_out + base, sigma_in + (size_t)c * N,
      sigma_out + (size_t)c * N, u + (size_t)c * N, acc_out + c,
      nneg_out + c, N, lamb, sign0, sign1, det_power, use_boson, clk);
#ifdef MC_PHASE_STAMPS
  if (threadIdx.x == 0) clk.store(g_stamps, c);
#endif
}

// One launch of kernel with SMEM bytes of dynamic shared memory per block,
// C blocks of Gm::NT threads
template <int SMEM, class Gm, class Kernel, class... Args>
int launch(Kernel kernel, int C, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<C, Gm::NT, SMEM, stream>>>(args...);
  return (int)cudaGetLastError();
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
      return launch<tiled::smem_bytes<false, 1, 1, Gm::NP>(), Gm>(
          site_sweep_tiled_f32<1, Gm>, C, st, G_in, G_out, sigma_in,
          sigma_out, u, acc, nneg, N, lamb, sign0, sign1, det_power,
          use_boson);
    return launch<tiled::smem_bytes<false, 2, 2, Gm::NP>(), Gm>(
        site_sweep_tiled_f32<2, Gm>, C, st, G_in, G_out, sigma_in, sigma_out,
        u, acc, nneg, N, lamb, sign0, sign1, det_power, use_boson);
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
  if (N < 2 || N > 128 || N % 2 || F < 1 || F > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return tiled::with_layout(N, [&](auto gm) {
    using Gm = decltype(gm);
    if (F == 1)
      return launch<tiled::smem_bytes<false, 1, 1, Gm::NP, float, 2>(), Gm>(
          site_sweep_pair_tiled<1, Gm>, C, st, G_in, G_out, sigma_in,
          sigma_out, u, acc, nneg, N, lamb, sign0, sign1, det_power,
          use_boson);
    return launch<tiled::smem_bytes<false, 2, 2, Gm::NP, float, 2>(), Gm>(
        site_sweep_pair_tiled<2, Gm>, C, st, G_in, G_out, sigma_in,
        sigma_out, u, acc, nneg, N, lamb, sign0, sign1, det_power,
        use_boson);
  });
}

// K1 in float64: N <= 128, F in {1,2}; neg: (C, 3) float64
// negative-weight statistics.
extern "C" int site_sweep_f64(const double* G_in, double* G_out,
                              const int8_t* sigma_in, int8_t* sigma_out,
                              const double* u, int* acc, int* nneg,
                              double* neg, int C, int F, int N, double lamb,
                              double sign0, double sign1, int det_power,
                              int use_boson, void* stream) {
  if (C == 0) return 0;
  if (N < 1 || N > 128 || F < 1 || F > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return tiled::with_layout<double>(N, [&](auto gm) {
    using Gm = decltype(gm);
    constexpr int NP = Gm::NP;
    if (F == 1)
      return launch<tiled::smem_bytes<
                        false, 1,
                        tiled::planes_in_registers<false, 1, NP, double>(),
                        NP, double>(),
                    Gm>(site_sweep_tiled_f64<1, Gm>, C, st, G_in, G_out,
                        sigma_in, sigma_out, u, acc, nneg, neg, N, lamb,
                        sign0, sign1, det_power, use_boson);
    return launch<tiled::smem_bytes<
                      false, 2,
                      tiled::planes_in_registers<false, 2, NP, double>(), NP,
                      double>(),
                  Gm>(site_sweep_tiled_f64<2, Gm>, C, st, G_in, G_out,
                      sigma_in, sigma_out, u, acc, nneg, neg, N, lamb, sign0,
                      sign1, det_power, use_boson);
  });
}

// Phase stamps of the last launch of any kernel of this file (K1 in float32
// or float64, K5): its first n_blocks blocks (kPhases cycle sums each) into
// dst on the host; a build with -DMC_PHASE_STAMPS only.
extern "C" int site_sweep_f32_stamps(void* dst, int n_blocks, void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
