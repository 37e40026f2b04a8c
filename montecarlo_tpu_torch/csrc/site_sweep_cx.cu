// Sequential Metropolis site sweep over one DQMC time slice for a complex
// Green's function (kernel K8: complex hopping, e.g. Peierls phases).
//
// Replaces montecarlo_tpu/ops/pallas_site_sweep.py::_cx_kernel (reached
// through _site_sweep_batched_cx / get_fused_site_sweep_cx). The plain
// PyTorch version with the same op order is
// montecarlo_tpu_torch/ops/site_sweep_cx.py::site_sweep_cx_plain.
//
// Per chain and site i (delta_f real, r_f and det complex):
//   delta_f = exp(sign_f * dEb) - 1,  dEb = -2 * lamb * sigma_i
//   r_f     = 1 + delta_f * (1 - G_f[i, i])
//   det     = (prod_f r_f) ** det_power,   det_power in {1, 2}
//   accept  = u_i < exp(-dEb)**use_boson * Re(det)
//   on accept: G_f -= y_f (x) G_f[i, :],  y_f = x_f * (e_i - G_f[:, i]),
//              x_f = delta_f * conj(r_f) / |r_f|^2
// Every site's accept flag and det go out to device memory: the caller
// folds them into the phase-problem statistics (imaginary weights, the
// running weight phase), which is why this kernel does not count them.
//
// What bounds it: the N decisions of a chain are sequential and each
// accepted one updates G_f, 8 FP32 operations per complex element (no FMA:
// the plain version rounds each product). At N = 64 that is the latency of
// the site chain; at N = 128, 131,072 operations per accepted site and
// chain, the SM's FP32 issue rate (128 per cycle): about 1,000 cycles per
// site with one chain per SM.
//
// Design: K1's loop (site_sweep_tiled.cuh) on two planes: one block per
// chain, G spread over the block's registers, only row i and column i
// staged in shared memory, one block barrier per site, sigma and u in
// shared memory; the accept flags and det of the sites gather in shared
// memory and go out after the loop. G of 256 chains at N = 128 (32 MB) fits
// neither the card's register files (33 MB, with nothing else in them) nor
// its shared memory (29 MB), so at N = 128 the chains run in two waves of
// one block per SM; at F = 2 past N = 64 flavor 1 lives in shared memory,
// private to each thread. 256 threads per chain.
//
// The complex128 instance (site_sweep_cx_c128, kernel K8-c128) runs the same
// loop on tiles of doubles, with the __d*_rn operations. It replaces the XLA
// site loop the JAX package runs for complex128 updates
// (montecarlo_tpu/dqmc/core.py::sweep_slice, the rank-1 lax.fori_loop):
// there is no TPU kernel for it, since Mosaic takes neither float64 nor
// complex128. Its plain version is site_sweep_cx_plain in complex128. G
// of one chain is 64 KB per plane at N = 64 and F = 2 (four planes: 128
// registers of each of the 256 threads, as K1-f64 at N = 128) and 128 KB
// per plane at N = 128: at F = 1 past N = 64 the real plane stays in
// registers and the imaginary plane lives in shared memory private to each
// thread (tiled::planes_in_registers), 140 KB per block. At F = 2 past
// N = 64 one block would need three planes there (384 KB): the chain runs
// on a cluster of 2 blocks, one flavor each (site_sweep_tiled_cx_flavors),
// each block holding its flavor as the F = 1 layout does. The flavors meet
// only in the decision, det = (r_0 r_1)^det_power: the owner of G_f[i, i]
// writes it into the other block's shared memory when it publishes row i
// (tiled::publish_diag), the barrier of every site is a cluster barrier,
// and both blocks decide from the same two entries in the same operations,
// so the kernel is bit-equal to the plain version as the one-block layout
// is. What bounds it: as in complex64, the site chain at N = 64 and the
// FP64 issue rate of the updates at N = 128 (8 FP64 operations per complex
// element and accepted site, 64 FP64 operations per cycle and SM); at F = 2
// past 64 each flavor has an SM of its own, behind a cluster barrier per
// site.
//
// Past N = 64 the wrapper (ops/site_sweep_cx.py::plan_layout) takes the
// rank-1 layout (site_sweep_rank1.cuh, site_sweep_cx_c128_rank1) where it
// ran faster on an H100: G padded on chip only to a multiple of 8 (no
// padding to 128), one block per chain or a cluster of 2, the rows of G
// beyond the register rows in shared memory, one cluster barrier per site
// and the next row sent by st.async (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_clock.cuh"
#include "site_sweep_rank1.cuh"
#include "site_sweep_tiled.cuh"

namespace cg = cooperative_groups;

namespace {

#ifdef MC_PHASE_STAMPS
// the phases of site_sweep_tiled_cx (thread 0 of each block), as
// tiled::sweep_chain laps them, or of the rank-1 layout's blocks
__device__ long long g_stamps[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

// G, det: interleaved (re, im) pairs of T; u: T
template <int F, class Gm>
__global__ void __launch_bounds__(Gm::NT)
site_sweep_tiled_cx(const typename Gm::T* __restrict__ G_in,
                    typename Gm::T* __restrict__ G_out,
                    const int8_t* __restrict__ sigma_in,
                    int8_t* __restrict__ sigma_out,
                    const typename Gm::T* __restrict__ u,
                    uint8_t* __restrict__ accept_out,
                    typename Gm::T* __restrict__ det_out, int N,
                    typename Gm::T lamb, typename Gm::T sign0,
                    typename Gm::T sign1, int det_power, int use_boson) {
  using T = typename Gm::T;
  constexpr int QR = tiled::planes_in_registers<true, F, Gm::NP, T>();
  extern __shared__ __align__(16) unsigned char smem_cx[];
  const int c = blockIdx.x;
  const size_t base = 2 * (size_t)c * F * N * N;
  phase_clock::Clock clk;
  tiled::sweep_chain<true, F, QR, Gm>(
      reinterpret_cast<T*>(smem_cx), G_in + base, G_out + base,
      sigma_in + (size_t)c * N, sigma_out + (size_t)c * N, u + (size_t)c * N,
      nullptr, nullptr, accept_out + (size_t)c * N, det_out + 2 * (size_t)c * N,
      nullptr, N, lamb, sign0, sign1, det_power, use_boson, clk);
#ifdef MC_PHASE_STAMPS
  if (threadIdx.x == 0) clk.store(g_stamps, c);
#endif
}

// The two flavors of a chain on a cluster of 2 blocks (tiled::sweep_chain's
// Xch): block rank holds flavor rank. local: this block's slots for the
// other flavor's G[n, n], by n & 1 and plane; remote: the other block's.
template <class T>
struct FlavorPair {
  static constexpr bool kPair = true;
  T* remote;
  const T* local;
  int rank;
  __device__ __forceinline__ void start() const { cg::this_cluster().sync(); }
  __device__ __forceinline__ void sync() const { cg::this_cluster().sync(); }
  __device__ __forceinline__ bool writer() const { return rank == 0; }
};

// K8 at F = 2 on a cluster of 2 blocks, block rank owning flavor rank of
// chain blockIdx.x / 2
template <class Gm>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(Gm::NT)
site_sweep_tiled_cx_flavors(const typename Gm::T* __restrict__ G_in,
                            typename Gm::T* __restrict__ G_out,
                            const int8_t* __restrict__ sigma_in,
                            int8_t* __restrict__ sigma_out,
                            const typename Gm::T* __restrict__ u,
                            uint8_t* __restrict__ accept_out,
                            typename Gm::T* __restrict__ det_out, int N,
                            typename Gm::T lamb, typename Gm::T sign0,
                            typename Gm::T sign1, int det_power,
                            int use_boson) {
  using T = typename Gm::T;
  constexpr int QR = tiled::planes_in_registers<true, 1, Gm::NP, T>();
  extern __shared__ __align__(16) unsigned char smem_cx[];
  __shared__ __align__(16) T diag[4];  // the other flavor's G[n, n]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / 2;
  const size_t base = 2 * ((size_t)c * 2 + rank) * N * N;
  const FlavorPair<T> xch{cluster.map_shared_rank(diag, rank ^ 1), diag,
                          rank};
  phase_clock::Clock clk;
  tiled::sweep_chain<true, 1, QR, Gm, tiled::NoWrap, FlavorPair<T>>(
      reinterpret_cast<T*>(smem_cx), G_in + base, G_out + base,
      sigma_in + (size_t)c * N, sigma_out + (size_t)c * N, u + (size_t)c * N,
      nullptr, nullptr, accept_out + (size_t)c * N, det_out + 2 * (size_t)c * N,
      nullptr, N, lamb, sign0, sign1, det_power, use_boson, clk,
      tiled::NoWrap{}, xch);
#ifdef MC_PHASE_STAMPS
  if (threadIdx.x == 0) clk.store(g_stamps, blockIdx.x);
#endif
}

// Shared memory of one block of the one-block layout at F flavors
template <int F, class Gm>
constexpr int block_smem() {
  using T = typename Gm::T;
  return tiled::smem_bytes<
      true, F, tiled::planes_in_registers<true, F, Gm::NP, T>(), Gm::NP, T>();
}

template <class Gm>
int launch_flavors(const typename Gm::T* G_in, typename Gm::T* G_out,
                   const int8_t* sigma_in, int8_t* sigma_out,
                   const typename Gm::T* u, uint8_t* accept,
                   typename Gm::T* det, int C, int N, typename Gm::T lamb,
                   typename Gm::T sign0, typename Gm::T sign1, int det_power,
                   int use_boson, cudaStream_t stream) {
  constexpr int smem = block_smem<1, Gm>();
  static_assert(smem <= 232448, "one flavor a block fits");
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_tiled_cx_flavors<Gm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_tiled_cx_flavors<Gm><<<2 * C, Gm::NT, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, accept, det, N, lamb, sign0,
      sign1, det_power, use_boson);
  return (int)cudaGetLastError();
}

template <int F, class Gm>
int launch(const typename Gm::T* G_in, typename Gm::T* G_out,
           const int8_t* sigma_in, int8_t* sigma_out,
           const typename Gm::T* u, uint8_t* accept, typename Gm::T* det,
           int C, int N, typename Gm::T lamb, typename Gm::T sign0,
           typename Gm::T sign1, int det_power, int use_boson,
           cudaStream_t stream) {
  constexpr int smem = block_smem<F, Gm>();
  // complex128 at F = 2 past N = 64: one flavor a block
  if constexpr (smem > 232448) {
    return launch_flavors<Gm>(G_in, G_out, sigma_in, sigma_out, u, accept,
                              det, C, N, lamb, sign0, sign1, det_power,
                              use_boson, stream);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        site_sweep_tiled_cx<F, Gm>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    site_sweep_tiled_cx<F, Gm><<<C, Gm::NT, smem, stream>>>(
        G_in, G_out, sigma_in, sigma_out, u, accept, det, N, lamb, sign0,
        sign1, det_power, use_boson);
    return (int)cudaGetLastError();
  }
}

template <class T>
int launch_cx(const void* G_in, void* G_out, const int8_t* sigma_in,
              int8_t* sigma_out, const T* u, uint8_t* accept, void* det,
              int C, int F, int N, T lamb, T sign0, T sign1, int det_power,
              int use_boson, void* stream) {
  if (C == 0) return 0;
  if (N < 1 || N > 128 || F < 1 || F > 2 || det_power < 1 || det_power > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const T* gi = (const T*)G_in;
  T* go = (T*)G_out;
  T* dt = (T*)det;
  return tiled::with_layout<T>(N, [&](auto gm) {
    using Gm = decltype(gm);
    if (F == 1)
      return launch<1, Gm>(gi, go, sigma_in, sigma_out, u, accept, dt, C, N,
                           lamb, sign0, sign1, det_power, use_boson, st);
    return launch<2, Gm>(gi, go, sigma_in, sigma_out, u, accept, dt, C, N,
                         lamb, sign0, sign1, det_power, use_boson, st);
  });
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). G is complex64
// (interleaved re, im), accept one byte per site, det complex64 (C, N).
// N <= 128, F in {1, 2}, det_power in {1, 2}.
extern "C" int site_sweep_cx_c64(const void* G_in, void* G_out,
                                 const int8_t* sigma_in, int8_t* sigma_out,
                                 const float* u, uint8_t* accept, void* det,
                                 int C, int F, int N, float lamb, float sign0,
                                 float sign1, int det_power, int use_boson,
                                 void* stream) {
  return launch_cx<float>(G_in, G_out, sigma_in, sigma_out, u, accept, det,
                          C, F, N, lamb, sign0, sign1, det_power, use_boson,
                          stream);
}

// K8-c128: G and det complex128, u float64. N <= 128, F in {1, 2} (F = 2
// past N = 64: a cluster of 2 blocks per chain), det_power in {1, 2}.
extern "C" int site_sweep_cx_c128(const void* G_in, void* G_out,
                                  const int8_t* sigma_in, int8_t* sigma_out,
                                  const double* u, uint8_t* accept, void* det,
                                  int C, int F, int N, double lamb,
                                  double sign0, double sign1, int det_power,
                                  int use_boson, void* stream) {
  return launch_cx<double>(G_in, G_out, sigma_in, sigma_out, u, accept, det,
                           C, F, N, lamb, sign0, sign1, det_power, use_boson,
                           stream);
}

// K8-c128's instances of the rank-1 layout (F, CS, KR) that the plan takes
// past N = 64 (ops/site_sweep_cx.py::RANK1_BUILDS): one block per chain
// with 20 (F = 1) or 11 (F = 2) register rows a thread and flavor, or a
// cluster of 2 with 16 or 10
using K8Rank1 = rank1::List<rank1::Inst<1, 1, 20>, rank1::Inst<1, 2, 16>,
                            rank1::Inst<2, 1, 11>, rank1::Inst<2, 2, 10>>;

// K8-c128 past N = 64 in the rank-1 layout (csrc/site_sweep_rank1.cuh): G
// complex128 (C, F, N, N) as it is, on chip at row length NP (N padded to
// a multiple of 8) in clusters of CS blocks of TR x NP threads holding KR
// rows a thread and flavor in registers, the rest in shared memory; sigma,
// u, accept and det (C, N). Returns the cudaError_t of the launch.
extern "C" int site_sweep_cx_c128_rank1(
    const void* G_in, void* G_out, const int8_t* sigma_in, int8_t* sigma_out,
    const double* u, uint8_t* accept, void* det, int C, int F, int N, int NP,
    int CS, int TR, int KR, double lamb, double sign0, double sign1,
    int det_power, int use_boson, void* stream) {
  long long* stamps = nullptr;
#ifdef MC_PHASE_STAMPS
  void* p = nullptr;
  if (cudaGetSymbolAddress(&p, g_stamps) == cudaSuccess)
    stamps = (long long*)p;
#endif
  return rank1::launch<8>(K8Rank1{}, G_in, G_out, sigma_in, sigma_out, u,
                             nullptr, nullptr, nullptr, accept, det, stamps,
                             C, F, NP, N, N, CS, TR, KR, lamb, sign0, sign1,
                             det_power, use_boson, (cudaStream_t)stream);
}

// The most clusters of that layout the card runs at once, into *out
extern "C" int site_sweep_cx_c128_rank1_max_clusters(int F, int NP, int CS,
                                                     int TR, int KR,
                                                     int* out) {
  return rank1::max_clusters<8>(K8Rank1{}, F, NP, CS, TR, KR, out);
}

// Phase stamps of the last launch (complex64 or complex128) of the first
// n_blocks blocks (kPhases cycle sums each) into dst on the host: a build
// with -DMC_PHASE_STAMPS only.
extern "C" int site_sweep_cx_c64_stamps(void* dst, int n_blocks,
                                        void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
