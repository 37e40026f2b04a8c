// The Ising model's two moves: the checkerboard Metropolis sweep (kernel
// K17) and one level of the Wolff cluster's breadth-first search (K18).
//
// Neither replaces a TPU kernel: the JAX package runs both as XLA loops
// fused into one jitted lax.scan per block of sweeps
// (montecarlo_tpu/mc/mc.py:146-185): the sweep is
// montecarlo_tpu/models/ising.py:88-103, the BFS level the body of its
// lax.while_loop at :131-148. In plain PyTorch each color class would cost
// about ten launches and a (C, n_c, z) gather, each BFS level as many again,
// so the port's main path runs these two kernels, as it runs K1-f64 for the
// JAX package's float64 XLA site loop. Their plain PyTorch versions are
// montecarlo_tpu_torch/ops/ising.py::ising_sweep_plain and
// wolff_step_plain.
//
// K17 (ising_sweep_i8). What bounds it: bytes. A sweep reads each site's
// spin (1 byte) and its float64 uniform (8 bytes) once and writes the spin
// once; the neighbor table (N x z int32, shared by every chain) stays in
// the read-only cache. Design: one warp per chain, eight chains per block,
// the chain's spins in shared memory (N bytes). Per color class in order,
// the warp's lanes take the class's sites in turn: h = s_i * sum_nn s_j
// (dE = 2h), accept when h <= 0 or u < thr[h], thr[h] = exp(-2 beta h)
// computed once on the host in float64, and flip the accepted spins in
// shared memory. No site of a class neighbors another of the same class
// (Lattice.site_colors), so the flips of one class never change another
// decision of that class; a __syncwarp between classes orders them. The
// uniforms arrive in class order (the class's sites in their order in
// Lattice.site_colors, classes one after another), so a warp reads them in
// consecutive 8-byte words. Each chain's accepted count is added to its
// int64 accumulator acc[c], which the caller keeps on the device across a
// chunk of sweeps: integer sums, the same in any order. The decisions
// compare the same float64 values as the plain version, so conf and the
// counts are bit-equal to it.
//
// K18 (wolff_step_u8). What bounds it: bytes, 8z + 5 per site and level
// (the level's float64 uniforms, conf, in_cluster and frontier read, the new
// in_cluster and frontier written). The JAX body scatters the activated
// bonds onto their targets with an OR (.at[].max); here each thread owns one
// target site t of one chain and gathers instead: t joins the frontier when
// it is not in the cluster, has the seed's spin, and one of the bonds (i, k)
// with table[i, k] = t (the reverse table rev, built on the host) has i on
// the frontier and u[c, i, k] < p_add. Every output is written by the one
// thread that owns it, so the result does not depend on thread order. A
// thread that adds a site stores 1 into the level's flag (pre-zeroed by the
// caller; every store writes the same value), which the host reads to end
// the search.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // chains per block of K17
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 232448;      // a block's dynamic shared memory

__global__ void ising_sweep_kernel(const int8_t* __restrict__ conf_in,
                                   int8_t* __restrict__ conf_out,
                                   const double* __restrict__ u,
                                   const int* __restrict__ table,
                                   const int* __restrict__ order,
                                   const int* __restrict__ offsets,
                                   const double* __restrict__ thr,
                                   long long* __restrict__ acc, int C, int N,
                                   int z, int n_classes, int NP) {
  extern __shared__ int8_t spins[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= C) return;             // the whole warp: no block barrier
  int8_t* s = spins + (long long)warp * NP;
  const int8_t* cin = conf_in + chain * N;
  for (int i = lane; i < N; i += 32) s[i] = cin[i];
  __syncwarp();
  const double* uc = u + chain * N;
  int count = 0;
  for (int k = 0; k < n_classes; ++k) {
    const int hi = __ldg(offsets + k + 1);
    for (int p = __ldg(offsets + k) + lane; p < hi; p += 32) {
      const int i = __ldg(order + p);
      const int* nb = table + (long long)i * z;
      int nn = 0;
      for (int j = 0; j < z; ++j) nn += s[__ldg(nb + j)];
      const int h = s[i] * nn;        // dE / 2
      if (h <= 0 || uc[p] < __ldg(thr + h)) {
        s[i] = -s[i];
        ++count;
      }
    }
    __syncwarp();
  }
  int8_t* cout = conf_out + chain * N;
  for (int i = lane; i < N; i += 32) cout[i] = s[i];
  for (int o = 16; o; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  if (lane == 0) acc[chain] += count;
}

__global__ void wolff_step_kernel(const int8_t* __restrict__ conf,
                                  const uint8_t* __restrict__ in_cluster,
                                  const uint8_t* __restrict__ frontier,
                                  const int8_t* __restrict__ seed_spin,
                                  const double* __restrict__ u,
                                  const int* __restrict__ rev,
                                  uint8_t* __restrict__ in_out,
                                  uint8_t* __restrict__ front_out,
                                  int* __restrict__ flag, double p_add, int C,
                                  int N, int z, int zr) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * N) return;
  const long long c = idx / N;
  const int t = (int)(idx - c * N);
  const uint8_t inc = in_cluster[idx];
  bool add = false;
  if (!inc && conf[idx] == seed_spin[c]) {
    const uint8_t* fr = frontier + c * N;
    const double* uc = u + c * N * z;
    const int* rt = rev + (long long)t * zr;
    for (int r = 0; r < zr && !add; ++r) {
      const int e = __ldg(rt + r);    // i * z + k of a bond onto t, or -1
      if (e < 0) break;
      add = fr[e / z] && uc[e] < p_add;
    }
  }
  in_out[idx] = inc | (uint8_t)add;
  front_out[idx] = (uint8_t)add;
  if (add) *flag = 1;
}

}  // namespace

// K17: conf (C, N) int8 ±1 in and out, u (C, N) float64 in class order,
// table (N, z) int32, order (N,) int32 and offsets (n_classes + 1,) int32
// (the color classes), thr (z + 1,) float64, acc (C,) int64 (added to).
extern "C" int ising_sweep_i8(const int8_t* conf_in, int8_t* conf_out,
                              const double* u, const int* table,
                              const int* order, const int* offsets,
                              const double* thr, long long* acc, int C,
                              int N, int z, int n_classes, void* stream) {
  if (C == 0) return 0;
  const int NP = (N + 15) & ~15;
  if (N < 1 || z < 0 || n_classes < 1 || NP > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int warps = NP * WARPS <= SMEM_MAX ? WARPS : SMEM_MAX / NP;
  const int smem = warps * NP;
  if (smem > SMEM_DEFAULT) {
    cudaError_t e = cudaFuncSetAttribute(
        ising_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + warps - 1) / warps;
  ising_sweep_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      conf_in, conf_out, u, table, order, offsets, thr, acc, C, N, z,
      n_classes, NP);
  return (int)cudaGetLastError();
}

// K18: conf (C, N) int8, in_cluster and frontier (C, N) uint8 (bool),
// seed_spin (C,) int8, u (C, N, z) float64, rev (N, zr) int32 (-1 padded),
// in_out and front_out (C, N) uint8, flag one int32 (set to 1 when a site
// joins the frontier).
extern "C" int wolff_step_u8(const int8_t* conf, const uint8_t* in_cluster,
                             const uint8_t* frontier, const int8_t* seed_spin,
                             const double* u, const int* rev, uint8_t* in_out,
                             uint8_t* front_out, int* flag, double p_add,
                             int C, int N, int z, int zr, void* stream) {
  if (C == 0) return 0;
  if (N < 1 || z < 1 || zr < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)C * N;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  wolff_step_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      conf, in_cluster, frontier, seed_spin, u, rev, in_out, front_out, flag,
      p_add, C, N, z, zr);
  return (int)cudaGetLastError();
}
