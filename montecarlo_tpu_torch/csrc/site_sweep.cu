// Sequential Metropolis site sweep over one DQMC time slice (kernel K1).
//
// Replaces montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel in
// col_read mode (reached through _site_sweep_batched / get_fused_site_sweep).
// The plain PyTorch version with the same op order is
// montecarlo_tpu_torch/ops/site_sweep.py::site_sweep_plain.
//
// What bounds it: the N decisions of a chain are sequential, and each
// accepted one is an O(F*N^2) rank-1 read-modify-write of G. At the DQMC
// sizes (F*N*N = 4096 floats) that is a few thousand shared-memory FMAs
// and two barriers per site, so the kernel is bound by shared-memory
// bandwidth and barrier latency inside one block, not by device memory or
// FLOPs; with one block per chain, 256 chains give ~2 blocks per SM.
//
// Design: one thread block per chain; G of the chain (F x N x N float32)
// lives in dynamic shared memory for the whole site loop, so device memory
// is touched once to load G and once to store it. Rows are padded to N+1
// floats so the column read G[:, i] is free of bank conflicts. Every thread
// computes the accept decision itself from the same shared values (no
// broadcast barrier); only accepted sites stage row i and the scaled column
// x*(e_i - G[:, i]) -- both read BEFORE the update overwrites them -- and
// apply the rank-1 update. The decision arithmetic uses the _rn intrinsics,
// which nvcc never fuses into FMAs, so every value matches the plain
// PyTorch version's separately rounded float32 operations.
//
// The TPU kernel's chain-on-lanes layout, one-hot contractions and
// grid-as-site-loop are Mosaic workarounds and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_kernel(const float* __restrict__ G_in, float* __restrict__ G_out,
                  const int8_t* __restrict__ sigma_in,
                  int8_t* __restrict__ sigma_out, const float* __restrict__ u,
                  int* __restrict__ acc_out, int* __restrict__ nneg_out,
                  int N, float lamb, float sign0, float sign1, int det_power,
                  int use_boson) {
  extern __shared__ float smem[];
  const int LD = N + 1;
  float* Gs = smem;                  // [f][a][b] at (f*N + a)*LD + b
  float* rows = Gs + F * N * LD;     // [f][b]: G_f[i, b]
  float* cols = rows + F * N;        // [f][a]: x_f * (e_i - G_f[:, i])[a]
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

  const float neg2lamb = -2.f * lamb;
  int acc = 0, nneg = 0;
  for (int i = 0; i < N; ++i) {
    const int8_t s8 = sigma_in[c * N + i];
    const float dEb = __fmul_rn(neg2lamb, (float)s8);
    float delta[F], r[F];
    float rprod = 1.f;
    for (int f = 0; f < F; ++f) {
      const float sg = f == 0 ? sign0 : sign1;
      delta[f] = __fsub_rn(expf(__fmul_rn(sg, dEb)), 1.f);
      const float gii = Gs[(f * N + i) * LD + i];
      r[f] = __fadd_rn(1.f, __fmul_rn(delta[f], __fsub_rn(1.f, gii)));
      rprod = f == 0 ? r[f] : __fmul_rn(rprod, r[f]);
    }
    float det = rprod;
    for (int k = 1; k < det_power; ++k) det = __fmul_rn(det, rprod);
    const float w = use_boson ? expf(-dEb) : 1.f;
    const bool accept = u[c * N + i] < __fmul_rn(w, det);
    if (tid == 0) {
      acc += accept;
      nneg += det < 0.f;
      sigma_out[c * N + i] = accept ? (int8_t)(-s8) : s8;
    }
    if (!accept) continue;  // block-uniform: every thread decided the same
    for (int e = tid; e < F * N; e += blockDim.x) {
      const int f = e / N, a = e - f * N;
      // constant indices keep delta/r in registers
      const float x = f == 0 ? __fdiv_rn(delta[0], r[0])
                             : __fdiv_rn(delta[F - 1], r[F - 1]);
      rows[e] = Gs[(f * N + i) * LD + a];
      const float ig = __fsub_rn(a == i ? 1.f : 0.f, Gs[(f * N + a) * LD + i]);
      cols[e] = __fmul_rn(x, ig);
    }
    __syncthreads();
    if (active) {
      for (int f = 0; f < F; ++f) {
        const float rb = rows[f * N + tx];
        for (int a = ty; a < N; a += rstep) {
          float* g = &Gs[(f * N + a) * LD + tx];
          *g = __fsub_rn(*g, __fmul_rn(cols[f * N + a], rb));
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
int launch(const float* G_in, float* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const float* u, int* acc, int* nneg, int C,
           int N, float lamb, float sign0, float sign1, int det_power,
           int use_boson, cudaStream_t stream) {
  const size_t smem = (size_t)(F * N * (N + 1) + 2 * F * N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_kernel<F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, acc, nneg, N, lamb, sign0, sign1,
      det_power, use_boson);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). N <= 128, F in {1,2}.
extern "C" int site_sweep_f32(const float* G_in, float* G_out,
                              const int8_t* sigma_in, int8_t* sigma_out,
                              const float* u, int* acc, int* nneg, int C,
                              int F, int N, float lamb, float sign0,
                              float sign1, int det_power, int use_boson,
                              void* stream) {
  if (C == 0) return 0;
  if (N < 1 || N > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (F == 1)
    return launch<1>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, N,
                     lamb, sign0, sign1, det_power, use_boson, st);
  if (F == 2)
    return launch<2>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, N,
                     lamb, sign0, sign1, det_power, use_boson, st);
  return (int)cudaErrorInvalidValue;
}
