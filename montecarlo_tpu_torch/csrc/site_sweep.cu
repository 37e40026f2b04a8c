// Sequential Metropolis site sweep over one DQMC time slice (kernel K1), in
// float32 and in float64.
//
// The float32 instance (site_sweep_f32) replaces
// montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel in col_read mode
// (reached through _site_sweep_batched / get_fused_site_sweep). The float64
// instance (site_sweep_f64) replaces the XLA site loop the JAX package runs
// for float64 updates (montecarlo_tpu/dqmc/core.py::sweep_slice, the
// lax.fori_loop over sites): Mosaic is float32-only, so there is no TPU
// kernel for it. The plain PyTorch version with the same op order, for
// both, is montecarlo_tpu_torch/ops/site_sweep.py::site_sweep_plain.
//
// What bounds it: the N decisions of a chain are sequential, and each
// accepted one is an O(F*N^2) rank-1 read-modify-write of G. At the DQMC
// sizes (F*N*N = 4096 elements) that is a few thousand shared-memory FMAs
// and two barriers per site, so the kernel is bound by shared-memory
// bandwidth and barrier latency inside one block, not by device memory or
// FLOPs; with one block per chain, 128-256 chains give one or two blocks per
// SM.
//
// Design: one thread block per chain; G of the chain (F x N x N) lives in
// dynamic shared memory for the whole site loop, so device memory is
// touched once to load G and once to store it. Rows are padded to N+1
// elements so the column read G[:, i] is free of bank conflicts. Every
// thread computes the accept decision itself from the same shared values (no
// broadcast barrier); only accepted sites stage row i and the scaled column
// x*(e_i - G[:, i]) -- both read BEFORE the update overwrites them -- and
// apply the rank-1 update. All arithmetic uses the _rn intrinsics (__f*_rn
// in float32, __d*_rn in float64), which nvcc never fuses into FMAs, so
// every value matches the plain PyTorch version's separately rounded
// operations. float64 doubles the shared memory: F*N*(N+1)*8 bytes must fit
// one block's 227 KB, so N <= 128 at F = 1 and N <= 119 at F = 2.
//
// The TPU kernel's chain-on-lanes layout, one-hot contractions and
// grid-as-site-loop are Mosaic workarounds and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// separately rounded operations of each element type
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_kernel(const T* __restrict__ G_in, T* __restrict__ G_out,
                  const int8_t* __restrict__ sigma_in,
                  int8_t* __restrict__ sigma_out, const T* __restrict__ u,
                  int* __restrict__ acc_out, int* __restrict__ nneg_out,
                  int N, T lamb, T sign0, T sign1, int det_power,
                  int use_boson) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = N + 1;
  T* Gs = reinterpret_cast<T*>(smem_raw);  // [f][a][b] at (f*N + a)*LD + b
  T* rows = Gs + F * N * LD;               // [f][b]: G_f[i, b]
  T* cols = rows + F * N;      // [f][a]: x_f * (e_i - G_f[:, i])[a]
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % N, ty = tid / N, rstep = blockDim.x / N;
  const bool active = ty < rstep;
  const size_t base = (size_t)c * F * N * N;
  const T one = 1;

  if (active) {
    for (int f = 0; f < F; ++f)
      for (int a = ty; a < N; a += rstep)
        Gs[(f * N + a) * LD + tx] = G_in[base + (size_t)(f * N + a) * N + tx];
  }
  __syncthreads();

  const T neg2lamb = mul_rn(T(-2), lamb);
  int acc = 0, nneg = 0;
  for (int i = 0; i < N; ++i) {
    const int8_t s8 = sigma_in[c * N + i];
    const T dEb = mul_rn(neg2lamb, (T)s8);
    T delta[F], r[F];
    T rprod = one;
    for (int f = 0; f < F; ++f) {
      const T sg = f == 0 ? sign0 : sign1;
      delta[f] = sub_rn(exp_(mul_rn(sg, dEb)), one);
      const T gii = Gs[(f * N + i) * LD + i];
      r[f] = add_rn(one, mul_rn(delta[f], sub_rn(one, gii)));
      rprod = f == 0 ? r[f] : mul_rn(rprod, r[f]);
    }
    T det = rprod;
    for (int k = 1; k < det_power; ++k) det = mul_rn(det, rprod);
    const T w = use_boson ? exp_(-dEb) : one;
    const bool accept = u[c * N + i] < mul_rn(w, det);
    if (tid == 0) {
      acc += accept;
      nneg += det < T(0);
      sigma_out[c * N + i] = accept ? (int8_t)(-s8) : s8;
    }
    if (!accept) continue;  // block-uniform: every thread decided the same
    for (int e = tid; e < F * N; e += blockDim.x) {
      const int f = e / N, a = e - f * N;
      // constant indices keep delta/r in registers
      const T x = f == 0 ? div_rn(delta[0], r[0])
                         : div_rn(delta[F - 1], r[F - 1]);
      rows[e] = Gs[(f * N + i) * LD + a];
      const T ig = sub_rn(a == i ? one : T(0), Gs[(f * N + a) * LD + i]);
      cols[e] = mul_rn(x, ig);
    }
    __syncthreads();
    if (active) {
      for (int f = 0; f < F; ++f) {
        const T rb = rows[f * N + tx];
        for (int a = ty; a < N; a += rstep) {
          T* g = &Gs[(f * N + a) * LD + tx];
          *g = sub_rn(*g, mul_rn(cols[f * N + a], rb));
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

template <typename T, int F>
int launch(const T* G_in, T* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const T* u, int* acc, int* nneg, int C,
           int N, T lamb, T sign0, T sign1, int det_power, int use_boson,
           cudaStream_t stream) {
  const size_t smem = (size_t)(F * N * (N + 1) + 2 * F * N) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_kernel<T, F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, acc, nneg, N, lamb, sign0, sign1,
      det_power, use_boson);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* G_in, T* G_out, const int8_t* sigma_in,
             int8_t* sigma_out, const T* u, int* acc, int* nneg, int C, int F,
             int N, T lamb, T sign0, T sign1, int det_power, int use_boson,
             void* stream) {
  if (C == 0) return 0;
  if (N < 1 || N > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (F == 1)
    return launch<T, 1>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, N,
                        lamb, sign0, sign1, det_power, use_boson, st);
  if (F == 2)
    return launch<T, 2>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, N,
                        lamb, sign0, sign1, det_power, use_boson, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Return the cudaError_t of the launch (0 = success). N <= 128, F in {1,2};
// a float64 G that does not fit one block's shared memory fails the launch.
extern "C" int site_sweep_f32(const float* G_in, float* G_out,
                              const int8_t* sigma_in, int8_t* sigma_out,
                              const float* u, int* acc, int* nneg, int C,
                              int F, int N, float lamb, float sign0,
                              float sign1, int det_power, int use_boson,
                              void* stream) {
  return dispatch<float>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C, F,
                         N, lamb, sign0, sign1, det_power, use_boson, stream);
}

extern "C" int site_sweep_f64(const double* G_in, double* G_out,
                              const int8_t* sigma_in, int8_t* sigma_out,
                              const double* u, int* acc, int* nneg, int C,
                              int F, int N, double lamb, double sign0,
                              double sign1, int det_power, int use_boson,
                              void* stream) {
  return dispatch<double>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, C,
                          F, N, lamb, sign0, sign1, det_power, use_boson,
                          stream);
}
