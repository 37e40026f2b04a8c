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
// What bounds it: as for K1 (csrc/site_sweep.cu), the N decisions of a chain
// are sequential and each accepted one is an O(F*N^2) read-modify-write of
// G, now of two planes and 8 FP32 operations per element. At N = 64 that is
// a few thousand shared-memory operations and two barriers per accepted
// site: shared-memory bandwidth and barrier latency inside one block, not
// device memory or FLOPs.
//
// Design: K1's. One 256-thread block per chain; G of the chain as two
// float32 planes (re, im), rows padded to N+1 floats so the column read
// G[:, i] is free of bank conflicts, in dynamic shared memory for the whole
// site loop (32 KB at N = 64, F = 1; 128 KB at N = 128, F = 1; N = 128 at
// F = 2 would need 256 KB and is refused). Device memory is touched once to
// load G and once to store it. Every thread computes the decision itself
// from the same shared values; only accepted sites stage row i and y (both
// read before the update overwrites them) and apply the update. The complex
// arithmetic is written out on the two planes in the plain version's order
// with _rn intrinsics, which nvcc never fuses into FMAs, so the kernel
// rounds every value as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_cx_kernel(const float2* __restrict__ G_in,
                     float2* __restrict__ G_out,
                     const int8_t* __restrict__ sigma_in,
                     int8_t* __restrict__ sigma_out,
                     const float* __restrict__ u,
                     uint8_t* __restrict__ accept_out,
                     float2* __restrict__ det_out, int N, float lamb,
                     float sign0, float sign1, int det_power, int use_boson) {
  extern __shared__ float smem[];
  const int LD = N + 1;
  float* Gr = smem;                   // Re G_f[a, b] at (f*N + a)*LD + b
  float* Gi = Gr + F * N * LD;        // Im G_f[a, b]
  float* rows_r = Gi + F * N * LD;    // [f][b]: G_f[i, b]
  float* rows_i = rows_r + F * N;
  float* ys_r = rows_i + F * N;       // [f][a]: y_f[a]
  float* ys_i = ys_r + F * N;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % N, ty = tid / N, rstep = blockDim.x / N;
  const bool active = ty < rstep;
  const size_t base = (size_t)c * F * N * N;

  if (active) {
    for (int f = 0; f < F; ++f)
      for (int a = ty; a < N; a += rstep) {
        const float2 g = G_in[base + (size_t)(f * N + a) * N + tx];
        Gr[(f * N + a) * LD + tx] = g.x;
        Gi[(f * N + a) * LD + tx] = g.y;
      }
  }
  __syncthreads();

  const float neg2lamb = -2.f * lamb;
  for (int i = 0; i < N; ++i) {
    const int8_t s8 = sigma_in[c * N + i];
    const float dEb = __fmul_rn(neg2lamb, (float)s8);
    float delta[F], rr[F], ri[F];
    float pr = 0.f, pi = 0.f;
    for (int f = 0; f < F; ++f) {
      const float sg = f == 0 ? sign0 : sign1;
      delta[f] = __fsub_rn(expf(__fmul_rn(sg, dEb)), 1.f);
      const float gr = Gr[(f * N + i) * LD + i];
      const float gi = Gi[(f * N + i) * LD + i];
      rr[f] = __fadd_rn(1.f, __fmul_rn(delta[f], __fsub_rn(1.f, gr)));
      ri[f] = -__fmul_rn(delta[f], gi);
      if (f == 0) {
        pr = rr[0];
        pi = ri[0];
      } else {
        const float npr = __fsub_rn(__fmul_rn(pr, rr[f]), __fmul_rn(pi, ri[f]));
        const float npi = __fadd_rn(__fmul_rn(pr, ri[f]), __fmul_rn(pi, rr[f]));
        pr = npr;
        pi = npi;
      }
    }
    float dre = pr, dim = pi;
    if (det_power == 2) {
      dre = __fsub_rn(__fmul_rn(pr, pr), __fmul_rn(pi, pi));
      dim = __fmul_rn(__fmul_rn(2.f, pr), pi);
    }
    const float w = use_boson ? expf(-dEb) : 1.f;
    const bool accept = u[c * N + i] < __fmul_rn(w, dre);
    if (tid == 0) {
      accept_out[c * N + i] = accept;
      det_out[c * N + i] = make_float2(dre, dim);
      sigma_out[c * N + i] = accept ? (int8_t)(-s8) : s8;
    }
    if (!accept) continue;  // block-uniform: every thread decided the same
    for (int e = tid; e < F * N; e += blockDim.x) {
      const int f = e / N, a = e - f * N;
      // constant indices keep delta/r in registers
      const float d = f == 0 ? delta[0] : delta[F - 1];
      const float r_re = f == 0 ? rr[0] : rr[F - 1];
      const float r_im = f == 0 ? ri[0] : ri[F - 1];
      const float inv = __fdiv_rn(
          1.f, __fadd_rn(__fmul_rn(r_re, r_re), __fmul_rn(r_im, r_im)));
      const float xr = __fmul_rn(__fmul_rn(d, r_re), inv);
      const float xi = -__fmul_rn(__fmul_rn(d, r_im), inv);
      rows_r[e] = Gr[(f * N + i) * LD + a];
      rows_i[e] = Gi[(f * N + i) * LD + a];
      const float igr = __fsub_rn(a == i ? 1.f : 0.f, Gr[(f * N + a) * LD + i]);
      const float igi = -Gi[(f * N + a) * LD + i];
      ys_r[e] = __fsub_rn(__fmul_rn(xr, igr), __fmul_rn(xi, igi));
      ys_i[e] = __fadd_rn(__fmul_rn(xr, igi), __fmul_rn(xi, igr));
    }
    __syncthreads();
    if (active) {
      for (int f = 0; f < F; ++f) {
        const float br = rows_r[f * N + tx], bi = rows_i[f * N + tx];
        for (int a = ty; a < N; a += rstep) {
          const float yr = ys_r[f * N + a], yi = ys_i[f * N + a];
          float* gr = &Gr[(f * N + a) * LD + tx];
          float* gi = &Gi[(f * N + a) * LD + tx];
          *gr = __fsub_rn(*gr, __fsub_rn(__fmul_rn(yr, br), __fmul_rn(yi, bi)));
          *gi = __fsub_rn(*gi, __fadd_rn(__fmul_rn(yr, bi), __fmul_rn(yi, br)));
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    for (int f = 0; f < F; ++f)
      for (int a = ty; a < N; a += rstep)
        G_out[base + (size_t)(f * N + a) * N + tx] = make_float2(
            Gr[(f * N + a) * LD + tx], Gi[(f * N + a) * LD + tx]);
  }
}

template <int F>
int launch(const float2* G_in, float2* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const float* u, uint8_t* accept, float2* det,
           int C, int N, float lamb, float sign0, float sign1, int det_power,
           int use_boson, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * F * N * (N + 1) + 4 * F * N) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_cx_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_cx_kernel<F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, accept, det, N, lamb, sign0,
      sign1, det_power, use_boson);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). G is complex64
// (interleaved re, im), accept one byte per site, det complex64 (C, N).
// N <= 128, F in {1, 2}, G of one chain within the shared memory of a block.
extern "C" int site_sweep_cx_c64(const void* G_in, void* G_out,
                                 const int8_t* sigma_in, int8_t* sigma_out,
                                 const float* u, uint8_t* accept, void* det,
                                 int C, int F, int N, float lamb, float sign0,
                                 float sign1, int det_power, int use_boson,
                                 void* stream) {
  if (C == 0) return 0;
  if (N < 1 || N > 128 || det_power < 1 || det_power > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* gi = (const float2*)G_in;
  float2* go = (float2*)G_out;
  float2* dt = (float2*)det;
  if (F == 1)
    return launch<1>(gi, go, sigma_in, sigma_out, u, accept, dt, C, N, lamb,
                     sign0, sign1, det_power, use_boson, st);
  if (F == 2)
    return launch<2>(gi, go, sigma_in, sigma_out, u, accept, dt, C, N, lamb,
                     sign0, sign1, det_power, use_boson, st);
  return (int)cudaErrorInvalidValue;
}
