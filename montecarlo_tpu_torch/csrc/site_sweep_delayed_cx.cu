// Delayed site-major Metropolis sweep over one DQMC time slice for a complex
// Green's function, N > 128 (kernel K9: complex hopping, e.g. Peierls
// phases, past the N where K8 keeps G in shared memory).
//
// Replaces montecarlo_tpu/ops/pallas_site_sweep.py::_sitemajor_kernel_cx
// (reached through _site_sweep_sitemajor_cx / get_fused_site_sweep_cx). The
// plain PyTorch version with the same op order is
// montecarlo_tpu_torch/ops/site_sweep_delayed_cx.py::
// site_sweep_delayed_cx_plain.
//
// Per chain and site i, K8's decision (csrc/site_sweep_cx.cu): delta_f real,
// r_f = 1 + delta_f (1 - G_f[i, i]) and det = (prod_f r_f)^det_power
// complex, accept = u_i < exp(-dEb)^use_boson * Re(det); every site's
// accept flag and det go out for the caller's phase-problem statistics; on
// accept G_f -= y_f (x) G_f[i, :] with y_f = x_f (e_i - G_f[:, i]),
// x_f = delta_f conj(r_f) / |r_f|^2.
//
// What bounds it: at N = 256 one chain's G is 512 KB of complex64, more than
// the 227 KB of shared memory a block may use, so G cannot stay in shared
// memory as in K8, and every pass over it goes to L2 (64 chains of F = 1
// hold 32 MB, resident in the 50 MB L2). A rank-1 sweep would pass over G
// once per accepted site; this kernel passes over it once per block of DK
// sites: per chain and slice about 2 * (N / DK) * F * N^2 complex values
// (8 MB at N = 256, DK = 32, F = 1) and up to 8 * N^2 * N FP32 operations
// for the fold, less in proportion to the rejected sites. The N sequential
// decisions and their barriers set the floor underneath.
//
// Design: K6's (csrc/site_sweep_delayed.cu) on two float32 planes. One block
// of 512 threads per chain (one block per chain leaves 68 of the H100's 132
// SMs idle at 64 chains, which this first version accepts). For the block of
// sites i0..i0+DK-1 the row slab G[i0:i0+DK, :] and the column slab
// G[:, i0:i0+DK] (rows of N+1 floats) sit in shared memory as re and im
// planes, 2 * (DK*N + DK*(N+1)) * 4 B = 131 KB at N = 256, DK = 32, F = 1,
// and stay exactly updated through the DK decisions, which read G_ii from the
// row slab. An accepted site stages y = x (e_i - G[:, i]) and b = G[i, :] --
// both read BEFORE the update -- folds y (x) b into both slabs, and stores y
// and b in a global scratch buffer (the slabs leave no room for DK of them).
// A rejected site costs no barrier and no fold. After the block, each
// flavor's accepted y, b are loaded into the (now free) slab memory and
// G -= y_k (x) b_k is applied in slot order, each complex product rounded
// and then subtracted, over register tiles of 4 rows x 2 complex columns
// with float4 loads: FP32 in the kernel, no tensor cores, no cuBLAS. G is
// read from G_in by the first block's fold and lives in G_out from then on.
//
// Every value uses the _rn intrinsics, which nvcc never contracts into FMAs,
// in K8's op order (a complex product re = ar*br - ai*bi, im = ar*bi +
// ai*br, then subtracted), so the kernel rounds as the plain version's
// separate PyTorch operations do, and the slabs and G hold exactly the
// values K8's rank-1 sweep would. The TPU kernel's chains-on-sublanes
// layout and its transposed copies of G are Mosaic workarounds and are not
// carried over: the column slab is read from G itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

// g -= a * b on the (re, im) planes, in K8's order
__device__ __forceinline__ void cfold(float& gr, float& gi, float ar, float ai,
                                      float br, float bi) {
  gr = __fsub_rn(gr, __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi)));
  gi = __fsub_rn(gi, __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br)));
}

template <int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_delayed_cx_kernel(const float2* __restrict__ G_in,
                             float2* __restrict__ G_out,
                             const int8_t* __restrict__ sigma_in,
                             int8_t* __restrict__ sigma_out,
                             const float* __restrict__ u,
                             uint8_t* __restrict__ accept_out,
                             float2* __restrict__ det_out,
                             float* __restrict__ scratch, int C, int N,
                             int DK, float lamb, float sign0, float sign1,
                             int det_power, int use_boson) {
  extern __shared__ __align__(16) float smem[];
  const int LDC = N + 1;
  const int RS = F * DK * N, CS = F * DK * LDC;
  float* Rr = smem;           // row slab [f][s][n] at (f*DK + s)*N + n
  float* Ri = Rr + RS;
  float* Cr = Ri + RS;        // column slab [f][s][r] at (f*DK + s)*LDC + r
  float* Ci = Cr + CS;
  float* yr_s = Ci + CS;      // [f][r]: y of the current site
  float* yi_s = yr_s + F * N;
  float* br_s = yi_s + F * N;  // [f][n]: G[i, :] of the current site
  float* bi_s = br_s + F * N;
  const int c = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const size_t gbase = (size_t)c * F * N * N;
  // scratch: four planes (y re, y im, b re, b im) of [C][f][k][N] floats
  const size_t plane = (size_t)C * F * DK * N;
  float* Ayr = scratch + (size_t)c * F * DK * N;
  float* Ayi = Ayr + plane;
  float* Abr = Ayi + plane;
  float* Abi = Abr + plane;
  float2* Gc = G_out + gbase;

  const float neg2lamb = -2.f * lamb;
  for (int i0 = 0; i0 < N; i0 += DK) {
    const float2* src = i0 == 0 ? G_in + gbase : Gc;  // G before this block
    for (int e = tid; e < F * DK * N; e += nth) {
      const int f = e / (DK * N), rem = e - f * DK * N;
      const int s = rem / N, n = rem - s * N;
      const float2 g = src[(size_t)(f * N + i0 + s) * N + n];
      Rr[e] = g.x;
      Ri[e] = g.y;
      // column slab: consecutive threads read consecutive columns of a row
      const int cs = rem % DK, cr = rem / DK;
      const float2 h = src[(size_t)(f * N + cr) * N + i0 + cs];
      Cr[(f * DK + cs) * LDC + cr] = h.x;
      Ci[(f * DK + cs) * LDC + cr] = h.y;
    }
    __syncthreads();

    int k = 0;  // accepted sites of this block (the same in every thread)
    for (int t = 0; t < DK; ++t) {
      const int i = i0 + t;
      const int8_t s8 = sigma_in[c * N + i];
      const float dEb = __fmul_rn(neg2lamb, (float)s8);
      float delta[F], rr[F], ri[F];
      float pr = 0.f, pi = 0.f;
      for (int f = 0; f < F; ++f) {
        const float sg = f == 0 ? sign0 : sign1;
        delta[f] = __fsub_rn(expf(__fmul_rn(sg, dEb)), 1.f);
        const float gr = Rr[(f * DK + t) * N + i];
        const float gi = Ri[(f * DK + t) * N + i];
        rr[f] = __fadd_rn(1.f, __fmul_rn(delta[f], __fsub_rn(1.f, gr)));
        ri[f] = -__fmul_rn(delta[f], gi);
        if (f == 0) {
          pr = rr[0];
          pi = ri[0];
        } else {
          const float npr =
              __fsub_rn(__fmul_rn(pr, rr[f]), __fmul_rn(pi, ri[f]));
          const float npi =
              __fadd_rn(__fmul_rn(pr, ri[f]), __fmul_rn(pi, rr[f]));
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
      for (int e = tid; e < F * N; e += nth) {
        const int f = e / N, n = e - f * N;
        // constant indices keep delta/r in registers
        const float d = f == 0 ? delta[0] : delta[F - 1];
        const float r_re = f == 0 ? rr[0] : rr[F - 1];
        const float r_im = f == 0 ? ri[0] : ri[F - 1];
        const float inv = __fdiv_rn(
            1.f, __fadd_rn(__fmul_rn(r_re, r_re), __fmul_rn(r_im, r_im)));
        const float xr = __fmul_rn(__fmul_rn(d, r_re), inv);
        const float xi = -__fmul_rn(__fmul_rn(d, r_im), inv);
        const int ci = (f * DK + t) * LDC + n;
        const float igr = __fsub_rn(n == i ? 1.f : 0.f, Cr[ci]);
        const float igi = -Ci[ci];
        const float yr = __fsub_rn(__fmul_rn(xr, igr), __fmul_rn(xi, igi));
        const float yi = __fadd_rn(__fmul_rn(xr, igi), __fmul_rn(xi, igr));
        const float br = Rr[(f * DK + t) * N + n];
        const float bi = Ri[(f * DK + t) * N + n];
        yr_s[e] = yr;
        yi_s[e] = yi;
        br_s[e] = br;
        bi_s[e] = bi;
        const size_t slot = (size_t)(f * DK + k) * N + n;
        Ayr[slot] = yr;
        Ayi[slot] = yi;
        Abr[slot] = br;
        Abi[slot] = bi;
      }
      ++k;
      __syncthreads();
      for (int e = tid; e < F * DK * N; e += nth) {
        const int f = e / (DK * N), rem = e - f * DK * N;
        const int s = rem / N, n = rem - s * N;
        const int fo = f * N;
        // R[s, n] = G[i0+s, n] -= y[i0+s] b[n]
        cfold(Rr[e], Ri[e], yr_s[fo + i0 + s], yi_s[fo + i0 + s],
              br_s[fo + n], bi_s[fo + n]);
        // C[s, n] = G[n, i0+s] -= y[n] b[i0+s]
        const int cx = (f * DK + s) * LDC + n;
        cfold(Cr[cx], Ci[cx], yr_s[fo + n], yi_s[fo + n], br_s[fo + i0 + s],
              bi_s[fo + i0 + s]);
      }
      __syncthreads();
    }

    // block fold G -= sum_k y_k (x) b_k, in slot order; the first block also
    // moves G from G_in to G_out when it accepted nothing
    if (k > 0 || i0 == 0) {
      float* Syr = smem;  // [k][r], reuses the slab memory
      float* Syi = Syr + k * N;
      float* Sbr = Syi + k * N;  // [k][n]
      float* Sbi = Sbr + k * N;
      const int NR = N / 4, NC = N / 2;  // tiles of 4 rows x 2 columns
      for (int f = 0; f < F; ++f) {
        __syncthreads();
        const size_t fo = (size_t)f * DK * N;
        for (int e = tid; e < k * N; e += nth) {
          Syr[e] = Ayr[fo + e];
          Syi[e] = Ayi[fo + e];
          Sbr[e] = Abr[fo + e];
          Sbi[e] = Abi[fo + e];
        }
        __syncthreads();
        const float2* Sf = src + (size_t)f * N * N;
        float2* Df = Gc + (size_t)f * N * N;
        for (int e = tid; e < NR * NC; e += nth) {
          const int rt = e / NC, ct = e - rt * NC;
          // g[q] = (re, im) of G[4rt+q, 2ct] and of G[4rt+q, 2ct+1]
          float4 g[4];
          for (int q = 0; q < 4; ++q)
            g[q] = *reinterpret_cast<const float4*>(
                &Sf[(size_t)(4 * rt + q) * N + 2 * ct]);
          for (int p = 0; p < k; ++p) {
            const float4 ar =
                *reinterpret_cast<const float4*>(&Syr[p * N + 4 * rt]);
            const float4 ai =
                *reinterpret_cast<const float4*>(&Syi[p * N + 4 * rt]);
            const float2 br =
                *reinterpret_cast<const float2*>(&Sbr[p * N + 2 * ct]);
            const float2 bi =
                *reinterpret_cast<const float2*>(&Sbi[p * N + 2 * ct]);
            const float yr[4] = {ar.x, ar.y, ar.z, ar.w};
            const float yi[4] = {ai.x, ai.y, ai.z, ai.w};
            for (int q = 0; q < 4; ++q) {
              cfold(g[q].x, g[q].y, yr[q], yi[q], br.x, bi.x);
              cfold(g[q].z, g[q].w, yr[q], yi[q], br.y, bi.y);
            }
          }
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float4*>(&Df[(size_t)(4 * rt + q) * N + 2 * ct]) =
                g[q];
        }
      }
    }
    __syncthreads();
  }
}

template <int F>
int launch(const float2* G_in, float2* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const float* u, uint8_t* accept, float2* det,
           float* scratch, int C, int N, int DK, float lamb, float sign0,
           float sign1, int det_power, int use_boson, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * F * DK * N + 2 * F * DK * (N + 1) + 4 * F * N) *
      sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_delayed_cx_kernel<F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_delayed_cx_kernel<F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, accept, det, scratch, C, N, DK,
      lamb, sign0, sign1, det_power, use_boson);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). G is complex64
// (interleaved re, im), accept one byte per site, det complex64 (C, N).
// 8 | N, DK | N, F in {1, 2}; scratch holds 4 * C * F * DK * N floats.
extern "C" int site_sweep_delayed_cx_c64(const void* G_in, void* G_out,
                                         const int8_t* sigma_in,
                                         int8_t* sigma_out, const float* u,
                                         uint8_t* accept, void* det,
                                         float* scratch, int C, int F, int N,
                                         int DK, float lamb, float sign0,
                                         float sign1, int det_power,
                                         int use_boson, void* stream) {
  if (C == 0) return 0;
  if (N < 8 || N % 8 || DK < 1 || N % DK || det_power < 1 || det_power > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* gi = (const float2*)G_in;
  float2* go = (float2*)G_out;
  float2* dt = (float2*)det;
  if (F == 1)
    return launch<1>(gi, go, sigma_in, sigma_out, u, accept, dt, scratch, C,
                     N, DK, lamb, sign0, sign1, det_power, use_boson, st);
  if (F == 2)
    return launch<2>(gi, go, sigma_in, sigma_out, u, accept, dt, scratch, C,
                     N, DK, lamb, sign0, sign1, det_power, use_boson, st);
  return (int)cudaErrorInvalidValue;
}
