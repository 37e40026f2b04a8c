// Delayed site-major Metropolis sweep over one DQMC time slice, N > 128
// (kernel K6).
//
// Replaces montecarlo_tpu/ops/pallas_site_sweep.py::_sitemajor_delayed_kernel
// (reached through _site_sweep_sitemajor_delayed) and, at DK = 1, its per-site
// fallback ::_sitemajor_kernel (_site_sweep_sitemajor). The plain PyTorch
// version with the same op order is
// montecarlo_tpu_torch/ops/site_sweep_delayed.py::site_sweep_delayed_plain.
//
// What bounds it: at N = 256 one flavor of G is 256 KB, more than the 227 KB
// of shared memory a block may use, so G cannot stay in shared memory as in
// K1 (csrc/site_sweep.cu) and every pass over it goes to L2 (64 chains of
// F = 1 hold 16 MB, resident in the 50 MB L2). A rank-1 sweep would pass
// over G once per accepted site; this kernel passes over it once per block
// of DK sites, so per chain and slice it moves about 2 * (N / DK) * F * N^2
// floats (4 MB at N = 256, DK = 32, F = 1) and does up to 2 * N^2 * N FP32
// operations for the fold, less in proportion to the rejected sites. The
// N sequential decisions and their barriers set the floor underneath.
//
// Design: one block of 512 threads per chain; one block per chain leaves
// 68 of the H100's 132 SMs idle at 64 chains, which this first version
// accepts. For the block of sites i0..i0+DK-1 the row slab G[i0:i0+DK, :]
// and the column slab G[:, i0:i0+DK] (rows of N+1 floats, so that loading
// it from G's rows is free of bank conflicts) sit in shared memory and are
// kept exactly updated through the DK decisions, which read G_ii from the
// row slab. An accepted site stages a = x * (e_i - G[:, i]) and b = G[i, :]
// -- both read BEFORE the update -- folds a (x) b into both slabs, and
// stores a and b in a global scratch buffer: at F = 2, N = 256, DK = 32 the
// slabs alone take 128 KB, which leaves no room for the DK vectors of a and
// b in shared memory. A rejected site costs no barrier and no fold. After
// the block, each flavor's accepted a, b are loaded into the (now free) slab
// memory and G -= a_k (x) b_k is applied in slot order, each product rounded
// and then subtracted, over 4x4 register tiles with float4 loads: FP32 in
// the kernel, no tensor cores, no cuBLAS. G is read from G_in by the first
// block's fold and lives in G_out from then on.
//
// Every decision, slab and fold value uses the _rn intrinsics, which nvcc
// never contracts into FMAs, so the kernel rounds as the plain version's
// separate PyTorch operations do. G is not symmetric: the column slab is
// read from G itself (the TPU kernel's transposed copy of G and its chain-on-
// sublane layout are Mosaic workarounds and are not carried over).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ void fold4(float4& g, float a, const float4& b) {
  g.x = __fsub_rn(g.x, __fmul_rn(a, b.x));
  g.y = __fsub_rn(g.y, __fmul_rn(a, b.y));
  g.z = __fsub_rn(g.z, __fmul_rn(a, b.z));
  g.w = __fsub_rn(g.w, __fmul_rn(a, b.w));
}

template <int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_delayed_kernel(const float* __restrict__ G_in,
                          float* __restrict__ G_out,
                          const int8_t* __restrict__ sigma_in,
                          int8_t* __restrict__ sigma_out,
                          const float* __restrict__ u,
                          int* __restrict__ acc_out, int* __restrict__ nneg_out,
                          float* __restrict__ scratch, int C, int N, int DK,
                          float lamb, float sign0, float sign1, int det_power,
                          int use_boson) {
  extern __shared__ float smem[];
  const int LDC = N + 1;
  float* Rs = smem;                  // [f][s][n] at (f*DK + s)*N + n
  float* Cs = Rs + F * DK * N;       // [f][s][r] at (f*DK + s)*LDC + r
  float* sa = Cs + F * DK * LDC;     // [f][r]: a of the current site
  float* sb = sa + F * N;            // [f][n]: b of the current site
  const int c = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const size_t gbase = (size_t)c * F * N * N;
  float* Ag = scratch + (size_t)c * F * DK * N;        // [f][k][r]
  float* Bg = scratch + ((size_t)C + c) * F * DK * N;  // [f][k][n]
  float* Gc = G_out + gbase;

  const float neg2lamb = -2.f * lamb;
  int acc = 0, nneg = 0;
  for (int i0 = 0; i0 < N; i0 += DK) {
    const float* src = i0 == 0 ? G_in + gbase : Gc;  // G before this block
    for (int e = tid; e < F * DK * N; e += nth) {
      const int f = e / (DK * N), rem = e - f * DK * N;
      const int s = rem / N, n = rem - s * N;
      Rs[e] = src[(size_t)(f * N + i0 + s) * N + n];
      // column slab: consecutive threads read consecutive columns of a row
      const int cs = rem % DK, cr = rem / DK;
      Cs[(f * DK + cs) * LDC + cr] = src[(size_t)(f * N + cr) * N + i0 + cs];
    }
    __syncthreads();

    int k = 0;  // accepted sites of this block (the same in every thread)
    for (int t = 0; t < DK; ++t) {
      const int i = i0 + t;
      const int8_t s8 = sigma_in[c * N + i];
      const float dEb = __fmul_rn(neg2lamb, (float)s8);
      float delta[F], r[F];
      float rprod = 1.f;
      for (int f = 0; f < F; ++f) {
        const float sg = f == 0 ? sign0 : sign1;
        delta[f] = __fsub_rn(expf(__fmul_rn(sg, dEb)), 1.f);
        const float gii = Rs[(f * DK + t) * N + i];
        r[f] = __fadd_rn(1.f, __fmul_rn(delta[f], __fsub_rn(1.f, gii)));
        rprod = f == 0 ? r[f] : __fmul_rn(rprod, r[f]);
      }
      float det = rprod;
      for (int q = 1; q < det_power; ++q) det = __fmul_rn(det, rprod);
      const float w = use_boson ? expf(-dEb) : 1.f;
      const bool accept = u[c * N + i] < __fmul_rn(w, det);
      if (tid == 0) {
        acc += accept;
        nneg += det < 0.f;
        sigma_out[c * N + i] = accept ? (int8_t)(-s8) : s8;
      }
      if (!accept) continue;  // block-uniform: every thread decided the same
      for (int e = tid; e < F * N; e += nth) {
        const int f = e / N, n = e - f * N;
        const float x = f == 0 ? __fdiv_rn(delta[0], r[0])
                               : __fdiv_rn(delta[F - 1], r[F - 1]);
        const float a = __fmul_rn(
            x, __fsub_rn(n == i ? 1.f : 0.f, Cs[(f * DK + t) * LDC + n]));
        const float b = Rs[(f * DK + t) * N + n];
        sa[e] = a;
        sb[e] = b;
        Ag[(size_t)(f * DK + k) * N + n] = a;
        Bg[(size_t)(f * DK + k) * N + n] = b;
      }
      ++k;
      __syncthreads();
      for (int e = tid; e < F * DK * N; e += nth) {
        const int f = e / (DK * N), rem = e - f * DK * N;
        const int s = rem / N, n = rem - s * N;
        const float* af = sa + f * N;
        const float* bf = sb + f * N;
        Rs[e] = __fsub_rn(Rs[e], __fmul_rn(af[i0 + s], bf[n]));
        float* cv = &Cs[(f * DK + s) * LDC + n];
        *cv = __fsub_rn(*cv, __fmul_rn(bf[i0 + s], af[n]));
      }
      __syncthreads();
    }

    // block fold G -= sum_k a_k (x) b_k, in slot order; the first block also
    // moves G from G_in to G_out when it accepted nothing
    if (k > 0 || i0 == 0) {
      float* As = smem;          // [k][r], reuses the slab memory
      float* Bs = smem + k * N;  // [k][n]
      const int NT = N / 4;
      for (int f = 0; f < F; ++f) {
        __syncthreads();
        for (int e = tid; e < k * N; e += nth) {
          As[e] = Ag[(size_t)f * DK * N + e];
          Bs[e] = Bg[(size_t)f * DK * N + e];
        }
        __syncthreads();
        const float* Sf = src + (size_t)f * N * N;
        float* Df = Gc + (size_t)f * N * N;
        for (int e = tid; e < NT * NT; e += nth) {
          const int rt = e / NT, ct = e - rt * NT;
          float4 g[4];
          for (int q = 0; q < 4; ++q)
            g[q] = *reinterpret_cast<const float4*>(
                &Sf[(size_t)(4 * rt + q) * N + 4 * ct]);
          for (int p = 0; p < k; ++p) {
            const float4 av = *reinterpret_cast<const float4*>(&As[p * N + 4 * rt]);
            const float4 bv = *reinterpret_cast<const float4*>(&Bs[p * N + 4 * ct]);
            fold4(g[0], av.x, bv);
            fold4(g[1], av.y, bv);
            fold4(g[2], av.z, bv);
            fold4(g[3], av.w, bv);
          }
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float4*>(&Df[(size_t)(4 * rt + q) * N + 4 * ct]) =
                g[q];
        }
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    acc_out[c] = acc;
    nneg_out[c] = nneg;
  }
}

template <int F>
int launch(const float* G_in, float* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const float* u, int* acc, int* nneg,
           float* scratch, int C, int N, int DK, float lamb, float sign0,
           float sign1, int det_power, int use_boson, cudaStream_t stream) {
  const size_t smem =
      (size_t)(F * DK * N + F * DK * (N + 1) + 2 * F * N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_delayed_kernel<F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_delayed_kernel<F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, acc, nneg, scratch, C, N, DK, lamb,
      sign0, sign1, det_power, use_boson);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). 4 | N, DK | N,
// F in {1, 2}; scratch holds 2 * C * F * DK * N floats.
extern "C" int site_sweep_delayed_f32(const float* G_in, float* G_out,
                                      const int8_t* sigma_in,
                                      int8_t* sigma_out, const float* u,
                                      int* acc, int* nneg, float* scratch,
                                      int C, int F, int N, int DK, float lamb,
                                      float sign0, float sign1, int det_power,
                                      int use_boson, void* stream) {
  if (C == 0) return 0;
  if (N < 4 || N % 4 || DK < 1 || N % DK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (F == 1)
    return launch<1>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, scratch,
                     C, N, DK, lamb, sign0, sign1, det_power, use_boson, st);
  if (F == 2)
    return launch<2>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, scratch,
                     C, N, DK, lamb, sign0, sign1, det_power, use_boson, st);
  return (int)cudaErrorInvalidValue;
}
