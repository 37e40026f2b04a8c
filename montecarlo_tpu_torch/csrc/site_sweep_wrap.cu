// Site sweep with the slice's wrap fused in (kernel K13), float32.
//
// Replaces montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel with
// wrap_dir = +1 / -1 (its in-kernel MXU wrap :160 _mxu_wrap_block; reached
// through get_fused_site_sweep_wrap and core._sweep_slice_fused_wrap, which
// the JAX package runs under MC_TPU_FUSE_WRAP=1). The plain PyTorch version
// is montecarlo_tpu_torch/ops/site_sweep.py::site_sweep_wrap_plain.
//
// Per chain, with the slice's HS field s and the flavor's coupling sign sg,
// ev = exp(lamb sg s) and evinv = exp(-lamb sg s) (diagonals), and the
// wrap's operands Ml (left) and Mr (right), both N x N:
//   wrap_dir = -1 (down): the wrap runs BEFORE the sweep, with the
//     pre-update s:  G <- evinv ⊙_row (Ml · (G · Mr)) ⊙_col ev,
//     Ml = exp(+dtau T), Mr = exp(-dtau T);
//   wrap_dir = +1 (up): K1's sweep, then the wrap with the post-update s:
//     G <- Ml · ((ev ⊙_row G ⊙_col evinv) · Mr),
//     Ml = exp(-dtau T), Mr = exp(+dtau T).
// The TPU kernel takes Mr transposed (MrT) because Mosaic contracts a
// slice's leading axis; here the kernel reads Mr itself. The association
// is the TPU kernel's, Ml · (M · Mr), not that of the separate wrap_up /
// wrap_down, so G differs from the unfused visit by rounding only.
//
// The site loop is K1's (site_sweep_loop.cuh), with its _rn operations
// unchanged: in the up direction sigma, acc and nneg are bit-equal to K1's
// on the same inputs. The wrap's two products are FP32 FMAs on the CUDA
// cores with float32 accumulation, as the TPU kernel's Precision.HIGHEST
// dots: no tensor cores, whose only FP32 input is TF32, which the
// propagation path must not use. The diagonal scalings round separately, as
// the TPU kernel's.
//
// What bounds it: K1's sequential site loop (shared-memory RMW and barriers
// inside one block, see site_sweep.cu) plus 4 F N^3 FP32 operations of the
// wrap per chain, which one 256-thread block runs from shared memory (G and
// the middle term Z) and L2 (Ml and Mr, the same for every chain). At
// N = 64 that is ~1 MFLOP per chain against ~0.5 MFLOP of rank-1 updates;
// the kernel stays latency-bound inside the block, far from the card's FP32
// rate or its memory bandwidth (G is read once and written once).
//
// Design: K1's block per chain with G in padded shared memory for the whole
// visit, plus one N x (N+1) scratch for Z and N bytes for the updated
// sigma: (F N (N+1) + 2 F N + N (N+1)) floats and N bytes, 200,320 bytes
// at F = 2, N = 128, inside a block's 232,448. Thread (tx, ty) forms column tx of
// rows ty, ty + rstep, ... of each product, kRows rows at a time in
// registers: reading Mr[k, tx] (coalesced across the warp) and G[a, k] from
// shared memory (one address per warp row: a broadcast) for Z = M · Mr, and
// Ml[i, a] (one address per warp row) and Z[a, tx] for Ml · Z. This is the
// simple, correct kernel; staging Ml and Mr in shared memory where they fit
// and tensor-core-free register tiling are later work.

#include "site_sweep_loop.cuh"

namespace {

constexpr int kRows = 8;  // output rows per thread per pass of a product

// One flavor block g (N x N in shared memory, rows padded to N+1) through
// the wrap of direction DIR, with its diagonals ev and evinv (N each, in
// shared memory) and the scratch Zs (N x (N+1)). Starts and ends with every
// thread at a barrier.
template <int DIR>
__device__ void wrap_flavor(float* g, float* Zs, const float* ev,
                            const float* evinv, const float* __restrict__ Ml,
                            const float* __restrict__ Mr, int N) {
  const Tile t(N);
  const int LD = N + 1;
  if (DIR > 0) {  // M = ev ⊙_row G ⊙_col evinv, rounded after each scaling
    if (t.active)
      for (int a = t.ty; a < N; a += t.rstep) {
        float* p = &g[a * LD + t.tx];
        *p = mul_rn(mul_rn(*p, ev[a]), evinv[t.tx]);
      }
    __syncthreads();
  }
  // Z = M · Mr
  if (t.active)
    for (int a0 = t.ty; a0 < N; a0 += kRows * t.rstep) {
      float z[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) z[r] = 0.f;
      for (int k = 0; k < N; ++k) {
        const float b = Mr[k * N + t.tx];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int a = a0 + r * t.rstep;
          if (a < N) z[r] = fmaf(g[a * LD + k], b, z[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int a = a0 + r * t.rstep;
        if (a < N) Zs[a * LD + t.tx] = z[r];
      }
    }
  __syncthreads();
  // G = Ml · Z, then (down) evinv ⊙_row . ⊙_col ev
  if (t.active)
    for (int i0 = t.ty; i0 < N; i0 += kRows * t.rstep) {
      float w[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) w[r] = 0.f;
      for (int a = 0; a < N; ++a) {
        const float z = Zs[a * LD + t.tx];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r * t.rstep;
          if (i < N) w[r] = fmaf(Ml[i * N + a], z, w[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r * t.rstep;
        if (i < N)
          g[i * LD + t.tx] =
              DIR < 0 ? mul_rn(mul_rn(w[r], evinv[i]), ev[t.tx]) : w[r];
      }
    }
  __syncthreads();
}

// The wrap of every flavor block of Gs from the field s (N entries): ev and
// evinv of flavor f go to ev_buf and evinv_buf (N floats each).
template <int F, int DIR>
__device__ void wrap_chain(float* Gs, float* Zs, float* ev_buf,
                           float* evinv_buf, const float* __restrict__ Ml,
                           const float* __restrict__ Mr, const int8_t* s,
                           int N, float lamb, float sign0, float sign1) {
  const int LD = N + 1;
  for (int f = 0; f < F; ++f) {
    // lamb * sign is +-lamb exactly, so each factor is exp(+-lamb s) rounded
    // once, as the TPU kernel's exp(float32(power lamb sg) s)
    const float x = mul_rn(lamb, f == 0 ? sign0 : sign1);
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      const float sk = (float)s[k];
      ev_buf[k] = expf(mul_rn(x, sk));
      evinv_buf[k] = expf(mul_rn(-x, sk));
    }
    __syncthreads();
    wrap_flavor<DIR>(Gs + f * N * LD, Zs, ev_buf, evinv_buf, Ml, Mr, N);
  }
}

template <int F, int DIR>
__global__ void __launch_bounds__(kThreads)
site_sweep_wrap_kernel(const float* __restrict__ G_in,
                       float* __restrict__ G_out,
                       const int8_t* __restrict__ sigma_in,
                       int8_t* __restrict__ sigma_out,
                       const float* __restrict__ u, int* __restrict__ acc_out,
                       int* __restrict__ nneg_out,
                       const float* __restrict__ Ml,
                       const float* __restrict__ Mr, int N, float lamb,
                       float sign0, float sign1, int det_power,
                       int use_boson) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = N + 1;
  float* Gs = reinterpret_cast<float*>(smem_raw);  // [f][a][b], as K1
  float* rows = Gs + F * N * LD;  // K1's staging; ev during the wrap
  float* cols = rows + F * N;     // K1's staging; evinv during the wrap
  float* Zs = cols + F * N;       // the wrap's middle term, N x (N+1)
  int8_t* sig = reinterpret_cast<int8_t*>(Zs + N * LD);  // updated sigma
  const int c = blockIdx.x;
  const size_t base = (size_t)c * F * N * N;

  load_g<float, F>(G_in + base, Gs, N);
  __syncthreads();
  if (DIR < 0)
    wrap_chain<F, -1>(Gs, Zs, rows, cols, Ml, Mr, sigma_in + c * N, N, lamb,
                      sign0, sign1);
  int acc = 0, nneg = 0;
  float neg_min = 0.f, neg_max = 0.f, neg_sum = 0.f;  // not recorded
  sweep_sites<float, F>(Gs, rows, cols, N, sigma_in + c * N, sig, u + c * N,
                        lamb, sign0, sign1, det_power, use_boson, false, acc,
                        nneg, neg_min, neg_max, neg_sum);
  __syncthreads();
  if (DIR > 0)
    wrap_chain<F, +1>(Gs, Zs, rows, cols, Ml, Mr, sig, N, lamb, sign0,
                      sign1);
  store_g<float, F>(Gs, G_out + base, N);
  for (int k = threadIdx.x; k < N; k += blockDim.x)
    sigma_out[c * N + k] = sig[k];
  if (threadIdx.x == 0) {
    acc_out[c] = acc;
    nneg_out[c] = nneg;
  }
}

template <int F, int DIR>
int launch(const float* G_in, float* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const float* u, int* acc, int* nneg,
           const float* Ml, const float* Mr, int C, int N, float lamb,
           float sign0, float sign1, int det_power, int use_boson,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(F * N * (N + 1) + 2 * F * N + N * (N + 1)) * sizeof(float) +
      N;
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_wrap_kernel<F, DIR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_wrap_kernel<F, DIR><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, acc, nneg, Ml, Mr, N, lamb, sign0,
      sign1, det_power, use_boson);
  return (int)cudaGetLastError();
}

}  // namespace

// Return the cudaError_t of the launch (0 = success). float32, N <= 128,
// F in {1,2}, wrap_dir in {+1, -1}; Ml, Mr (N, N) row-major, shared by every
// chain.
extern "C" int site_sweep_wrap_f32(const float* G_in, float* G_out,
                                   const int8_t* sigma_in, int8_t* sigma_out,
                                   const float* u, int* acc, int* nneg,
                                   const float* Ml, const float* Mr, int C,
                                   int F, int N, float lamb, float sign0,
                                   float sign1, int det_power, int use_boson,
                                   int wrap_dir, void* stream) {
  if (C == 0) return 0;
  if (N < 1 || N > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define MCT_WRAP_LAUNCH(F_, D_)                                               \
  return launch<F_, D_>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, Ml, \
                        Mr, C, N, lamb, sign0, sign1, det_power, use_boson,  \
                        st)
  if (F == 1 && wrap_dir == 1) MCT_WRAP_LAUNCH(1, 1);
  if (F == 1 && wrap_dir == -1) MCT_WRAP_LAUNCH(1, -1);
  if (F == 2 && wrap_dir == 1) MCT_WRAP_LAUNCH(2, 1);
  if (F == 2 && wrap_dir == -1) MCT_WRAP_LAUNCH(2, -1);
#undef MCT_WRAP_LAUNCH
  return (int)cudaErrorInvalidValue;
}
