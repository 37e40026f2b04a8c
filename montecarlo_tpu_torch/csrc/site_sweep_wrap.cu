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
// The site loop is K1's (site_sweep_tiled.cuh, the same code and _rn
// operations): in the up direction sigma, acc and nneg are bit-equal to
// K1's on the same inputs. The wrap's two products are FP32 FMAs on the
// CUDA cores with float32 accumulation, as the TPU kernel's
// Precision.HIGHEST dots: no tensor cores, whose only FP32 input is TF32,
// which the propagation path must not use. Each output element's k-sum is
// one chain of fmaf over k = 0..N-1 from 0, and the diagonal scalings round
// separately, as the TPU kernel's.
//
// Design: K1's block of 256 threads per chain with G over the registers
// (site_sweep_tiled.cuh: thread (ty, tx) owns an RT x CT tile of G padded to
// NP x NP), and the wrap as two register-tiled products whose output tile
// is the thread's own tile of G, so neither direction adds a pass over G
// in shared memory: down goes load -> wrap -> sweep -> store, up load ->
// sweep -> wrap -> store. Per flavor: the thread writes its tile of M
// (the scaled G) transposed into X and the block stages Mr into W; then
// Z = M · Mr accumulates into the tile from a row of X (the thread's rows)
// and a row of W (its columns) per k, RT + CT floats for RT x CT FMAs;
// Z goes back into X row-major, Ml^T into W, and Ml · Z accumulates into
// the tile the same way. X and W are NP x (NP + 4) floats each (rows
// padded by 16 bytes: the transposed writes spread over the banks), 34 KB
// at NP = 64 and 132 KB at NP = 128, beside the loop's staging. Ml and Mr
// are the same for every chain and come from L2.
//
// What bounds it: K1's sequential site loop (one barrier-and-staging round
// trip per site inside one block, see site_sweep.cu) plus 4 F N^3 FP32
// operations of the wrap per chain. At N = 64 that is ~1 MFLOP per chain
// against ~0.5 MFLOP of rank-1 updates. The products read two float4 of
// shared memory per 16 FMAs (NP = 64; four per 64 at NP = 128), so they run
// near the SM's FP32 rate, and the kernel stays latency-bound in its site
// loop, far from the card's FP32 rate or its memory bandwidth (G is read
// once and written once).

#include "phase_clock.cuh"
#include "site_sweep_tiled.cuh"

namespace {

#ifdef MC_PHASE_STAMPS
// phases (thread 0 of each block): K1's 0 load, 1 decision, 2 update,
// 3 publish, 4 barrier, 5 store, and the wrap's 6 diagonals, staging and
// Z = M Mr, 7 Ml Z and the down direction's scaling
__device__ long long g_stamps[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

// The wrap of direction DIR on the thread tiles of G (F flavors in
// registers), with the shared-memory matrices X and W (NP x LD floats
// each).
template <int F, int DIR, class Gm>
struct TiledWrap {
  static constexpr int NP = Gm::NP, LD = NP + 4, NT = Gm::NT;
  static constexpr int RT = Gm::RT, CT = Gm::CT, WR = Gm::WR, WC = Gm::WC;
  float* X;
  float* W;
  const float* __restrict__ Ml;
  const float* __restrict__ Mr;
  int N;
  float lamb, sign0, sign1;

  // The product P = A · B into the tile t (RT x CT), A^T's rows and B's
  // rows in shared memory (A^T at a, B at b, both with row stride LD): per
  // k < N the thread's RT entries of row k of A^T and CT of row k of B.
  __device__ __forceinline__ void product(float (&t)[RT][CT], const float* a,
                                          const float* b, int ty,
                                          int tx) const {
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int j = 0; j < CT; ++j) t[k][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < N; ++kk) {
      float av[RT], bv[CT];
#pragma unroll
      for (int k0 = 0; k0 < RT; k0 += WR)
        tiled::ld_vec<WR>(a + kk * LD + Gm::row(ty, k0), av + k0);
#pragma unroll
      for (int j0 = 0; j0 < CT; j0 += WC)
        tiled::ld_vec<WC>(b + kk * LD + Gm::col(tx, j0), bv + j0);
#pragma unroll
      for (int k = 0; k < RT; ++k)
#pragma unroll
        for (int j = 0; j < CT; ++j) t[k][j] = fmaf(av[k], bv[j], t[k][j]);
    }
  }

  // One flavor's tile t through the wrap, the field s (N entries in shared
  // memory) and x = lamb sg. Starts and ends with every thread at a
  // barrier.
  __device__ __forceinline__ void flavor(float (&t)[RT][CT], const int8_t* s,
                                         float x, phase_clock::Clock& clk,
                                         bool t0) const {
    const int tid = threadIdx.x, ty = tid / Gm::TC, tx = tid % Gm::TC;
    // exp(x s) and exp(-x s) for s = +-1: lamb sg s is +-x exactly, so each
    // factor is one rounding of exp, as the TPU kernel's exp(float32(power
    // lamb sg) s); up scales rows by ev and columns by evinv, down rows by
    // evinv and columns by ev
    const float ep = expf(x), em = expf(-x);
    float fr[RT], fc[CT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int a = Gm::row(ty, k);
      const bool up = a >= N || s[a] > 0;
      fr[k] = (DIR > 0) == up ? ep : em;
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int b = Gm::col(tx, j);
      const bool up = b >= N || s[b] > 0;
      fc[j] = (DIR > 0) == up ? em : ep;
    }
    // X <- M^T (up: M = ev ⊙_row G ⊙_col evinv, rounded after each
    // scaling; down: M = G), W <- Mr, padded columns 0
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int k0 = 0; k0 < RT; k0 += WR) {
        float m[WR];
#pragma unroll
        for (int w = 0; w < WR; ++w)
          m[w] = DIR > 0 ? __fmul_rn(__fmul_rn(t[k0 + w][j], fr[k0 + w]),
                                     fc[j])
                         : t[k0 + w][j];
        tiled::st_vec<WR>(X + Gm::col(tx, j) * LD + Gm::row(ty, k0), m);
      }
    for (int e = tid; e < N * NP; e += NT) {
      const int k = e / NP, b = e - k * NP;
      W[k * LD + b] = b < N ? Mr[k * N + b] : 0.f;
    }
    __syncthreads();
    product(t, X, W, ty, tx);  // Z = M · Mr
    if (t0) clk.lap(6);
    __syncthreads();
    // X <- Z, W <- Ml^T (padded columns 0): a warp reads an 8 x 4 block of
    // Ml (rows i, columns a) and writes it transposed, lane (a, i) to bank
    // (4 a + i) mod 32, so the writes never collide
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int j0 = 0; j0 < CT; j0 += WC)
        tiled::st_vec<WC>(X + Gm::row(ty, k) * LD + Gm::col(tx, j0),
                          &t[k][j0]);
    const int lane = tid & 31;
    for (int blk = tid >> 5; blk < (N + 7) / 8 * (NP / 4); blk += NT / 32) {
      const int a = blk / (NP / 4) * 8 + (lane & 7);
      const int i = blk % (NP / 4) * 4 + (lane >> 3);
      if (a < N) W[a * LD + i] = i < N ? Ml[i * N + a] : 0.f;
    }
    __syncthreads();
    product(t, W, X, ty, tx);  // Ml · Z
    if (DIR < 0) {
#pragma unroll
      for (int k = 0; k < RT; ++k)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          t[k][j] = __fmul_rn(__fmul_rn(t[k][j], fr[k]), fc[j]);
    }
    __syncthreads();  // X and W free for the next flavor
    if (t0) clk.lap(7);
  }

  template <class TileT>
  __device__ __forceinline__ void run(TileT& g, const int8_t* s,
                                      phase_clock::Clock& clk) const {
    const bool t0 = threadIdx.x == 0;
    __syncthreads();  // s written
#pragma unroll
    for (int f = 0; f < F; ++f)
      flavor(g.r[f], s, __fmul_rn(lamb, f == 0 ? sign0 : sign1), clk, t0);
  }

  template <class TileT>
  __device__ __forceinline__ void before(TileT& g, const int8_t* s,
                                         phase_clock::Clock& clk) const {
    if constexpr (DIR < 0) {
      if (threadIdx.x == 0) clk.lap(0);
      run(g, s, clk);
    }
  }

  template <class TileT>
  __device__ __forceinline__ void after(TileT& g, const int8_t* s,
                                        phase_clock::Clock& clk) const {
    if constexpr (DIR > 0) run(g, s, clk);
  }
};

// Shared memory of one block, in bytes: K1's loop, then X and W (16-byte
// aligned). ops/site_sweep.py::wrap_smem_bytes mirrors it.
template <int F, class Gm>
constexpr int wrap_smem_bytes() {
  return (tiled::smem_bytes<false, F, F, Gm::NP>() + 15) / 16 * 16 +
         2 * Gm::NP * (Gm::NP + 4) * 4;
}

template <int F, int DIR, class Gm>
__global__ void __launch_bounds__(Gm::NT)
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
  extern __shared__ __align__(16) float smem_wrap[];
  constexpr int NP = Gm::NP;
  constexpr int X0 = (tiled::smem_bytes<false, F, F, NP>() + 15) / 16 * 4;
  const int c = blockIdx.x;
  const size_t base = (size_t)c * F * N * N;
  const TiledWrap<F, DIR, Gm> wrap{smem_wrap + X0,
                                   smem_wrap + X0 + NP * (NP + 4),
                                   Ml, Mr, N, lamb, sign0, sign1};
  phase_clock::Clock clk;
  tiled::sweep_chain<false, F, F, Gm>(
      smem_wrap, G_in + base, G_out + base, sigma_in + (size_t)c * N,
      sigma_out + (size_t)c * N, u + (size_t)c * N, acc_out + c,
      nneg_out + c, nullptr, nullptr, nullptr, N, lamb, sign0, sign1,
      det_power, use_boson, clk, wrap);
#ifdef MC_PHASE_STAMPS
  if (threadIdx.x == 0) clk.store(g_stamps, c);
#endif
}

template <int F, int DIR, class Gm>
int launch(const float* G_in, float* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const float* u, int* acc, int* nneg,
           const float* Ml, const float* Mr, int C, int N, float lamb,
           float sign0, float sign1, int det_power, int use_boson,
           cudaStream_t stream) {
  constexpr int smem = wrap_smem_bytes<F, Gm>();
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_wrap_kernel<F, DIR, Gm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_wrap_kernel<F, DIR, Gm><<<C, Gm::NT, smem, stream>>>(
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
  if (N < 1 || N > 128 || F < 1 || F > 2 || (wrap_dir != 1 && wrap_dir != -1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return tiled::with_layout(N, [&](auto gm) {
    using Gm = decltype(gm);
#define MCT_WRAP_LAUNCH(F_, D_)                                               \
  launch<F_, D_, Gm>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, Ml, Mr, \
                     C, N, lamb, sign0, sign1, det_power, use_boson, st)
    if (F == 1)
      return wrap_dir > 0 ? MCT_WRAP_LAUNCH(1, 1) : MCT_WRAP_LAUNCH(1, -1);
    return wrap_dir > 0 ? MCT_WRAP_LAUNCH(2, 1) : MCT_WRAP_LAUNCH(2, -1);
#undef MCT_WRAP_LAUNCH
  });
}

// Phase stamps of the last K13 launch's first n_blocks blocks into dst on
// the host: a build with -DMC_PHASE_STAMPS only.
extern "C" int site_sweep_wrap_f32_stamps(void* dst, int n_blocks,
                                          void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
