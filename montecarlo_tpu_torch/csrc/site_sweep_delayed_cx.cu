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
// x_f = delta_f conj(r_f) / |r_f|^2, applied once per block of DK sites in
// slot order.
//
// What bounds it: the N sequential decisions of a chain and, behind them,
// up to 8 * N^2 * N FP32 operations of the folds per chain (less in
// proportion to the rejected sites); G (512 KB per flavor at N = 256) has to
// be read and written once.
//
// Design: K6's (csrc/site_sweep_delayed.cu) on two float32 planes. In
// site_sweep_delayed_cx_cluster one thread-block cluster of CS = 2 or 4 blocks
// per chain holds G in G_out, block q owning rows [q N/CS, (q+1) N/CS). Per
// block of DK sites every block reads the diagonal block of G at the block's
// start, one warp of every block runs the DK decisions on it, replaying the
// accepted slots' updates in slot order -- the same decisions in every block,
// so none is exchanged -- each block replays the slots to form y_k over its own
// rows and b_k = G[i_k, :] over all columns, and after a cluster barrier folds
// its own rows, G -= y_k (x) b_k in slot order, over register tiles of 4 rows x
// 2 complex columns; a second barrier publishes them. Shapes whose vectors and
// tables do not fit run site_sweep_delayed_cx_slab (CS = 1), the one-block
// layout: the row slab G[i0:i0+DK, :] and the column slab G[:, i0:i0+DK] (rows
// of N+1 floats) as re and im planes exactly updated through the DK decisions,
// the accepted y and b staged in a global scratch buffer, G folded in G_out
// once per block. ops/site_sweep_delayed_cx.py::cluster_plan picks the layout
// from the shape; smem_bytes there and cluster_smem_floats here agree. A
// cluster of 4 blocks holding G in their shared memory (complex64 F = 1 at N =
// 256 does not fit 2) took twice the time of 2 blocks with G in G_out on an
// H100: 30 such clusters run at once against 66 (PERF.md, PR 9).
//
// Every value uses the _rn intrinsics, which nvcc never contracts into FMAs,
// in K8's op order (a complex product re = ar*br - ai*bi, im = ar*bi +
// ai*br, then subtracted), so the kernel rounds as the plain version's
// separate PyTorch operations do, and G holds exactly the values K8's
// rank-1 sweep would. No tensor cores. The TPU kernel's chains-on-sublanes
// layout and its transposed copies of G are Mosaic workarounds and are not
// carried over: columns are read from G itself.
//
// The complex128 instance (site_sweep_delayed_cx_c128, kernel K9-c128) runs
// both layouts on double planes with the __d*_rn operations. It replaces
// the XLA loop the JAX package runs for complex128 updates past N = 128
// (montecarlo_tpu/dqmc/core.py::sweep_slice_delayed, and at DK = 1 the
// rank-1 lax.fori_loop of sweep_slice): Mosaic takes no complex128, so there
// is no TPU kernel for it. What bounds it: the folds' 8 N^2 FP64 operations
// per accepted site and chain, behind the site chain. Every buffer takes
// twice the bytes, so the cluster layout runs its b vectors in P column
// passes, as K6-f64 does (csrc/site_sweep_delayed.cu): per pass b over N/P
// columns, a cluster barrier, the fold of those columns of the own rows. At
// N = 256, F = 1 and DK = 32: clusters of 2 blocks in 2 passes, 225,568
// bytes per block.
//
// Flavor stages. The decisions need every flavor's diagonal block and
// staged tables, but the two flavors' folds never meet: flavor f's y and b
// update G_f only. Where the fold's buffers of both flavors do not fit
// (complex128 at F = 2, N = 256, DK = 32: the 16x16 repulsive model in a
// flux), the cluster layout replays and folds in S = 2 stages of one
// flavor each, its y, b and Y2, B2 buffers holding one flavor, so G_f
// takes the same subtractions in the same slot order and the kernel stays
// bit-equal. complex64 runs that shape in one stage and two column passes;
// complex128 in clusters of 4 blocks, 2 stages and 4 passes (216,896
// bytes per block).
//
// The flavor layout (site_sweep_delayed_cx_flavors, complex128 at F = 2
// where the cluster layout needs two flavor stages: the repulsive 16x16 in
// a flux at delay 32) replaces the stages there: a cluster of 2 blocks per
// chain, one flavor each, which exchange each site's r_f over distributed
// shared memory and replay and fold their own flavor in 2 row and 2 column
// passes. 64 chains take 128 blocks, one wave, where the stages' clusters
// of 4 took two: 2.42 ms of device time against 5.74-5.98 at (64, 2,
// 256, 256) on an H100 (PERF.md). What bounds it: the fold's 8 N^2 FP64
// operations per accepted site and chain and G's traffic through L2 and
// HBM (2 MB a chain, once per block of sites each way), behind the
// decision chain.
// At DK = 1 the complex128 instance runs the rank-1 layout
// (csrc/site_sweep_rank1.cuh; K6-f64's).
//
// Sites and storage, as in K6 (csrc/site_sweep_delayed.cu): N is G's row
// length in memory, NS <= N the sites the sweep visits; where 8 does not
// divide the lattice's sites, ops/site_sweep_delayed_cx.py pads G with zero
// rows and columns to a multiple of 8, which the sweep never visits, and
// every real entry stays the plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_clock.cuh"
#include "site_sweep_rank1.cuh"
#include "site_sweep_tiled.cuh"

namespace cg = cooperative_groups;

namespace {

using tiled::add_rn;
using tiled::div_rn;
using tiled::exp_;
using tiled::ld4;
using tiled::mul_rn;
using tiled::st4;
using tiled::sub_rn;
using tiled::V4;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

#ifdef MC_PHASE_STAMPS
// site_sweep_delayed_cx_slab's phases: 0 slab load, 1 decisions, 2 staging
// and slab update, 3 fold; site_sweep_delayed_cx_cluster's: 0 setup and
// copy, 1 cluster barriers, 2 diagonal block, 3 decisions, 4 y and b
// vectors, 5 fold
__device__ long long g_stamps[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

// One complex element of G as a (re, im) pair of T
template <class T>
struct Cplx;
template <>
struct Cplx<float> {
  using type = float2;
  __device__ static __forceinline__ float2 make(float r, float i) {
    return make_float2(r, i);
  }
};
template <>
struct Cplx<double> {
  using type = double2;
  __device__ static __forceinline__ double2 make(double r, double i) {
    return make_double2(r, i);
  }
};

// 2 consecutive elements of T in one access
template <class T>
__device__ __forceinline__ typename Cplx<T>::type ld2(const T* p) {
  return *reinterpret_cast<const typename Cplx<T>::type*>(p);
}

// g -= a * b on the (re, im) planes, in K8's order
template <class T>
__device__ __forceinline__ void cfold(T& gr, T& gi, T ar, T ai, T br, T bi) {
  gr = sub_rn(gr, sub_rn(mul_rn(ar, br), mul_rn(ai, bi)));
  gi = sub_rn(gi, add_rn(mul_rn(ar, bi), mul_rn(ai, br)));
}

template <class T, int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_delayed_cx_slab(const typename Cplx<T>::type* __restrict__ G_in,
                           typename Cplx<T>::type* __restrict__ G_out,
                           const int8_t* __restrict__ sigma_in,
                           int8_t* __restrict__ sigma_out,
                           const T* __restrict__ u,
                           uint8_t* __restrict__ accept_out,
                           typename Cplx<T>::type* __restrict__ det_out,
                           T* __restrict__ scratch, int C, int N, int NS,
                           int DK, T lamb, T sign0, T sign1, int det_power,
                           int use_boson) {
  using C2 = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_slab[];
  T* smem = reinterpret_cast<T*>(smem_slab);
  const int LDC = N + 1;
  const int RS = F * DK * N, CS = F * DK * LDC;
  T* Rr = smem;           // row slab [f][s][n] at (f*DK + s)*N + n
  T* Ri = Rr + RS;
  T* Cr = Ri + RS;        // column slab [f][s][r] at (f*DK + s)*LDC + r
  T* Ci = Cr + CS;
  T* yr_s = Ci + CS;      // [f][r]: y of the current site
  T* yi_s = yr_s + F * N;
  T* br_s = yi_s + F * N;  // [f][n]: G[i, :] of the current site
  T* bi_s = br_s + F * N;
  const int c = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const size_t gbase = (size_t)c * F * N * N;
  // scratch: four planes (y re, y im, b re, b im) of [C][f][k][N] elements
  const size_t plane = (size_t)C * F * DK * N;
  T* Ayr = scratch + (size_t)c * F * DK * N;
  T* Ayi = Ayr + plane;
  T* Abr = Ayi + plane;
  T* Abi = Abr + plane;
  C2* Gc = G_out + gbase;
  const T one = 1, zero = 0;

  phase_clock::Clock clk;
  if (tid == 0) clk.start();
  const T neg2lamb = T(-2) * lamb;
  for (int i0 = 0; i0 < NS; i0 += DK) {
    const C2* src = i0 == 0 ? G_in + gbase : Gc;  // G before this block
    for (int e = tid; e < F * DK * N; e += nth) {
      const int f = e / (DK * N), rem = e - f * DK * N;
      const int s = rem / N, n = rem - s * N;
      const C2 g = src[(size_t)(f * N + i0 + s) * N + n];
      Rr[e] = g.x;
      Ri[e] = g.y;
      // column slab: consecutive threads read consecutive columns of a row
      const int cs = rem % DK, cr = rem / DK;
      const C2 h = src[(size_t)(f * N + cr) * N + i0 + cs];
      Cr[(f * DK + cs) * LDC + cr] = h.x;
      Ci[(f * DK + cs) * LDC + cr] = h.y;
    }
    __syncthreads();
    if (tid == 0) clk.lap(0);

    int k = 0;  // accepted sites of this block (the same in every thread)
    for (int t = 0; t < DK; ++t) {
      const int i = i0 + t;
      const int8_t s8 = sigma_in[c * NS + i];
      const T dEb = mul_rn(neg2lamb, (T)s8);
      T delta[F], rr[F], ri[F];
      T pr = zero, pi = zero;
      for (int f = 0; f < F; ++f) {
        const T sg = f == 0 ? sign0 : sign1;
        delta[f] = sub_rn(exp_(mul_rn(sg, dEb)), one);
        const T gr = Rr[(f * DK + t) * N + i];
        const T gi = Ri[(f * DK + t) * N + i];
        rr[f] = add_rn(one, mul_rn(delta[f], sub_rn(one, gr)));
        ri[f] = -mul_rn(delta[f], gi);
        if (f == 0) {
          pr = rr[0];
          pi = ri[0];
        } else {
          const T npr = sub_rn(mul_rn(pr, rr[f]), mul_rn(pi, ri[f]));
          const T npi = add_rn(mul_rn(pr, ri[f]), mul_rn(pi, rr[f]));
          pr = npr;
          pi = npi;
        }
      }
      T dre = pr, dim = pi;
      if (det_power == 2) {
        dre = sub_rn(mul_rn(pr, pr), mul_rn(pi, pi));
        dim = mul_rn(mul_rn(T(2), pr), pi);
      }
      const T w = use_boson ? exp_(-dEb) : one;
      const bool accept = u[c * NS + i] < mul_rn(w, dre);
      if (tid == 0) {
        accept_out[c * NS + i] = accept;
        det_out[c * NS + i] = Cplx<T>::make(dre, dim);
        sigma_out[c * NS + i] = accept ? (int8_t)(-s8) : s8;
      }
      if (tid == 0) clk.lap(1);
      if (!accept) continue;  // block-uniform: every thread decided the same
      for (int e = tid; e < F * N; e += nth) {
        const int f = e / N, n = e - f * N;
        // constant indices keep delta/r in registers
        const T d = f == 0 ? delta[0] : delta[F - 1];
        const T r_re = f == 0 ? rr[0] : rr[F - 1];
        const T r_im = f == 0 ? ri[0] : ri[F - 1];
        const T inv =
            div_rn(one, add_rn(mul_rn(r_re, r_re), mul_rn(r_im, r_im)));
        const T xr = mul_rn(mul_rn(d, r_re), inv);
        const T xi = -mul_rn(mul_rn(d, r_im), inv);
        const int ci = (f * DK + t) * LDC + n;
        const T igr = sub_rn(n == i ? one : zero, Cr[ci]);
        const T igi = -Ci[ci];
        const T yr = sub_rn(mul_rn(xr, igr), mul_rn(xi, igi));
        const T yi = add_rn(mul_rn(xr, igi), mul_rn(xi, igr));
        const T br = Rr[(f * DK + t) * N + n];
        const T bi = Ri[(f * DK + t) * N + n];
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
      if (tid == 0) clk.lap(2);
    }

    // block fold G -= sum_k y_k (x) b_k, in slot order; the first block also
    // moves G from G_in to G_out when it accepted nothing
    if (k > 0 || i0 == 0) {
      T* Syr = smem;  // [k][r], reuses the slab memory
      T* Syi = Syr + k * N;
      T* Sbr = Syi + k * N;  // [k][n]
      T* Sbi = Sbr + k * N;
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
        const T* Sf = reinterpret_cast<const T*>(src + (size_t)f * N * N);
        T* Df = reinterpret_cast<T*>(Gc + (size_t)f * N * N);
        for (int e = tid; e < NR * NC; e += nth) {
          const int rt = e / NC, ct = e - rt * NC;
          // g[q] = (re, im) of G[4rt+q, 2ct] and of G[4rt+q, 2ct+1]
          V4<T> g[4];
          for (int q = 0; q < 4; ++q)
            g[q] = ld4(&Sf[2 * ((size_t)(4 * rt + q) * N + 2 * ct)]);
          for (int p = 0; p < k; ++p) {
            const V4<T> ar = ld4(&Syr[p * N + 4 * rt]);
            const V4<T> ai = ld4(&Syi[p * N + 4 * rt]);
            const auto br = ld2(&Sbr[p * N + 2 * ct]);
            const auto bi = ld2(&Sbi[p * N + 2 * ct]);
            const T yr[4] = {ar.x, ar.y, ar.z, ar.w};
            const T yi[4] = {ai.x, ai.y, ai.z, ai.w};
            for (int q = 0; q < 4; ++q) {
              cfold(g[q].x, g[q].y, yr[q], yi[q], br.x, bi.x);
              cfold(g[q].z, g[q].w, yr[q], yi[q], br.y, bi.y);
            }
          }
          for (int q = 0; q < 4; ++q)
            st4(&Df[2 * ((size_t)(4 * rt + q) * N + 2 * ct)], g[q]);
        }
      }
    }
    __syncthreads();
    if (tid == 0) clk.lap(3);
  }
#ifdef MC_PHASE_STAMPS
  if (tid == 0) clk.store(g_stamps, c);
#endif
}

// Slots of the y and b replays handled together in registers
constexpr int kChunk = 8;

// Row length of the staged tables: the slots of one site in a row, padded
// to 4-element loads and offset by 4 elements per row, so that a warp's
// float4 loads of 8 rows fall in distinct banks
__host__ __device__ inline int staged_ld(int DK) {
  return (DK + 3) / 4 * 4 + 4;
}

// Shared memory of site_sweep_delayed_cx_cluster in elements of T, with
// FS = F / S flavors per stage: re and im planes of b over the N/P columns
// of one pass [fs][k][n], y [fs][k][r], the staged y and b of the block's
// sites by site, YT [f][s][k] = y_k[i0+s] and BT [f][s][k] = b_k[i0+s],
// their entries at the slots' sites Y2 [fs][k'][k] = y_k'[i_k] and B2
// [fs][k'][k] = b_k'[i_k], the diagonal block at the block's start D0
// [f][s][s'] (rows of DK+1), its current diagonal [f][s] and x [f][k]; u
// [i], delta [f][i] and the boson weight [i] of flipping each site, the
// slots' sites and their count (ints) and sigma [i] (int8).
// ops/site_sweep_delayed_cx.py::smem_bytes mirrors it.
__host__ __device__ inline size_t cluster_smem_elems(int F, int CS, int N,
                                                     int DK, int P, int S) {
  const size_t RQ = N / CS, NCH = N / P, FS = F / S;
  return 2 * FS * DK * NCH + 2 * FS * DK * RQ +
         4 * (size_t)F * DK * staged_ld(DK) + 4 * FS * DK * DK +
         2 * (size_t)F * DK * (DK + 1) + 4 * F * DK + (F + 2) * N + DK + 4 +
         (N + 3) / 4;
}

// v -= a[0] b[0], v -= a[1] b[1], ... in that order for kp < k, each
// complex product in K8's order (a, b: 16-byte aligned re and im planes)
template <class T>
__device__ __forceinline__ void creplay(T& vr, T& vi, const T* ar,
                                        const T* ai, const T* br,
                                        const T* bi, int k) {
  int kp = 0;
#pragma unroll 2
  for (; kp + 4 <= k; kp += 4) {
    const V4<T> xr = ld4(ar + kp);
    const V4<T> xi = ld4(ai + kp);
    const V4<T> yr = ld4(br + kp);
    const V4<T> yi = ld4(bi + kp);
    cfold(vr, vi, xr.x, xi.x, yr.x, yi.x);
    cfold(vr, vi, xr.y, xi.y, yr.y, yi.y);
    cfold(vr, vi, xr.z, xi.z, yr.z, yi.z);
    cfold(vr, vi, xr.w, xi.w, yr.w, yi.w);
  }
  for (; kp < k; ++kp) cfold(vr, vi, ar[kp], ai[kp], br[kp], bi[kp]);
}

template <class T, int F, int CS>
__global__ void __launch_bounds__(kThreads)
site_sweep_delayed_cx_cluster(const typename Cplx<T>::type* __restrict__ G_in,
                              typename Cplx<T>::type* G_out,
                              const int8_t* __restrict__ sigma_in,
                              int8_t* __restrict__ sigma_out,
                              const T* __restrict__ u,
                              uint8_t* __restrict__ accept_out,
                              typename Cplx<T>::type* __restrict__ det_out,
                              int N, int NS, int DK, int P, int S, T lamb,
                              T sign0, T sign1, int det_power,
                              int use_boson) {
  using C2 = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_cluster[];
  T* smem = reinterpret_cast<T*>(smem_cluster);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / CS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int RQ = N / CS, r0 = rank * RQ, LDD = DK + 1, DD = DK * DK;
  const int NCH = N / P;  // columns of one pass
  const int FS = F / S;   // flavors of one stage
  const int LDT = staged_ld(DK), TP = F * DK * LDT;  // a table's plane
  const size_t NN = (size_t)N * N, gbase = (size_t)c * F * NN;
  const T one = 1, zero = 0;
  T* Br = smem;                               // [fs][k][n - pass start]
  T* Bi = Br + FS * DK * NCH;
  T* Ar = Bi + FS * DK * NCH;                 // [fs][k][r], r local
  T* Ai = Ar + FS * DK * RQ;
  T* YT = Ai + FS * DK * RQ;                  // [f][s][k], re then im
  T* BT = YT + 2 * TP;                        // [f][s][k], re then im
  T* Y2r = BT + 2 * TP;                       // [fs][k'][k]
  T* Y2i = Y2r + FS * DD;
  T* B2r = Y2i + FS * DD;                     // [fs][k'][k]
  T* B2i = B2r + FS * DD;
  T* D0r = B2i + FS * DD;                     // [f][s][s']
  T* D0i = D0r + F * DK * LDD;
  T* dgr = D0i + F * DK * LDD;                // [f][s]: G[i0+s][i0+s]
  T* dgi = dgr + F * DK;
  T* Xr = dgi + F * DK;                       // [f][k]
  T* Xi = Xr + F * DK;
  T* us = Xi + F * DK;                        // [i]
  T* dl = us + N;                             // [f][i]
  T* wg = dl + F * N;                         // [i]
  int* ts = reinterpret_cast<int*>(wg + N);   // [k]: the slot's t
  int* kcount = ts + DK;
  int8_t* ss = reinterpret_cast<int8_t*>(kcount + 4);  // [i]

  // row r of flavor f of this chain's G, in G_out
  auto row = [&](int f, int r) -> C2* {
    return G_out + gbase + f * NN + (size_t)r * N;
  };

  phase_clock::Clock clk;
  if (tid == 0) clk.start();
  // each site's flip terms, which depend on its own sigma only (a site is
  // decided once per slice): delta_f = exp(sign_f dEb) - 1, w = exp(-dEb)
  const T neg2lamb = T(-2) * lamb;
  for (int i = tid; i < NS; i += nth) {
    const int8_t s8 = sigma_in[(size_t)c * NS + i];
    const T dEb = mul_rn(neg2lamb, (T)s8);
    us[i] = u[(size_t)c * NS + i];
    ss[i] = s8;
#pragma unroll
    for (int f = 0; f < F; ++f)
      dl[f * N + i] = sub_rn(exp_(mul_rn(f == 0 ? sign0 : sign1, dEb)), one);
    wg[i] = use_boson ? exp_(-dEb) : one;
  }
  for (int f = 0; f < F; ++f) {  // G_in's own rows into G_out
    const C2* src = G_in + gbase + f * NN + (size_t)r0 * N;
    C2* dst = row(f, r0);
    for (int e = tid; e < RQ * N; e += nth) dst[e] = src[e];
  }
  if (tid == 0) clk.lap(0);
  cluster.sync();
  if (tid == 0) clk.lap(1);

  for (int i0 = 0; i0 < NS; i0 += DK) {
    // 1. the diagonal block D0 = G[i0:i0+DK, i0:i0+DK]
    for (int f = 0; f < F; ++f)
      for (int s = warp; s < DK; s += kWarps) {
        const C2* src = row(f, i0 + s) + i0;
        for (int s2 = lane; s2 < DK; s2 += 32) {
          const C2 g = src[s2];
          D0r[(f * DK + s) * LDD + s2] = g.x;
          D0i[(f * DK + s) * LDD + s2] = g.y;
        }
      }
    __syncthreads();
    if (tid == 0) clk.lap(2);

    // 2. the DK decisions, by warp 0. Before site t, with k slots accepted,
    // the block's current entries are D0's less the slots' updates in slot
    // order, G[i0+s][i0+s'] = D0[s][s'] - sum y_k'[i0+s] b_k'[i0+s']: lane s
    // keeps the diagonal entry G[i0+s][i0+s] current, and on acceptance
    // replays G[i0+s][i] and G[i][i0+s] to stage the slot's y and b.
    if (warp == 0) {
      for (int f = 0; f < F; ++f)
        for (int s = lane; s < DK; s += 32) {
          dgr[f * DK + s] = D0r[(f * DK + s) * LDD + s];
          dgi[f * DK + s] = D0i[(f * DK + s) * LDD + s];
        }
      __syncwarp();
      int k = 0;  // accepted slots (the same in every lane)
      for (int t = 0; t < DK; ++t) {
        const int i = i0 + t;
        const int8_t s8 = ss[i];
        T delta[F], rr[F], ri[F];
        T pr = zero, pi = zero;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          delta[f] = dl[f * N + i];
          const T gr = dgr[f * DK + t], gi = dgi[f * DK + t];
          rr[f] = add_rn(one, mul_rn(delta[f], sub_rn(one, gr)));
          ri[f] = -mul_rn(delta[f], gi);
          if (f == 0) {
            pr = rr[0];
            pi = ri[0];
          } else {
            const T npr = sub_rn(mul_rn(pr, rr[f]), mul_rn(pi, ri[f]));
            const T npi = add_rn(mul_rn(pr, ri[f]), mul_rn(pi, rr[f]));
            pr = npr;
            pi = npi;
          }
        }
        T dre = pr, dim = pi;
        if (det_power == 2) {
          dre = sub_rn(mul_rn(pr, pr), mul_rn(pi, pi));
          dim = mul_rn(mul_rn(T(2), pr), pi);
        }
        const bool accept = us[i] < mul_rn(wg[i], dre);
        if (rank == 0 && lane == 0) {
          const size_t o = (size_t)c * NS + i;
          accept_out[o] = accept;
          det_out[o] = Cplx<T>::make(dre, dim);
          sigma_out[o] = accept ? (int8_t)(-s8) : s8;
        }
        if (!accept) continue;  // warp-uniform
        // stage y[i0+s] = x (delta_st - G[i0+s][i]), b[i0+s] = G[i][i0+s]
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const T inv = div_rn(
              one, add_rn(mul_rn(rr[f], rr[f]), mul_rn(ri[f], ri[f])));
          const T xr = mul_rn(mul_rn(delta[f], rr[f]), inv);
          const T xi = -mul_rn(mul_rn(delta[f], ri[f]), inv);
          const int ft = (f * DK + t) * LDT;
          for (int s = lane; s < DK; s += 32) {
            const int fs = (f * DK + s) * LDT;
            const int dc = (f * DK + s) * LDD + t, dr = (f * DK + t) * LDD + s;
            T cvr = D0r[dc], cvi = D0i[dc], rvr = D0r[dr], rvi = D0i[dr];
            creplay(cvr, cvi, YT + fs, YT + TP + fs, BT + ft, BT + TP + ft, k);
            creplay(rvr, rvi, YT + ft, YT + TP + ft, BT + fs, BT + TP + fs, k);
            const T igr = sub_rn(s == t ? one : zero, cvr);
            const T igi = -cvi;
            const T yr = sub_rn(mul_rn(xr, igr), mul_rn(xi, igi));
            const T yi = add_rn(mul_rn(xr, igi), mul_rn(xi, igr));
            YT[fs + k] = yr;
            YT[TP + fs + k] = yi;
            BT[fs + k] = rvr;
            BT[TP + fs + k] = rvi;
            cfold(dgr[f * DK + s], dgi[f * DK + s], yr, yi, rvr, rvi);
          }
          if (lane == 0) {
            Xr[f * DK + k] = xr;
            Xi[f * DK + k] = xi;
          }
        }
        if (lane == 0) ts[k] = t;
        ++k;
        __syncwarp();
      }
      if (lane == 0) *kcount = k;
    }
    __syncthreads();
    const int K = *kcount;
    if (tid == 0) clk.lap(3);
    if (K == 0) continue;  // cluster-uniform: nothing to fold

    // the flavors' replays and folds, FS flavors [f0, f0 + FS) per stage
    for (int f0 = 0; f0 < F; f0 += FS) {
      // the staged values at the slots' sites: Y2[k'][k] = y_k'[i_k],
      // B2[k'][k] = b_k'[i_k] (the previous stage's replay read them before
      // its cluster barriers)
      for (int fl = 0; fl < FS; ++fl)
        for (int e = tid; e < K * K; e += nth) {
          const int kp = e / K, k = e - kp * K;
          const int o = fl * DD + kp * DK + k;
          const int st = ((f0 + fl) * DK + ts[k]) * LDT + kp;
          Y2r[o] = YT[st];
          Y2i[o] = YT[TP + st];
          B2r[o] = BT[st];
          B2i[o] = BT[TP + st];
        }
      __syncthreads();

      for (int pass = 0; pass < P; ++pass) {
        const int c0 = pass * NCH;  // the pass's first column
        // 3. replay the slots: items [0, FS NCH) form b_k[n] = G[i_k][n] -
        // sum y_k'[i_k] b_k'[n] at the pass's columns outside the block (the
        // decisions staged those), items [FS NCH, FS NCH + FS RQ) in the
        // first pass y_k over the own rows from G[r][i_k] - sum y_k'[r]
        // b_k'[i_k]. Each value takes its subtractions in slot order, as the
        // slab updates apply them; kChunk slots at a time in registers.
        const int nb = FS * NCH, items = nb + (pass == 0 ? FS * RQ : 0);
        for (int item = tid; item < items; item += nth) {
          const bool is_b = item < nb;
          const int e = is_b ? item : item - nb;
          const int fl = is_b ? (FS == 2 && e >= NCH) : (FS == 2 && e >= RQ);
          const int f = f0 + fl;
          const int j0 = e - fl * (is_b ? NCH : RQ);  // pass column, local row
          const int n = c0 + j0;                      // b: the column
          const size_t ob = is_b ? (size_t)fl * DK * NCH + j0
                                 : (size_t)fl * DK * RQ + j0;
          T* outr = (is_b ? Br : Ar) + ob;
          T* outi = (is_b ? Bi : Ai) + ob;
          const size_t ostride = is_b ? NCH : RQ;
          if (is_b && (unsigned)(n - i0) < (unsigned)DK) {
            const int st = (f * DK + n - i0) * LDT;
            for (int k = 0; k < K; ++k) {
              outr[k * ostride] = BT[st + k];
              outi[k * ostride] = BT[TP + st + k];
            }
            continue;
          }
          const T* cfr = (is_b ? Y2r : B2r) + fl * DD;
          const T* cfi = (is_b ? Y2i : B2i) + fl * DD;
          const C2* g = is_b ? nullptr : row(f, r0 + j0);
          for (int cb = 0; cb < K; cb += kChunk) {
            T vr[kChunk], vi[kChunk];
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              const int k = cb + j < K ? cb + j : K - 1;
              const C2 h = is_b ? row(f, i0 + ts[k])[n] : g[i0 + ts[k]];
              vr[j] = h.x;
              vi[j] = h.y;
            }
            // b: v -= y2 * b_k'; y: v -= y_k' * b2 (K8's operand order)
#pragma unroll 4
            for (int kp = 0; kp < cb; ++kp) {
              const T fr = outr[kp * ostride], fi = outi[kp * ostride];
              const T* cr = cfr + kp * DK + cb;
              const T* ci = cfi + kp * DK + cb;
#pragma unroll
              for (int j = 0; j < kChunk; ++j) {
                if (is_b)
                  cfold(vr[j], vi[j], cr[j], ci[j], fr, fi);
                else
                  cfold(vr[j], vi[j], fr, fi, cr[j], ci[j]);
              }
            }
#pragma unroll
            for (int jp = 0; jp < kChunk; ++jp) {
              if (cb + jp < K) {
                if (!is_b) {  // y_k = x_k (delta_{r i_k} - v_k)
                  const int k = cb + jp;
                  const T xr = Xr[f * DK + k], xi = Xi[f * DK + k];
                  const T igr =
                      sub_rn(r0 + j0 == i0 + ts[k] ? one : zero, vr[jp]);
                  const T igi = -vi[jp];
                  vr[jp] = sub_rn(mul_rn(xr, igr), mul_rn(xi, igi));
                  vi[jp] = add_rn(mul_rn(xr, igi), mul_rn(xi, igr));
                }
                const T* cr = cfr + (cb + jp) * DK + cb;
                const T* ci = cfi + (cb + jp) * DK + cb;
#pragma unroll
                for (int j = jp + 1; j < kChunk; ++j) {
                  if (is_b)
                    cfold(vr[j], vi[j], cr[j], ci[j], vr[jp], vi[jp]);
                  else
                    cfold(vr[j], vi[j], vr[jp], vi[jp], cr[j], ci[j]);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              if (cb + j < K) {
                outr[(cb + j) * ostride] = vr[j];
                outi[(cb + j) * ostride] = vi[j];
              }
          }
        }
        __syncthreads();
        if (tid == 0) clk.lap(4);
        cluster.sync();  // every block has read the pass's columns of the rows
        if (tid == 0) clk.lap(1);

        // 4. fold the pass's columns of the own rows: G -= y_k (x) b_k in
        // slot order, tiles of 4 rows x 2 complex columns (each thread loads
        // its next tile before folding this one)
        const int NC = NCH / 2, tiles = (RQ / 4) * NC;
        for (int fl = 0; fl < FS; ++fl) {
          const int f = f0 + fl;
          auto tile = [&](int e) {
            return reinterpret_cast<T*>(row(f, r0 + 4 * (e / NC)) + c0 +
                                        2 * (e % NC));
          };
          V4<T> next[4];
          if (tid < tiles)
            for (int q = 0; q < 4; ++q)
              next[q] = ld4(tile(tid) + 2 * (size_t)q * N);
          for (int e = tid; e < tiles; e += nth) {
            const int rt = e / NC, ct = e - rt * NC;
            T* g0 = tile(e);
            // g[q] = (re, im) of G[4rt+q][c0+2ct] and of G[4rt+q][c0+2ct+1]
            V4<T> g[4];
            for (int q = 0; q < 4; ++q) g[q] = next[q];
            if (e + nth < tiles)
              for (int q = 0; q < 4; ++q)
                next[q] = ld4(tile(e + nth) + 2 * (size_t)q * N);
            const size_t ao = (size_t)fl * DK * RQ + 4 * rt;
            const size_t bo = (size_t)fl * DK * NCH + 2 * ct;
            for (int p = 0; p < K; ++p) {
              const V4<T> ar = ld4(Ar + ao + p * RQ);
              const V4<T> ai = ld4(Ai + ao + p * RQ);
              const auto br = ld2(Br + bo + (size_t)p * NCH);
              const auto bi = ld2(Bi + bo + (size_t)p * NCH);
              const T yr[4] = {ar.x, ar.y, ar.z, ar.w};
              const T yi[4] = {ai.x, ai.y, ai.z, ai.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                cfold(g[q].x, g[q].y, yr[q], yi[q], br.x, bi.x);
                cfold(g[q].z, g[q].w, yr[q], yi[q], br.y, bi.y);
              }
            }
            for (int q = 0; q < 4; ++q) st4(g0 + 2 * (size_t)q * N, g[q]);
          }
        }
        if (tid == 0) clk.lap(5);
        // the next pass or stage rewrites b (and the next stage y, Y2 and
        // B2), which this pass's fold reads
        if (pass + 1 < P || f0 + FS < F) __syncthreads();
      }
    }
    cluster.sync();  // the folded rows, before the next diagonal block
    if (tid == 0) clk.lap(1);
  }

  if (tid == 0) clk.lap(0);
#ifdef MC_PHASE_STAMPS
  if (tid == 0) clk.store(g_stamps, blockIdx.x);
#endif
}

// Shared memory of site_sweep_delayed_cx_flavors in bytes: re and im planes
// of b over the N/P columns of a column pass [k][n], y over the N/R rows of
// a row pass [k][r], the staged y and b of the block's sites by site YT, BT
// [s][k], their entries at the slots' sites Y2, B2 [k'][k], the diagonal
// block D0 [s][s'] (rows of DK+1), its current diagonal and x [k], u, delta,
// the boson weight and the peer flavor's r (re, im) per site (elements of
// T); the slots' sites, their count and the peer's flags per site (ints);
// sigma (int8). ops/site_sweep_delayed_cx.py::flavors_smem mirrors it.
__host__ __device__ inline size_t flavors_smem_bytes(int N, int DK, int P,
                                                     int R, size_t el) {
  const size_t NCH = N / P, RR = N / R;
  return el * (2 * DK * NCH + 2 * DK * RR + 4 * (size_t)DK * staged_ld(DK) +
               4 * (size_t)DK * DK + 2 * (size_t)DK * (DK + 1) + 4 * DK +
               5 * (size_t)N) +
         4 * ((size_t)DK + 4 + N) + N;
}

__device__ __forceinline__ void flag_release(int* remote, int v) {
  asm volatile("st.release.cluster.u32 [%0], %1;\n" ::"l"(remote), "r"(v)
               : "memory");
}

__device__ __forceinline__ int flag_acquire(const int* local) {
  int v;
  asm volatile("ld.acquire.cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(local)
               : "memory");
  return v;
}

// The two flavors of a chain in a cluster of two blocks (F = 2), block f
// holding flavor f (K9-c128 at F = 2 past what one stage of
// site_sweep_delayed_cx_cluster fits: the repulsive 16x16 in a flux at
// delay 32). The flavors meet only in the decision, det = (r_0 r_1)^p: per
// site, warp 0 of each block computes r of its flavor from its diagonal
// block, writes it into the peer block's shared memory with a release flag
// (one slot per site, so no slot is written twice), and reads the peer's;
// both blocks then take the same decision in the same operations. Each
// block replays and folds its own flavor's G (all N rows, in G_out) in R
// row passes of N/R rows and P column passes of N/P columns: per row pass y
// over its rows, per (row, column) pass b over the pass's columns and the
// fold of that tile. The row pass that holds the block's sites comes last:
// every b reads the sites' rows before any fold touches them, and every y
// its rows' site columns before any fold of those rows. Each value takes
// the subtractions of site_sweep_delayed_cx_cluster in the same slot order,
// so the layout is bit-equal to it and to the plain version. No cluster
// barrier after the setup; 64 chains take 128 blocks, one wave.
template <class T>
__global__ void __launch_bounds__(kThreads)
site_sweep_delayed_cx_flavors(const typename Cplx<T>::type* __restrict__ G_in,
                              typename Cplx<T>::type* G_out,
                              const int8_t* __restrict__ sigma_in,
                              int8_t* __restrict__ sigma_out,
                              const T* __restrict__ u,
                              uint8_t* __restrict__ accept_out,
                              typename Cplx<T>::type* __restrict__ det_out,
                              int N, int NS, int DK, int P, int R, T lamb,
                              T sign0, T sign1, int det_power,
                              int use_boson) {
  using C2 = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_flavors[];
  T* smem = reinterpret_cast<T*>(smem_flavors);
  cg::cluster_group cluster = cg::this_cluster();
  const int fb = (int)cluster.block_rank();  // the block's flavor
  const int c = blockIdx.x / 2;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int LDD = DK + 1, DD = DK * DK;
  const int NCH = N / P, RR = N / R;  // columns, rows of a pass
  const int LDT = staged_ld(DK), TP = DK * LDT;  // a table's plane
  const size_t NN = (size_t)N * N, gbase = ((size_t)c * 2 + fb) * NN;
  const T one = 1, zero = 0;
  T* Br = smem;                 // [k][n - pass start]
  T* Bi = Br + DK * NCH;
  T* Ar = Bi + DK * NCH;        // [k][r - pass start]
  T* Ai = Ar + DK * RR;
  T* YT = Ai + DK * RR;         // [s][k], re then im
  T* BT = YT + 2 * TP;          // [s][k], re then im
  T* Y2r = BT + 2 * TP;         // [k'][k]
  T* Y2i = Y2r + DD;
  T* B2r = Y2i + DD;            // [k'][k]
  T* B2i = B2r + DD;
  T* D0r = B2i + DD;            // [s][s']
  T* D0i = D0r + DK * LDD;
  T* dgr = D0i + DK * LDD;      // [s]: G[i0+s][i0+s]
  T* dgi = dgr + DK;
  T* Xr = dgi + DK;             // [k]
  T* Xi = Xr + DK;
  T* us = Xi + DK;              // [i]
  T* dl = us + N;               // [i]: the flavor's delta
  T* wg = dl + N;               // [i]
  T* pv = wg + N;               // [i][re, im]: the peer flavor's r
  int* ts = reinterpret_cast<int*>(pv + 2 * N);  // [k]: the slot's t
  int* kcount = ts + DK;
  int* flag = kcount + 4;                        // [i]: the peer's r is in
  int8_t* ss = reinterpret_cast<int8_t*>(flag + N);  // [i]
  T* pv_peer = cluster.map_shared_rank(pv, fb ^ 1);
  int* flag_peer = cluster.map_shared_rank(flag, fb ^ 1);

  // row r of this flavor of this chain's G, in G_out
  auto row = [&](int r) -> C2* { return G_out + gbase + (size_t)r * N; };

  phase_clock::Clock clk;
  if (tid == 0) clk.start();
  const T neg2lamb = T(-2) * lamb;
  const T sg = fb == 0 ? sign0 : sign1;
  for (int i = tid; i < NS; i += nth) {
    const int8_t s8 = sigma_in[(size_t)c * NS + i];
    const T dEb = mul_rn(neg2lamb, (T)s8);
    us[i] = u[(size_t)c * NS + i];
    ss[i] = s8;
    dl[i] = sub_rn(exp_(mul_rn(sg, dEb)), one);
    wg[i] = use_boson ? exp_(-dEb) : one;
    flag[i] = 0;
  }
  {  // G_in's flavor into G_out
    const C2* src = G_in + gbase;
    C2* dst = row(0);
    for (size_t e = tid; e < NN; e += nth) dst[e] = src[e];
  }
  if (tid == 0) clk.lap(0);
  cluster.sync();  // both blocks run, their flags are clear, G_out is set
  if (tid == 0) clk.lap(1);

  for (int i0 = 0; i0 < NS; i0 += DK) {
    // 1. the diagonal block D0 = G[i0:i0+DK, i0:i0+DK] of the flavor
    for (int s = warp; s < DK; s += kWarps) {
      const C2* src = row(i0 + s) + i0;
      for (int s2 = lane; s2 < DK; s2 += 32) {
        const C2 g = src[s2];
        D0r[s * LDD + s2] = g.x;
        D0i[s * LDD + s2] = g.y;
      }
    }
    __syncthreads();
    if (tid == 0) clk.lap(2);

    // 2. the DK decisions, by warp 0, as site_sweep_delayed_cx_cluster's
    // with the peer flavor's r read from pv
    if (warp == 0) {
      for (int s = lane; s < DK; s += 32) {
        dgr[s] = D0r[s * LDD + s];
        dgi[s] = D0i[s * LDD + s];
      }
      __syncwarp();
      int k = 0;  // accepted slots (the same in every lane)
      for (int t = 0; t < DK; ++t) {
        const int i = i0 + t;
        const int8_t s8 = ss[i];
        const T delta = dl[i];
        const T rr = add_rn(one, mul_rn(delta, sub_rn(one, dgr[t])));
        const T ri = -mul_rn(delta, dgi[t]);
        if (lane == 0) {
          pv_peer[2 * i] = rr;
          pv_peer[2 * i + 1] = ri;
          flag_release(flag_peer + i, 1);
        }
        while (flag_acquire(flag + i) == 0) {
        }
        const T qr = pv[2 * i], qi = pv[2 * i + 1];
        // r_0 r_1 in flavor order
        const T r0r = fb == 0 ? rr : qr, r0i = fb == 0 ? ri : qi;
        const T r1r = fb == 0 ? qr : rr, r1i = fb == 0 ? qi : ri;
        const T pr = sub_rn(mul_rn(r0r, r1r), mul_rn(r0i, r1i));
        const T pi = add_rn(mul_rn(r0r, r1i), mul_rn(r0i, r1r));
        T dre = pr, dim = pi;
        if (det_power == 2) {
          dre = sub_rn(mul_rn(pr, pr), mul_rn(pi, pi));
          dim = mul_rn(mul_rn(T(2), pr), pi);
        }
        const bool accept = us[i] < mul_rn(wg[i], dre);
        if (fb == 0 && lane == 0) {
          const size_t o = (size_t)c * NS + i;
          accept_out[o] = accept;
          det_out[o] = Cplx<T>::make(dre, dim);
          sigma_out[o] = accept ? (int8_t)(-s8) : s8;
        }
        if (!accept) continue;  // warp-uniform
        // stage y[i0+s] = x (delta_st - G[i0+s][i]), b[i0+s] = G[i][i0+s]
        const T inv = div_rn(one, add_rn(mul_rn(rr, rr), mul_rn(ri, ri)));
        const T xr = mul_rn(mul_rn(delta, rr), inv);
        const T xi = -mul_rn(mul_rn(delta, ri), inv);
        const int ft = t * LDT;
        for (int s = lane; s < DK; s += 32) {
          const int fs = s * LDT;
          const int dc = s * LDD + t, dr = t * LDD + s;
          T cvr = D0r[dc], cvi = D0i[dc], rvr = D0r[dr], rvi = D0i[dr];
          creplay(cvr, cvi, YT + fs, YT + TP + fs, BT + ft, BT + TP + ft, k);
          creplay(rvr, rvi, YT + ft, YT + TP + ft, BT + fs, BT + TP + fs, k);
          const T igr = sub_rn(s == t ? one : zero, cvr);
          const T igi = -cvi;
          const T yr = sub_rn(mul_rn(xr, igr), mul_rn(xi, igi));
          const T yi = add_rn(mul_rn(xr, igi), mul_rn(xi, igr));
          YT[fs + k] = yr;
          YT[TP + fs + k] = yi;
          BT[fs + k] = rvr;
          BT[TP + fs + k] = rvi;
          cfold(dgr[s], dgi[s], yr, yi, rvr, rvi);
        }
        if (lane == 0) {
          Xr[k] = xr;
          Xi[k] = xi;
          ts[k] = t;
        }
        ++k;
        __syncwarp();
      }
      if (lane == 0) *kcount = k;
    }
    __syncthreads();
    const int K = *kcount;
    if (tid == 0) clk.lap(3);
    if (K == 0) continue;  // block-uniform: nothing to fold

    // the staged values at the slots' sites: Y2[k'][k] = y_k'[i_k],
    // B2[k'][k] = b_k'[i_k]
    for (int e = tid; e < K * K; e += nth) {
      const int kp = e / K, k = e - kp * K;
      const int o = kp * DK + k, st = ts[k] * LDT + kp;
      Y2r[o] = YT[st];
      Y2i[o] = YT[TP + st];
      B2r[o] = BT[st];
      B2i[o] = BT[TP + st];
    }
    __syncthreads();

    const int site_pass = i0 / RR;
    for (int rp = 0; rp < R; ++rp) {
      // the row passes in turn, the one that holds the sites last
      const int rho = rp < site_pass ? rp : (rp + 1 < R ? rp + 1 : site_pass);
      const int q0 = rho * RR;  // the pass's first row
      for (int pass = 0; pass < P; ++pass) {
        const int c0 = pass * NCH;  // the pass's first column
        // 3. replay the slots: items [0, NCH) form b_k[n] at the pass's
        // columns outside the block (the decisions staged those), items
        // [NCH, NCH + RR) in the first column pass y_k over the row pass's
        // rows, as site_sweep_delayed_cx_cluster forms them
        const int nb = NCH, items = nb + (pass == 0 ? RR : 0);
        for (int item = tid; item < items; item += nth) {
          const bool is_b = item < nb;
          const int j0 = is_b ? item : item - nb;  // pass column, pass row
          const int n = c0 + j0;                   // b: the column
          T* outr = (is_b ? Br : Ar) + j0;
          T* outi = (is_b ? Bi : Ai) + j0;
          const size_t ostride = is_b ? NCH : RR;
          if (is_b && (unsigned)(n - i0) < (unsigned)DK) {
            const int st = (n - i0) * LDT;
            for (int k = 0; k < K; ++k) {
              outr[k * ostride] = BT[st + k];
              outi[k * ostride] = BT[TP + st + k];
            }
            continue;
          }
          const T* cfr = is_b ? Y2r : B2r;
          const T* cfi = is_b ? Y2i : B2i;
          const C2* g = is_b ? nullptr : row(q0 + j0);
          for (int cb = 0; cb < K; cb += kChunk) {
            T vr[kChunk], vi[kChunk];
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              const int k = cb + j < K ? cb + j : K - 1;
              const C2 h = is_b ? row(i0 + ts[k])[n] : g[i0 + ts[k]];
              vr[j] = h.x;
              vi[j] = h.y;
            }
            // b: v -= y2 * b_k'; y: v -= y_k' * b2 (K8's operand order)
#pragma unroll 4
            for (int kp = 0; kp < cb; ++kp) {
              const T fr = outr[kp * ostride], fi = outi[kp * ostride];
              const T* cr = cfr + kp * DK + cb;
              const T* ci = cfi + kp * DK + cb;
#pragma unroll
              for (int j = 0; j < kChunk; ++j) {
                if (is_b)
                  cfold(vr[j], vi[j], cr[j], ci[j], fr, fi);
                else
                  cfold(vr[j], vi[j], fr, fi, cr[j], ci[j]);
              }
            }
#pragma unroll
            for (int jp = 0; jp < kChunk; ++jp) {
              if (cb + jp < K) {
                if (!is_b) {  // y_k = x_k (delta_{r i_k} - v_k)
                  const int k = cb + jp;
                  const T xr = Xr[k], xi = Xi[k];
                  const T igr =
                      sub_rn(q0 + j0 == i0 + ts[k] ? one : zero, vr[jp]);
                  const T igi = -vi[jp];
                  vr[jp] = sub_rn(mul_rn(xr, igr), mul_rn(xi, igi));
                  vi[jp] = add_rn(mul_rn(xr, igi), mul_rn(xi, igr));
                }
                const T* cr = cfr + (cb + jp) * DK + cb;
                const T* ci = cfi + (cb + jp) * DK + cb;
#pragma unroll
                for (int j = jp + 1; j < kChunk; ++j) {
                  if (is_b)
                    cfold(vr[j], vi[j], cr[j], ci[j], vr[jp], vi[jp]);
                  else
                    cfold(vr[j], vi[j], vr[jp], vi[jp], cr[j], ci[j]);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              if (cb + j < K) {
                outr[(cb + j) * ostride] = vr[j];
                outi[(cb + j) * ostride] = vi[j];
              }
          }
        }
        __syncthreads();
        if (tid == 0) clk.lap(4);

        // 4. fold the tile (the row pass's rows, the column pass's
        // columns): G -= y_k (x) b_k in slot order, tiles of 4 rows x 2
        // complex columns (each thread loads its next tile before folding
        // this one)
        const int NC = NCH / 2, tiles = (RR / 4) * NC;
        auto tile = [&](int e) {
          return reinterpret_cast<T*>(row(q0 + 4 * (e / NC)) + c0 +
                                      2 * (e % NC));
        };
        V4<T> next[4];
        if (tid < tiles)
          for (int q = 0; q < 4; ++q)
            next[q] = ld4(tile(tid) + 2 * (size_t)q * N);
        for (int e = tid; e < tiles; e += nth) {
          const int rt = e / NC, ct = e - rt * NC;
          T* g0 = tile(e);
          // g[q] = (re, im) of G[q0+4rt+q][c0+2ct] and of [..][c0+2ct+1]
          V4<T> g[4];
          for (int q = 0; q < 4; ++q) g[q] = next[q];
          if (e + nth < tiles)
            for (int q = 0; q < 4; ++q)
              next[q] = ld4(tile(e + nth) + 2 * (size_t)q * N);
          const size_t ao = 4 * rt, bo = 2 * ct;
          for (int p = 0; p < K; ++p) {
            const V4<T> ar = ld4(Ar + ao + p * RR);
            const V4<T> ai = ld4(Ai + ao + p * RR);
            const auto br = ld2(Br + bo + (size_t)p * NCH);
            const auto bi = ld2(Bi + bo + (size_t)p * NCH);
            const T yr[4] = {ar.x, ar.y, ar.z, ar.w};
            const T yi[4] = {ai.x, ai.y, ai.z, ai.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              cfold(g[q].x, g[q].y, yr[q], yi[q], br.x, bi.x);
              cfold(g[q].z, g[q].w, yr[q], yi[q], br.y, bi.y);
            }
          }
          for (int q = 0; q < 4; ++q) st4(g0 + 2 * (size_t)q * N, g[q]);
        }
        if (tid == 0) clk.lap(5);
        // the next pass rewrites b (and the next row pass y), which this
        // fold reads; the next block of sites reads the folded rows
        __syncthreads();
      }
    }
  }

  if (tid == 0) clk.lap(0);
#ifdef MC_PHASE_STAMPS
  if (tid == 0) clk.store(g_stamps, blockIdx.x);
#endif
}

template <class T, int F>
int launch_slab(const typename Cplx<T>::type* G_in,
                typename Cplx<T>::type* G_out, const int8_t* sigma_in,
                int8_t* sigma_out, const T* u, uint8_t* accept,
                typename Cplx<T>::type* det, T* scratch, int C, int N, int NS,
                int DK, T lamb, T sign0, T sign1, int det_power,
                int use_boson, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * F * DK * N + 2 * F * DK * (N + 1) + 4 * F * N) * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_delayed_cx_slab<T, F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_delayed_cx_slab<T, F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, accept, det, scratch, C, N, NS, DK,
      lamb, sign0, sign1, det_power, use_boson);
  return (int)cudaGetLastError();
}

// The launch configuration of site_sweep_delayed_cx_cluster<T, F, CS> for C
// chains, P column passes and S flavor stages, with its shared memory
// allowed; returns the cudaError_t of that setting.
template <class T, int F, int CS>
int cluster_config(int C, int N, int DK, int P, int S, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = cluster_smem_elems(F, CS, N, DK, P, S) * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_delayed_cx_cluster<T, F, CS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C * CS);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <class T, int F, int CS>
int launch_cluster(const typename Cplx<T>::type* G_in,
                   typename Cplx<T>::type* G_out, const int8_t* sigma_in,
                   int8_t* sigma_out, const T* u, uint8_t* accept,
                   typename Cplx<T>::type* det, int C, int N, int NS, int DK,
                   int P, int S, T lamb, T sign0, T sign1, int det_power,
                   int use_boson, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = cluster_config<T, F, CS>(C, N, DK, P, S, stream, &cfg, &attr);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, site_sweep_delayed_cx_cluster<T, F, CS>,
                                G_in, G_out, sigma_in, sigma_out, u, accept,
                                det, N, NS, DK, P, S, lamb, sign0, sign1,
                                det_power, use_boson);
  return err ? err : (int)cudaGetLastError();
}

template <class T, int F, int CS>
int max_clusters(int N, int DK, int P, int S, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = cluster_config<T, F, CS>(1, N, DK, P, S, 0, &cfg, &attr);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (void*)site_sweep_delayed_cx_cluster<T, F, CS>, &cfg);
}

// The launch configuration of site_sweep_delayed_cx_flavors<T> for C chains
// (clusters of 2 blocks, one flavor each), P column and R row passes, with
// its shared memory allowed; returns the cudaError_t of that setting.
bool valid_flavors(int N, int DK, int P, int R) {
  return P >= 1 && R >= 1 && N % P == 0 && N % R == 0 && (N / P) % 2 == 0 &&
         (N / R) % 4 == 0 && (R == 1 || (N / R) % DK == 0);
}

template <class T>
int flavors_config(int C, int N, int DK, int P, int R, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (!valid_flavors(N, DK, P, R) || DK < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = flavors_smem_bytes(N, DK, P, R, sizeof(T));
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_delayed_cx_flavors<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(2 * C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// The layouts that ops/site_sweep_delayed_cx.py::cluster_plan can pick
#define MC_K9_LAYOUTS(X) X(1, 2) X(1, 4) X(2, 2) X(2, 4)

// A cluster layout's shape: whole 4-row tiles per block and per pass, one
// or F flavor stages
bool valid_cluster(int F, int N, int CS, int P, int S) {
  return (CS == 2 || CS == 4) && N % (4 * CS) == 0 && P >= 1 &&
         N % (4 * P) == 0 && (S == 1 || S == F);
}

template <class T>
int sweep(const void* G_in, void* G_out, const int8_t* sigma_in,
          int8_t* sigma_out, const T* u, uint8_t* accept, void* det,
          T* scratch, int C, int F, int N, int NS, int DK, int CS, int P,
          int S, T lamb, T sign0, T sign1, int det_power, int use_boson,
          void* stream) {
  using C2 = typename Cplx<T>::type;
  if (C == 0) return 0;
  if (N < 8 || N % 8 || NS < 1 || NS > N || DK < 1 || NS % DK ||
      det_power < 1 || det_power > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const C2* gi = (const C2*)G_in;
  C2* go = (C2*)G_out;
  C2* dt = (C2*)det;
  if (CS == 1) {
    if (F == 1)
      return launch_slab<T, 1>(gi, go, sigma_in, sigma_out, u, accept, dt,
                               scratch, C, N, NS, DK, lamb, sign0, sign1,
                               det_power, use_boson, st);
    if (F == 2)
      return launch_slab<T, 2>(gi, go, sigma_in, sigma_out, u, accept, dt,
                               scratch, C, N, NS, DK, lamb, sign0, sign1,
                               det_power, use_boson, st);
    return (int)cudaErrorInvalidValue;
  }
  if (!valid_cluster(F, N, CS, P, S)) return (int)cudaErrorInvalidValue;
#define MC_K9_LAUNCH(f, cs)                                                  \
  if (F == f && CS == cs)                                                    \
    return launch_cluster<T, f, cs>(gi, go, sigma_in, sigma_out, u, accept,  \
                                    dt, C, N, NS, DK, P, S, lamb, sign0,     \
                                    sign1, det_power, use_boson, st);
  MC_K9_LAYOUTS(MC_K9_LAUNCH)
#undef MC_K9_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <class T>
int query(int F, int N, int DK, int CS, int P, int S, int* out) {
  *out = 0;
  if (!valid_cluster(F, N, CS, P, S) || DK < 1)
    return (int)cudaErrorInvalidValue;
#define MC_K9_QUERY(f, cs) \
  if (F == f && CS == cs) return max_clusters<T, f, cs>(N, DK, P, S, out);
  MC_K9_LAYOUTS(MC_K9_QUERY)
#undef MC_K9_QUERY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). G is complex64
// (interleaved re, im) (C, F, N, N) with 8 | N; sigma, u, accept (one byte
// per site) and det (complex64) hold NS <= N sites per chain (the rest of
// G: zero pad rows and columns). DK | NS, F in {1, 2}, det_power 1 or 2.
// CS = 1: site_sweep_delayed_cx_slab, scratch holds 4 * C * F * DK * N
// floats; CS = 2 or 4 (4 CS | N): site_sweep_delayed_cx_cluster in P column
// passes (4 P | N) and S flavor stages (1 or F), scratch unused.
extern "C" int site_sweep_delayed_cx_c64(const void* G_in, void* G_out,
                                         const int8_t* sigma_in,
                                         int8_t* sigma_out, const float* u,
                                         uint8_t* accept, void* det,
                                         float* scratch, int C, int F, int N,
                                         int NS, int DK, int CS, int P, int S,
                                         float lamb, float sign0, float sign1,
                                         int det_power, int use_boson,
                                         void* stream) {
  return sweep<float>(G_in, G_out, sigma_in, sigma_out, u, accept, det,
                      scratch, C, F, N, NS, DK, CS, P, S, lamb, sign0, sign1,
                      det_power, use_boson, stream);
}

// K9-c128: as site_sweep_delayed_cx_c64 with G and det complex128, u and
// scratch float64.
extern "C" int site_sweep_delayed_cx_c128(const void* G_in, void* G_out,
                                          const int8_t* sigma_in,
                                          int8_t* sigma_out, const double* u,
                                          uint8_t* accept, void* det,
                                          double* scratch, int C, int F,
                                          int N, int NS, int DK, int CS,
                                          int P, int S, double lamb,
                                          double sign0, double sign1,
                                          int det_power, int use_boson,
                                          void* stream) {
  return sweep<double>(G_in, G_out, sigma_in, sigma_out, u, accept, det,
                       scratch, C, F, N, NS, DK, CS, P, S, lamb, sign0, sign1,
                       det_power, use_boson, stream);
}

// K9-c128 at F = 2 on clusters of two blocks, one flavor each
// (site_sweep_delayed_cx_flavors): G complex128 (C, 2, N, N), N % P and
// N % R zero, (N/R) % DK zero where R > 1; sigma, u, accept and det hold
// NS <= N sites per chain.
extern "C" int site_sweep_delayed_cx_c128_flavors(
    const void* G_in, void* G_out, const int8_t* sigma_in, int8_t* sigma_out,
    const double* u, uint8_t* accept, void* det, int C, int N, int NS, int DK,
    int P, int R, double lamb, double sign0, double sign1, int det_power,
    int use_boson, void* stream) {
  using C2 = Cplx<double>::type;
  if (C == 0) return 0;
  if (N < 8 || NS < 1 || NS > N || DK < 1 || NS % DK || det_power < 1 ||
      det_power > 2)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = flavors_config<double>(C, N, DK, P, R, (cudaStream_t)stream, &cfg,
                                   &attr);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(
      &cfg, site_sweep_delayed_cx_flavors<double>, (const C2*)G_in,
      (C2*)G_out, sigma_in, sigma_out, u, accept, (C2*)det, N, NS, DK, P, R,
      lamb, sign0, sign1, det_power, use_boson);
  return err ? err : (int)cudaGetLastError();
}

// The most clusters of the flavor layout the card runs at once, into *out
extern "C" int site_sweep_delayed_cx_c128_flavors_max_clusters(int N, int DK,
                                                               int P, int R,
                                                               int* out) {
  *out = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = flavors_config<double>(1, N, DK, P, R, 0, &cfg, &attr);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (void*)site_sweep_delayed_cx_flavors<double>, &cfg);
}

// K9-c128 at DK = 1 in the rank-1 layout (csrc/site_sweep_rank1.cuh): G
// complex128 (C, F, N, N) on chip in clusters of CS blocks of TR x N
// threads; sigma, u, accept and det hold NS <= N sites per chain.
extern "C" int site_sweep_delayed_cx_c128_rank1(
    const void* G_in, void* G_out, const int8_t* sigma_in, int8_t* sigma_out,
    const double* u, uint8_t* accept, void* det, int C, int F, int N, int NS,
    int CS, int TR, double lamb, double sign0, double sign1, int det_power,
    int use_boson, void* stream) {
  long long* stamps = nullptr;
#ifdef MC_PHASE_STAMPS
  void* p = nullptr;
  if (cudaGetSymbolAddress(&p, g_stamps) == cudaSuccess)
    stamps = (long long*)p;
#endif
  if (F < 1 || F > 2) return (int)cudaErrorInvalidValue;
  return rank1::launch<9>(rank1::Delayed{}, G_in, G_out, sigma_in,
                             sigma_out, u, nullptr, nullptr, nullptr, accept,
                             det, stamps, C, F, N, NS, N, CS, TR,
                             rank1::reg_rows(F), lamb, sign0, sign1,
                             det_power, use_boson, (cudaStream_t)stream);
}

// The most clusters of the rank-1 layout the card runs at once, into *out
extern "C" int site_sweep_delayed_cx_c128_rank1_max_clusters(int F, int N,
                                                             int CS, int TR,
                                                             int* out) {
  if (F < 1 || F > 2) return (int)cudaErrorInvalidValue;
  return rank1::max_clusters<9>(rank1::Delayed{}, F, N, CS, TR,
                                   rank1::reg_rows(F), out);
}

// The most clusters of the layout (CS > 1) that the card runs at once, into
// *out; returns the cudaError_t of the query.
extern "C" int site_sweep_delayed_cx_c64_max_clusters(int F, int N, int DK,
                                                      int CS, int P, int S,
                                                      int* out) {
  return query<float>(F, N, DK, CS, P, S, out);
}

extern "C" int site_sweep_delayed_cx_c128_max_clusters(int F, int N, int DK,
                                                       int CS, int P, int S,
                                                       int* out) {
  return query<double>(F, N, DK, CS, P, S, out);
}

// Phase stamps of the last launch's first n_blocks blocks (kPhases cycle
// sums each) into dst on the host: a build with -DMC_PHASE_STAMPS only. The
// complex64 and complex128 kernels share one buffer.
extern "C" int site_sweep_delayed_cx_c64_stamps(void* dst, int n_blocks,
                                                void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}

extern "C" int site_sweep_delayed_cx_c128_stamps(void* dst, int n_blocks,
                                                 void* stream) {
  return site_sweep_delayed_cx_c64_stamps(dst, n_blocks, stream);
}
