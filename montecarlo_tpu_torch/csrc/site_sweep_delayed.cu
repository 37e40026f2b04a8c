// Delayed site-major Metropolis sweep over one DQMC time slice, N > 128
// (kernel K6).
//
// Replaces montecarlo_tpu/ops/pallas_site_sweep.py::_sitemajor_delayed_kernel
// (reached through _site_sweep_sitemajor_delayed) and, at DK = 1, its per-site
// fallback ::_sitemajor_kernel (_site_sweep_sitemajor). The plain PyTorch
// version with the same op order is
// montecarlo_tpu_torch/ops/site_sweep_delayed.py::site_sweep_delayed_plain.
//
// The function: the sites are taken in blocks of DK. Each decision is K1's
// (csrc/site_sweep.cu), read from G as updated by the block's earlier
// accepted sites; an accepted site i contributes a (x) b with
// a = x (e_i - G[:, i]) and b = G[i, :], both read BEFORE its own update,
// and G -= a_0 (x) b_0, G -= a_1 (x) b_1, ... in slot order once per block,
// each product rounded and then subtracted.
//
// What bounds it: the N sequential decisions of a chain and, behind them,
// up to 2 * N^2 * N FP32 operations of the folds per chain (less in
// proportion to the rejected sites); G (256 KB per flavor at N = 256) has to
// be read and written once.
//
// Design (site_sweep_delayed_cluster, CS = 2 or 4): one thread-block cluster of
// CS blocks per chain, which fills 128 of the H100's 132 SMs at 64 chains and
// CS = 2; the cluster barrier is what lets the blocks of a chain wait for each
// other (a cluster's blocks run at the same time). Block q owns rows [q N/CS,
// (q+1) N/CS) of every flavor block of G, which lives in G_out (64 chains of
// 16x16 hold 16 MB, resident in the 50 MB L2). Per block of DK sites:
//  1. every block reads the DK x DK diagonal block D0 = G[i0:i0+DK, i0:i0+DK];
//  2. one warp of every block runs the DK decisions: the current entries of the
//     diagonal block are D0's less the accepted slots' updates, replayed in
//     slot order (lane s keeps G[i0+s][i0+s] current; an accepted site's column
//     and row are replayed by the lanes), so every block of the cluster reaches
//     the same decisions from the same values, no decision is exchanged, and a
//     rejected site costs no barrier;
//  3. each block forms b_k over all N columns (from rows i_k) and a_k over its
//     own rows (from columns i_k) for the accepted slots k, replaying the
//     earlier slots' updates in slot order, kChunk slots at a time in
//     registers;
//  4. after a cluster barrier (every block has read the rows of this block of
//     sites) each block folds its own rows, G -= a_k (x) b_k in slot order,
//     over 4x4 register tiles; a second barrier publishes them.
// So a block of DK sites costs two cluster barriers, none when it accepts
// nothing, where the one-block layout took two block barriers and a pass over 2
// DK N slab entries per accepted site. Shapes whose vectors and tables do not
// fit run site_sweep_delayed_slab (CS = 1), that one-block layout: the row slab
// G[i0:i0+DK, :] and the column slab G[:, i0:i0+DK] (rows of N+1 floats)
// exactly updated in shared memory through the DK decisions, each accepted a
// and b staged in a global scratch buffer, G folded in G_out once per block.
// ops/site_sweep_delayed.py::cluster_plan picks the layout from the shape;
// smem_bytes there and cluster_smem_floats here agree. Keeping each block's
// rows of G in its shared memory instead (read once, written once) measured
// slower on an H100: the fold is bound by FP32 issue either way, and reading
// the owners' rows over distributed shared memory cost more than reading them
// from L2 (PERF.md, PR 9).
//
// Every decision, slab and fold value uses the _rn intrinsics, which nvcc
// never contracts into FMAs, so both layouts round as the plain version's
// separate PyTorch operations do: replaying an update chain element by
// element performs the same operations in the same order as updating a
// slab, so the kernel is bit-equal to its plain version. No tensor cores
// (their FP32 input is TF32). G is not symmetric: columns are read from G
// itself (the TPU kernel's transposed copy of G and its chain-on-sublane
// layout are Mosaic workarounds and are not carried over).
//
// The float64 instance (site_sweep_delayed_f64, kernel K6-f64) runs both
// layouts on doubles with the __d*_rn operations. It replaces the XLA loops
// the JAX package runs for float64 updates past N = 128
// (montecarlo_tpu/dqmc/core.py::sweep_slice_delayed, and at DK = 1 the
// rank-1 lax.fori_loop of sweep_slice): Mosaic is float32-only, so there is
// no TPU kernel for them. It also records how large the negative detratios
// were, as those loops do (_push_mag, _track_detratio): the min, max and sum
// of log10(max(|det|, 1e-38)) over them in site order, into neg_out[3c ..
// 3c+2]; the float32 entry passes NULL (the Pallas kernels count them only).
// What bounds it: the folds' 2 N^2 FP64 operations per accepted site and
// chain, at the FP64 rate (half the FP32 rate on an H100), behind the site
// chain. Every buffer takes twice the bytes, so the cluster layout can run
// its b vectors in P column passes (P = 1, 2 or 4): per pass it forms b_k
// over N/P columns, a cluster barrier, and folds those columns of its own
// rows, so the b buffer holds N/P columns (a pass reads the rows of the
// sites at its own columns only, which no earlier pass folded). At N = 256
// and DK = 32 F = 1 runs one pass and F = 2 two (227,616 bytes per block).
// The 4 x 4 register tiles of the fold move as two double2 per row, so the
// rule stays 4 | N (4 P | N and 4 CS | N in a cluster).
//
// At DK = 1 the float64 instance runs the rank-1 layout instead
// (csrc/site_sweep_rank1.cuh, site_sweep_delayed_f64_rank1): the JAX
// package's delay rule gives DK = 1 for 129 <= N < 256, where the cluster
// layout's two cluster barriers, diagonal block and L2 pass over the own
// rows per accepted site took 17-23 us a site (0.5% of the bound). The
// rank-1 layout keeps each chain's G on chip (16 rows a thread in
// registers, the rest in shared memory) in a cluster of 2 blocks (F = 2:
// 4), and signals once per site: 0.85 ms of device time against 4.06 at
// (64, 1, 225, 225) on an H100 (PERF.md). What bounds it: the site chain (a
// cluster barrier, the decision and the next row's fold and publication
// per site) and the fold's shared-memory traffic behind it.
//
// Sites and storage. N is G's row length in memory and NS <= N the number
// of sites the sweep visits: sigma and u hold NS entries per chain and the
// blocks of DK sites cover [0, NS). Where 4 does not divide the lattice's
// sites, ops/site_sweep_delayed.py pads G with zero rows and columns to a
// multiple of 8 (N) and passes the lattice's sites as NS. A pad row or
// column is never visited, so every slot's a and b are 0 there (0 - 0 times
// a finite x), and a real entry G[r][n] takes the same subtractions in the
// same slot order as without the pad: the kernel stays bit-equal to the
// plain version on the unpadded G.

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
using tiled::log10_;
using tiled::mul_rn;
using tiled::ld4;
using tiled::st4;
using tiled::sub_rn;
using tiled::V4;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

#ifdef MC_PHASE_STAMPS
// site_sweep_delayed_slab's phases: 0 slab load, 1 decisions, 2 staging and
// slab update, 3 fold; site_sweep_delayed_cluster's: 0 setup and copy,
// 1 cluster barriers, 2 diagonal block, 3 decisions, 4 a and b vectors,
// 5 fold
__device__ long long g_stamps[phase_clock::kMaxBlocks * phase_clock::kPhases];
#endif

template <class T>
__device__ __forceinline__ void fold4(V4<T>& g, T a, const V4<T>& b) {
  g.x = sub_rn(g.x, mul_rn(a, b.x));
  g.y = sub_rn(g.y, mul_rn(a, b.y));
  g.z = sub_rn(g.z, mul_rn(a, b.z));
  g.w = sub_rn(g.w, mul_rn(a, b.w));
}

// The negative detratios' log10 magnitudes of one chain, folded in site
// order (ops/site_sweep.py::neg_push): min, max and sum of
// log10(max(|det|, 1e-38)) over the proposals with det < 0
// float64 records them (neg_out); float32 counts them only (neg_out NULL)
template <class T>
constexpr bool kRecordNeg = sizeof(T) == 8;

template <class T>
struct NegStats {
  T mn, mx, sum;
  __device__ __forceinline__ NegStats()
      : mn(T(INFINITY)), mx(T(-INFINITY)), sum(T(0)) {}
  __device__ __forceinline__ void push(T det) {
    if (det < T(0)) {
      const T lv = log10_(fmax(fabs(det), T(1e-38)));
      mn = fmin(mn, lv);
      mx = fmax(mx, lv);
      sum = add_rn(sum, lv);
    }
  }
  __device__ __forceinline__ void store(T* out) const {
    out[0] = mn;
    out[1] = mx;
    out[2] = sum;
  }
};

template <class T, int F>
__global__ void __launch_bounds__(kThreads)
site_sweep_delayed_slab(const T* __restrict__ G_in, T* __restrict__ G_out,
                        const int8_t* __restrict__ sigma_in,
                        int8_t* __restrict__ sigma_out,
                        const T* __restrict__ u, int* __restrict__ acc_out,
                        int* __restrict__ nneg_out, T* __restrict__ neg_out,
                        T* __restrict__ scratch, int C, int N, int NS, int DK,
                        T lamb, T sign0, T sign1, int det_power,
                        int use_boson) {
  extern __shared__ __align__(16) unsigned char smem_slab[];
  T* smem = reinterpret_cast<T*>(smem_slab);
  const int LDC = N + 1;
  T* Rs = smem;                  // [f][s][n] at (f*DK + s)*N + n
  T* Cs = Rs + F * DK * N;       // [f][s][r] at (f*DK + s)*LDC + r
  T* sa = Cs + F * DK * LDC;     // [f][r]: a of the current site
  T* sb = sa + F * N;            // [f][n]: b of the current site
  const int c = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const size_t gbase = (size_t)c * F * N * N;
  T* Ag = scratch + (size_t)c * F * DK * N;        // [f][k][r]
  T* Bg = scratch + ((size_t)C + c) * F * DK * N;  // [f][k][n]
  T* Gc = G_out + gbase;
  const T one = 1, zero = 0;

  phase_clock::Clock clk;
  if (tid == 0) clk.start();
  const T neg2lamb = T(-2) * lamb;
  int acc = 0, nneg = 0;
  NegStats<T> negs;
  for (int i0 = 0; i0 < NS; i0 += DK) {
    const T* src = i0 == 0 ? G_in + gbase : Gc;  // G before this block
    for (int e = tid; e < F * DK * N; e += nth) {
      const int f = e / (DK * N), rem = e - f * DK * N;
      const int s = rem / N, n = rem - s * N;
      Rs[e] = src[(size_t)(f * N + i0 + s) * N + n];
      // column slab: consecutive threads read consecutive columns of a row
      const int cs = rem % DK, cr = rem / DK;
      Cs[(f * DK + cs) * LDC + cr] = src[(size_t)(f * N + cr) * N + i0 + cs];
    }
    __syncthreads();
    if (tid == 0) clk.lap(0);

    int k = 0;  // accepted sites of this block (the same in every thread)
    for (int t = 0; t < DK; ++t) {
      const int i = i0 + t;
      const int8_t s8 = sigma_in[c * NS + i];
      const T dEb = mul_rn(neg2lamb, (T)s8);
      T delta[F], r[F];
      T rprod = one;
      for (int f = 0; f < F; ++f) {
        const T sg = f == 0 ? sign0 : sign1;
        delta[f] = sub_rn(exp_(mul_rn(sg, dEb)), one);
        const T gii = Rs[(f * DK + t) * N + i];
        r[f] = add_rn(one, mul_rn(delta[f], sub_rn(one, gii)));
        rprod = f == 0 ? r[f] : mul_rn(rprod, r[f]);
      }
      T det = rprod;
      for (int q = 1; q < det_power; ++q) det = mul_rn(det, rprod);
      const T w = use_boson ? exp_(-dEb) : one;
      const bool accept = u[c * NS + i] < mul_rn(w, det);
      if (tid == 0) {
        acc += accept;
        nneg += det < zero;
        if (kRecordNeg<T>) negs.push(det);
        sigma_out[c * NS + i] = accept ? (int8_t)(-s8) : s8;
      }
      if (tid == 0) clk.lap(1);
      if (!accept) continue;  // block-uniform: every thread decided the same
      for (int e = tid; e < F * N; e += nth) {
        const int f = e / N, n = e - f * N;
        const T x = f == 0 ? div_rn(delta[0], r[0])
                           : div_rn(delta[F - 1], r[F - 1]);
        const T a = mul_rn(
            x, sub_rn(n == i ? one : zero, Cs[(f * DK + t) * LDC + n]));
        const T b = Rs[(f * DK + t) * N + n];
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
        const T* af = sa + f * N;
        const T* bf = sb + f * N;
        Rs[e] = sub_rn(Rs[e], mul_rn(af[i0 + s], bf[n]));
        T* cv = &Cs[(f * DK + s) * LDC + n];
        *cv = sub_rn(*cv, mul_rn(bf[i0 + s], af[n]));
      }
      __syncthreads();
      if (tid == 0) clk.lap(2);
    }

    // block fold G -= sum_k a_k (x) b_k, in slot order; the first block also
    // moves G from G_in to G_out when it accepted nothing
    if (k > 0 || i0 == 0) {
      T* As = smem;          // [k][r], reuses the slab memory
      T* Bs = smem + k * N;  // [k][n]
      const int NT = N / 4;
      for (int f = 0; f < F; ++f) {
        __syncthreads();
        for (int e = tid; e < k * N; e += nth) {
          As[e] = Ag[(size_t)f * DK * N + e];
          Bs[e] = Bg[(size_t)f * DK * N + e];
        }
        __syncthreads();
        const T* Sf = src + (size_t)f * N * N;
        T* Df = Gc + (size_t)f * N * N;
        for (int e = tid; e < NT * NT; e += nth) {
          const int rt = e / NT, ct = e - rt * NT;
          V4<T> g[4];
          for (int q = 0; q < 4; ++q)
            g[q] = ld4(&Sf[(size_t)(4 * rt + q) * N + 4 * ct]);
          for (int p = 0; p < k; ++p) {
            const V4<T> av = ld4(&As[p * N + 4 * rt]);
            const V4<T> bv = ld4(&Bs[p * N + 4 * ct]);
            fold4(g[0], av.x, bv);
            fold4(g[1], av.y, bv);
            fold4(g[2], av.z, bv);
            fold4(g[3], av.w, bv);
          }
          for (int q = 0; q < 4; ++q)
            st4(&Df[(size_t)(4 * rt + q) * N + 4 * ct], g[q]);
        }
      }
    }
    __syncthreads();
    if (tid == 0) clk.lap(3);
  }

  if (tid == 0) {
    acc_out[c] = acc;
    nneg_out[c] = nneg;
    if (kRecordNeg<T>) negs.store(neg_out + 3 * (size_t)c);
  }
#ifdef MC_PHASE_STAMPS
  if (tid == 0) clk.store(g_stamps, c);
#endif
}

// Slots of the a and b replays handled together in registers
constexpr int kChunk = 8;

// Row length of the staged tables AbT and BbT: the slots of one site in a
// row, padded to 4-element loads and offset by 4 elements per row, so that
// a warp's float4 loads of 8 rows fall in distinct banks
__host__ __device__ inline int staged_ld(int DK) {
  return (DK + 3) / 4 * 4 + 4;
}

// Shared memory of site_sweep_delayed_cluster in elements of T: b of every
// slot over the N/P columns of one pass [f][k][n], a [f][k][r], the staged
// a and b of the block's sites by site, AbT [f][s][k] = a_k[i0+s] and BbT
// [f][s][k] = b_k[i0+s], their entries at the slots' sites A2 [f][k'][k] =
// a_k'[i_k] and B2 [f][k'][k] = b_k'[i_k], the diagonal block at the
// block's start D0 [f][s][s'] (rows of DK+1), its current diagonal [f][s],
// x [f][k], u [i], delta [f][i] and the boson weight [i] of flipping each
// site, the slots' sites and their count (ints) and sigma [i] (int8).
// ops/site_sweep_delayed.py::smem_bytes mirrors it.
__host__ __device__ inline size_t cluster_smem_elems(int F, int CS, int N,
                                                     int DK, int P) {
  const size_t RQ = N / CS, NCH = N / P;
  return (size_t)F * DK * NCH + F * DK * RQ +
         2 * (size_t)F * DK * staged_ld(DK) + 2 * (size_t)F * DK * DK +
         (size_t)F * DK * (DK + 1) + 2 * F * DK + (F + 2) * N + DK + 4 +
         (N + 3) / 4;
}

// v - a[0] b[0] - a[1] b[1] - ... - a[k-1] b[k-1], each product rounded and
// then subtracted, in that order (a, b 16-byte aligned)
template <class T>
__device__ __forceinline__ T replay(T v, const T* a, const T* b, int k) {
  int kp = 0;
#pragma unroll 4
  for (; kp + 4 <= k; kp += 4) {
    const V4<T> x = ld4(a + kp);
    const V4<T> y = ld4(b + kp);
    v = sub_rn(v, mul_rn(x.x, y.x));
    v = sub_rn(v, mul_rn(x.y, y.y));
    v = sub_rn(v, mul_rn(x.z, y.z));
    v = sub_rn(v, mul_rn(x.w, y.w));
  }
  for (; kp < k; ++kp) v = sub_rn(v, mul_rn(a[kp], b[kp]));
  return v;
}

// v[j] -= coef[j] * fin for the j < n of one chunk, in registers
template <class T>
__device__ __forceinline__ void chunk_sub(T (&v)[kChunk], const T* coef,
                                          T fin) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) v[j] = sub_rn(v[j], mul_rn(coef[j], fin));
}

template <class T, int F, int CS>
__global__ void __launch_bounds__(kThreads)
site_sweep_delayed_cluster(const T* __restrict__ G_in, T* G_out,
                           const int8_t* __restrict__ sigma_in,
                           int8_t* __restrict__ sigma_out,
                           const T* __restrict__ u, int* __restrict__ acc_out,
                           int* __restrict__ nneg_out, T* __restrict__ neg_out,
                           int N, int NS, int DK, int passes, T lamb,
                           T sign0, T sign1, int det_power, int use_boson) {
  extern __shared__ __align__(16) unsigned char smem_cluster[];
  T* smem = reinterpret_cast<T*>(smem_cluster);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / CS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int RQ = N / CS, r0 = rank * RQ, LDD = DK + 1, DD = DK * DK;
  // column passes: float32 always runs one, a constant here
  const int P = sizeof(T) == 4 ? 1 : passes;
  const int NCH = N / P;  // columns of one pass
  const int LDT = staged_ld(DK);
  const size_t NN = (size_t)N * N, gbase = (size_t)c * F * NN;
  const T one = 1, zero = 0;
  T* Bv = smem;                            // [f][k][n - pass start]
  T* Av = Bv + F * DK * NCH;               // [f][k][r], r local
  T* AbT = Av + F * DK * RQ;               // [f][s][k]
  T* BbT = AbT + F * DK * LDT;             // [f][s][k]
  T* A2 = BbT + F * DK * LDT;              // [f][k'][k]
  T* B2 = A2 + F * DD;                     // [f][k'][k]
  T* D0 = B2 + F * DD;                     // [f][s][s']
  T* dg = D0 + F * DK * LDD;               // [f][s]: G[i0+s][i0+s]
  T* xs = dg + F * DK;                     // [f][k]
  T* us = xs + F * DK;                     // [i]
  T* dl = us + N;                          // [f][i]
  T* wg = dl + F * N;                      // [i]
  int* ts = reinterpret_cast<int*>(wg + N);  // [k]: the slot's t
  int* kcount = ts + DK;
  int8_t* ss = reinterpret_cast<int8_t*>(kcount + 4);  // [i]

  // row r of flavor f of this chain's G, in G_out
  auto row = [&](int f, int r) -> T* {
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
    const T* src = G_in + gbase + f * NN + (size_t)r0 * N;
    T* dst = row(f, r0);
    for (int e = tid; e < RQ * N / 4; e += nth) st4(dst + 4 * e, ld4(src + 4 * e));
  }
  if (tid == 0) clk.lap(0);
  cluster.sync();
  if (tid == 0) clk.lap(1);

  int acc = 0, nneg = 0;  // the counts, kept by thread 0 of rank 0
  NegStats<T> negs;
  for (int i0 = 0; i0 < NS; i0 += DK) {
    // 1. the diagonal block D0 = G[i0:i0+DK, i0:i0+DK]
    for (int f = 0; f < F; ++f)
      for (int s = warp; s < DK; s += kWarps) {
        const T* src = row(f, i0 + s) + i0;
        for (int s2 = lane; s2 < DK; s2 += 32)
          D0[(f * DK + s) * LDD + s2] = src[s2];
      }
    __syncthreads();
    if (tid == 0) clk.lap(2);

    // 2. the DK decisions, by warp 0. Before site t, with k slots accepted,
    // the block's current entries are D0's less the slots' updates in slot
    // order, G[i0+s][i0+s'] = D0[s][s'] - sum a_k'[i0+s] b_k'[i0+s']: lane s
    // keeps the diagonal entry G[i0+s][i0+s] current, and on acceptance
    // replays G[i0+s][i] and G[i][i0+s] to stage the slot's a and b.
    if (warp == 0) {
      for (int f = 0; f < F; ++f)
        for (int s = lane; s < DK; s += 32)
          dg[f * DK + s] = D0[(f * DK + s) * LDD + s];
      __syncwarp();
      int k = 0;  // accepted slots (the same in every lane)
      for (int t = 0; t < DK; ++t) {
        const int i = i0 + t;
        const int8_t s8 = ss[i];
        T delta[F], r[F];
        T rprod = one;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          delta[f] = dl[f * N + i];
          const T gii = dg[f * DK + t];
          r[f] = add_rn(one, mul_rn(delta[f], sub_rn(one, gii)));
          rprod = f == 0 ? r[f] : mul_rn(rprod, r[f]);
        }
        T det = rprod;
        for (int p = 1; p < det_power; ++p) det = mul_rn(det, rprod);
        const bool accept = us[i] < mul_rn(wg[i], det);
        if (rank == 0 && lane == 0) {
          acc += accept;
          nneg += det < zero;
          if (kRecordNeg<T>) negs.push(det);
          sigma_out[(size_t)c * NS + i] = accept ? (int8_t)(-s8) : s8;
        }
        if (!accept) continue;  // warp-uniform
        // stage a[i0+s] = x (delta_st - G[i0+s][i]), b[i0+s] = G[i][i0+s]
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const T x = div_rn(delta[f], r[f]);
          const int ft = (f * DK + t) * LDT;
          for (int s = lane; s < DK; s += 32) {
            const int fs = (f * DK + s) * LDT;
            const T cv = replay(D0[(f * DK + s) * LDD + t], AbT + fs,
                                BbT + ft, k);
            const T rv = replay(D0[(f * DK + t) * LDD + s], AbT + ft,
                                BbT + fs, k);
            const T a = mul_rn(x, sub_rn(s == t ? one : zero, cv));
            AbT[fs + k] = a;
            BbT[fs + k] = rv;
            dg[f * DK + s] = sub_rn(dg[f * DK + s], mul_rn(a, rv));
          }
          if (lane == 0) xs[f * DK + k] = x;
        }
        if (lane == 0) ts[k] = t;
        ++k;
        __syncwarp();
      }
      if (lane == 0) *kcount = k;
    }
    __syncthreads();
    const int K = *kcount;
    // the staged values at the slots' sites: A2[k'][k] = a_k'[i_k],
    // B2[k'][k] = b_k'[i_k]
    for (int f = 0; f < F; ++f)
      for (int e = tid; e < K * K; e += nth) {
        const int kp = e / K, k = e - kp * K;
        A2[f * DD + kp * DK + k] = AbT[(f * DK + ts[k]) * LDT + kp];
        B2[f * DD + kp * DK + k] = BbT[(f * DK + ts[k]) * LDT + kp];
      }
    __syncthreads();
    if (tid == 0) clk.lap(3);
    if (K == 0) continue;  // cluster-uniform: nothing to fold

    for (int pass = 0; pass < P; ++pass) {
      const int c0 = pass * NCH;  // the pass's first column
      // 3. replay the slots: items [0, F NCH) form b_k[n] = G[i_k][n] - sum
      // a_k'[i_k] b_k'[n] for the pass's columns outside the block (the
      // decisions staged those), items [F NCH, F NCH + F RQ) in the first
      // pass a_k[r] = x_k (delta_{r i_k} - (G[r][i_k] - sum b_k'[i_k]
      // a_k'[r])) for the own rows. Each value takes its subtractions in slot
      // order, as the slab updates apply them; kChunk slots at a time in
      // registers.
      const int nb = F * NCH, items = nb + (pass == 0 ? F * RQ : 0);
      for (int item = tid; item < items; item += nth) {
        const bool is_b = item < nb;
        const int e = is_b ? item : item - nb;
        const int f = is_b ? (F == 2 && e >= NCH) : (F == 2 && e >= RQ);
        const int j0 = e - f * (is_b ? NCH : RQ);  // pass column, local row
        const int n = c0 + j0;                     // b: the column
        T* out = is_b ? Bv + (size_t)f * DK * NCH + j0 : Av + f * DK * RQ + j0;
        const size_t ostride = is_b ? NCH : RQ;
        if (is_b && (unsigned)(n - i0) < (unsigned)DK) {
          const T* st = BbT + (f * DK + n - i0) * LDT;
          for (int k = 0; k < K; ++k) out[k * ostride] = st[k];
          continue;
        }
        const T* coef = (is_b ? A2 : B2) + f * DD;
        const T* g = is_b ? nullptr : row(f, r0 + j0);
        for (int cb = 0; cb < K; cb += kChunk) {
          T v[kChunk];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int k = cb + j < K ? cb + j : K - 1;
            v[j] = is_b ? row(f, i0 + ts[k])[n] : g[i0 + ts[k]];
          }
#pragma unroll 4
          for (int kp = 0; kp < cb; ++kp)
            chunk_sub(v, coef + kp * DK + cb, out[kp * ostride]);
#pragma unroll
          for (int jp = 0; jp < kChunk; ++jp) {
            if (cb + jp < K) {
              if (!is_b) {  // a_k = x_k (delta_{r i_k} - v_k)
                const int k = cb + jp;
                v[jp] = mul_rn(xs[f * DK + k],
                               sub_rn(r0 + j0 == i0 + ts[k] ? one : zero,
                                      v[jp]));
              }
              const T* cf = coef + (cb + jp) * DK + cb;
#pragma unroll
              for (int j = jp + 1; j < kChunk; ++j)
                v[j] = sub_rn(v[j], mul_rn(cf[j], v[jp]));
            }
          }
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
            if (cb + j < K) out[(cb + j) * ostride] = v[j];
        }
      }
      __syncthreads();
      if (tid == 0) clk.lap(4);
      cluster.sync();  // every block has read the pass's columns of the rows
      if (tid == 0) clk.lap(1);

      // 4. fold the pass's columns of the own rows: G -= a_k (x) b_k in slot
      // order (each thread loads its next tile before folding this one)
      const int NT = NCH / 4, tiles = (RQ / 4) * NT;
      for (int f = 0; f < F; ++f) {
        auto tile = [&](int e) {
          return row(f, r0 + 4 * (e / NT)) + c0 + 4 * (e % NT);
        };
        V4<T> next[4];
        if (tid < tiles)
          for (int q = 0; q < 4; ++q) next[q] = ld4(tile(tid) + (size_t)q * N);
        for (int e = tid; e < tiles; e += nth) {
          const int rt = e / NT, ct = e - rt * NT;
          T* g0 = tile(e);
          V4<T> g[4];
          for (int q = 0; q < 4; ++q) g[q] = next[q];
          if (e + nth < tiles)
            for (int q = 0; q < 4; ++q)
              next[q] = ld4(tile(e + nth) + (size_t)q * N);
          const T* a = Av + f * DK * RQ + 4 * rt;
          const T* b = Bv + (size_t)f * DK * NCH + 4 * ct;
          for (int p = 0; p < K; ++p) {
            const V4<T> av = ld4(a + p * RQ);
            const V4<T> bv = ld4(b + (size_t)p * NCH);
            fold4(g[0], av.x, bv);
            fold4(g[1], av.y, bv);
            fold4(g[2], av.z, bv);
            fold4(g[3], av.w, bv);
          }
          for (int q = 0; q < 4; ++q) st4(g0 + (size_t)q * N, g[q]);
        }
      }
      if (tid == 0) clk.lap(5);
      // the next pass rewrites b, which this pass's fold reads
      if (pass + 1 < P) __syncthreads();
    }
    cluster.sync();  // the folded rows, before the next diagonal block
    if (tid == 0) clk.lap(1);
  }

  if (rank == 0 && tid == 0) {
    acc_out[c] = acc;
    nneg_out[c] = nneg;
    if (kRecordNeg<T>) negs.store(neg_out + 3 * (size_t)c);
  }
  if (tid == 0) clk.lap(0);
#ifdef MC_PHASE_STAMPS
  if (tid == 0) clk.store(g_stamps, blockIdx.x);
#endif
}

template <class T, int F>
int launch_slab(const T* G_in, T* G_out, const int8_t* sigma_in,
                int8_t* sigma_out, const T* u, int* acc, int* nneg, T* neg,
                T* scratch, int C, int N, int NS, int DK, T lamb, T sign0,
                T sign1, int det_power, int use_boson, cudaStream_t stream) {
  const size_t smem =
      (size_t)(F * DK * N + F * DK * (N + 1) + 2 * F * N) * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_delayed_slab<T, F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  site_sweep_delayed_slab<T, F><<<C, kThreads, smem, stream>>>(
      G_in, G_out, sigma_in, sigma_out, u, acc, nneg, neg, scratch, C, N, NS,
      DK, lamb, sign0, sign1, det_power, use_boson);
  return (int)cudaGetLastError();
}

// The launch configuration of site_sweep_delayed_cluster<T, F, CS> for C
// chains and P column passes, with its shared memory allowed; returns the
// cudaError_t of that setting.
template <class T, int F, int CS>
int cluster_config(int C, int N, int DK, int P, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = cluster_smem_elems(F, CS, N, DK, P) * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      site_sweep_delayed_cluster<T, F, CS>,
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
int launch_cluster(const T* G_in, T* G_out, const int8_t* sigma_in,
                   int8_t* sigma_out, const T* u, int* acc, int* nneg, T* neg,
                   int C, int N, int NS, int DK, int P, T lamb, T sign0,
                   T sign1, int det_power, int use_boson, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = cluster_config<T, F, CS>(C, N, DK, P, stream, &cfg, &attr);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, site_sweep_delayed_cluster<T, F, CS>,
                                G_in, G_out, sigma_in, sigma_out, u, acc,
                                nneg, neg, N, NS, DK, P, lamb, sign0, sign1,
                                det_power, use_boson);
  return err ? err : (int)cudaGetLastError();
}

template <class T, int F, int CS>
int max_clusters(int N, int DK, int P, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = cluster_config<T, F, CS>(1, N, DK, P, 0, &cfg, &attr);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (void*)site_sweep_delayed_cluster<T, F, CS>, &cfg);
}

// The layouts that ops/site_sweep_delayed.py::cluster_plan can pick
#define MC_K6_LAYOUTS(X) X(1, 2) X(1, 4) X(2, 2) X(2, 4)

bool valid_cluster(int N, int CS, int P) {
  return (CS == 2 || CS == 4) && N % (4 * CS) == 0 && P >= 1 &&
         N % (4 * P) == 0;
}

template <class T>
int sweep(const T* G_in, T* G_out, const int8_t* sigma_in, int8_t* sigma_out,
          const T* u, int* acc, int* nneg, T* neg, T* scratch, int C, int F,
          int N, int NS, int DK, int CS, int P, T lamb, T sign0, T sign1,
          int det_power, int use_boson, void* stream) {
  if (C == 0) return 0;
  if (N < 4 || N % 4 || NS < 1 || NS > N || DK < 1 || NS % DK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (CS == 1) {
    if (F == 1)
      return launch_slab<T, 1>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg,
                               neg, scratch, C, N, NS, DK, lamb, sign0, sign1,
                               det_power, use_boson, st);
    if (F == 2)
      return launch_slab<T, 2>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg,
                               neg, scratch, C, N, NS, DK, lamb, sign0, sign1,
                               det_power, use_boson, st);
    return (int)cudaErrorInvalidValue;
  }
  if (!valid_cluster(N, CS, P)) return (int)cudaErrorInvalidValue;
#define MC_K6_LAUNCH(f, cs)                                                  \
  if (F == f && CS == cs)                                                    \
    return launch_cluster<T, f, cs>(G_in, G_out, sigma_in, sigma_out, u, acc, \
                                    nneg, neg, C, N, NS, DK, P, lamb, sign0,  \
                                    sign1, det_power, use_boson, st);
  MC_K6_LAYOUTS(MC_K6_LAUNCH)
#undef MC_K6_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <class T>
int query(int F, int N, int DK, int CS, int P, int* out) {
  *out = 0;
  if (!valid_cluster(N, CS, P) || DK < 1) return (int)cudaErrorInvalidValue;
#define MC_K6_QUERY(f, cs) \
  if (F == f && CS == cs) return max_clusters<T, f, cs>(N, DK, P, out);
  MC_K6_LAYOUTS(MC_K6_QUERY)
#undef MC_K6_QUERY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). G is (C, F, N, N)
// with 4 | N, sigma and u (C, NS) with NS <= N sites (the rest of G: zero
// pad rows and columns), DK | NS, F in {1, 2}. CS = 1:
// site_sweep_delayed_slab, scratch holds 2 * C * F * DK * N floats; CS = 2
// or 4 (4 CS | N): site_sweep_delayed_cluster in one column pass, scratch
// unused.
extern "C" int site_sweep_delayed_f32(const float* G_in, float* G_out,
                                      const int8_t* sigma_in,
                                      int8_t* sigma_out, const float* u,
                                      int* acc, int* nneg, float* scratch,
                                      int C, int F, int N, int NS, int DK,
                                      int CS, float lamb, float sign0,
                                      float sign1, int det_power,
                                      int use_boson, void* stream) {
  return sweep<float>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, nullptr,
                      scratch, C, F, N, NS, DK, CS, 1, lamb, sign0, sign1,
                      det_power, use_boson, stream);
}

// K6-f64: as site_sweep_delayed_f32 on doubles, with the negative-weight
// statistics neg (C, 3) and the cluster layout's P column passes
// (4 P | N); scratch holds 2 * C * F * DK * N doubles in the slab layout.
extern "C" int site_sweep_delayed_f64(const double* G_in, double* G_out,
                                      const int8_t* sigma_in,
                                      int8_t* sigma_out, const double* u,
                                      int* acc, int* nneg, double* neg,
                                      double* scratch, int C, int F, int N,
                                      int NS, int DK, int CS, int P,
                                      double lamb, double sign0, double sign1,
                                      int det_power, int use_boson,
                                      void* stream) {
  return sweep<double>(G_in, G_out, sigma_in, sigma_out, u, acc, nneg, neg,
                       scratch, C, F, N, NS, DK, CS, P, lamb, sign0, sign1,
                       det_power, use_boson, stream);
}

// K6-f64 at DK = 1 in the rank-1 layout (csrc/site_sweep_rank1.cuh): G of
// row length N (C, F, N, N) on chip in clusters of CS blocks of TR x N/2
// threads; sigma and u hold NS <= N sites; acc, nneg and neg as
// site_sweep_delayed_f64's.
extern "C" int site_sweep_delayed_f64_rank1(const double* G_in, double* G_out,
                                            const int8_t* sigma_in,
                                            int8_t* sigma_out, const double* u,
                                            int* acc, int* nneg, double* neg,
                                            int C, int F, int N, int NS,
                                            int CS, int TR, double lamb,
                                            double sign0, double sign1,
                                            int det_power, int use_boson,
                                            void* stream) {
  long long* stamps = nullptr;
#ifdef MC_PHASE_STAMPS
  void* p = nullptr;
  if (cudaGetSymbolAddress(&p, g_stamps) == cudaSuccess)
    stamps = (long long*)p;
#endif
  if (F < 1 || F > 2) return (int)cudaErrorInvalidValue;
  return rank1::launch<6>(rank1::Delayed{}, G_in, G_out, sigma_in,
                              sigma_out, u, acc, nneg, neg, nullptr, nullptr,
                              stamps, C, F, N, NS, N, CS, TR,
                              rank1::reg_rows(F), lamb, sign0, sign1,
                              det_power, use_boson, (cudaStream_t)stream);
}

// The most clusters of the rank-1 layout the card runs at once, into *out
extern "C" int site_sweep_delayed_f64_rank1_max_clusters(int F, int N, int CS,
                                                         int TR, int* out) {
  if (F < 1 || F > 2) return (int)cudaErrorInvalidValue;
  return rank1::max_clusters<6>(rank1::Delayed{}, F, N, CS, TR,
                                    rank1::reg_rows(F), out);
}

// The most clusters of the layout (CS > 1) that the card runs at once, into
// *out; returns the cudaError_t of the query.
extern "C" int site_sweep_delayed_f32_max_clusters(int F, int N, int DK,
                                                   int CS, int* out) {
  return query<float>(F, N, DK, CS, 1, out);
}

extern "C" int site_sweep_delayed_f64_max_clusters(int F, int N, int DK,
                                                   int CS, int P, int* out) {
  return query<double>(F, N, DK, CS, P, out);
}

// Phase stamps of the last launch's first n_blocks blocks (kPhases cycle
// sums each) into dst on the host: a build with -DMC_PHASE_STAMPS only. The
// float32 and float64 kernels share one buffer.
extern "C" int site_sweep_delayed_f32_stamps(void* dst, int n_blocks,
                                             void* stream) {
#ifdef MC_PHASE_STAMPS
  return phase_clock::copy_rows(g_stamps, dst, n_blocks, stream);
#else
  (void)dst, (void)n_blocks, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}

extern "C" int site_sweep_delayed_f64_stamps(void* dst, int n_blocks,
                                             void* stream) {
  return site_sweep_delayed_f32_stamps(dst, n_blocks, stream);
}
