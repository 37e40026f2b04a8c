// The rank-1 layout of the FP64 delayed sweeps at DK = 1: K6-f64
// (site_sweep_delayed.cu, float64 G) and K9-c128 (site_sweep_delayed_cx.cu,
// complex128 G), for N > 128, where the JAX package runs its rank-1 XLA
// loop (montecarlo_tpu/dqmc/core.py:560-592) and its delay rule gives
// DK = 1 (129 <= N < 256).
//
// The function at DK = 1 is the rank-1 sweep: per site i, the decision from
// G_f[i, i], and on accept G_f[r][n] -= a_r b_n for every r, n with
// a = x (e_i - G_f[:, i]) and b = G_f[i, :] read before the update; real:
// a_r = x (delta_ri - G[r][i]), x = delta / r, each product rounded and then
// subtracted; complex: K8's order (site_sweep_delayed_cx.cu::cfold). These
// are the operations of site_sweep_delayed_plain and
// site_sweep_delayed_cx_plain at dk = 1, so the layout is bit-equal to them.
//
// What bounds it: the N sequential decisions of a chain, each of which needs
// the row of G that the previous site's update produced, and behind them
// 2 N^2 (complex: 8 N^2) FP64 operations per accepted site and chain; G
// itself moves once each way.
//
// Design: G stays on chip for the whole launch. One thread-block cluster of
// CS = 2 or 4 blocks per chain (F = 2: 4, or 8 where 4 do not hold G, as
// complex128 past N = 192); block q owns rows [q RQ,
// (q+1) RQ) of every flavor, RQ = NP / CS. A 16-byte unit is 2 columns of
// a real row or one complex element; a row holds UR units. The block's
// NT = TR x UR threads each own one unit column u = tid % UR at the rows
// ty + TR k (ty = tid / UR, k < RPT = RQ / TR): the first KR of them in
// registers, the rest in shared memory (Gs[f][k - KR][tid], consecutive
// threads on consecutive words). G_in is read once and G_out written once.
//
// Per site i (buffer b = i & 1):
//  1. wait on the cluster barrier: row i of every flavor is in this block's
//     rowb[b] and column i at the block's rows in colb[b];
//  2. every thread takes the decision from rowb[b]'s G_f[i, i] in the same
//     operations (no flag is exchanged) and reads b at its unit column;
//  3. on accept: threads write a_r of the block's rows into ab[b] (one row
//     a thread), the TR threads of column i+1's unit copy it at their rows
//     into colb[b^1], and the UR threads of row i+1 in its owner block fold
//     that row and write it into rowb[b^1] of every block of the cluster
//     (distributed shared memory). On reject the owners copy row and column
//     i+1 as they are. Then one block barrier, taken at every site, and on
//     accept a thread a row folds column i+1 in colb[b^1] in the fold's
//     operations. (Taken inside the accept branch only, that barrier
//     stalled a build with F = 2 and clusters of 2 at every geometry tried
//     on an H100; taken at every site, every build ran bit-equal,
//     PERF.md.);
//  4. arrive on the cluster barrier (release): the one signal per site;
//  5. on accept every thread folds its rows (the row owners all but row
//     i+1) while the barrier's other arrivals come in: the fold overlaps the
//     next site's signal, and a rejected site costs no fold.
// The barrier's wait at site i+1 covers every read of the buffers b^1 at
// site i-1 (each thread arrives only after it), so the double buffers need
// no second signal; ab is double-buffered too, so site i+1's coefficients do
// not overwrite those the fold of site i still reads. No element of G is
// read by any thread but its owner: the column and the row go through the
// buffers, and a is computed from colb by whoever needs it, in the same
// operations. Decisions, sigma and (real) the detratios go to shared
// memory; the counts and the negative detratios' magnitudes are taken after
// the loop, in site order.
//
// Sites and storage as in K6 and K9: NP is G's row length, NS <= NP the
// sites visited; zero pad rows and columns (ops/site_sweep_delayed.py::
// padded, site_sweep_delayed_cx.py::padded) are never visited, every slot's
// a and b are 0 there, and every real entry takes the plain version's
// subtractions. ops/site_sweep_delayed.py::rank1_layout and
// site_sweep_delayed_cx.py::rank1_layout pick CS and TR; smem_bytes here and
// there agree.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase_clock.cuh"
#include "site_sweep_tiled.cuh"

namespace rank1 {

namespace cg = cooperative_groups;

// threads a block at most (__launch_bounds__: up to 128 registers a thread)
constexpr int kMaxThreads = 512;
// the largest shared memory one block may use on sm_90, in bytes
constexpr size_t kSmemPerBlock = 232448;

// rows of G a thread keeps in registers, per flavor: 32 doubles in all
__host__ __device__ constexpr int reg_rows(int F) { return 16 / F; }

// Shared memory of one block in bytes: the shared-memory rows of G
// [f][k - KR][tid], the row double buffer [b][f][u], the column and
// coefficient double buffers [b][f][lr] (16-byte units), u [i] (double),
// real: the detratios [i] (double), sigma [i] (int8), real: sigma out [i]
__host__ __device__ inline size_t smem_bytes(bool cx, int F, int NP, int CS,
                                             int TR) {
  const int RQ = NP / CS, UR = cx ? NP : NP / 2, NT = TR * UR;
  const int RS = RQ / TR - reg_rows(F);
  return 16 * ((size_t)F * RS * NT + 2 * (size_t)F * UR + 4 * (size_t)F * RQ) +
         (cx ? 9 : 18) * (size_t)NP;
}

// Whether (CS, TR) lays out a G of row length NP: clusters of 2 or 4
// blocks at F = 1, of 4 or 8 at F = 2 (clusters of 2 ran slower than 4
// there on an H100 at 16 and 64 chains, PERF.md), whole units, rows and
// thread rows per block, at most kMaxThreads threads, at least the register
// rows per thread, and the shared memory within one block's
__host__ inline bool valid(bool cx, int F, int NP, int CS, int TR) {
  if (F < 1 || F > 2 || TR < 1 || NP < 1) return false;
  if (F == 1 ? CS != 2 && CS != 4 : CS != 4 && CS != 8) return false;
  if (NP % CS || (!cx && NP % 2)) return false;
  const int RQ = NP / CS, UR = cx ? NP : NP / 2;
  if (RQ % TR) return false;
  return TR * UR <= kMaxThreads && RQ / TR >= reg_rows(F) &&
         smem_bytes(cx, F, NP, CS, TR) <= kSmemPerBlock;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The rank-1 sweep of one chain per cluster. G_in and G_out: (C, F, NP, NP)
// as 16-byte units (real: pairs of columns; complex: (re, im)); sigma_in,
// sigma_out and u: NS sites per chain. Real: acc_out, nneg_out, and given
// neg_out the negative detratios' log10 magnitudes (min, max, sum, in site
// order) per chain. Complex: accept_out and det_out per site. Rank 0's
// thread 0 writes the per-site and per-chain results. Thread 0 of each
// block laps clk: 0 load and store, 1 signal wait, 2 decision, 3 the next
// row's and column's folds and their publication, 4 the fold of the rest;
// stamps (a build with -DMC_PHASE_STAMPS) gets each block's sums.
template <bool CX, int F, int CS>
__global__ void __launch_bounds__(kMaxThreads)
sweep(const double2* __restrict__ G_in, double2* __restrict__ G_out,
      const int8_t* __restrict__ sigma_in, int8_t* __restrict__ sigma_out,
      const double* __restrict__ u, int* __restrict__ acc_out,
      int* __restrict__ nneg_out, double* __restrict__ neg_out,
      uint8_t* __restrict__ accept_out, double2* __restrict__ det_out,
      long long* stamps, int NP, int NS, int TR, double lamb, double sign0,
      double sign1, int det_power, int use_boson) {
  using U = double2;
  using tiled::add_rn;
  using tiled::mul_rn;
  using tiled::sub_rn;
  constexpr int NV = CX ? 2 : 1;
  constexpr int KR = reg_rows(F);
  extern __shared__ __align__(16) unsigned char smem_rank1[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int UR = CX ? NP : NP / 2, RQ = NP / CS, RPT = RQ / TR;
  const int NT = TR * UR, RS = RPT - KR;
  const int uu = tid % UR, ty = tid / UR, r0 = rank * RQ;
  U* Gs = reinterpret_cast<U*>(smem_rank1);  // [f][k - KR][tid]
  U* rowb = Gs + (size_t)F * RS * NT;         // [b][f][u]
  U* colb = rowb + 2 * F * UR;                // [b][f][lr]
  U* ab = colb + 2 * F * RQ;                  // [b][f][lr]
  double* us = reinterpret_cast<double*>(ab + 2 * F * RQ);
  double* dets = us + NP;  // real: [i] the detratios
  int8_t* ss = reinterpret_cast<int8_t*>(dets + (CX ? 0 : NP));
  int8_t* so = ss + NP;    // real: [i] sigma out
  // rowb in each block of the cluster
  U* rowb_at[CS];
#pragma unroll
  for (int q = 0; q < CS; ++q) rowb_at[q] = cluster.map_shared_rank(rowb, q);

  phase_clock::Clock clk;
  if (tid == 0) clk.start();
  // the thread's rows of G: k < KR in registers, the rest in Gs
  U gr[F][KR];
  const size_t gbase = (size_t)c * F * NP * UR;
  auto gidx = [&](int f, int k) {
    return gbase + ((size_t)f * NP + r0 + ty + TR * k) * UR + uu;
  };
  auto gsm = [&](int f, int k) -> U& {
    return Gs[((size_t)f * RS + k - KR) * NT + tid];
  };
#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int k = 0; k < KR; ++k) gr[f][k] = G_in[gidx(f, k)];
    for (int k = KR; k < RPT; ++k) gsm(f, k) = G_in[gidx(f, k)];
  }
  for (int a = tid; a < NS; a += NT) {
    us[a] = u[(size_t)c * NS + a];
    ss[a] = sigma_in[(size_t)c * NS + a];
  }
  // the unit at row k (a runtime index) of flavor f
  auto get = [&](int f, int k) -> U {
    U v = make_double2(0.0, 0.0);
    if (k < KR) {
#pragma unroll
      for (int kk = 0; kk < KR; ++kk)
        if (kk == k) v = gr[f][kk];
    } else {
      v = gsm(f, k);
    }
    return v;
  };
  // column n's entry of a unit, as colb holds it
  auto column = [](U v, int n) -> U {
    if constexpr (CX) return v;
    return make_double2((n & 1) ? v.y : v.x, 0.0);
  };
  // the owners of column n (n < NS) write it at the block's rows into
  // colb[n & 1], the owners of row n into rowb[n & 1] of every block
  auto publish_column = [&](int n) {
    if (uu != (CX ? n : n >> 1)) return;
    const int b = n & 1;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      U* cn = colb + (b * F + f) * RQ + ty;
#pragma unroll
      for (int k = 0; k < KR; ++k) cn[TR * k] = column(gr[f][k], n);
      for (int k = KR; k < RPT; ++k) cn[TR * k] = column(gsm(f, k), n);
    }
  };
  auto publish_row = [&](int n) {
    const int q = n / RQ, lr = n - q * RQ;
    if (rank != q || ty != lr % TR) return;
    const int b = n & 1;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const U v = get(f, lr / TR);
#pragma unroll
      for (int p = 0; p < CS; ++p) rowb_at[p][(b * F + f) * UR + uu] = v;
    }
  };
  // a_r = x (delta_ri - G[r][i]) from column i's entry gc (complex: y in
  // K8's operations)
  auto coef = [](double xr, double xi, U gc, bool diag) -> U {
    const double one = 1, zero = 0;
    if constexpr (CX) {
      const double igr = sub_rn(diag ? one : zero, gc.x), igi = -gc.y;
      return make_double2(sub_rn(mul_rn(xr, igr), mul_rn(xi, igi)),
                          add_rn(mul_rn(xr, igi), mul_rn(xi, igr)));
    } else {
      (void)xi;
      return make_double2(mul_rn(xr, sub_rn(diag ? one : zero, gc.x)), 0.0);
    }
  };
  // g -= a (x) b on one unit
  auto fold = [](U& g, U a, U bv) {
    if constexpr (CX) {
      g.x = sub_rn(g.x, sub_rn(mul_rn(a.x, bv.x), mul_rn(a.y, bv.y)));
      g.y = sub_rn(g.y, add_rn(mul_rn(a.x, bv.y), mul_rn(a.y, bv.x)));
    } else {
      g.x = sub_rn(g.x, mul_rn(a.x, bv.x));
      g.y = sub_rn(g.y, mul_rn(a.x, bv.y));
    }
  };

  const tiled::Decision<CX, F, double> decide(lamb, sign0, sign1, use_boson);
  cluster.sync();  // every block runs before its shared memory is written
  publish_column(0);
  publish_row(0);
  cluster_arrive();
  if (tid == 0) clk.lap(0);

  for (int i = 0; i < NS; ++i) {
    const int b = i & 1, n = i + 1;
    cluster_wait();
    if (tid == 0) clk.lap(1);
    // 2. the decision from G_f[i, i], the same in every thread
    const int ui = CX ? i : i >> 1;
    double gii[F][NV], x[F][NV], det[NV];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const U d = rowb[(b * F + f) * UR + ui];
      gii[f][0] = CX ? d.x : ((i & 1) ? d.y : d.x);
      if constexpr (CX) gii[f][NV - 1] = d.y;
    }
    const int8_t s8 = ss[i];
    const bool accept = decide(gii, s8, us[i], det_power, x, det);
    if (rank == 0 && tid == 0) {
      if constexpr (CX) {
        const size_t o = (size_t)c * NS + i;
        sigma_out[o] = accept ? (int8_t)(-s8) : s8;
        accept_out[o] = accept;
        det_out[o] = make_double2(det[0], det[NV - 1]);
      } else {  // counted after the loop, in site order
        dets[i] = det[0];
        so[i] = accept ? (int8_t)(-s8) : s8;
      }
    }
    U bv[F];  // row i at the thread's unit column
#pragma unroll
    for (int f = 0; f < F; ++f) bv[f] = rowb[(b * F + f) * UR + uu];
    if (tid == 0) clk.lap(2);

    // 3. the next site's row and column first
    const bool more = n < NS;
    const int qn = n / RQ, lrn = n - qn * RQ;
    const bool col_own = more && uu == (CX ? n : n >> 1);
    const bool row_own = more && rank == qn && ty == lrn % TR;
    const int kn = row_own ? lrn / TR : -1;
    if (accept) {
      // the coefficients of the block's rows
      for (int e = tid; e < F * RQ; e += NT) {
        const int f = F == 2 && e >= RQ, lr = e - f * RQ;
        const double xr = f ? x[F - 1][0] : x[0][0];
        const double xi = f ? x[F - 1][NV - 1] : x[0][NV - 1];
        ab[(b * F + f) * RQ + lr] =
            coef(xr, xi, colb[(b * F + f) * RQ + lr], r0 + lr == i);
      }
      // column n at the block's rows as it is, into colb[b^1]: folded
      // there below, one row a thread
      if (col_own) publish_column(n);
      if (row_own) {  // row n folded, into every block's rowb
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const U a = coef(x[f][0], x[f][NV - 1],
                           colb[(b * F + f) * RQ + lrn], r0 + lrn == i);
          U v = make_double2(0.0, 0.0);
          if (kn < KR) {
#pragma unroll
            for (int k = 0; k < KR; ++k)
              if (k == kn) {
                fold(gr[f][k], a, bv[f]);
                v = gr[f][k];
              }
          } else {
            v = gsm(f, kn);
            fold(v, a, bv[f]);
            gsm(f, kn) = v;
          }
#pragma unroll
          for (int p = 0; p < CS; ++p)
            rowb_at[p][((b ^ 1) * F + f) * UR + uu] = v;
        }
      }
    } else if (more) {
      publish_column(n);
      publish_row(n);
    }
    __syncthreads();  // ab[b], column n as it was (at every site)
    if (accept && more) {  // column n folded, in the fold's operations
      const int un = CX ? n : n >> 1;
      for (int e = tid; e < F * RQ; e += NT) {
        const int f = F == 2 && e >= RQ, lr = e - f * RQ;
        U* cn = colb + ((b ^ 1) * F + f) * RQ + lr;
        const U a = ab[(b * F + f) * RQ + lr];
        const U bn = rowb[(b * F + f) * UR + un];
        U g = *cn;
        if constexpr (CX)
          fold(g, a, bn);
        else
          g.x = sub_rn(g.x, mul_rn(a.x, (n & 1) ? bn.y : bn.x));
        *cn = g;
      }
    }
    if (tid == 0) clk.lap(3);
    // 4. the site's signal
    if (more) cluster_arrive();
    // 5. the fold of the rest
    if (accept) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const U* a = ab + (b * F + f) * RQ + ty;
#pragma unroll
        for (int k = 0; k < KR; ++k)
          if (k != kn) fold(gr[f][k], a[TR * k], bv[f]);
        for (int k = KR; k < RPT; ++k)
          if (k != kn) {
            U g = gsm(f, k);
            fold(g, a[TR * k], bv[f]);
            gsm(f, k) = g;
          }
      }
    }
    if (tid == 0) clk.lap(4);
  }

#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int k = 0; k < KR; ++k) G_out[gidx(f, k)] = gr[f][k];
    for (int k = KR; k < RPT; ++k) G_out[gidx(f, k)] = gsm(f, k);
  }
  if constexpr (!CX) {
    // the counts and the negative detratios' log10 magnitudes, in site
    // order (ops/site_sweep.py::neg_push)
    if (rank == 0 && tid == 0) {
      int acc = 0, nneg = 0;
      double mn = INFINITY, mx = -INFINITY, sum = 0.0;
      for (int a = 0; a < NS; ++a) {
        const int8_t sa = so[a];
        sigma_out[(size_t)c * NS + a] = sa;
        acc += sa != ss[a];
        const double d = dets[a];
        if (d < 0.0) {
          ++nneg;
          const double lv = log10(fmax(fabs(d), 1e-38));
          mn = fmin(mn, lv);
          mx = fmax(mx, lv);
          sum = add_rn(sum, lv);
        }
      }
      acc_out[c] = acc;
      nneg_out[c] = nneg;
      if (neg_out != nullptr) {
        neg_out[3 * (size_t)c] = mn;
        neg_out[3 * (size_t)c + 1] = mx;
        neg_out[3 * (size_t)c + 2] = sum;
      }
    }
  }
  if (tid == 0) {
    clk.lap(0);
    (void)stamps;
#ifdef MC_PHASE_STAMPS
    if (stamps != nullptr) clk.store(stamps, blockIdx.x);
#endif
  }
}

// The launch configuration of sweep<CX, F, CS> for C chains at row length
// NP and TR thread rows, with its shared memory allowed; returns the
// cudaError_t of that setting.
template <bool CX, int F, int CS>
int config(int C, int NP, int TR, cudaStream_t stream, cudaLaunchConfig_t* cfg,
           cudaLaunchAttribute* attr) {
  if (!valid(CX, F, NP, CS, TR)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(CX, F, NP, CS, TR);
  cudaError_t err = cudaFuncSetAttribute(
      sweep<CX, F, CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C * CS);
  cfg->blockDim = dim3(TR * (CX ? NP : NP / 2));
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

// One launch over C chains; returns the cudaError_t of the launch
template <bool CX>
int launch(const void* G_in, void* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const double* u, int* acc, int* nneg,
           double* neg, uint8_t* accept, void* det, long long* stamps, int C,
           int F, int NP, int NS, int CS, int TR, double lamb, double sign0,
           double sign1, int det_power, int use_boson, cudaStream_t stream) {
  if (C == 0) return 0;
  if (NS < 1 || NS > NP || det_power < 1 || det_power > 2)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const double2* gi = (const double2*)G_in;
  double2* go = (double2*)G_out;
  double2* dt = (double2*)det;
#define MC_RANK1_LAUNCH(f, cs)                                                \
  if (F == f && CS == cs) {                                                   \
    int err = config<CX, f, cs>(C, NP, TR, stream, &cfg, &attr);              \
    if (err) return err;                                                      \
    err = (int)cudaLaunchKernelEx(&cfg, sweep<CX, f, cs>, gi, go, sigma_in,   \
                                  sigma_out, u, acc, nneg, neg, accept, dt,   \
                                  stamps, NP, NS, TR, lamb, sign0, sign1,     \
                                  det_power, use_boson);                      \
    return err ? err : (int)cudaGetLastError();                               \
  }
  MC_RANK1_LAUNCH(1, 2)
  MC_RANK1_LAUNCH(1, 4)
  MC_RANK1_LAUNCH(2, 4)
  MC_RANK1_LAUNCH(2, 8)
#undef MC_RANK1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The most clusters of the layout the card runs at once, into *out
template <bool CX>
int max_clusters(int F, int NP, int CS, int TR, int* out) {
  *out = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
#define MC_RANK1_QUERY(f, cs)                                                 \
  if (F == f && CS == cs) {                                                   \
    const int err = config<CX, f, cs>(1, NP, TR, 0, &cfg, &attr);             \
    if (err) return err;                                                      \
    return (int)cudaOccupancyMaxActiveClusters(                               \
        out, (void*)sweep<CX, f, cs>, &cfg);                                  \
  }
  MC_RANK1_QUERY(1, 2)
  MC_RANK1_QUERY(1, 4)
  MC_RANK1_QUERY(2, 4)
  MC_RANK1_QUERY(2, 8)
#undef MC_RANK1_QUERY
  return (int)cudaErrorInvalidValue;
}

}  // namespace rank1
