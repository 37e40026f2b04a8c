// The rank-1 layout: K6-f64 (site_sweep_delayed.cu, float64 G) and K9-c128
// (site_sweep_delayed_cx.cu, complex128 G) at DK = 1 past N = 128, where
// the JAX package runs its rank-1 XLA loop (montecarlo_tpu/dqmc/core.py:
// 560-592) and its delay rule gives DK = 1 (129 <= N < 256), and K8-c128
// (site_sweep_cx.cu, complex128 G) at 64 < N <= 128, the same XLA loop.
//
// The function is the rank-1 sweep: per site i, the decision from
// G_f[i, i], and on accept G_f[r][n] -= a_r b_n for every r, n with
// a = x (e_i - G_f[:, i]) and b = G_f[i, :] read before the update; real:
// a_r = x (delta_ri - G[r][i]), x = delta / r, each product rounded and then
// subtracted; complex: K8's order (site_sweep_delayed_cx.cu::cfold). These
// are the operations of site_sweep_delayed_plain and
// site_sweep_delayed_cx_plain at dk = 1, and of site_sweep_cx_plain, so the
// layout is bit-equal to them.
//
// What bounds it: the N sequential decisions of a chain, each of which needs
// the row of G that the previous site's update produced, and behind them
// 2 N^2 (complex: 8 N^2) FP64 operations per accepted site and chain; G
// itself moves once each way.
//
// Design: G stays on chip for the whole launch. One thread-block cluster of
// CS blocks per chain (K6-f64, K9-c128: F = 1 2 or 4, F = 2 4 or 8, 8
// where 4 do not hold G, as complex128 past N = 192; K8-c128 also CS = 1,
// one block per chain, and F = 2 in clusters of 2); block q owns rows
// [q RQ, (q+1) RQ) of every flavor, RQ = NP / CS. A 16-byte unit is 2
// columns of a real row or one complex element; a row holds UR units. The
// block's NT = TR x UR threads each own one unit column u = tid % UR at
// the RPT = RQ / TR rows ty + TR k (ty = tid / UR, k < RPT): the first KR
// of them in registers (KR a compile-time parameter), the rest in shared
// memory (Gs[f][k - KR][tid], consecutive threads on consecutive words).
// K6-f64 and K9-c128 take KR = reg_rows(F). A warp's registers come from
// one SM sub-partition's quarter of the register file, so a block of 13
// to 16 warps gets at most 128 registers a thread and one of up to 12
// warps up to 168: max_threads bounds each instance. G_in is read once and
// G_out written once.
//
// Per site i (buffer b = i & 1):
//  1. wait on mbarrier full[b]: row i of every flavor is in this block's
//     rowb[b] (column i at the block's rows is in colb[b] since site i-1);
//  2. every thread takes the decision from rowb[b]'s G_f[i, i] in the same
//     operations (no flag is exchanged) and reads b at its unit column and
//     at column i+1; then it waits on the cluster barrier: every block is
//     past site i-1, so rowb[b^1] and full[b^1] are free in each;
//  3. on accept: threads write a_r of the block's rows into ab[b] (one row
//     a thread; column i as colb[b] holds it, folded with site i-1's a and
//     b where site i-1 was accepted), the TR threads of column i+1's unit
//     copy it at their rows into colb[b^1], and the UR threads of row i+1
//     in its owner block fold that row and send it into rowb[b^1] of every
//     block of the cluster by st.async, counted on that block's full[b^1]
//     (thread 0 of each block arrives on its full[b^1] with the row's
//     bytes). On reject the owners copy row and column i+1 as they are.
//     Then one block barrier, at every site;
//  4. arrive on the cluster barrier, relaxed: the one signal per site. It
//     orders no memory (a release at cluster scope, a GPU-wide memory
//     barrier in the machine code, cost ~1,000 SM cycles a site on an H100,
//     PERF.md): each thread has consumed its reads of rowb[b] before it
//     arrives, and the block barriers order colb and ab;
//  5. on accept every thread folds its rows while the other arrivals come
//     in: the fold overlaps the next site's signal, and a rejected site
//     costs no fold.
// ab and colb are double-buffered: site i+1 reads ab[b] and colb[b^1] before
// its block barrier, after which site i+2 writes them. No element of G is
// read by any thread but its owner: the column and the row go through the
// buffers, and a is computed from colb by whoever needs it, in the same
// operations. Decisions, sigma and (real) the detratios go to shared
// memory; the counts and the negative detratios' magnitudes are taken after
// the loop, in site order.
//
// Sites and storage: NP is the row length of the layout, NS <= NP the sites
// visited, NG the row length of G in device memory. K6 and K9 take G
// padded to NP by their wrappers (NG = NP; ops/site_sweep_delayed.py::
// padded, site_sweep_delayed_cx.py::padded); K8-c128 takes G as it is
// (NG = NS = N, NP = N padded to a multiple of 8): the rows and unit
// columns at or past NG are zero on chip and neither read nor written. Pad
// rows and columns are never visited, every slot's a and b are 0 there, and
// every real entry takes the plain version's subtractions.
// ops/site_sweep_delayed.py::rank1_layout, site_sweep_delayed_cx.py::
// rank1_layout and site_sweep_cx.py::plan_layout pick CS, TR and KR;
// smem_bytes here and there agree.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase_clock.cuh"
#include "site_sweep_tiled.cuh"

namespace rank1 {

namespace cg = cooperative_groups;

// the largest shared memory one block may use on sm_90, in bytes
constexpr size_t kSmemPerBlock = 232448;

// rows of G a thread of K6-f64 and K9-c128 keeps in registers, per flavor:
// 32 doubles in all
__host__ __device__ constexpr int reg_rows(int F) { return 16 / F; }

// threads a block at most (__launch_bounds__): as many whole warps as the
// SM's 65,536 registers hold at the register rows' 4 F KR registers and 48
// more a thread, at most kMaxThreads (KR = 16 / F: 512, up to 128
// registers a thread; 104 registers of G: 416 threads, up to 152)
constexpr int kMaxThreads = 512;
__host__ __device__ constexpr int max_threads(int F, int KR) {
  return 65536 / (4 * F * KR + 48) / 32 * 32 < kMaxThreads
             ? 65536 / (4 * F * KR + 48) / 32 * 32
             : kMaxThreads;
}

// Shared memory of one block in bytes: the shared-memory rows of G
// [f][k - KR][tid] (none where RQ / TR <= KR), the row double buffer
// [b][f][u], the column and coefficient double buffers [b][f][lr] (16-byte
// units), u [i] (double), real: the detratios [i] (double), sigma [i]
// (int8), real: sigma out [i]
__host__ __device__ inline size_t smem_bytes(bool cx, int F, int NP, int CS,
                                             int TR, int KR) {
  const int RQ = NP / CS, UR = cx ? NP : NP / 2, NT = TR * UR;
  const int RS = RQ / TR > KR ? RQ / TR - KR : 0;
  return 16 * ((size_t)F * RS * NT + 2 * (size_t)F * UR + 4 * (size_t)F * RQ) +
         (cx ? 9 : 18) * (size_t)NP;
}

// Whether (CS, TR) lays out a G of row length NP with KR register rows:
// clusters of 1, 2 or 4 blocks at F = 1, of 2, 4 or 8 at F = 2 (the plans
// of K6-f64 and K9-c128 take 2 or 4 at F = 1 and 4 or 8 at F = 2: clusters
// of 2 ran slower than 4 there at F = 2 on an H100, PERF.md), whole
// units, rows and thread rows per block, at most max_threads(F, KR)
// threads, and the shared memory within one block's
__host__ inline bool valid(bool cx, int F, int NP, int CS, int TR, int KR) {
  if (F < 1 || F > 2 || TR < 1 || NP < 1 || KR < 1) return false;
  if (CS != 1 && CS != 2 && CS != 4 && CS != 8) return false;
  if (F == 1 && CS == 8) return false;
  if (NP % CS || (!cx && NP % 2)) return false;
  const int RQ = NP / CS, UR = cx ? NP : NP / 2;
  if (RQ % TR) return false;
  return TR * UR <= max_threads(F, KR) &&
         smem_bytes(cx, F, NP, CS, TR, KR) <= kSmemPerBlock;
}

// The per-site signal: a cluster barrier without a memory fence (a
// release fence at cluster scope costs ~1,000 cycles a site on an H100,
// PERF.md). It orders no memory: the rows between blocks travel by
// st.async with an mbarrier (below), the block's barriers order its own
// shared memory, and every thread has consumed what it read of a buffer
// (consumed) before it arrives, so no later write can reach the read.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// a value loaded from shared memory is in the register: the load has
// completed
__device__ __forceinline__ void consumed(double2& v) {
  asm volatile("mov.b64 %0, %0;\n\tmov.b64 %1, %1;\n"
               : "+d"(v.x), "+d"(v.y));
}

// the shared::cta address of p, and the shared::cluster address of that
// location in block q of the cluster
__device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int q) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(q));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this block's arrival on its mbarrier, expecting bytes more to come
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// 16 bytes into another block's shared memory (shared::cluster address),
// counted on that block's mbarrier
__device__ __forceinline__ void st_async(uint32_t dst, double2 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "d"(v.x), "d"(v.y), "r"(bar)
      : "memory");
}

// The rank-1 sweep of one chain per cluster. G_in and G_out: (C, F, NG, NG)
// as 16-byte units (real: pairs of columns; complex: (re, im)), NG = NP or
// NG = NS (see above); sigma_in,
// sigma_out and u: NS sites per chain. Real: acc_out, nneg_out, and given
// neg_out the negative detratios' log10 magnitudes (min, max, sum, in site
// order) per chain. Complex: accept_out and det_out per site. Rank 0's
// thread 0 writes the per-site and per-chain results. Thread 0 of each
// block laps clk: 0 load and store, 1 signal wait, 2 decision, 3 the next
// row's and column's folds and their publication, 4 the fold of the rest;
// stamps (a build with -DMC_PHASE_STAMPS) gets each block's sums. K: the
// kernel (6: K6-f64, real G; 8: K8-c128 and 9: K9-c128, complex G), so
// that each kernel file's instances have names of their own.
template <int K, int F, int CS, int KR>
__global__ void __launch_bounds__(max_threads(F, KR))
sweep(const double2* __restrict__ G_in, double2* __restrict__ G_out,
      const int8_t* __restrict__ sigma_in, int8_t* __restrict__ sigma_out,
      const double* __restrict__ u, int* __restrict__ acc_out,
      int* __restrict__ nneg_out, double* __restrict__ neg_out,
      uint8_t* __restrict__ accept_out, double2* __restrict__ det_out,
      long long* stamps, int NP, int NS, int NG, int TR, double lamb,
      double sign0, double sign1, int det_power, int use_boson) {
  constexpr bool CX = K != 6;
  using U = double2;
  using tiled::add_rn;
  using tiled::mul_rn;
  using tiled::sub_rn;
  constexpr int NV = CX ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_rank1[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int UR = CX ? NP : NP / 2, RQ = NP / CS, RPT = RQ / TR;
  const int NT = TR * UR, RS = RPT > KR ? RPT - KR : 0;
  const int uu = tid % UR, ty = tid / UR, r0 = rank * RQ;
  U* Gs = reinterpret_cast<U*>(smem_rank1);  // [f][k - KR][tid]
  U* rowb = Gs + (size_t)F * RS * NT;         // [b][f][u]
  U* colb = rowb + 2 * F * UR;                // [b][f][lr]
  U* ab = colb + 2 * F * RQ;                  // [b][f][lr]
  double* us = reinterpret_cast<double*>(ab + 2 * F * RQ);
  double* dets = us + NP;  // real: [i] the detratios
  int8_t* ss = reinterpret_cast<int8_t*>(dets + (CX ? 0 : NP));
  int8_t* so = ss + NP;    // real: [i] sigma out
  // full[b]: row i of every flavor in rowb[b] (one arrival, by thread 0
  // with the bytes expected; the bytes by st.async from the row's owners)
  __shared__ __align__(8) uint64_t full[2];
  const int row_bytes = 16 * F * UR;
  // rowb and full in each block of the cluster (shared::cluster addresses)
  uint32_t rowb_at[CS], full_at[CS];
#pragma unroll
  for (int q = 0; q < CS; ++q) {
    rowb_at[q] = cluster_addr(cta_addr(rowb), q);
    full_at[q] = cluster_addr(cta_addr(full), q);
  }

  phase_clock::Clock clk;
  if (tid == 0) clk.start();
  // the thread's rows of G: k < min(KR, RPT) in registers, the rest in Gs
  U gr[F][KR];
  // G in device memory: rows of UG units, unit columns and rows past NG
  // absent (zero on chip)
  const int UG = CX ? NG : NG / 2;
  const bool in_g = uu < UG;
  const size_t gbase = (size_t)c * F * NG * UG;
  auto gidx = [&](int f, int k) {
    return gbase + ((size_t)f * NG + r0 + ty + TR * k) * UG + uu;
  };
  auto held = [&](int k) { return in_g && r0 + ty + TR * k < NG; };
  auto load = [&](int f, int k) {
    return held(k) ? G_in[gidx(f, k)] : make_double2(0.0, 0.0);
  };
  auto gsm = [&](int f, int k) -> U& {
    return Gs[((size_t)f * RS + k - KR) * NT + tid];
  };
#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int k = 0; k < KR; ++k)
      if (k < RPT) gr[f][k] = load(f, k);
    for (int k = KR; k < RPT; ++k) gsm(f, k) = load(f, k);
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
      for (int k = 0; k < KR; ++k)
        if (k < RPT) cn[TR * k] = column(gr[f][k], n);
      for (int k = KR; k < RPT; ++k) cn[TR * k] = column(gsm(f, k), n);
    }
  };
  // row n's unit of flavor f into rowb[n & 1] of every block
  auto send_row = [&](int n, int f, U v) {
    const int b = n & 1;
    const uint32_t off = 16 * ((b * F + f) * UR + uu);
#pragma unroll
    for (int p = 0; p < CS; ++p)
      st_async(rowb_at[p] + off, v, full_at[p] + 8 * b);
  };
  auto publish_row = [&](int n) {
    const int q = n / RQ, lr = n - q * RQ;
    if (rank != q || ty != lr % TR) return;
#pragma unroll
    for (int f = 0; f < F; ++f) send_row(n, f, get(f, lr / TR));
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
  if (tid == 0) {
    mbar_init(cta_addr(full), 1);
    mbar_init(cta_addr(full + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block runs, its mbarriers set, before its shared memory is written
  cluster.sync();
  if (tid == 0) mbar_expect(cta_addr(full), row_bytes);
  publish_column(0);
  publish_row(0);
  __syncthreads();  // column 0
  cluster_arrive();
  if (tid == 0) clk.lap(0);
  // whether site i-1 was accepted, and row i-1 at column i: colb[b] holds
  // column i as it was before site i-1's update, folded where it is read
  bool acc_prev = false;
  U bn_prev[F];

  for (int i = 0; i < NS; ++i) {
    const int b = i & 1, n = i + 1;
    mbar_wait(cta_addr(full + b), (i >> 1) & 1);  // row i is here
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
    // row i at the thread's unit column and at column n
    U bv[F], bn[F];
    const int un = CX ? n : n >> 1;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      bv[f] = rowb[(b * F + f) * UR + uu];
      bn[f] = rowb[(b * F + f) * UR + (n < NS ? un : 0)];
    }
    // column i at the block's row lr, in the fold's operations
    auto col_at = [&](int f, int lr) -> U {
      U g = colb[(b * F + f) * RQ + lr];
      if (acc_prev) {
        const U a = ab[((b ^ 1) * F + f) * RQ + lr];
        if constexpr (CX)
          fold(g, a, bn_prev[f]);
        else
          g.x = sub_rn(g.x, mul_rn(a.x, (i & 1) ? bn_prev[f].y
                                                : bn_prev[f].x));
      }
      return g;
    };
    // every block is past site i-1: its rowb[b^1] and full[b^1] are free
    cluster_wait();
    if (tid == 0) clk.lap(2);

    // 3. the next site's row and column first
    const bool more = n < NS;
    const int qn = n / RQ, lrn = n - qn * RQ;
    const bool col_own = more && uu == (CX ? n : n >> 1);
    const bool row_own = more && rank == qn && ty == lrn % TR;
    if (tid == 0 && more) mbar_expect(cta_addr(full + (b ^ 1)), row_bytes);
    if (accept) {
      // the coefficients of the block's rows
      for (int e = tid; e < F * RQ; e += NT) {
        const int f = F == 2 && e >= RQ, lr = e - f * RQ;
        const double xr = f ? x[F - 1][0] : x[0][0];
        const double xi = f ? x[F - 1][NV - 1] : x[0][NV - 1];
        ab[(b * F + f) * RQ + lr] = coef(xr, xi, col_at(f, lr), r0 + lr == i);
      }
      // column n at the block's rows as it is, into colb[b^1] (folded
      // where site n reads it)
      if (col_own) publish_column(n);
      if (row_own) {  // row n folded, into every block's rowb
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const U a = coef(x[f][0], x[f][NV - 1], col_at(f, lrn),
                           r0 + lrn == i);
          U v = get(f, lrn / TR);  // its own fold below gives the same
          fold(v, a, bv[f]);
          send_row(n, f, v);
        }
      }
    } else if (more) {
      publish_column(n);
      publish_row(n);
    }
    // ab[b] and column n for the block's threads, and every read of
    // rowb[b] of this site done before the signal
#pragma unroll
    for (int f = 0; f < F; ++f) {
      consumed(bv[f]);
      consumed(bn[f]);
      bn_prev[f] = bn[f];
    }
    acc_prev = accept;
    __syncthreads();
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
          if (k < RPT) fold(gr[f][k], a[TR * k], bv[f]);
        for (int k = KR; k < RPT; ++k) {
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
    for (int k = 0; k < KR; ++k)
      if (k < RPT && held(k)) G_out[gidx(f, k)] = gr[f][k];
    for (int k = KR; k < RPT; ++k)
      if (held(k)) G_out[gidx(f, k)] = gsm(f, k);
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

// The launch configuration of sweep<K, F, CS, KR> for C chains at row
// length NP and TR thread rows, with its shared memory allowed; returns the
// cudaError_t of that setting.
template <int K, int F, int CS, int KR>
int config(int C, int NP, int TR, cudaStream_t stream, cudaLaunchConfig_t* cfg,
           cudaLaunchAttribute* attr) {
  constexpr bool CX = K != 6;
  if (!valid(CX, F, NP, CS, TR, KR)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(CX, F, NP, CS, TR, KR);
  cudaError_t err = cudaFuncSetAttribute(
      sweep<K, F, CS, KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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

// One built instance of sweep, (F, CS, KR), and the instances a kernel file
// builds
template <int F_, int CS_, int KR_>
struct Inst {
  static constexpr int F = F_, CS = CS_, KR = KR_;
};
template <class... Is>
struct List {};
// K6-f64's and K9-c128's: KR = reg_rows(F)
using Delayed = List<Inst<1, 2, 16>, Inst<1, 4, 16>, Inst<2, 4, 8>,
                     Inst<2, 8, 8>>;

template <int K, int F, int CS, int KR>
int launch_one(const double2* gi, double2* go, const int8_t* sigma_in,
               int8_t* sigma_out, const double* u, int* acc, int* nneg,
               double* neg, uint8_t* accept, double2* dt, long long* stamps,
               int C, int NP, int NS, int NG, int TR, double lamb,
               double sign0, double sign1, int det_power, int use_boson,
               cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = config<K, F, CS, KR>(C, NP, TR, stream, &cfg, &attr);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, sweep<K, F, CS, KR>, gi, go, sigma_in,
                                sigma_out, u, acc, nneg, neg, accept, dt,
                                stamps, NP, NS, NG, TR, lamb, sign0, sign1,
                                det_power, use_boson);
  return err ? err : (int)cudaGetLastError();
}

// One launch over C chains in the instance (F, CS, KR) of the list; returns
// the cudaError_t of the launch (cudaErrorInvalidValue where the list has
// no such instance)
template <int K, class... Is>
int launch(List<Is...>, const void* G_in, void* G_out, const int8_t* sigma_in,
           int8_t* sigma_out, const double* u, int* acc, int* nneg,
           double* neg, uint8_t* accept, void* det, long long* stamps, int C,
           int F, int NP, int NS, int NG, int CS, int TR, int KR, double lamb,
           double sign0, double sign1, int det_power, int use_boson,
           cudaStream_t stream) {
  if (C == 0) return 0;
  if (NS < 1 || NS > NP || NG < NS || NG > NP || det_power < 1 ||
      det_power > 2)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  (void)((F == Is::F && CS == Is::CS && KR == Is::KR &&
          ((err = launch_one<K, Is::F, Is::CS, Is::KR>(
                (const double2*)G_in, (double2*)G_out, sigma_in, sigma_out,
                u, acc, nneg, neg, accept, (double2*)det, stamps, C, NP, NS,
                NG, TR, lamb, sign0, sign1, det_power, use_boson, stream)),
           true)) ||
         ...);
  return err;
}

template <int K, int F, int CS, int KR>
int query_one(int NP, int TR, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = config<K, F, CS, KR>(1, NP, TR, 0, &cfg, &attr);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (void*)sweep<K, F, CS, KR>, &cfg);
}

// The most clusters of the instance (F, CS, KR) of the list the card runs
// at once at row length NP and TR thread rows, into *out
template <int K, class... Is>
int max_clusters(List<Is...>, int F, int NP, int CS, int TR, int KR,
                 int* out) {
  *out = 0;
  int err = (int)cudaErrorInvalidValue;
  (void)((F == Is::F && CS == Is::CS && KR == Is::KR &&
          ((err = query_one<K, Is::F, Is::CS, Is::KR>(NP, TR, out)), true)) ||
         ...);
  return err;
}

}  // namespace rank1
