// The first design of K1's Metropolis site loop, which K1 in float64
// (site_sweep.cu's site_sweep_kernel<double>) alone still runs; K1 in
// float32, K8 and K13 run site_sweep_tiled.cuh, and K5 (site_sweep.cu)
// borrows the rounding helpers below. One thread block per chain; G of the
// chain (F x N x N) lives in dynamic shared memory, rows padded to N+1
// elements.
// Every operation is an _rn intrinsic (__f*_rn in float32, __d*_rn in
// float64), which nvcc never fuses into FMAs, so every value matches the
// plain PyTorch version's separately rounded operations
// (montecarlo_tpu_torch/ops/site_sweep.py::site_sweep_plain).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
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
__device__ __forceinline__ float log10_(float x) { return log10f(x); }
__device__ __forceinline__ double log10_(double x) { return log10(x); }

// The block's threads as (tx, ty): column tx of rows ty, ty + rstep, ...;
// threads with ty >= rstep (when N does not divide the block) stay idle in
// the element-wise passes.
struct Tile {
  int tx, ty, rstep;
  bool active;
  __device__ explicit Tile(int N)
      : tx(threadIdx.x % N), ty(threadIdx.x / N), rstep(blockDim.x / N),
        active(threadIdx.x / N < blockDim.x / N) {}
};

// G of one chain (F x N x N, row-major at src) into shared memory Gs
template <typename T, int F>
__device__ __forceinline__ void load_g(const T* __restrict__ src, T* Gs,
                                       int N) {
  const Tile t(N);
  const int LD = N + 1;
  if (!t.active) return;
  for (int f = 0; f < F; ++f)
    for (int a = t.ty; a < N; a += t.rstep)
      Gs[(f * N + a) * LD + t.tx] = src[(size_t)(f * N + a) * N + t.tx];
}

template <typename T, int F>
__device__ __forceinline__ void store_g(const T* Gs, T* __restrict__ dst,
                                        int N) {
  const Tile t(N);
  const int LD = N + 1;
  if (!t.active) return;
  for (int f = 0; f < F; ++f)
    for (int a = t.ty; a < N; a += t.rstep)
      dst[(size_t)(f * N + a) * N + t.tx] = Gs[(f * N + a) * LD + t.tx];
}

// The site loop of one chain: sigma_in, sigma_out and u point at the
// chain's N entries (sigma_out may lie in shared memory). Every thread
// computes the accept decision itself from the same shared values (no
// broadcast barrier); only accepted sites stage row i and the scaled column
// x*(e_i - G[:, i]) in rows / cols (F*N each) -- both read BEFORE the update
// overwrites them -- and apply the rank-1 update. Thread 0 writes sigma_out,
// counts the accepted (acc) and negative (nneg) detratios and, with
// record_neg, folds log10(max(|det|, 1e-38)) of the negative ones into
// (neg_min, neg_max, neg_sum) in site order, as the XLA loop's _push_mag
// does. Ends without a barrier after a rejected last site.
template <typename T, int F>
__device__ __forceinline__ void sweep_sites(
    T* Gs, T* rows, T* cols, int N, const int8_t* __restrict__ sigma_in,
    int8_t* __restrict__ sigma_out, const T* __restrict__ u, T lamb,
    T sign0, T sign1, int det_power, int use_boson, bool record_neg,
    int& acc, int& nneg, T& neg_min, T& neg_max, T& neg_sum) {
  const Tile t(N);
  const int LD = N + 1;
  const int tid = threadIdx.x;
  const T one = 1;
  const T neg2lamb = mul_rn(T(-2), lamb);
  for (int i = 0; i < N; ++i) {
    const int8_t s8 = sigma_in[i];
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
    const bool accept = u[i] < mul_rn(w, det);
    if (tid == 0) {
      acc += accept;
      nneg += det < T(0);
      sigma_out[i] = accept ? (int8_t)(-s8) : s8;
      if (record_neg && det < T(0)) {
        const T lv = log10_(fmax(fabs(det), T(1e-38)));
        neg_min = fmin(neg_min, lv);
        neg_max = fmax(neg_max, lv);
        neg_sum = add_rn(neg_sum, lv);
      }
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
    if (t.active) {
      for (int f = 0; f < F; ++f) {
        const T rb = rows[f * N + t.tx];
        for (int a = t.ty; a < N; a += t.rstep) {
          T* g = &Gs[(f * N + a) * LD + t.tx];
          *g = sub_rn(*g, mul_rn(cols[f * N + a], rb));
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace
