// The Ising model's two moves: the checkerboard Metropolis sweep (kernel
// K17) and a batch of levels of the Wolff cluster's breadth-first search
// (K18).
//
// Neither replaces a TPU kernel: the JAX package runs both as XLA loops
// fused into one jitted lax.scan per block of sweeps
// (montecarlo_tpu/mc/mc.py:146-185): the sweep is
// montecarlo_tpu/models/ising.py:88-103, the BFS level the body of its
// lax.while_loop at :131-148. In plain PyTorch each color class would cost
// about ten launches and a (C, n_c, z) gather, each BFS level as many again,
// so the port's main path runs these two kernels, as it runs K1-f64 for the
// JAX package's float64 XLA site loop. Their plain PyTorch versions are
// montecarlo_tpu_torch/ops/ising.py::ising_sweep_plain and
// wolff_step_plain.
//
// K17 (ising_sweep_i8). What bounds it: bytes. A sweep reads each site's
// spin (1 byte) and its float64 uniform (8 bytes) once and writes the spin
// once. Per color class in order, h = s_i * sum_nn s_j (dE = 2h), accept
// when h <= 0 or u < thr[h], thr[h] = exp(-2 beta h) computed once on the
// host in float64, and flip the accepted spins. No site of a class
// neighbors another of the same class (Lattice.site_colors), so the flips
// of one class never change another decision of that class. The uniforms
// arrive in class order (the class's sites in their order in
// Lattice.site_colors, classes one after another). Each chain's accepted
// count is added to its int64 accumulator acc[c]: integer sums, the same in
// any order. The decisions compare the same float64 values as the plain
// version, so conf and the counts are bit-equal to it.
//   The tile layout (N <= 64, 16 | N and no neighbor listed twice: the
// 8x8, the 4x4 and the cubic L = 4 of the benchmark rows): one warp per
// chain, the chain's spins a 64-bit mask in registers over class positions
// (bit r: the spin of site order[r]). Lane l decides class positions l and
// l + 32; the neighbor sum of position p is 2 popc(up & M[p]) - z, with
// M[p] the host's mask of the positions of the neighbors of site order[p],
// the threshold read from shared memory without a branch. A class's flips
// are one pair of ballots (the 8x8's and the cubic L = 4's two classes of
// 32 positions, one ballot each), with no block barrier. Builds of the
// first designs with the arithmetic or the loads compiled out showed
// instructions, not loads, bounding the sweep; so the decisions run
// without a branch, and no read waits on a decision: the grid holds as
// many blocks as fit at once and walks over tiles of 8 consecutive chains. A block's producer warp copies
// a tile's uniforms and spins (two contiguous runs of rows) with two bulk
// copies of the tensor memory accelerator into a ring of 4 stages, each
// completing on an mbarrier; its 8 consumer warps sweep one chain each and
// release the stage.
//   Every other lattice, the shared-memory layout: one warp per chain, the
// spins in shared memory (N bytes); per class the lanes take the class's
// positions in turn, the uniform loaded before the neighbor sum (no load
// gated on h).
//
// K18 (wolff_step_u8). A batch of Lb BFS levels of every chain's search in
// one launch: u holds Lb levels' uniforms stacked (Lb, C, N, z), the level
// ell of chain c at u[ell, c]. The JAX loop runs one level of every chain
// at a time until no frontier is left; a chain whose frontier is empty does
// nothing in a level, so each chain runs its own levels with no grid-wide
// barrier. A site t joins the frontier when it is not in the cluster, has
// the seed's spin, and one of the bonds (i, k) with table[i, k] = t (the
// reverse table rev, built on the host) has i on the frontier and
// u[ell, c, i, k] < p_add: a gather, so every output has one writer and the
// result does not depend on thread order. The launch writes status[0], the
// most levels any chain ran (a chain runs a level while its frontier holds a
// site: the JAX loop's body count), and status[1] = 1 when a frontier is
// left after Lb levels; the host reads both once a batch.
//   What bounds it: the latency of the levels, each a dependent gather of
// the frontier's uniforms (8z bytes per site that joins, each site on the
// frontier once). N <= 64 and at most 8 bonds onto a site: one warp per
// chain, cluster, frontier and same-spin sites as 64-bit masks in
// registers, lane l deciding targets l and l + 32 (its rev entries in
// registers), the new frontier one pair of ballots. Otherwise one block per
// chain, cluster, frontier, next frontier and spins as bytes in shared
// memory (in device memory, the outputs and a scratch buffer, where 4N
// bytes do not fit), two block barriers a level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;              // chains per block (warp layouts)
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 232448;      // a block's dynamic shared memory
constexpr int SMALL_N = 64;           // sites of the register layouts
constexpr int SMALL_ZR = 8;           // K18: bonds onto a site, registers

__device__ __forceinline__ unsigned long long ballot64(bool lo, bool hi) {
  return (unsigned long long)__ballot_sync(FULL, lo) |
         ((unsigned long long)__ballot_sync(FULL, hi) << 32);
}

// ------------------------------------------------------------------ K17

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(void* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void bar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(void* bar, unsigned parity) {
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// A bulk copy (the tensor memory accelerator) of bytes (a multiple of 16,
// both ends 16-byte aligned) into shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// How the tile layout walks the color classes: SPLIT, two classes,
// positions [0, 32) and [32, N) (the checkerboards of the 8x8 and the
// cubic L = 4), lane l deciding position l in the first and l + 32 in the
// second, one ballot each; ANY, a lane deciding each of its positions in
// its class's turn.
enum Walk { SPLIT, ANY };
constexpr int THR_MAX = 64;             // thresholds held in shared memory

// What a lane of the tile layout keeps for every chain: its class
// positions p0 = lane and p1 = lane + 32, their sites j0, j1, classes k0,
// k1 and neighbor masks m0, m1, and the bits b0, b1 (at their positions)
// of sites lane and lane + 32.
struct Lane {
  int lane, j0, j1, k0, k1;
  bool v0, v1;
  unsigned long long m0, m1, b0, b1;
};

__device__ Lane lane_setup(const unsigned long long* __restrict__ masks,
                           const int* __restrict__ order,
                           const int* __restrict__ offsets,
                           const unsigned char* pos, int N, int n_classes) {
  Lane L;
  L.lane = threadIdx.x & 31;
  const int p0 = L.lane, p1 = L.lane + 32;
  L.v0 = p0 < N;
  L.v1 = p1 < N;
  L.j0 = L.v0 ? __ldg(order + p0) : 0;
  L.j1 = L.v1 ? __ldg(order + p1) : 0;
  L.m0 = L.v0 ? __ldg(masks + p0) : 0ull;
  L.m1 = L.v1 ? __ldg(masks + p1) : 0ull;
  L.b0 = L.v0 ? 1ull << pos[p0] : 0ull;
  L.b1 = L.v1 ? 1ull << pos[p1] : 0ull;
  L.k0 = L.k1 = -1;
  for (int k = 0; k < n_classes; ++k) {
    const int lo = __ldg(offsets + k), hi = __ldg(offsets + k + 1);
    if (p0 >= lo && p0 < hi) L.k0 = k;
    if (p1 >= lo && p1 < hi) L.k1 = k;
  }
  return L;
}

// The block's shared copies of the thresholds and of each site's class
// position (pos[order[p]] = p), before any warp leaves.
__device__ __forceinline__ void block_setup(
    const double* __restrict__ thr, const int* __restrict__ order, int z,
    int N, double* thr_s, unsigned char* pos) {
  for (int h = threadIdx.x; h <= z; h += blockDim.x) thr_s[h] = thr[h];
  for (int p = threadIdx.x; p < N; p += blockDim.x) pos[__ldg(order + p)] = p;
}

// The decision at class position p (neighbor mask m) on the spins up (bit
// r: the spin of site order[r]), without a branch: accept when h <= 0 or
// uu < thr[h].
__device__ __forceinline__ bool decide(unsigned long long up,
                                       unsigned long long m, int p, int z,
                                       double uu, const double* thr) {
  const int nn = 2 * __popcll(up & m) - z;  // sum of the neighbors' spins
  const int h = ((up >> p) & 1) ? nn : -nn;
  const double t = thr[h > 0 ? h : 0];
  return (h <= 0) | (uu < t);
}

// One chain's sweep in the tile layout from its spins s0, s1 (of sites
// j0, j1) and its uniforms uc (in class order) in shared memory: returns
// the spins, bit r the spin of site order[r], and the accepted count in
// *count.
template <Walk W>
__device__ __forceinline__ unsigned long long sweep_chain(
    const Lane& L, int s0, int s1, const double* uc, int z, int n_classes,
    const double* thr, unsigned* count) {
  const int p0 = L.lane, p1 = L.lane + 32;
  const double u0 = uc[p0];
  const double u1 = L.v1 ? uc[p1] : 1.0;
  // the spins in class order: a class's flips are one pair of ballots
  // (SPLIT: one ballot)
  unsigned long long up = ballot64(L.v0 && s0 > 0, L.v1 && s1 > 0);
  if (W == SPLIT) {
    const unsigned f0 =
        __ballot_sync(FULL, decide(up, L.m0, p0, z, u0, thr));
    up ^= f0;
    const unsigned f1 =
        __ballot_sync(FULL, L.v1 && decide(up, L.m1, p1, z, u1, thr));
    up ^= (unsigned long long)f1 << 32;
    *count = __popc(f0) + __popc(f1);
    return up;
  }
  unsigned n = 0;
  for (int k = 0; k < n_classes; ++k) {
    const bool a0 = L.k0 == k && decide(up, L.m0, p0, z, u0, thr);
    const bool a1 = L.k1 == k && decide(up, L.m1, p1, z, u1, thr);
    const unsigned long long flip = ballot64(a0, a1);
    up ^= flip;
    n += __popcll(flip);
  }
  *count = n;
  return up;
}

// The chain's spins back in site order (every lane two sites) and its
// count added to acc[c].
__device__ __forceinline__ void store_chain(const Lane& L,
                                            unsigned long long up,
                                            unsigned count,
                                            int8_t* __restrict__ out,
                                            long long* __restrict__ acc) {
  if (L.v0) out[L.lane] = (up & L.b0) ? 1 : -1;
  if (L.v1) out[L.lane + 32] = (up & L.b1) ? 1 : -1;
  if (L.lane == 0) atomicAdd((unsigned long long*)acc, count);
}

// The tile layout (N <= 64, 16 | N, no neighbor listed twice): a block of
// WARPS consumer warps and one producer warp walks over tiles of WARPS
// consecutive chains (a grid of as many blocks as fit at once). The
// producer's one lane copies a tile's uniforms and spins, two contiguous
// runs of rows, into a ring of STAGES stages of shared memory with two
// bulk copies completing on the stage's mbarrier, as soon as the consumers
// have released the stage; consumer warp w sweeps chain w of the tile, its
// spins a 64-bit mask in registers.
constexpr int STAGES = 4;

struct TileStage {
  double u[WARPS * SMALL_N];
  int8_t spins[WARPS * SMALL_N];
};

template <Walk W>
__global__ void __launch_bounds__(32 * (WARPS + 1)) ising_sweep_tile_kernel(
    const int8_t* __restrict__ conf_in, int8_t* __restrict__ conf_out,
    const double* __restrict__ u, const unsigned long long* __restrict__ masks,
    const int* __restrict__ order, const int* __restrict__ offsets,
    const double* __restrict__ thr, long long* __restrict__ acc, int C, int N,
    int z, int n_classes) {
  __shared__ __align__(128) TileStage stage[STAGES];
  __shared__ __align__(8) unsigned long long full[STAGES], empty[STAGES];
  __shared__ double thr_s[THR_MAX];
  __shared__ unsigned char pos[SMALL_N];
  block_setup(thr, order, z, N, thr_s, pos);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const long long tiles = ((long long)C + WARPS - 1) / WARPS;
  if (warp == WARPS) {                  // the producer
    if ((threadIdx.x & 31) != 0) return;
    int s = 0;
    unsigned parity = 0;
    for (long long t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
      if (i >= STAGES) bar_wait(&empty[s], parity ^ 1);
      const long long c0 = t * WARPS;
      const long long rows = C - c0 < WARPS ? C - c0 : WARPS;
      bar_expect(&full[s], (unsigned)(9 * N * rows));
      bulk_copy(stage[s].u, u + c0 * N, (unsigned)(8 * N * rows), &full[s]);
      bulk_copy(stage[s].spins, conf_in + c0 * N, (unsigned)(N * rows),
                &full[s]);
      if (++s == STAGES) {
        s = 0;
        parity ^= 1;
      }
    }
    return;
  }
  const Lane L = lane_setup(masks, order, offsets, pos, N, n_classes);
  int s = 0;
  unsigned parity = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    bar_wait(&full[s], parity);
    const long long c = t * WARPS + warp;
    unsigned count = 0;
    unsigned long long up = 0;
    if (c < C) {
      const int8_t* spins = stage[s].spins + warp * N;
      up = sweep_chain<W>(L, spins[L.j0], L.v1 ? spins[L.j1] : 0,
                          stage[s].u + warp * N, z, n_classes, thr_s, &count);
    }
    // every value read from the stage is in registers and used
    __syncwarp();
    if (L.lane == 0) bar_arrive(&empty[s]);
    if (c < C) store_chain(L, up, count, conf_out + c * N, acc + c);
    if (++s == STAGES) {
      s = 0;
      parity ^= 1;
    }
  }
}

__global__ void ising_sweep_smem_kernel(const int8_t* __restrict__ conf_in,
                                        int8_t* __restrict__ conf_out,
                                        const double* __restrict__ u,
                                        const int* __restrict__ table,
                                        const int* __restrict__ order,
                                        const int* __restrict__ offsets,
                                        const double* __restrict__ thr,
                                        long long* __restrict__ acc, int C,
                                        int N, int z, int n_classes, int NP) {
  extern __shared__ int8_t spins[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= C) return;             // the whole warp: no block barrier
  int8_t* s = spins + (long long)warp * NP;
  const int8_t* cin = conf_in + chain * N;
  for (int i = lane; i < N; i += 32) s[i] = cin[i];
  __syncwarp();
  const double* uc = u + chain * N;
  int count = 0;
  for (int k = 0; k < n_classes; ++k) {
    const int hi = __ldg(offsets + k + 1);
    for (int p = __ldg(offsets + k) + lane; p < hi; p += 32) {
      const double up = __ldcs(uc + p);  // loaded before the decision
      const int i = __ldg(order + p);
      const int* nb = table + (long long)i * z;
      int nn = 0;
      for (int j = 0; j < z; ++j) nn += s[__ldg(nb + j)];
      const int h = s[i] * nn;        // dE / 2
      if (h <= 0 || up < __ldg(thr + h)) {
        s[i] = -s[i];
        ++count;
      }
    }
    __syncwarp();
  }
  int8_t* cout = conf_out + chain * N;
  for (int i = lane; i < N; i += 32) cout[i] = s[i];
  count = __reduce_add_sync(FULL, count);
  if (lane == 0) acc[chain] += count;
}

// ------------------------------------------------------------------ K18

__global__ void __launch_bounds__(32 * WARPS) wolff_reg_kernel(
    const int8_t* __restrict__ conf, const uint8_t* __restrict__ in_cluster,
    const uint8_t* __restrict__ frontier, const int8_t* __restrict__ seed_spin,
    const double* __restrict__ u, const int* __restrict__ rev,
    uint8_t* __restrict__ in_out, uint8_t* __restrict__ front_out,
    int* __restrict__ status, double p_add, int C, int N, int z, int zr,
    int Lb) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= C) return;                   // the whole warp
  const long long row = c * N;
  const int t0 = lane, t1 = lane + 32;
  const bool v0 = t0 < N, v1 = t1 < N;
  const int8_t sp = seed_spin[c];
  const unsigned long long same = ballot64(v0 && conf[row + t0] == sp,
                                           v1 && conf[row + t1] == sp);
  unsigned long long inc = ballot64(v0 && in_cluster[row + t0],
                                    v1 && in_cluster[row + t1]);
  unsigned long long fr = ballot64(v0 && frontier[row + t0],
                                   v1 && frontier[row + t1]);
  // the bonds onto targets t0 and t1: flat index e = i * z + k into a
  // level's (N, z) uniforms and source site i (-1: none)
  int e0[SMALL_ZR], e1[SMALL_ZR], i0[SMALL_ZR], i1[SMALL_ZR];
#pragma unroll
  for (int r = 0; r < SMALL_ZR; ++r) {
    e0[r] = v0 && r < zr ? __ldg(rev + t0 * zr + r) : -1;
    e1[r] = v1 && r < zr ? __ldg(rev + t1 * zr + r) : -1;
    i0[r] = e0[r] >= 0 ? e0[r] / z : 0;
    i1[r] = e1[r] >= 0 ? e1[r] / z : 0;
  }
  const long long level = (long long)C * N * z;
  const double* uc = u + row * z;
  int ran = 0;
  for (int l = 0; l < Lb && fr; ++l, uc += level) {
    ran = l + 1;
    const unsigned long long cand = same & ~inc;
    const bool c0 = (cand >> t0) & 1, c1 = v1 && ((cand >> t1) & 1);
    bool a0 = false, a1 = false;
#pragma unroll
    for (int r = 0; r < SMALL_ZR; ++r) {
      if (c0 && e0[r] >= 0 && ((fr >> i0[r]) & 1))
        a0 |= __ldcs(uc + e0[r]) < p_add;
      if (c1 && e1[r] >= 0 && ((fr >> i1[r]) & 1))
        a1 |= __ldcs(uc + e1[r]) < p_add;
    }
    fr = ballot64(a0, a1);              // new sites: never in the cluster
    inc |= fr;
  }
  if (v0) {
    in_out[row + t0] = (inc >> t0) & 1;
    front_out[row + t0] = (fr >> t0) & 1;
  }
  if (v1) {
    in_out[row + t1] = (inc >> t1) & 1;
    front_out[row + t1] = (fr >> t1) & 1;
  }
  if (lane == 0) {
    atomicMax(status, ran);
    if (fr) atomicOr(status + 1, 1);
  }
}

__global__ void wolff_block_kernel(
    const int8_t* __restrict__ conf, const uint8_t* __restrict__ in_cluster,
    const uint8_t* __restrict__ frontier, const int8_t* __restrict__ seed_spin,
    const double* __restrict__ u, const int* __restrict__ rev,
    uint8_t* __restrict__ in_out, uint8_t* __restrict__ front_out,
    uint8_t* __restrict__ scratch, int* __restrict__ status, double p_add,
    int C, int N, int z, int zr, int Lb, int on_chip) {
  extern __shared__ uint8_t sm[];
  const long long c = blockIdx.x;
  const long long row = c * N;
  // the chain's state: on chip, or in the outputs and scratch
  uint8_t *inc, *fr, *nx;
  const int8_t* cf;
  if (on_chip) {
    inc = sm;
    fr = sm + N;
    nx = sm + 2 * N;
    cf = (const int8_t*)(sm + 3 * N);
  } else {
    inc = in_out + row;
    fr = front_out + row;
    nx = scratch + row;
    cf = conf + row;
  }
  int alive = 0;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    inc[t] = in_cluster[row + t];
    const uint8_t f = frontier[row + t];
    fr[t] = f;
    alive |= f;
    if (on_chip) sm[3 * N + t] = (uint8_t)conf[row + t];
  }
  alive = __syncthreads_or(alive);
  const int8_t sp = seed_spin[c];
  const long long level = (long long)C * N * z;
  const double* uc = u + row * z;
  int ran = 0;
  for (int l = 0; l < Lb && alive; ++l, uc += level) {
    ran = l + 1;
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
      uint8_t a = 0;
      if (!inc[t] && cf[t] == sp) {
        const int* rt = rev + (long long)t * zr;
        for (int r = 0; r < zr && !a; ++r) {
          const int e = __ldg(rt + r);  // i * z + k of a bond onto t, or -1
          if (e < 0) break;
          a = fr[e / z] && __ldcs(uc + e) < p_add;
        }
      }
      nx[t] = a;
    }
    __syncthreads();
    int any = 0;
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
      const uint8_t a = nx[t];
      inc[t] |= a;
      fr[t] = a;
      any |= a;
    }
    alive = __syncthreads_or(any);
  }
  if (on_chip)
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
      in_out[row + t] = inc[t];
      front_out[row + t] = fr[t];
    }
  if (threadIdx.x == 0) {
    atomicMax(status, ran);
    if (alive) atomicOr(status + 1, 1);
  }
}

// blocks of kernel that fit on the card at once (the grid of its walk
// over chains)
int resident_blocks(const void* kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <Walk W>
cudaError_t launch_tiles(const int8_t* conf_in, int8_t* conf_out,
                         const double* u, const int* order,
                         const int* offsets, const unsigned long long* masks,
                         const double* thr, long long* acc, int C, int N,
                         int z, int n_classes, cudaStream_t st) {
  static int resident = 0;
  if (resident == 0)
    resident = resident_blocks((const void*)ising_sweep_tile_kernel<W>,
                               32 * (WARPS + 1));
  if (resident == 0) return cudaErrorInvalidValue;
  const long long tiles = ((long long)C + WARPS - 1) / WARPS;
  ising_sweep_tile_kernel<W><<<(int)(tiles < resident ? tiles : resident),
                               32 * (WARPS + 1), 0, st>>>(
      conf_in, conf_out, u, masks, order, offsets, thr, acc, C, N, z,
      n_classes);
  return cudaGetLastError();
}

cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// K17: conf (C, N) int8 ±1 in and out, u (C, N) float64 in class order,
// table (N, z) int32, order (N,) int32 and offsets (n_classes + 1,) int32
// (the color classes), masks (N,) uint64 (bit r of masks[p]: site order[r]
// neighbors site order[p]; null where N > 64 or a neighbor is listed
// twice: the shared-memory layout), thr (z + 1,) float64, acc (C,) int64
// (added to), split 1 when the classes are positions [0, 32) and [32, N).
extern "C" int ising_sweep_i8(const int8_t* conf_in, int8_t* conf_out,
                              const double* u, const int* table,
                              const int* order, const int* offsets,
                              const unsigned long long* masks,
                              const double* thr, long long* acc, int C,
                              int N, int z, int n_classes, int split,
                              void* stream) {
  if (C == 0) return 0;
  const int NP = (N + 15) & ~15;
  if (N < 1 || z < 0 || n_classes < 1 || NP > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the tile layout where its bulk copies' runs of rows are multiples of
  // 16 bytes on 16-byte boundaries
  if (masks != nullptr && N <= SMALL_N && (N & 15) == 0 && z < THR_MAX &&
      (((uintptr_t)conf_in | (uintptr_t)u) & 15) == 0)
    return (int)(split ? launch_tiles<SPLIT> : launch_tiles<ANY>)(
        conf_in, conf_out, u, order, offsets, masks, thr, acc, C, N, z,
        n_classes, st);
  const int warps = NP * WARPS <= SMEM_MAX ? WARPS : SMEM_MAX / NP;
  const int smem = warps * NP;
  cudaError_t e = allow_smem((const void*)ising_sweep_smem_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (C + warps - 1) / warps;
  ising_sweep_smem_kernel<<<blocks, 32 * warps, smem, st>>>(
      conf_in, conf_out, u, table, order, offsets, thr, acc, C, N, z,
      n_classes, NP);
  return (int)cudaGetLastError();
}

// K18: conf (C, N) int8, in_cluster and frontier (C, N) uint8 (bool),
// seed_spin (C,) int8, u (Lb, C, N, z) float64, rev (N, zr) int32 (-1
// padded), in_out and front_out (C, N) uint8, scratch (C, N) uint8 where
// the block layout's 4N bytes exceed a block's shared memory (else unused),
// status two int32, zeroed by the caller: the most levels a chain ran and
// whether a frontier is left.
extern "C" int wolff_step_u8(const int8_t* conf, const uint8_t* in_cluster,
                             const uint8_t* frontier, const int8_t* seed_spin,
                             const double* u, const int* rev, uint8_t* in_out,
                             uint8_t* front_out, uint8_t* scratch,
                             int* status, double p_add, int C, int N, int z,
                             int zr, int Lb, void* stream) {
  if (C == 0) return 0;
  if (N < 1 || z < 1 || zr < 0 || Lb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= SMALL_N && zr <= SMALL_ZR) {
    const long long blocks = ((long long)C + WARPS - 1) / WARPS;
    wolff_reg_kernel<<<(unsigned)blocks, 32 * WARPS, 0, st>>>(
        conf, in_cluster, frontier, seed_spin, u, rev, in_out, front_out,
        status, p_add, C, N, z, zr, Lb);
    return (int)cudaGetLastError();
  }
  const long long bytes = 4LL * N;
  const int on_chip = bytes <= SMEM_MAX;
  if (!on_chip && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = on_chip ? (int)bytes : 0;
  cudaError_t e = allow_smem((const void*)wolff_block_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = N >= 256 ? 256 : (N + 31) & ~31;
  wolff_block_kernel<<<C, threads, smem, st>>>(
      conf, in_cluster, frontier, seed_spin, u, rev, in_out, front_out,
      scratch, status, p_add, C, N, z, zr, Lb, on_chip);
  return (int)cudaGetLastError();
}
