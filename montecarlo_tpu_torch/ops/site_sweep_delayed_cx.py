"""Delayed site-major Metropolis sweep over one time slice for a complex
Green's function, for N > 128 (kernel K9: complex hopping past the N where
K8 keeps G in shared memory).

``site_sweep_delayed_cx`` launches the CUDA kernel
``csrc/site_sweep_delayed_cx.cu`` on CUDA tensors; on CPU tensors it runs
``site_sweep_delayed_cx_plain``, the plain PyTorch version of the same
algorithm with the same op order. It replaces the Pallas kernel
``montecarlo_tpu/ops/pallas_site_sweep.py::_sitemajor_kernel_cx`` (reached
through ``_site_sweep_sitemajor_cx`` / ``get_fused_site_sweep_cx``).

It is the complex instance of K6 (``ops/site_sweep_delayed.py``): the sites
are taken in blocks of dk; the row slab G[i0:i0+dk, :] and the column slab
G[:, i0:i0+dk] are kept exactly updated through the dk decisions, each of
them K8's (``ops/site_sweep_cx.py``: Metropolis on Re(det), every site's
accept flag and complex det returned) read from the slabs; an accepted
site's rank-1 term y ⊗ G[i, :], y = x·(e_i - G[:, i]), folds into the slabs
at once and into G once per block, in slot order, each complex product
rounded on the real and imaginary planes as K8 rounds it and then
subtracted. So the Markov chain is K8's, and every value is K8's operation
in K8's order.

On the card, ``plan_layout`` picks the kernel's layout (a ``Layout``) from
the shape: one thread-block cluster of CS = 2 or 4 blocks per chain, each
block folding N/CS rows of G (``cluster_plan``'s CS), or, where the
cluster's buffers do not fit, one block per chain with the slabs above. At
dk = 1 in complex128 it picks the rank-1 layout (``rank1_layout``,
``csrc/site_sweep_rank1.cuh``, K6-f64's) wherever that fits: G on chip for
the whole launch, one cluster barrier per site.

``site_sweep_delayed_cx_c128`` is the same kernel in complex128 (K9-c128):
it replaces the XLA loops the JAX package runs for complex128 updates past
N = 128 (``montecarlo_tpu/dqmc/core.py::sweep_slice_delayed``, and at
dk = 1 the rank-1 loop of ``sweep_slice``), which have no TPU kernel. Its
buffers take twice the bytes, so its cluster layout may form the b vectors
in column passes over N/P columns each, as K6-f64's
(``ops/site_sweep_delayed.py``), and at F = 2 replay and fold one flavor
at a time (flavor stages; ``plan`` picks both): complex128 at F = 2,
N = 256, dk = 32 (the 16x16 repulsive model in a flux at its default
delay) fits a cluster only so, and past one wave of those clusters runs
the flavor layout (``flavors_layout``: one flavor a block) instead.

The kernel takes 8 | N. Elsewhere (13 x 13, 14 x 14, 15 x 15, rings of 130
sites) the wrappers pad G with zero rows and columns to ``padded(N)``, which
the sweep never visits; the result is the plain version's on the unpadded
G. Filling the padded copy, copying G into it and slicing the result back
move G three more times besides the kernel's own traffic.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .site_sweep import MAX_N
from .site_sweep_delayed import (Layout, rank1_geometry, rank1_regs,
                                 rank1_smem)

MIN_N = MAX_N + 1        # K8 (ops/site_sweep_cx.py) takes N <= 128
# the cluster sizes (blocks per chain) in the order cluster_plan tries
# them, and how many clusters of each an H100 runs at once (its occupancy
# query at up to ~217 KB a block: clusters of 2 blocks 66, of 4 only 30)
CLUSTER_SIZES = (2, 4)
CLUSTERS_AT_ONCE = {2: 66, 4: 30}
# the phases that a build with -DMC_PHASE_STAMPS times (chip_profile.py),
# per kernel of csrc/site_sweep_delayed_cx.cu
PHASES = {"slab": ("slab load", "decisions", "staging and slab update",
                   "fold"),
          "cluster": ("setup and copy", "cluster barriers", "diagonal block",
                      "decisions", "y and b vectors", "fold"),
          # csrc/site_sweep_rank1.cuh (complex128, dk = 1)
          "rank1": ("load and store", "signal wait", "decision",
                    "next row and column", "fold of the rest"),
          # site_sweep_delayed_cx_flavors (complex128, F = 2)
          "flavors": ("setup and copy", "cluster barrier", "diagonal block",
                      "decisions and flavor exchange", "y and b vectors",
                      "fold")}


# the column passes of the cluster layout, in the order ``plan`` tries them,
# per dtype of G: complex64 keeps one pass where it fits (its layout as
# measured) and takes two at F = 2, N = 256, dk = 32; complex128 buffers
# take twice the bytes
PASSES = {torch.complex64: (1, 2), torch.complex128: (1, 2, 4)}


# the rank-1 layout at dk = 1 (csrc/site_sweep_rank1.cuh): the types of G it
# is built for
RANK1_DTYPES = (torch.complex128,)


def rank1_layout(N: int, F: int, dk: int, dtype=torch.complex64):
    """The rank-1 layout where the plan takes it: dk = 1, N past 128,
    complex128, and a geometry that fits (``site_sweep_delayed.
    rank1_geometry`` at ``padded(N)``, a 16-byte unit per element); else
    None."""
    if dk != 1 or dtype not in RANK1_DTYPES or N < MIN_N:
        return None
    NP = padded(N)
    geometry = rank1_geometry(NP, F, cx=True)
    if geometry is None:
        return None
    cs, tr = geometry
    return Layout("rank1", cs, (tr,), rank1_smem(NP, F, cs, tr, cx=True))


# the flavor layout of complex128 at F = 2 (site_sweep_delayed_cx_flavors):
# its (column passes, row passes) in the order flavors_layout tries them
FLAVOR_PASSES = ((1, 1), (2, 1), (1, 2), (2, 2))


def flavors_smem(N: int, dk: int, p: int, r: int) -> int:
    """Shared memory of one block of the flavor layout in bytes (complex128,
    G of row length padded(N)): re and im planes of b over N/p columns and
    y over N/r rows, the staged tables, their entries at the slots' sites,
    the diagonal block, its diagonal and x; u, delta, the boson weight and
    the peer flavor's r per site; the slots' sites, their count and a flag
    per site; sigma (csrc/site_sweep_delayed_cx.cu::flavors_smem_bytes)."""
    N = padded(N)
    return (8 * (2 * dk * (N // p) + 2 * dk * (N // r) + 4 * dk * staged_ld(dk)
                 + 4 * dk * dk + 2 * dk * (dk + 1) + 4 * dk + 5 * N)
            + 4 * (dk + 4 + N) + N)


def flavors_layout(N: int, F: int, dk: int, dtype=torch.complex64):
    """The flavor layout where the plan takes it: complex128 at F = 2 past
    N = 128 wherever the delayed cluster layout would need two flavor
    stages (or fits not at all), in the first (P, R) of FLAVOR_PASSES with
    whole passes (2 | N/P, 4 | N/R, dk | N/R where R > 1) whose buffers fit
    one block's shared memory; else None."""
    if (dtype != torch.complex128 or F != 2 or N < MIN_N or dk < 1
            or N % dk or dk == 1):
        return None
    cs = cluster_plan(N, F, dk, dtype)
    if cs > 1 and plan(N, F, dk, cs, dtype)[1] == 1:
        return None
    NP = padded(N)
    for p, r in FLAVOR_PASSES:
        if (NP % p == 0 and (NP // p) % 2 == 0 and NP % r == 0
                and (NP // r) % 4 == 0 and (r == 1 or (NP // r) % dk == 0)
                and flavors_smem(N, dk, p, r) <= _build.SMEM_PER_BLOCK):
            return Layout("flavors", 2, (p, r), flavors_smem(N, dk, p, r))
    return None


def padded(N: int) -> int:
    """G's row length on the card: N where 8 | N, else N padded with zero
    rows and columns to a multiple of 8, which the sweep never visits."""
    return (N + 7) // 8 * 8


def _smem(N, F, dk, cs, el, passes, stages=1):
    N, fs = padded(N), F // stages
    if cs == 1:
        return el * (2 * F * dk * N + 2 * F * dk * (N + 1) + 4 * F * N)
    rq, nch = N // cs, N // passes
    return el * (2 * fs * dk * nch + 2 * fs * dk * rq
                 + 4 * F * dk * staged_ld(dk) + 4 * fs * dk * dk
                 + 2 * F * dk * (dk + 1) + 4 * F * dk + (F + 2) * N + dk + 4
                 + (N + 3) // 4)


def plan(N: int, F: int, dk: int, cs: int, dtype=torch.complex64):
    """The cluster layout's (P, S) at this shape: column passes P and flavor
    stages S (1, or F: the replays and folds one flavor at a time), the
    first whose buffers fit one block's shared memory with 4 P | padded(N),
    one stage before F stages and the fewest passes first; (1, 1) for the
    slab layout (cs = 1); None where none fits."""
    if cs == 1:
        return 1, 1
    el = dtype.itemsize // 2
    for stages in sorted({1, F}):
        for p in PASSES[dtype]:
            if (padded(N) % (4 * p) == 0
                    and _smem(N, F, dk, cs, el, p, stages)
                    <= _build.SMEM_PER_BLOCK):
                return p, stages
    return None


def smem_bytes(N: int, F: int, dk: int, cs: int = 1,
               dtype=torch.complex64) -> int:
    """Shared memory of one block of the delayed layouts in bytes, in real
    planes of dtype's precision at G's row length on the card
    (``padded(N)``): cs = 1 (site_sweep_delayed_cx_slab): the row and
    column slabs of every flavor as two planes (column rows padded to N+1)
    and the staged y and row vectors of one site, both planes. cs > 1
    (site_sweep_delayed_cx_cluster, in ``plan``'s P column passes and S
    flavor stages, or the most passes of PASSES[dtype] in F stages where
    none fits): re and im planes of b of every slot of a stage's flavors
    over N/P columns, y over the block's N/cs rows, the staged y and b of
    the block's sites by site (rows padded to staged_ld(dk)), their dk x dk
    entries at the slots' sites (a stage's flavors), the diagonal block
    (rows of dk + 1), its current diagonal and x; u, each site's delta and
    boson weight, the slots' sites and sigma, as
    csrc/site_sweep_delayed_cx.cu::cluster_smem_elems counts them. The
    rank-1 layout's is ``rank1_smem``, the flavor layout's
    ``flavors_smem``."""
    p, stages = plan(N, F, dk, cs, dtype) or (PASSES[dtype][-1], F)
    return _smem(N, F, dk, cs, dtype.itemsize // 2, p, stages)


def staged_ld(dk: int) -> int:
    """Row length of the kernel's staged tables: dk padded to 4-element
    loads, plus 4 elements, so that 8 rows' float4 loads fall in distinct
    banks."""
    return (dk + 3) // 4 * 4 + 4


def cluster_layout(N: int, F: int, dk: int, cs: int,
                   dtype=torch.complex64):
    """The delayed layout with cs blocks per chain where it takes this
    shape, else None: cs = 1 the slab layout, its block shared memory
    within the card's; cs > 1 the cluster layout, 4 cs | padded(N) (whole
    4-row tiles per block) in ``plan``'s column passes and flavor
    stages."""
    if cs == 1:
        smem = smem_bytes(N, F, dk, 1, dtype)
        return (Layout("slab", 1, (), smem)
                if smem <= _build.SMEM_PER_BLOCK else None)
    geometry = plan(N, F, dk, cs, dtype)
    if padded(N) % (4 * cs) or geometry is None:
        return None
    return Layout("cluster", cs, geometry, smem_bytes(N, F, dk, cs, dtype))


def fits(N: int, F: int, dk: int, cs: int, dtype=torch.complex64) -> bool:
    """Whether the delayed layout of cs blocks per chain (1: the slab
    layout) takes this shape (``cluster_layout``)."""
    return cluster_layout(N, F, dk, cs, dtype) is not None


def cluster_plan(N: int, F: int, dk: int, dtype=torch.complex64) -> int:
    """CS of the delayed layouts: the first of CLUSTER_SIZES that fits; 1,
    the one-block slab layout, where none does."""
    for cs in CLUSTER_SIZES:
        if fits(N, F, dk, cs, dtype):
            return cs
    return 1


def plan_layout(N: int, F: int, dk: int, dtype, chains: int):
    """The ``Layout`` the wrappers launch for chains chains at this shape:
    ``rank1_layout``'s where it takes the shape; where ``flavors_layout``
    does, the delayed layout in clusters of 4 if it fits, the chains'
    clusters run in one wave (chains <= CLUSTERS_AT_ONCE[4]) and the
    flavor layout needs two row passes, else the flavor layout; else the
    delayed layout of ``cluster_plan``'s CS; None where none fits. On an
    H100 (complex128 F = 2, dk = 32; chip_layouts.py, PERF.md) the
    clusters of 4 took 2.16-2.17 ms at N = 256 and 29-30 chains against
    the flavor layout's 2.31-2.32 (3.71-3.73 against 2.32-2.33 at 31),
    1.07-1.10 against 1.29-1.32 at N = 192, and 0.81-0.83 against
    0.79-0.82 at N = 160, where the flavor layout takes one row pass."""
    r1 = rank1_layout(N, F, dk, dtype)
    if r1 is not None:
        return r1
    flavors = flavors_layout(N, F, dk, dtype)
    if flavors is not None:
        four = cluster_layout(N, F, dk, 4, dtype)
        one_wave = (four is not None and chains <= CLUSTERS_AT_ONCE[4]
                    and flavors.geometry[1] > 1)
        return four if one_wave else flavors
    return cluster_layout(N, F, dk, cluster_plan(N, F, dk, dtype), dtype)


def layouts(N: int, F: int, dk: int, dtype, chains: int) -> list:
    """Every layout that takes this shape, the plan's for chains chains
    first (to time them against each other): the rank-1 or flavor layout
    where they take it, then the delayed layouts, clusters before the
    slab."""
    plan_ = plan_layout(N, F, dk, dtype, chains)
    others = [rank1_layout(N, F, dk, dtype), flavors_layout(N, F, dk, dtype),
              *(cluster_layout(N, F, dk, cs, dtype)
                for cs in (*CLUSTER_SIZES, 1))]
    return [plan_] * (plan_ is not None) + [
        lay for lay in others if lay is not None and lay != plan_]


def layout(N: int, F: int, dk: int, lay: Layout = None,
           dtype=torch.complex64, chains: int = None) -> str:
    """A layout in words: lay, or the plan's for chains chains at this
    shape."""
    lay = lay or plan_layout(N, F, dk, dtype, chains)
    pad = (f"G padded to {padded(N)} x {padded(N)}, "
           if padded(N) != N else "")
    if lay.kind == "flavors":
        p, r = lay.geometry
        return (f"{pad}flavors: cluster of 2 blocks of 512 threads per "
                f"chain, one flavor each, {r} row pass"
                f"{'es' if r > 1 else ''} and {p} column "
                f"pass{'es' if p > 1 else ''}, {lay.smem} bytes per block")
    if lay.kind == "rank1":
        NP = padded(N)
        return (f"{pad}rank-1: cluster of {lay.cs} blocks of "
                f"{lay.geometry[0] * NP} threads per chain, {NP // lay.cs} "
                f"rows each on chip ({rank1_regs(F)} rows a thread in "
                f"registers), {lay.smem} bytes per block")
    if lay.kind == "slab":
        return f"{pad}slab: one block of 512 threads per chain"
    p, stages = lay.geometry
    st = f", {stages} flavor stages" if stages > 1 else ""
    return (f"{pad}cluster of {lay.cs} blocks of 512 threads per chain, "
            f"{padded(N) // lay.cs} rows each, {p} column "
            f"pass{'es' if p > 1 else ''}{st}, {lay.smem} bytes per block")


def kernel_supports(N: int, F: int, dk: int, dtype=torch.complex64) -> bool:
    """Shapes the CUDA kernel takes, complex64 or complex128: N > 128 (G
    padded to a multiple of 8 where 8 does not divide N), F in {1, 2},
    dk | N, and the layout's buffers within one block's shared memory (at
    N = 256, dk = 32: complex64 F = 1 in one column pass, F = 2 in two;
    complex128 F = 1 in clusters of 2 blocks and two column passes, F = 2
    in the flavor layout), or the rank-1 layout's (complex128 at dk =
    1)."""
    if not (dtype in PASSES and N >= MIN_N and F in (1, 2)
            and 1 <= dk and N % dk == 0):
        return False
    return bool(rank1_layout(N, F, dk, dtype)
                or flavors_layout(N, F, dk, dtype)
                or cluster_layout(N, F, dk, cluster_plan(N, F, dk, dtype),
                                  dtype))


@functools.cache
def max_clusters(N: int, F: int, dk: int, lay: Layout,
                 dtype=torch.complex64) -> int:
    """The most clusters of lay (a cluster, the rank-1 or the flavor
    layout) that the card runs at once; 1 for the slab layout (one query
    per shape and process)."""
    if lay.kind == "slab":
        return 1
    out = ctypes.c_int(0)
    lib = _build.load()
    if lay.kind == "rank1":
        code = lib.site_sweep_delayed_cx_c128_rank1_max_clusters(
            F, padded(N), lay.cs, *lay.geometry, ctypes.addressof(out))
    elif lay.kind == "flavors":
        code = lib.site_sweep_delayed_cx_c128_flavors_max_clusters(
            padded(N), dk, *lay.geometry, ctypes.addressof(out))
    else:
        fn = (lib.site_sweep_delayed_cx_c128_max_clusters
              if dtype == torch.complex128
              else lib.site_sweep_delayed_cx_c64_max_clusters)
        code = fn(F, padded(N), dk, lay.cs, *lay.geometry,
                  ctypes.addressof(out))
    _build.check_launch("site_sweep_delayed_cx (occupancy query)", code)
    return out.value


def site_sweep_delayed_cx_plain(G, sigma, u, *, dk, lamb, signs, det_power,
                                use_boson):
    """Plain PyTorch delayed complex site sweep, batched over chains (any N
    with dk | N, complex64 or complex128 G).

    G: (C, F, N, N) complex, sigma: (C, N) int8 ±1, u: (C, N) uniforms in
    G's real dtype. Returns new (G, sigma, accept (C, N) bool, det (C, N)
    complex), as ``site_sweep_cx_plain``; the inputs are not modified."""
    C, F, N, _ = G.shape
    if N % dk:
        raise ValueError(f"site_sweep_delayed_cx: dk={dk} does not divide "
                         f"N={N}")
    Gr, Gi = G.real.clone(), G.imag.clone()
    sigma = sigma.clone()
    accept_all = torch.zeros(C, N, dtype=torch.bool, device=G.device)
    det_r, det_i = Gr.new_zeros(C, N), Gr.new_zeros(C, N)
    onehot = torch.zeros(N, dtype=Gr.dtype, device=G.device)
    for i0 in range(0, N, dk):
        sl = slice(i0, i0 + dk)
        Rr, Ri = Gr[:, :, sl, :].clone(), Gi[:, :, sl, :].clone()
        # column slab, Cs[s, r] = G[r, i0 + s]
        Cr = Gr[:, :, :, sl].transpose(-1, -2).clone()
        Ci = Gi[:, :, :, sl].transpose(-1, -2).clone()
        terms = []
        for t in range(dk):
            i = i0 + t
            dEb = sigma[:, i].to(Gr.dtype) * (-2.0 * lamb)
            deltas, rs, pr, pi = [], [], None, None
            for f, sg in enumerate(signs):
                delta = torch.exp(dEb * sg) - 1.0
                rr = 1.0 + delta * (1.0 - Rr[:, f, t, i])
                ri = -(delta * Ri[:, f, t, i])
                deltas.append(delta)
                rs.append((rr, ri))
                if pr is None:
                    pr, pi = rr, ri
                else:
                    pr, pi = pr * rr - pi * ri, pr * ri + pi * rr
            dre, dim = pr, pi
            if det_power == 2:
                dre, dim = pr * pr - pi * pi, 2.0 * pr * pi
            w = torch.exp(-dEb) if use_boson else 1.0
            accept = u[:, i] < w * dre
            det_r[:, i], det_i[:, i] = dre, dim
            accept_all[:, i] = accept
            onehot.zero_()
            onehot[i] = 1.0
            ys, rows = [], []
            for f in range(F):
                rr, ri = rs[f]
                inv = 1.0 / (rr * rr + ri * ri)
                xr = torch.where(accept, deltas[f] * rr * inv, 0.0)[:, None]
                xi = torch.where(accept, -(deltas[f] * ri * inv), 0.0)[:, None]
                igr = onehot - Cr[:, f, t, :]
                igi = -Ci[:, f, t, :]
                ys.append((xr * igr - xi * igi, xr * igi + xi * igr))
                rows.append((Rr[:, f, t, :], Ri[:, f, t, :]))
            # stacked copies, read before the slab updates below
            ar, ai = (torch.stack(v, dim=1) for v in zip(*ys))    # (C, F, N)
            br, bi = (torch.stack(v, dim=1) for v in zip(*rows))
            # R[s, n] -= y[i0 + s] row[n];  Cs[s, r] -= y[r] row[i0 + s]
            yr_s, yi_s = ar[:, :, sl, None], ai[:, :, sl, None]
            Rr -= yr_s * br[:, :, None, :] - yi_s * bi[:, :, None, :]
            Ri -= yr_s * bi[:, :, None, :] + yi_s * br[:, :, None, :]
            br_s, bi_s = br[:, :, sl, None], bi[:, :, sl, None]
            Cr -= ar[:, :, None, :] * br_s - ai[:, :, None, :] * bi_s
            Ci -= ar[:, :, None, :] * bi_s + ai[:, :, None, :] * br_s
            terms.append((ar, ai, br, bi))
            sigma[:, i] = torch.where(accept, -sigma[:, i], sigma[:, i])
        for ar, ai, br, bi in terms:
            yr, yi = ar[..., :, None], ai[..., :, None]
            Gr -= yr * br[..., None, :] - yi * bi[..., None, :]
            Gi -= yr * bi[..., None, :] + yi * br[..., None, :]
    return (torch.complex(Gr, Gi), sigma, accept_all,
            torch.complex(det_r, det_i))


def site_sweep_delayed_cx(G, sigma, u, *, dk, lamb, signs, det_power,
                          use_boson):
    """Delayed complex site sweep of one time slice for every chain: the
    complex64 CUDA kernel for a CUDA tensor, in the layout ``cluster_plan``
    picks, ``site_sweep_delayed_cx_plain`` for a CPU tensor. Same arguments
    and results as ``site_sweep_delayed_cx_plain``; on CUDA, G must be
    complex64 (C, F, N, N) with ``kernel_supports(N, F, dk)``, sigma int8
    (C, N) and u float32 (C, N), all contiguous on one device."""
    return _sweep(site_sweep_delayed_cx, torch.complex64, G, sigma, u, dk=dk,
                  lamb=lamb, signs=signs, det_power=det_power,
                  use_boson=use_boson)


def site_sweep_delayed_cx_c128(G, sigma, u, *, dk, lamb, signs, det_power,
                               use_boson):
    """``site_sweep_delayed_cx`` in complex128 (K9-c128): the complex128
    CUDA kernel for a CUDA tensor (G complex128, u float64,
    ``kernel_supports(N, F, dk, torch.complex128)``),
    ``site_sweep_delayed_cx_plain`` for a CPU tensor."""
    return _sweep(site_sweep_delayed_cx_c128, torch.complex128, G, sigma, u,
                  dk=dk, lamb=lamb, signs=signs, det_power=det_power,
                  use_boson=use_boson)


def _sweep(fn, dtype, G, sigma, u, **kw):
    if G.device.type == "cpu":
        return site_sweep_delayed_cx_plain(G, sigma, u, **kw)
    _check(G, sigma, u, kw["signs"], kw["dk"], kw["det_power"], dtype)
    C, F, N, _ = G.shape
    return launch(G, sigma, u, plan_layout(N, F, kw["dk"], dtype, C), **kw)


def launch(G, sigma, u, lay, *, dk, lamb, signs, det_power, use_boson):
    """One launch of the CUDA kernel of G's dtype in the ``Layout`` lay:
    ``plan_layout``'s, or another of ``layouts`` at this shape, to time two
    layouts against each other; on G padded to ``padded(N)`` where 8 does
    not divide N; counted in ``site_sweep_delayed_cx.launches``
    (complex64) or ``site_sweep_delayed_cx_c128.launches`` (complex128)."""
    c128 = G.dtype == torch.complex128
    C, F, N = _check(G, sigma, u, signs, dk, det_power, G.dtype)
    if lay not in layouts(N, F, dk, G.dtype, C):
        raise ValueError(
            f"site_sweep_delayed_cx: the layout {lay} does not take N={N}, "
            f"F={F}, dk={dk} in {str(G.dtype)[6:]}")
    NP = padded(N)
    if NP != N:
        Gp = G.new_zeros(C, F, NP, NP)
        Gp[:, :, :N, :N] = G
        G = Gp
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    accept = torch.empty(C, N, dtype=torch.bool, device=G.device)
    det = torch.empty(C, N, dtype=G.dtype, device=G.device)
    # slab layout: the accepted sites' y and row vectors of one block, re
    # and im planes
    scratch = (torch.empty(4, C, F, dk, NP, dtype=u.dtype, device=G.device)
               if lay.kind == "slab" else None)
    lib = _build.load()
    head = (G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), accept.data_ptr(),
            det.data_ptr())
    tail = (float(lamb), float(signs[0]), float(signs[-1]), int(det_power),
            int(bool(use_boson)), torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(G.device):
        if max_clusters(N, F, dk, lay, G.dtype) < 1:
            raise RuntimeError(
                f"site_sweep_delayed_cx: the card cannot run the layout's "
                f"clusters ({lay.smem} bytes of shared memory a block)")
        if lay.kind == "rank1":
            code = lib.site_sweep_delayed_cx_c128_rank1(
                *head, C, F, NP, N, lay.cs, *lay.geometry, *tail)
        elif lay.kind == "flavors":
            code = lib.site_sweep_delayed_cx_c128_flavors(
                *head, C, NP, N, dk, *lay.geometry, *tail)
        else:
            fn = (lib.site_sweep_delayed_cx_c128 if c128
                  else lib.site_sweep_delayed_cx_c64)
            code = fn(*head, 0 if scratch is None else scratch.data_ptr(), C,
                      F, NP, N, int(dk), lay.cs, *(lay.geometry or (1, 1)),
                      *tail)
    fn = site_sweep_delayed_cx_c128 if c128 else site_sweep_delayed_cx
    _build.check_launch(fn.__name__, code)
    fn.launches += 1
    if NP != N:
        G_out = G_out[:, :, :N, :N].contiguous()
    return G_out, sigma_out, accept, det


site_sweep_delayed_cx.launches = 0
site_sweep_delayed_cx_c128.launches = 0


def _check(G, sigma, u, signs, dk, det_power, dtype):
    name = ("site_sweep_delayed_cx_c128" if dtype == torch.complex128
            else "site_sweep_delayed_cx")
    rd = {torch.complex64: torch.float32, torch.complex128: torch.float64}
    if G.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {G.device}")
    if dtype not in rd or G.dtype != dtype or u.dtype != rd[dtype]:
        raise ValueError(f"{name}: the CUDA kernel takes {str(dtype)[6:]} G "
                         f"and {str(rd.get(dtype))[6:]} u")
    if sigma.dtype != torch.int8:
        raise ValueError(f"{name}: sigma must be int8")
    if G.dim() != 4 or G.shape[2] != G.shape[3]:
        raise ValueError(f"{name}: G must be (C, F, N, N), got {tuple(G.shape)}")
    C, F, N, _ = G.shape
    if (not kernel_supports(N, F, dk, dtype) or len(signs) != F
            or det_power not in (1, 2)):
        raise ValueError(f"{name}: no CUDA kernel for N={N}, F={F}, dk={dk} "
                         f"(N >= {MIN_N}, F in (1, 2), dk | N, "
                         f"{smem_bytes(N, F, dk, 1, dtype)} of "
                         f"{_build.SMEM_PER_BLOCK} bytes of shared memory in "
                         "the slab layout; det_power 1 or 2)")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError(f"{name}: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one device")
    return C, F, N
