"""Delayed site-major Metropolis sweep over one time slice, for N > 128
(kernel K6).

``site_sweep_delayed`` launches the CUDA kernel ``csrc/site_sweep_delayed.cu``
on CUDA tensors; on CPU tensors it runs ``site_sweep_delayed_plain``, the
plain PyTorch version of the same algorithm with the same op order. It
replaces the Pallas kernels
``montecarlo_tpu/ops/pallas_site_sweep.py::_sitemajor_delayed_kernel``
(reached through ``_site_sweep_sitemajor_delayed``) and, at dk = 1, its
per-site fallback ``::_sitemajor_kernel`` (``_site_sweep_sitemajor``).

The sites are taken in blocks of dk. For the block i0..i0+dk-1 the row slab
R = G[i0:i0+dk, :] and the column slab C[s, :] = G[:, i0+s] are kept exactly
updated through the dk sequential decisions; each decision is K1's
(``ops/site_sweep.py``) read from the slabs. An accepted site i contributes
the rank-1 term a ⊗ b with a = x·(e_i - G[:, i]), b = G[i, :] (x = delta / r),
which is folded into the slabs at once and into G once per block:
G -= a_0 ⊗ b_0, G -= a_1 ⊗ b_1, ... in slot order, each product rounded and
then subtracted. A rejected site's term is zero and changes nothing. The
Markov chain is the rank-1 sweep's; G is the rank-1 sweep's up to rounding.

On the card, ``plan_layout`` picks the kernel's layout (a ``Layout``) from
the shape: one thread-block cluster of CS = 2 or 4 blocks per chain, each
block folding N/CS rows of G (``cluster_plan``'s CS), or, where the
cluster's buffers do not fit, one block per chain with the slabs above. At
dk = 1 in float64 it picks the rank-1 layout (``rank1_layout``,
``csrc/site_sweep_rank1.cuh``) wherever that fits: G on chip for the whole
launch, a cluster of CS blocks per chain, one cluster barrier per site.

``site_sweep_delayed_f64`` is the same kernel in float64 (K6-f64): it
replaces the XLA loops the JAX package runs for float64 updates past
N = 128 (``montecarlo_tpu/dqmc/core.py::sweep_slice_delayed``, and at dk = 1
the rank-1 loop of ``sweep_slice``), which have no TPU kernel, and it
returns the negative detratios' log10 magnitudes as those loops record
them (``site_sweep.neg_push``). Its buffers take twice the bytes, so its
cluster layout may form the b vectors in ``column_passes`` passes over
N/P columns each.

The kernel's 4 x 4 register tiles take 4 | N. Where 4 does not divide N
(13 x 13, 15 x 15, rings of 130 or 150 sites) the wrappers pad G with zero
rows and columns to ``padded(N)``, a multiple of 8, and the kernel visits
the N lattice sites only; the pad's entries stay 0 and never enter a real
one, so the result is the plain version's on the unpadded G. Filling the
padded copy, copying G into it and slicing the result back move G three
more times besides the kernel's own traffic.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .site_sweep import MAX_N, empty_neg, neg_push

MIN_N = MAX_N + 1        # K1 (ops/site_sweep.py) takes N <= 128
# the cluster sizes (blocks per chain) in the order cluster_plan tries
# them: clusters of 2 blocks of up to ~150 KB of shared memory run 66 at
# once on an H100, clusters of 4 only 30
CLUSTER_SIZES = (2, 4)
# the phases that a build with -DMC_PHASE_STAMPS times (chip_profile.py),
# per kernel of csrc/site_sweep_delayed.cu
PHASES = {"slab": ("slab load", "decisions", "staging and slab update",
                   "fold"),
          "cluster": ("setup and copy", "cluster barriers", "diagonal block",
                      "decisions", "a and b vectors", "fold"),
          # csrc/site_sweep_rank1.cuh (float64, dk = 1)
          "rank1": ("load and store", "signal wait", "decision",
                    "next row and column", "fold of the rest")}


# the column passes of the cluster layout, in the order column_passes tries
# them, per element type: the float32 kernel keeps one pass (its layout as
# measured), float64 buffers take twice the bytes
PASSES = {torch.float32: (1,), torch.float64: (1, 2, 4)}


# the rank-1 layout at dk = 1 (csrc/site_sweep_rank1.cuh): the element types
# it is built for, its cluster sizes per F in the order rank1_geometry tries
# them (F = 2: clusters of 4, and of 8 where 4 do not hold G, as complex128
# past N = 192), and its most threads a block
RANK1_DTYPES = (torch.float64,)
RANK1_SIZES = {1: (2, 4), 2: (4, 8)}
RANK1_MAX_THREADS = 512


def rank1_regs(F: int) -> int:
    """Rows of G per flavor that a thread of the rank-1 layout keeps in
    registers (csrc/site_sweep_rank1.cuh::reg_rows)."""
    return 16 // F


def rank1_smem(NP: int, F: int, cs: int, tr: int, cx: bool = False,
               kr: int = None) -> int:
    """Shared memory of one block of the rank-1 layout in bytes, G of row
    length NP in clusters of cs blocks of tr thread rows: the rows of G
    beyond the kr register rows (default ``rank1_regs(F)``), the row double
    buffer, the column and coefficient double buffers (16-byte units: two
    real columns or one complex128 element), u and sigma, and in float64
    each site's detratio and new sigma (csrc/site_sweep_rank1.cuh::
    smem_bytes)."""
    rq, ur = NP // cs, (NP if cx else NP // 2)
    rs = max(rq // tr - (rank1_regs(F) if kr is None else kr), 0)
    return (16 * (F * rs * tr * ur + 2 * F * ur + 4 * F * rq)
            + (9 if cx else 18) * NP)


def rank1_geometry(NP: int, F: int, cx: bool = False):
    """(cs, tr) of the rank-1 layout for G of row length NP: the first of
    RANK1_SIZES[F], and in it the most thread rows tr (tr | NP / cs), whose
    blocks of tr x (units a row) threads hold at least rank1_regs(F) rows
    each and fit one block's shared memory (rank1_smem) with at most
    RANK1_MAX_THREADS threads; None where none does."""
    ur = NP if cx else NP // 2
    if F not in (1, 2) or (not cx and NP % 2):
        return None
    for cs in RANK1_SIZES[F]:
        if NP % cs:
            continue
        rq, best = NP // cs, None
        for tr in range(1, rq + 1):
            if (rq % tr == 0 and tr * ur <= RANK1_MAX_THREADS
                    and rq // tr >= rank1_regs(F)
                    and rank1_smem(NP, F, cs, tr, cx)
                    <= _build.SMEM_PER_BLOCK):
                best = tr
        if best is not None:
            return cs, best
    return None


class Layout(NamedTuple):
    """One layout of K6 or K9 at one shape (``plan_layout``, ``layouts``):
    its kind ("rank1", "flavors", "cluster" or "slab"), the blocks per chain
    CS, the kind's geometry (rank1: the thread rows (TR,); flavors: the
    column and row passes (P, R); cluster: the column passes (P,), in K9
    (P, S) with the flavor stages S; slab: ()) and the shared memory of one
    block in bytes."""
    kind: str
    cs: int
    geometry: tuple
    smem: int


def rank1_layout(N: int, F: int, dk: int, dtype=torch.float32):
    """The rank-1 layout where the plan takes it: dk = 1, N past 128,
    float64, and a geometry that fits (``rank1_geometry`` at
    ``padded(N)``); else None."""
    if dk != 1 or dtype not in RANK1_DTYPES or N < MIN_N:
        return None
    NP = padded(N)
    geometry = rank1_geometry(NP, F)
    if geometry is None:
        return None
    cs, tr = geometry
    return Layout("rank1", cs, (tr,), rank1_smem(NP, F, cs, tr))


def padded(N: int) -> int:
    """G's row length on the card: N where 4 | N, else N padded with zero
    rows and columns to a multiple of 8 (whole 4-row tiles in each block of
    a cluster of 2)."""
    return N if N % 4 == 0 else (N + 7) // 8 * 8


def _smem(N, F, dk, cs, el, passes):
    N = padded(N)
    if cs == 1:
        return el * (2 * F * dk * N + F * dk + 2 * F * N)
    rq, nch = N // cs, N // passes
    return el * (F * dk * nch + F * dk * rq
                 + 2 * F * dk * staged_ld(dk) + 2 * F * dk * dk
                 + F * dk * (dk + 1) + 2 * F * dk + (F + 2) * N + dk + 4
                 + (N + 3) // 4)


def column_passes(N: int, F: int, dk: int, cs: int,
                  dtype=torch.float32):
    """The cluster layout's column passes P at this shape: the fewest of
    PASSES[dtype] with 4 P | padded(N) whose buffers fit one block's shared
    memory (1 for the slab layout, cs = 1); None where none does."""
    if cs == 1:
        return 1
    for p in PASSES[dtype]:
        if (padded(N) % (4 * p) == 0
                and _smem(N, F, dk, cs, dtype.itemsize, p)
                <= _build.SMEM_PER_BLOCK):
            return p
    return None


def smem_bytes(N: int, F: int, dk: int, cs: int = 1,
               dtype=torch.float32) -> int:
    """Shared memory of one block of the delayed layouts in bytes, in
    elements of dtype at G's row length on the card (``padded(N)``): cs = 1
    (site_sweep_delayed_slab): the row and column slabs of every flavor and
    the staged a, b vectors of one site. cs > 1 (site_sweep_delayed_cluster,
    in ``column_passes`` passes P, or the most of PASSES[dtype] where none
    fits): b of every slot over N/P columns, a over the block's N/cs rows,
    the staged a and b of the block's sites by site (rows padded to
    staged_ld(dk)), their dk x dk entries at the slots' sites, the diagonal
    block (rows of dk + 1) and its current diagonal, x, u, each site's delta
    and boson weight, the slots' sites and sigma, as
    csrc/site_sweep_delayed.cu::cluster_smem_elems counts them. The rank-1
    layout's is ``rank1_smem``."""
    p = column_passes(N, F, dk, cs, dtype) or PASSES[dtype][-1]
    return _smem(N, F, dk, cs, dtype.itemsize, p)


def staged_ld(dk: int) -> int:
    """Row length of the kernel's staged tables: dk padded to 4-element
    loads, plus 4 elements, so that 8 rows' float4 loads fall in distinct
    banks."""
    return (dk + 3) // 4 * 4 + 4


def cluster_layout(N: int, F: int, dk: int, cs: int,
                   dtype=torch.float32):
    """The delayed layout with cs blocks per chain where it takes this
    shape, else None: cs = 1 the slab layout, its block shared memory within
    the card's; cs > 1 the cluster layout, 4 cs | padded(N) (whole 4-row
    tiles per block) in ``column_passes`` passes."""
    if cs == 1:
        smem = smem_bytes(N, F, dk, 1, dtype)
        return (Layout("slab", 1, (), smem)
                if smem <= _build.SMEM_PER_BLOCK else None)
    p = column_passes(N, F, dk, cs, dtype)
    if padded(N) % (4 * cs) or p is None:
        return None
    return Layout("cluster", cs, (p,), smem_bytes(N, F, dk, cs, dtype))


def fits(N: int, F: int, dk: int, cs: int, dtype=torch.float32) -> bool:
    """Whether the delayed layout of cs blocks per chain (1: the slab
    layout) takes this shape (``cluster_layout``)."""
    return cluster_layout(N, F, dk, cs, dtype) is not None


def cluster_plan(N: int, F: int, dk: int, dtype=torch.float32) -> int:
    """CS of the delayed layouts: the first of CLUSTER_SIZES that fits; 1,
    the one-block slab layout, where none does."""
    for cs in CLUSTER_SIZES:
        if fits(N, F, dk, cs, dtype):
            return cs
    return 1


def plan_layout(N: int, F: int, dk: int, dtype=torch.float32,
                chains: int = None):
    """The ``Layout`` the wrappers launch at this shape: ``rank1_layout``'s
    where it takes the shape, else the delayed layout of ``cluster_plan``'s
    CS; None where none fits. K6's choice is the same at every chain count
    (chains; K9's is not: ``site_sweep_delayed_cx.plan_layout``)."""
    return (rank1_layout(N, F, dk, dtype)
            or cluster_layout(N, F, dk, cluster_plan(N, F, dk, dtype), dtype))


def layouts(N: int, F: int, dk: int, dtype=torch.float32,
            chains: int = None) -> list:
    """Every layout that takes this shape, the plan's first (to time them
    against each other): the rank-1 layout where the plan takes it, then the
    delayed layouts, clusters before the slab (at every chain count)."""
    plan = plan_layout(N, F, dk, dtype)
    others = [cluster_layout(N, F, dk, cs, dtype)
              for cs in (*CLUSTER_SIZES, 1)]
    return [plan] * (plan is not None) + [
        lay for lay in others if lay is not None and lay != plan]


def layout(N: int, F: int, dk: int, lay: Layout = None,
           dtype=torch.float32, chains: int = None) -> str:
    """A layout in words: lay, or the plan's at this shape."""
    lay = lay or plan_layout(N, F, dk, dtype)
    pad = (f"G padded to {padded(N)} x {padded(N)}, "
           if padded(N) != N else "")
    if lay.kind == "rank1":
        NP = padded(N)
        return (f"{pad}rank-1: cluster of {lay.cs} blocks of "
                f"{lay.geometry[0] * NP // 2} threads per chain, "
                f"{NP // lay.cs} rows each on chip ({rank1_regs(F)} rows a "
                f"thread in registers), {lay.smem} bytes per block")
    if lay.kind == "slab":
        return f"{pad}slab: one block of 512 threads per chain"
    p = lay.geometry[0]
    return (f"{pad}cluster of {lay.cs} blocks of 512 threads per chain, "
            f"{padded(N) // lay.cs} rows each, {p} column "
            f"pass{'es' if p > 1 else ''}, {lay.smem} bytes per block")


def kernel_supports(N: int, F: int, dk: int, dtype=torch.float32) -> bool:
    """Shapes the CUDA kernel takes, float32 or float64: N > 128 (G
    padded to a multiple of 8 where 4 does not divide N: the fold's 4 x 4
    register tiles), F in {1, 2}, dk | N, and the layout's buffers within
    one block's shared memory (float64 at N = 256, dk = 32: clusters of 2
    blocks, F = 2 in two column passes), or the rank-1 layout's (float64
    at dk = 1)."""
    if not (dtype in PASSES and N >= MIN_N and F in (1, 2)
            and 1 <= dk and N % dk == 0):
        return False
    return plan_layout(N, F, dk, dtype) is not None


@functools.cache
def max_clusters(N: int, F: int, dk: int, lay: Layout,
                 dtype=torch.float32) -> int:
    """The most clusters of lay (a cluster or the rank-1 layout) that the
    card runs at once; 1 for the slab layout (one query per shape and
    process)."""
    if lay.kind == "slab":
        return 1
    out = ctypes.c_int(0)
    lib = _build.load()
    if lay.kind == "rank1":
        code = lib.site_sweep_delayed_f64_rank1_max_clusters(
            F, padded(N), lay.cs, *lay.geometry, ctypes.addressof(out))
    elif dtype == torch.float64:
        code = lib.site_sweep_delayed_f64_max_clusters(
            F, padded(N), dk, lay.cs, *lay.geometry, ctypes.addressof(out))
    else:
        code = lib.site_sweep_delayed_f32_max_clusters(
            F, padded(N), dk, lay.cs, ctypes.addressof(out))
    _build.check_launch("site_sweep_delayed (occupancy query)", code)
    return out.value


def site_sweep_delayed_plain(G, sigma, u, *, dk, lamb, signs, det_power,
                             use_boson):
    """Plain PyTorch delayed site sweep, batched over chains (any N with
    dk | N, any float type).

    G: (C, F, N, N), sigma: (C, N) int8 ±1, u: (C, N) uniforms in G's dtype.
    Returns new (G, sigma, acc (C,) int32, nneg (C,) int32, neg (C, 3)):
    neg holds the negative-weight statistics in G's dtype (``neg_push``);
    the inputs are not modified."""
    C, F, N, _ = G.shape
    if N % dk:
        raise ValueError(f"site_sweep_delayed: dk={dk} does not divide N={N}")
    G = G.clone()
    sigma = sigma.clone()
    acc = torch.zeros(C, dtype=torch.int32, device=G.device)
    nneg = torch.zeros(C, dtype=torch.int32, device=G.device)
    neg = empty_neg(C, G.dtype, G.device)
    for i0 in range(0, N, dk):
        R = G[:, :, i0:i0 + dk, :].clone()                 # (C, F, dk, N)
        Cs = G[:, :, :, i0:i0 + dk].transpose(-1, -2).clone()
        A, B = [], []
        for t in range(dk):
            i = i0 + t
            s = sigma[:, i].to(G.dtype)
            dEb = s * (-2.0 * lamb)
            deltas, rs, rprod = [], [], None
            for f, sg in enumerate(signs):
                delta = torch.exp(dEb * sg) - 1.0
                r = 1.0 + delta * (1.0 - R[:, f, t, i])
                deltas.append(delta)
                rs.append(r)
                rprod = r if rprod is None else rprod * r
            detratio = rprod
            for _ in range(det_power - 1):
                detratio = detratio * rprod
            w = torch.exp(-dEb) if use_boson else 1.0
            accept = u[:, i] < w * detratio
            x = torch.stack([torch.where(accept, deltas[f] / rs[f], 0.0)
                             for f in range(F)], dim=1)    # (C, F)
            a = -Cs[:, :, t, :]
            a[:, :, i] += 1.0
            a = x[:, :, None] * a                          # (C, F, N) over r
            b = R[:, :, t, :].clone()                      # (C, F, N) over n
            R -= a[:, :, i0:i0 + dk, None] * b[:, :, None, :]
            Cs -= b[:, :, i0:i0 + dk, None] * a[:, :, None, :]
            A.append(a)
            B.append(b)
            sigma[:, i] = torch.where(accept, -sigma[:, i], sigma[:, i])
            acc += accept
            nneg += detratio < 0
            neg = neg_push(neg, detratio)
        for a, b in zip(A, B):
            G -= a[:, :, :, None] * b[:, :, None, :]
    return G, sigma, acc, nneg, neg


def site_sweep_delayed(G, sigma, u, *, dk, lamb, signs, det_power, use_boson):
    """Delayed site sweep of one time slice for every chain: the float32
    CUDA kernel for a CUDA tensor, in the layout ``cluster_plan`` picks,
    ``site_sweep_delayed_plain`` for a CPU tensor. Same arguments and
    results as ``site_sweep_delayed_plain``, but neg is None (the float32
    kernel counts the negative weights only); on CUDA, G must be float32
    (C, F, N, N)
    with ``kernel_supports(N, F, dk)``, sigma int8 (C, N) and u float32
    (C, N), all contiguous on one device."""
    kw = dict(dk=dk, lamb=lamb, signs=signs, det_power=det_power,
              use_boson=use_boson)
    if G.device.type == "cpu":
        return (*site_sweep_delayed_plain(G, sigma, u, **kw)[:4], None)
    _check(G, sigma, u, signs, dk, torch.float32)
    C, F, N, _ = G.shape
    return launch(G, sigma, u, plan_layout(N, F, dk), **kw)


def site_sweep_delayed_f64(G, sigma, u, *, dk, lamb, signs, det_power,
                           use_boson):
    """``site_sweep_delayed`` in float64 (K6-f64): the float64 CUDA kernel
    for a CUDA tensor (G and u float64, ``kernel_supports(N, F, dk,
    torch.float64)``), ``site_sweep_delayed_plain`` for a CPU tensor. Both
    also return the negative-weight statistics (C, 3) float64 as neg."""
    kw = dict(dk=dk, lamb=lamb, signs=signs, det_power=det_power,
              use_boson=use_boson)
    if G.device.type == "cpu":
        return site_sweep_delayed_plain(G, sigma, u, **kw)
    _check(G, sigma, u, signs, dk, torch.float64)
    C, F, N, _ = G.shape
    return launch(G, sigma, u, plan_layout(N, F, dk, torch.float64), **kw)


def launch(G, sigma, u, lay, *, dk, lamb, signs, det_power, use_boson):
    """One launch of the CUDA kernel of G's dtype in the ``Layout`` lay:
    ``plan_layout``'s, or another of ``layouts`` at this shape, to time
    two layouts against each other; on G padded to ``padded(N)`` where 4
    does not divide N; counted in the launches of ``site_sweep_delayed`` or
    ``site_sweep_delayed_f64``. Returns (G, sigma, acc, nneg, neg), neg
    None in float32."""
    f64 = G.dtype == torch.float64
    C, F, N = _check(G, sigma, u, signs, dk, G.dtype)
    if lay not in layouts(N, F, dk, G.dtype):
        raise ValueError(
            f"site_sweep_delayed: the layout {lay} does not take N={N}, "
            f"F={F}, dk={dk} in {str(G.dtype)[6:]}")
    NP = padded(N)
    if NP != N:
        Gp = G.new_zeros(C, F, NP, NP)
        Gp[:, :, :N, :N] = G
        G = Gp
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    acc = torch.empty(C, dtype=torch.int32, device=G.device)
    nneg = torch.empty(C, dtype=torch.int32, device=G.device)
    neg = torch.empty(C, 3, dtype=G.dtype, device=G.device) if f64 else None
    # slab layout: the accepted sites' a and b vectors of one block, per
    # chain and flavor
    scratch = (torch.empty(2, C, F, dk, NP, dtype=G.dtype, device=G.device)
               if lay.kind == "slab" else None)
    lib = _build.load()
    head = (G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), acc.data_ptr(),
            nneg.data_ptr())
    tail = (float(lamb), float(signs[0]), float(signs[-1]), int(det_power),
            int(bool(use_boson)), torch.cuda.current_stream().cuda_stream)
    scr = 0 if scratch is None else scratch.data_ptr()
    with torch.cuda.device(G.device):
        if max_clusters(N, F, dk, lay, G.dtype) < 1:
            raise RuntimeError(
                f"site_sweep_delayed: the card cannot run a cluster of "
                f"{lay.cs} blocks with {lay.smem} bytes of shared memory "
                "each")
        if lay.kind == "rank1":
            code = lib.site_sweep_delayed_f64_rank1(
                *head, neg.data_ptr(), C, F, NP, N, lay.cs, *lay.geometry,
                *tail)
        elif f64:
            code = lib.site_sweep_delayed_f64(
                *head, neg.data_ptr(), scr, C, F, NP, N, int(dk), lay.cs,
                *(lay.geometry or (1,)), *tail)
        else:
            code = lib.site_sweep_delayed_f32(*head, scr, C, F, NP, N,
                                              int(dk), lay.cs, *tail)
    wrapper = site_sweep_delayed_f64 if f64 else site_sweep_delayed
    _build.check_launch(wrapper.__name__, code)
    wrapper.launches += 1
    if NP != N:
        G_out = G_out[:, :, :N, :N].contiguous()
    return G_out, sigma_out, acc, nneg, neg


site_sweep_delayed.launches = 0
site_sweep_delayed_f64.launches = 0


def _check(G, sigma, u, signs, dk, dtype):
    name = ("site_sweep_delayed_f64" if dtype == torch.float64
            else "site_sweep_delayed")
    if G.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {G.device}")
    if dtype not in PASSES or G.dtype != dtype or u.dtype != dtype:
        raise ValueError(f"{name}: the CUDA kernel takes {str(dtype)[6:]} G "
                         "and u")
    if sigma.dtype != torch.int8:
        raise ValueError(f"{name}: sigma must be int8")
    if G.dim() != 4 or G.shape[2] != G.shape[3]:
        raise ValueError(f"{name}: G must be (C, F, N, N), got {tuple(G.shape)}")
    C, F, N, _ = G.shape
    if not kernel_supports(N, F, dk, dtype) or len(signs) != F:
        raise ValueError(f"{name}: no CUDA kernel for N={N}, F={F}, dk={dk} "
                         f"(N >= {MIN_N}, F in (1, 2), dk | N, "
                         f"{smem_bytes(N, F, dk, 1, dtype)} of "
                         f"{_build.SMEM_PER_BLOCK} bytes of shared memory in "
                         "the slab layout)")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError(f"{name}: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one device")
    return C, F, N
