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

On the card, ``cluster_plan`` picks the kernel's layout from the shape: one
thread-block cluster of CS = 2 or 4 blocks per chain, each block folding N/CS
rows of G, or, where the cluster's buffers do not fit, one block per chain
with the slabs above.

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
                      "decisions", "a and b vectors", "fold")}


# the column passes of the cluster layout, in the order column_passes tries
# them, per element type: the float32 kernel keeps one pass (its layout as
# measured), float64 buffers take twice the bytes
PASSES = {torch.float32: (1,), torch.float64: (1, 2, 4)}


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
    """Shared memory of one block, elements of dtype, at G's row length
    on the card (``padded(N)``). cs = 1
    (site_sweep_delayed_slab): the row and column slabs of every flavor and
    the staged a, b vectors of one site. cs > 1 (site_sweep_delayed_cluster,
    in ``column_passes`` passes P, or the most of PASSES[dtype] where none
    fits): b of every slot over N/P columns, a over the block's N/cs rows,
    the staged a and b of the block's sites by site (rows padded to
    staged_ld(dk)), their dk x dk entries at the slots' sites, the diagonal
    block (rows of dk + 1) and its current diagonal, x, u, each site's delta
    and boson weight, the slots' sites and sigma, as
    csrc/site_sweep_delayed.cu::cluster_smem_elems counts them."""
    p = column_passes(N, F, dk, cs, dtype) or PASSES[dtype][-1]
    return _smem(N, F, dk, cs, dtype.itemsize, p)


def staged_ld(dk: int) -> int:
    """Row length of the kernel's staged tables: dk padded to 4-element
    loads, plus 4 elements, so that 8 rows' float4 loads fall in distinct
    banks."""
    return (dk + 3) // 4 * 4 + 4


def fits(N: int, F: int, dk: int, cs: int, dtype=torch.float32) -> bool:
    """Whether the layout of cs blocks per chain (1: the slab layout) takes
    this shape: its block shared memory within the card's (in some column
    passes), and for a cluster 4 * cs | padded(N) (whole 4-row tiles per
    block)."""
    if cs == 1:
        return smem_bytes(N, F, dk, 1, dtype) <= _build.SMEM_PER_BLOCK
    return (padded(N) % (4 * cs) == 0
            and column_passes(N, F, dk, cs, dtype) is not None)


def cluster_plan(N: int, F: int, dk: int, dtype=torch.float32) -> int:
    """CS, the blocks per chain: the first of CLUSTER_SIZES that fits; 1,
    the one-block slab layout, where none does."""
    for cs in CLUSTER_SIZES:
        if fits(N, F, dk, cs, dtype):
            return cs
    return 1


def layout(N: int, F: int, dk: int, cs: int = None,
           dtype=torch.float32) -> str:
    """The kernel's layout at this shape (or with cs blocks), in words."""
    cs = cs or cluster_plan(N, F, dk, dtype)
    pad = (f"G padded to {padded(N)} x {padded(N)}, "
           if padded(N) != N else "")
    if cs == 1:
        return f"{pad}slab: one block of 512 threads per chain"
    p = column_passes(N, F, dk, cs, dtype)
    return (f"{pad}cluster of {cs} blocks of 512 threads per chain, "
            f"{padded(N) // cs} rows each, {p} column "
            f"pass{'es' if p > 1 else ''}, "
            f"{smem_bytes(N, F, dk, cs, dtype)} bytes per block")


def kernel_supports(N: int, F: int, dk: int, dtype=torch.float32) -> bool:
    """Shapes the CUDA kernel takes, float32 or float64: N > 128 (G
    padded to a multiple of 8 where 4 does not divide N: the fold's 4 x 4
    register tiles), F in {1, 2}, dk | N, and the layout's buffers within
    one block's shared memory (float64 at N = 256, dk = 32: clusters of 2
    blocks, F = 2 in two column passes)."""
    return (dtype in PASSES and N >= MIN_N and F in (1, 2)
            and 1 <= dk and N % dk == 0
            and fits(N, F, dk, cluster_plan(N, F, dk, dtype), dtype))


@functools.cache
def max_clusters(F: int, N: int, dk: int, cs: int,
                 dtype=torch.float32) -> int:
    """The most clusters of cs blocks the card runs at once (one query per
    shape and process)."""
    out = ctypes.c_int(0)
    lib = _build.load()
    if dtype == torch.float64:
        code = lib.site_sweep_delayed_f64_max_clusters(
            F, padded(N), dk, cs, column_passes(N, F, dk, cs, dtype),
            ctypes.addressof(out))
    else:
        code = lib.site_sweep_delayed_f32_max_clusters(
            F, padded(N), dk, cs, ctypes.addressof(out))
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
    return launch(G, sigma, u, cluster_plan(N, F, dk), **kw)


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
    return launch(G, sigma, u, cluster_plan(N, F, dk, torch.float64), **kw)


def launch(G, sigma, u, cs, *, dk, lamb, signs, det_power, use_boson):
    """One launch of the CUDA kernel of G's dtype with cs blocks per chain
    (``cluster_plan``'s, or another that fits, to time two layouts against
    each other), in ``column_passes`` passes, on G padded to ``padded(N)``
    where 4 does not divide N; counted in the launches of
    ``site_sweep_delayed`` or ``site_sweep_delayed_f64``. Returns (G, sigma,
    acc, nneg, neg), neg None in float32."""
    f64 = G.dtype == torch.float64
    C, F, N = _check(G, sigma, u, signs, dk, G.dtype)
    if not fits(N, F, dk, cs, G.dtype):
        raise ValueError(
            f"site_sweep_delayed: {cs} blocks per chain do not take "
            f"N={N}, F={F}, dk={dk} in {str(G.dtype)[6:]} "
            f"({smem_bytes(N, F, dk, cs, G.dtype)} bytes of shared memory "
            "per block)")
    passes = column_passes(N, F, dk, cs, G.dtype)
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
               if cs == 1 else None)
    lib = _build.load()
    head = (G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), acc.data_ptr(),
            nneg.data_ptr())
    tail = (float(lamb), float(signs[0]), float(signs[-1]), int(det_power),
            int(bool(use_boson)), torch.cuda.current_stream().cuda_stream)
    scr = 0 if scratch is None else scratch.data_ptr()
    with torch.cuda.device(G.device):
        if cs > 1 and max_clusters(F, N, dk, cs, G.dtype) < 1:
            raise RuntimeError(
                f"site_sweep_delayed: the card cannot run a cluster of {cs} "
                f"blocks with {smem_bytes(N, F, dk, cs, G.dtype)} bytes of "
                "shared memory each")
        if f64:
            code = lib.site_sweep_delayed_f64(
                *head, neg.data_ptr(), scr, C, F, NP, N, int(dk), cs, passes,
                *tail)
        else:
            code = lib.site_sweep_delayed_f32(*head, scr, C, F, NP, N,
                                              int(dk), cs, *tail)
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
