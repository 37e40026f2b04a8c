"""Sequential Metropolis site sweep over one time slice for a complex
Green's function (kernel K8: complex hopping, e.g. Peierls phases).

``site_sweep_cx`` launches the CUDA kernel ``csrc/site_sweep_cx.cu`` (its
loop in ``csrc/site_sweep_tiled.cuh``, shared with K1 in float32) on CUDA
tensors; on CPU tensors it runs ``site_sweep_cx_plain``, the plain PyTorch
version of the same algorithm with the same op order. It replaces the Pallas
kernel ``montecarlo_tpu/ops/pallas_site_sweep.py::_cx_kernel`` (reached
through ``_site_sweep_batched_cx``).

Per chain and site i in order (sigma_i = ±1, f over flavor blocks; delta
real, r and det complex):
  delta_f = exp(sign_f * dEb) - 1,  dEb = -2 * lamb * sigma_i
  r_f     = 1 + delta_f * (1 - G_f[i, i])
  det     = (prod_f r_f) ** det_power,   det_power in {1, 2}
  accept  = u_i < exp(-dEb)**use_boson * Re(det)
  on accept: G_f -= x_f * (e_i - G_f[:, i]) ⊗ G_f[i, :], flip sigma_i,
             with x_f = delta_f * conj(r_f) / |r_f|^2
The weight is the real part, as in the JAX package; each site's accept
flag and det are returned for the phase-problem statistics
(``dqmc.core._track_detratio_batch``). The complex arithmetic is written
out on the real and imaginary planes in the Pallas kernel's op order, never
through torch's complex division, which rounds differently.

``site_sweep_cx_c128`` is the same kernel in complex128 (K8-c128): it
replaces the rank-1 XLA loop the JAX package runs for complex128 updates
(``montecarlo_tpu/dqmc/core.py::sweep_slice``), which has no TPU kernel.
Its one-block layout pads G to 32, 64 or 128; at F = 1 past N = 64 the
imaginary plane lives in shared memory, and at F = 2 past N = 64 one
chain's G fits no SM, so each chain runs on a cluster of 2 blocks, one
flavor each, which exchange the diagonal entry of every site
(``flavor_pair``). Past N = 64 the plan (``plan_layout``) takes the rank-1
layout of ``csrc/site_sweep_rank1.cuh`` (K6-f64's and K9-c128's at dk = 1)
where it ran faster on an H100: G padded on chip only to a multiple of 8,
one block per chain or a cluster of 2 (``rank1_layouts``). ``layouts``
lists every layout that takes a shape and ``launch`` runs any of them, to
time them against each other (chip_layouts.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .site_sweep import MAX_N, PHASES, tiled_smem_bytes
from .site_sweep import layout as _layout
from .site_sweep_delayed import Layout, rank1_smem
from .site_sweep_delayed_cx import padded

# the real element type of each complex dtype the kernel takes
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
# K8-c128's built instances of the rank-1 layout (csrc/site_sweep_cx.cu::
# K8Rank1): (F, blocks per chain CS, register rows per flavor KR)
RANK1_BUILDS = ((1, 1, 20), (1, 2, 16), (2, 1, 11), (2, 2, 10))
# the plan's bounds (plan_layout): the rank-1 layout at F = 2 up to
# RANK1_MAX_N; one block per chain up to ONE_BLOCK_MAX_N where the chains
# fill more than one wave of clusters of 2 (CLUSTERS_AT_ONCE, an H100's
# occupancy query at up to 217 KB a block)
RANK1_MAX_N, ONE_BLOCK_MAX_N, CLUSTERS_AT_ONCE = 104, 88, 66


def rank1_max_threads(F: int, kr: int) -> int:
    """Threads a block of the rank-1 instance (F, kr) may have (csrc/
    site_sweep_rank1.cuh::max_threads): as many whole warps as 65,536
    registers hold at 4 F kr registers of G and 48 more a thread, at most
    512."""
    return min(65536 // (4 * F * kr + 48) // 32 * 32, 512)


@functools.cache
def rank1_layouts(N: int, F: int) -> tuple:
    """Every rank-1 layout of K8-c128 at this shape: for each built (CS, KR)
    at this F, the most thread rows TR (TR | NP / CS) whose TR x NP threads
    the instance's cap takes, NP = ``padded(N)``, where one block's shared
    memory holds the rows past the KR register rows. Layout geometry:
    (TR, KR); one computation per shape and process."""
    NP, out = padded(N), []
    for f, cs, kr in RANK1_BUILDS:
        if f != F or NP % cs:
            continue
        rq = NP // cs
        trs = [tr for tr in range(1, rq + 1)
               if rq % tr == 0 and tr * NP <= rank1_max_threads(F, kr)]
        if not trs:
            continue
        tr = max(trs)
        smem = rank1_smem(NP, F, cs, tr, cx=True, kr=kr)
        if smem <= _build.SMEM_PER_BLOCK:
            out.append(Layout("rank1", cs, (tr, kr), smem))
    return tuple(out)


def flavor_pair(N: int, F: int, dtype=torch.complex64) -> bool:
    """Whether the one-block layout runs a chain on a cluster of 2 blocks,
    one flavor each: F = 2 where one block's layout would exceed its shared
    memory (complex128 past N = 64: three planes of 128 KB)."""
    return (F == 2 and dtype in _REAL
            and tiled_smem_bytes(N, 2, True, _REAL[dtype])
            > _build.SMEM_PER_BLOCK)


def tiled_layout(N: int, F: int, dtype=torch.complex64):
    """K8's one-block layout (``site_sweep.tiled_smem_bytes``, G padded to
    32, 64 or 128) where it takes the shape: complex64 up to N = 128 (F = 2
    past 64: flavor 1 in shared memory), complex128 up to N = 128 (F = 1
    past 64: the imaginary plane in shared memory; F = 2 past 64: the
    flavor pair, kind "flavors"); else None."""
    if dtype not in _REAL or not 1 <= N <= MAX_N or F not in (1, 2):
        return None
    pair = flavor_pair(N, F, dtype)
    smem = smem_bytes(N, F, dtype)
    if smem > _build.SMEM_PER_BLOCK:
        return None
    return Layout("flavors" if pair else "tiled", 2 if pair else 1, (), smem)


@functools.cache
def plan_layout(N: int, F: int, dtype=torch.complex64, chains: int = None):
    """The ``Layout`` the wrappers launch for chains chains at this shape.
    Complex128 past N = 64 takes the rank-1 layout where it ran faster on
    an H100 (chip_layouts.py, PERF.md): with more chains than one wave of
    clusters of 2 (CLUSTERS_AT_ONCE), one block per chain up to
    ONE_BLOCK_MAX_N (F = 1: 20 register rows, F = 2: 11), then at F = 2
    clusters of 2 up to RANK1_MAX_N; with fewer chains clusters of 2 (F = 1:
    16 register rows, F = 2: 10) up to 128 at F = 1 and RANK1_MAX_N at
    F = 2. Elsewhere the one-block layout (``tiled_layout``; F = 2 past 64
    its flavor pair), and None where no layout takes the shape."""
    if dtype == torch.complex128 and F in (1, 2) and 64 < N <= MAX_N:
        wide = chains is None or chains > CLUSTERS_AT_ONCE
        cs = (1 if wide and padded(N) <= ONE_BLOCK_MAX_N else
              2 if F == 1 and not wide or F == 2 and N <= RANK1_MAX_N
              else None)
        for lay in rank1_layouts(N, F):
            if lay.cs == cs:
                return lay
    return tiled_layout(N, F, dtype)


@functools.cache
def layouts(N: int, F: int, dtype=torch.complex64,
            chains: int = None) -> tuple:
    """Every layout that takes this shape, the plan's first (to time them
    against each other): complex128 has the rank-1 layouts beside the
    one-block layout. One computation per shape, chain count and process:
    the wrappers check every launch's layout against it."""
    plan = plan_layout(N, F, dtype, chains)
    others = [tiled_layout(N, F, dtype)]
    if dtype == torch.complex128 and 1 <= N <= MAX_N and F in (1, 2):
        others += rank1_layouts(N, F)
    return tuple([plan] * (plan is not None) + [
        lay for lay in others if lay is not None and lay != plan])


def smem_bytes(N: int, F: int, dtype=torch.complex64) -> int:
    """Shared memory of one block of the one-block layout in bytes
    (``tiled_smem_bytes``; a flavor pair's blocks hold one flavor each)."""
    f = 1 if flavor_pair(N, F, dtype) else F
    return tiled_smem_bytes(N, f, True, _REAL[dtype])


def kernel_supports(N: int, F: int, dtype=torch.complex64) -> bool:
    """Shapes the CUDA kernel takes: N <= 128, F in {1, 2}, complex64 or
    complex128 (``plan_layout``)."""
    return (dtype in _REAL and 1 <= N <= MAX_N and F in (1, 2)
            and plan_layout(N, F, dtype) is not None)


def layout(N: int, F: int, dtype=torch.complex64, lay: Layout = None) -> str:
    """A layout of K8 in words: lay, or the plan's at this shape."""
    lay = lay or plan_layout(N, F, dtype)
    if lay.kind == "tiled":
        return _layout(N, F, complex_=True, dtype=_REAL[dtype])
    if lay.kind == "flavors":
        return ("a cluster of 2 blocks per chain, one flavor each, the "
                "diagonal entry of every site exchanged: "
                + _layout(N, 1, complex_=True, dtype=_REAL[dtype]))
    NP, (tr, kr) = padded(N), lay.geometry
    rows = NP // lay.cs // tr
    pad = f"G padded to {NP} x {NP} on chip, " if NP != N else ""
    where = ("every row of G in registers" if rows <= kr else
             f"{min(rows, kr)} of {rows} rows a thread and flavor in "
             "registers, the rest in shared memory")
    blocks = ("one block" if lay.cs == 1 else
              f"a cluster of {lay.cs} blocks")
    return (f"{pad}rank-1: {blocks} of {tr * NP} threads per chain, "
            f"{NP // lay.cs} rows a block, {where}, {lay.smem} bytes per "
            "block")


@functools.cache
def max_clusters(N: int, F: int, lay: Layout) -> int:
    """The most clusters of the rank-1 layout lay that the card runs at
    once (one query per shape and process)."""
    out = ctypes.c_int(0)
    code = _build.load().site_sweep_cx_c128_rank1_max_clusters(
        F, padded(N), lay.cs, *lay.geometry, ctypes.addressof(out))
    _build.check_launch("site_sweep_cx_c128 (occupancy query)", code)
    return out.value


def site_sweep_cx_plain(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """Plain PyTorch complex site sweep, batched over chains (any N, complex64
    or complex128 G).

    G: (C, F, N, N) complex, sigma: (C, N) int8 ±1, u: (C, N) uniforms in
    G's real dtype. Returns new (G, sigma, accept (C, N) bool, det (C, N)
    complex); the inputs are not modified."""
    C, F, N, _ = G.shape
    Gr, Gi = G.real.clone(), G.imag.clone()
    sigma = sigma.clone()
    accept_all = torch.zeros(C, N, dtype=torch.bool, device=G.device)
    det_r, det_i = Gr.new_zeros(C, N), Gr.new_zeros(C, N)
    for i in range(N):
        s = sigma[:, i].to(Gr.dtype)
        dEb = s * (-2.0 * lamb)
        deltas, rs, pr, pi = [], [], None, None
        for f, sg in enumerate(signs):
            delta = torch.exp(dEb * sg) - 1.0
            rr = 1.0 + delta * (1.0 - Gr[:, f, i, i])
            ri = -(delta * Gi[:, f, i, i])
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
        onehot = torch.zeros(N, dtype=Gr.dtype, device=G.device)
        onehot[i] = 1.0
        for f in range(F):
            rr, ri = rs[f]
            inv = 1.0 / (rr * rr + ri * ri)
            xr = torch.where(accept, deltas[f] * rr * inv, 0.0)[:, None]
            xi = torch.where(accept, -(deltas[f] * ri * inv), 0.0)[:, None]
            row_r = Gr[:, f, i, None, :].clone()
            row_i = Gi[:, f, i, None, :].clone()
            igr = onehot - Gr[:, f, :, i]
            igi = -Gi[:, f, :, i]
            yr = (xr * igr - xi * igi)[:, :, None]
            yi = (xr * igi + xi * igr)[:, :, None]
            Gr[:, f] -= yr * row_r - yi * row_i
            Gi[:, f] -= yr * row_i + yi * row_r
        sigma[:, i] = torch.where(accept, -sigma[:, i], sigma[:, i])
    return (torch.complex(Gr, Gi), sigma, accept_all,
            torch.complex(det_r, det_i))


def site_sweep_cx(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """Complex site sweep of one time slice for every chain: the complex64
    CUDA kernel for a CUDA tensor, ``site_sweep_cx_plain`` for a CPU tensor.
    Same arguments and results as ``site_sweep_cx_plain``; on CUDA, G must
    be complex64 (C, F, N, N) within ``kernel_supports``, sigma int8 (C, N)
    and u float32 (C, N), all contiguous on one device."""
    return _sweep(site_sweep_cx, torch.complex64, G, sigma, u, lamb=lamb,
                  signs=signs, det_power=det_power, use_boson=use_boson)


def site_sweep_cx_c128(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """``site_sweep_cx`` in complex128 (K8-c128): the complex128 CUDA kernel
    for a CUDA tensor (G complex128, u float64, ``kernel_supports(N, F,
    torch.complex128)``), ``site_sweep_cx_plain`` for a CPU tensor."""
    return _sweep(site_sweep_cx_c128, torch.complex128, G, sigma, u,
                  lamb=lamb, signs=signs, det_power=det_power,
                  use_boson=use_boson)


def _sweep(fn, dtype, G, sigma, u, **kw):
    if G.device.type == "cpu":
        return site_sweep_cx_plain(G, sigma, u, **kw)
    C, F, N = _check(fn.__name__, dtype, G, sigma, u, kw["signs"],
                     kw["det_power"])
    return launch(G, sigma, u, plan_layout(N, F, dtype, C), **kw)


def launch(G, sigma, u, lay, *, lamb, signs, det_power, use_boson):
    """One launch of the CUDA kernel of G's dtype in the ``Layout`` lay:
    ``plan_layout``'s, or another of ``layouts`` at this shape, to time two
    layouts against each other; counted in ``site_sweep_cx.launches``
    (complex64) or ``site_sweep_cx_c128.launches`` (complex128)."""
    c128 = G.dtype == torch.complex128
    fn = site_sweep_cx_c128 if c128 else site_sweep_cx
    C, F, N = _check(fn.__name__, G.dtype, G, sigma, u, signs, det_power)
    if lay not in layouts(N, F, G.dtype, C):
        raise ValueError(f"{fn.__name__}: the layout {lay} does not take "
                         f"N={N}, F={F} in {str(G.dtype)[6:]}")
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    accept = torch.empty(C, N, dtype=torch.bool, device=G.device)
    det = torch.empty(C, N, dtype=G.dtype, device=G.device)
    head = (G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), accept.data_ptr(),
            det.data_ptr(), C, F, N)
    tail = (float(lamb), float(signs[0]), float(signs[-1]), int(det_power),
            int(bool(use_boson)), torch.cuda.current_stream().cuda_stream)
    lib = _build.load()
    with torch.cuda.device(G.device):
        if lay.kind == "rank1":
            if max_clusters(N, F, lay) < 1:
                raise RuntimeError(
                    f"{fn.__name__}: the card cannot run the layout's "
                    f"clusters ({lay.smem} bytes of shared memory a block)")
            code = lib.site_sweep_cx_c128_rank1(
                *head, padded(N), lay.cs, *lay.geometry, *tail)
        else:
            entry = lib.site_sweep_cx_c128 if c128 else lib.site_sweep_cx_c64
            code = entry(*head, *tail)
    _build.check_launch(fn.__name__, code)
    fn.launches += 1
    return G_out, sigma_out, accept, det


site_sweep_cx.launches = 0
site_sweep_cx_c128.launches = 0


def _check(name, dtype, G, sigma, u, signs, det_power):
    if G.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {G.device}")
    if G.dtype != dtype or u.dtype != _REAL[dtype]:
        raise ValueError(f"{name}: the CUDA kernel takes {str(dtype)[6:]} G "
                         f"and {str(_REAL[dtype])[6:]} u")
    if sigma.dtype != torch.int8:
        raise ValueError(f"{name}: sigma must be int8")
    if G.dim() != 4 or G.shape[2] != G.shape[3]:
        raise ValueError(f"{name}: G must be (C, F, N, N), got "
                         f"{tuple(G.shape)}")
    C, F, N, _ = G.shape
    if (not kernel_supports(N, F, dtype) or len(signs) != F
            or det_power not in (1, 2)):
        raise ValueError(f"{name}: no CUDA kernel for N={N}, F={F} "
                         f"(N <= {MAX_N}, F in (1, 2); det_power 1 or 2)")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError(f"{name}: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one "
                             "device")
    return C, F, N
