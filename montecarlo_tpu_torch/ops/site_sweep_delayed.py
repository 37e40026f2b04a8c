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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .site_sweep import MAX_N

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


def smem_bytes(N: int, F: int, dk: int, cs: int = 1) -> int:
    """Shared memory of one block. cs = 1 (site_sweep_delayed_slab): the row
    and column slabs of every flavor and the staged a, b vectors of one
    site. cs > 1 (site_sweep_delayed_cluster): b of every slot over all N
    columns, a over the block's N/cs rows, the staged a and b of the
    block's sites by site (rows padded to staged_ld(dk)), their dk x dk
    entries at the slots' sites, the diagonal block (rows of dk + 1) and
    its current diagonal, x, u, each site's delta and boson weight, the
    slots' sites and sigma, as csrc/site_sweep_delayed.cu::
    cluster_smem_floats counts them."""
    if cs == 1:
        return 4 * (2 * F * dk * N + F * dk + 2 * F * N)
    rq = N // cs
    return 4 * (F * dk * N + F * dk * rq
                + 2 * F * dk * staged_ld(dk) + 2 * F * dk * dk
                + F * dk * (dk + 1) + 2 * F * dk + (F + 2) * N + dk + 4
                + (N + 3) // 4)


def staged_ld(dk: int) -> int:
    """Row length of the kernel's staged tables: dk padded to float4 loads,
    plus 4 floats, so that 8 rows' float4 loads fall in distinct banks."""
    return (dk + 3) // 4 * 4 + 4


def fits(N: int, F: int, dk: int, cs: int) -> bool:
    """Whether the layout of cs blocks per chain (1: the slab layout) takes
    this shape: its block shared memory within the card's, and for a
    cluster 4 * cs | N (whole 4-row tiles per block)."""
    return (smem_bytes(N, F, dk, cs) <= _build.SMEM_PER_BLOCK
            and (cs == 1 or N % (4 * cs) == 0))


def cluster_plan(N: int, F: int, dk: int) -> int:
    """CS, the blocks per chain: the first of CLUSTER_SIZES that fits; 1,
    the one-block slab layout, where none does."""
    for cs in CLUSTER_SIZES:
        if fits(N, F, dk, cs):
            return cs
    return 1


def layout(N: int, F: int, dk: int, cs: int = None) -> str:
    """The kernel's layout at this shape (or with cs blocks), in words."""
    cs = cs or cluster_plan(N, F, dk)
    if cs == 1:
        return "slab: one block of 512 threads per chain"
    return (f"cluster of {cs} blocks of 512 threads per chain, {N // cs} "
            f"rows each, {smem_bytes(N, F, dk, cs)} bytes per block")


def kernel_supports(N: int, F: int, dk: int) -> bool:
    """Shapes the CUDA kernel takes: N > 128 with 4 | N (float4 rows),
    F in {1, 2}, dk | N, and the layout's buffers within one block's shared
    memory."""
    return (N >= MIN_N and N % 4 == 0 and F in (1, 2) and 1 <= dk
            and N % dk == 0 and fits(N, F, dk, cluster_plan(N, F, dk)))


@functools.cache
def max_clusters(F: int, N: int, dk: int, cs: int) -> int:
    """The most clusters of cs blocks the card runs at once (one query per
    shape and process)."""
    out = ctypes.c_int(0)
    code = _build.load().site_sweep_delayed_f32_max_clusters(
        F, N, dk, cs, ctypes.addressof(out))
    _build.check_launch("site_sweep_delayed (occupancy query)", code)
    return out.value


def site_sweep_delayed_plain(G, sigma, u, *, dk, lamb, signs, det_power,
                             use_boson):
    """Plain PyTorch delayed site sweep, batched over chains (any N with
    dk | N, any float type).

    G: (C, F, N, N), sigma: (C, N) int8 ±1, u: (C, N) uniforms in G's dtype.
    Returns new (G, sigma, acc (C,) int32, nneg (C,) int32); the inputs are
    not modified."""
    C, F, N, _ = G.shape
    if N % dk:
        raise ValueError(f"site_sweep_delayed: dk={dk} does not divide N={N}")
    G = G.clone()
    sigma = sigma.clone()
    acc = torch.zeros(C, dtype=torch.int32, device=G.device)
    nneg = torch.zeros(C, dtype=torch.int32, device=G.device)
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
        for a, b in zip(A, B):
            G -= a[:, :, :, None] * b[:, :, None, :]
    return G, sigma, acc, nneg


def site_sweep_delayed(G, sigma, u, *, dk, lamb, signs, det_power, use_boson):
    """Delayed site sweep of one time slice for every chain: the CUDA kernel
    for a CUDA tensor, in the layout ``cluster_plan`` picks,
    ``site_sweep_delayed_plain`` for a CPU tensor. Same arguments and results
    as ``site_sweep_delayed_plain``; on CUDA, G must be float32 (C, F, N, N)
    with ``kernel_supports(N, F, dk)``, sigma int8 (C, N) and u float32
    (C, N), all contiguous on one device."""
    kw = dict(dk=dk, lamb=lamb, signs=signs, det_power=det_power,
              use_boson=use_boson)
    if G.device.type == "cpu":
        return site_sweep_delayed_plain(G, sigma, u, **kw)
    C, F, N = _check(G, sigma, u, signs, dk)
    return launch(G, sigma, u, cluster_plan(N, F, dk), **kw)


def launch(G, sigma, u, cs, *, dk, lamb, signs, det_power, use_boson):
    """One launch of the CUDA kernel with cs blocks per chain
    (``cluster_plan``'s, or another that fits, to time two layouts against
    each other); counted in ``site_sweep_delayed.launches``."""
    C, F, N = _check(G, sigma, u, signs, dk)
    if not fits(N, F, dk, cs):
        raise ValueError(
            f"site_sweep_delayed: {cs} blocks per chain do not take "
            f"N={N}, F={F}, dk={dk} ({smem_bytes(N, F, dk, cs)} bytes of "
            "shared memory per block)")
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    acc = torch.empty(C, dtype=torch.int32, device=G.device)
    nneg = torch.empty(C, dtype=torch.int32, device=G.device)
    # slab layout: the accepted sites' a and b vectors of one block, per
    # chain and flavor
    scratch = (torch.empty(2, C, F, dk, N, dtype=G.dtype, device=G.device)
               if cs == 1 else None)
    with torch.cuda.device(G.device):
        if cs > 1 and max_clusters(F, N, dk, cs) < 1:
            raise RuntimeError(
                f"site_sweep_delayed: the card cannot run a cluster of {cs} "
                f"blocks with {smem_bytes(N, F, dk, cs)} bytes of shared "
                "memory each")
        code = _build.load().site_sweep_delayed_f32(
            G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), acc.data_ptr(),
            nneg.data_ptr(), 0 if scratch is None else scratch.data_ptr(), C,
            F, N, int(dk), cs, float(lamb), float(signs[0]),
            float(signs[-1]), int(det_power), int(bool(use_boson)),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("site_sweep_delayed", code)
    site_sweep_delayed.launches += 1
    return G_out, sigma_out, acc, nneg


site_sweep_delayed.launches = 0


def _check(G, sigma, u, signs, dk):
    name = "site_sweep_delayed"
    if G.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {G.device}")
    if G.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel takes float32 G and u")
    if sigma.dtype != torch.int8:
        raise ValueError(f"{name}: sigma must be int8")
    if G.dim() != 4 or G.shape[2] != G.shape[3]:
        raise ValueError(f"{name}: G must be (C, F, N, N), got {tuple(G.shape)}")
    C, F, N, _ = G.shape
    if not kernel_supports(N, F, dk) or len(signs) != F:
        raise ValueError(f"{name}: no CUDA kernel for N={N}, F={F}, dk={dk} "
                         f"(N >= {MIN_N}, 4 | N, F in (1, 2), dk | N, "
                         f"{smem_bytes(N, F, dk)} of {_build.SMEM_PER_BLOCK} "
                         "bytes of shared memory in the slab layout)")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError(f"{name}: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one device")
    return C, F, N
