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
"""

from __future__ import annotations

import torch

from . import _build
from .site_sweep import MAX_N

MIN_N = MAX_N + 1        # K1 (ops/site_sweep.py) takes N <= 128


def smem_bytes(N: int, F: int, dk: int) -> int:
    """Shared memory of one block: the row and column slabs of every flavor
    and the staged a, b vectors of one site."""
    return 4 * (2 * F * dk * N + F * dk + 2 * F * N)


def kernel_supports(N: int, F: int, dk: int) -> bool:
    """Shapes the CUDA kernel takes: N > 128 with 4 | N (float4 rows),
    F in {1, 2}, dk | N, and the slabs within one block's shared memory."""
    return (N >= MIN_N and N % 4 == 0 and F in (1, 2) and 1 <= dk
            and N % dk == 0 and smem_bytes(N, F, dk) <= _build.SMEM_PER_BLOCK)


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
    for a CUDA tensor, ``site_sweep_delayed_plain`` for a CPU tensor. Same
    arguments and results as ``site_sweep_delayed_plain``; on CUDA, G must be
    float32 (C, F, N, N) with ``kernel_supports(N, F, dk)``, sigma int8
    (C, N) and u float32 (C, N), all contiguous on one device."""
    kw = dict(dk=dk, lamb=lamb, signs=signs, det_power=det_power,
              use_boson=use_boson)
    if G.device.type == "cpu":
        return site_sweep_delayed_plain(G, sigma, u, **kw)
    C, F, N = _check(G, sigma, u, signs, dk)
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    acc = torch.empty(C, dtype=torch.int32, device=G.device)
    nneg = torch.empty(C, dtype=torch.int32, device=G.device)
    # the accepted sites' a and b vectors of one block, per chain and flavor
    scratch = torch.empty(2, C, F, dk, N, dtype=G.dtype, device=G.device)
    with torch.cuda.device(G.device):
        code = _build.load().site_sweep_delayed_f32(
            G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), acc.data_ptr(),
            nneg.data_ptr(), scratch.data_ptr(), C, F, N, int(dk),
            float(lamb), float(signs[0]), float(signs[-1]), int(det_power),
            int(bool(use_boson)), torch.cuda.current_stream().cuda_stream)
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
                         "bytes of shared memory)")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError(f"{name}: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one device")
    return C, F, N
