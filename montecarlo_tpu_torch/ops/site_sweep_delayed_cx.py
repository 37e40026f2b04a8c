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

MIN_N = MAX_N + 1        # K8 (ops/site_sweep_cx.py) takes N <= 128
# the cluster sizes (blocks per chain) in the order cluster_plan tries
# them: clusters of 2 blocks of up to ~150 KB of shared memory run 66 at
# once on an H100, clusters of 4 only 30
CLUSTER_SIZES = (2, 4)
# the phases that a build with -DMC_PHASE_STAMPS times (chip_profile.py),
# per kernel of csrc/site_sweep_delayed_cx.cu
PHASES = {"slab": ("slab load", "decisions", "staging and slab update",
                   "fold"),
          "cluster": ("setup and copy", "cluster barriers", "diagonal block",
                      "decisions", "y and b vectors", "fold")}


def smem_bytes(N: int, F: int, dk: int, cs: int = 1) -> int:
    """Shared memory of one block. cs = 1 (site_sweep_delayed_cx_slab): the
    row and column slabs of every flavor as two float32 planes (column rows
    padded to N+1) and the staged y and row vectors of one site, both
    planes. cs > 1 (site_sweep_delayed_cx_cluster): re and im planes of b
    of every slot over all N columns, y over the block's N/cs rows, the
    staged y and b of the block's sites by site (rows padded to
    staged_ld(dk)), their dk x dk entries at the slots' sites, the diagonal
    block (rows of dk + 1), its current diagonal and x; u, each site's
    delta and boson weight, the slots' sites and sigma, as
    csrc/site_sweep_delayed_cx.cu::cluster_smem_floats counts them."""
    if cs == 1:
        return 4 * (2 * F * dk * N + 2 * F * dk * (N + 1) + 4 * F * N)
    rq = N // cs
    return 4 * (2 * F * dk * N + 2 * F * dk * rq + 4 * F * dk * staged_ld(dk)
                + 4 * F * dk * dk + 2 * F * dk * (dk + 1) + 4 * F * dk
                + (F + 2) * N + dk + 4 + (N + 3) // 4)


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
    """Shapes the CUDA kernel takes: N > 128 with 8 | N, F in {1, 2},
    dk | N, and the layout's buffers within one block's shared memory (at
    N = 256: F = 1 to dk = 32, F = 2 to dk = 16)."""
    return (N >= MIN_N and N % 8 == 0 and F in (1, 2) and 1 <= dk
            and N % dk == 0 and fits(N, F, dk, cluster_plan(N, F, dk)))


@functools.cache
def max_clusters(F: int, N: int, dk: int, cs: int) -> int:
    """The most clusters of cs blocks the card runs at once (one query per
    shape and process)."""
    out = ctypes.c_int(0)
    code = _build.load().site_sweep_delayed_cx_c64_max_clusters(
        F, N, dk, cs, ctypes.addressof(out))
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
    CUDA kernel for a CUDA tensor, in the layout ``cluster_plan`` picks,
    ``site_sweep_delayed_cx_plain`` for a CPU tensor. Same arguments and
    results as ``site_sweep_delayed_cx_plain``; on CUDA, G must be complex64
    (C, F, N, N) with ``kernel_supports(N, F, dk)``, sigma int8 (C, N) and u
    float32 (C, N), all contiguous on one device."""
    kw = dict(dk=dk, lamb=lamb, signs=signs, det_power=det_power,
              use_boson=use_boson)
    if G.device.type == "cpu":
        return site_sweep_delayed_cx_plain(G, sigma, u, **kw)
    C, F, N = _check(G, sigma, u, signs, dk, det_power)
    return launch(G, sigma, u, cluster_plan(N, F, dk), **kw)


def launch(G, sigma, u, cs, *, dk, lamb, signs, det_power, use_boson):
    """One launch of the CUDA kernel with cs blocks per chain
    (``cluster_plan``'s, or another that fits, to time two layouts against
    each other); counted in ``site_sweep_delayed_cx.launches``."""
    C, F, N = _check(G, sigma, u, signs, dk, det_power)
    if not fits(N, F, dk, cs):
        raise ValueError(
            f"site_sweep_delayed_cx: {cs} blocks per chain do not take "
            f"N={N}, F={F}, dk={dk} ({smem_bytes(N, F, dk, cs)} bytes of "
            "shared memory per block)")
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    accept = torch.empty(C, N, dtype=torch.bool, device=G.device)
    det = torch.empty(C, N, dtype=G.dtype, device=G.device)
    # slab layout: the accepted sites' y and row vectors of one block, re
    # and im planes
    scratch = (torch.empty(4, C, F, dk, N, dtype=torch.float32,
                           device=G.device) if cs == 1 else None)
    with torch.cuda.device(G.device):
        if cs > 1 and max_clusters(F, N, dk, cs) < 1:
            raise RuntimeError(
                f"site_sweep_delayed_cx: the card cannot run a cluster of {cs}"
                f" blocks with {smem_bytes(N, F, dk, cs)} bytes of shared "
                "memory each")
        code = _build.load().site_sweep_delayed_cx_c64(
            G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), accept.data_ptr(),
            det.data_ptr(), 0 if scratch is None else scratch.data_ptr(), C,
            F, N, int(dk), cs, float(lamb), float(signs[0]),
            float(signs[-1]), int(det_power), int(bool(use_boson)),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("site_sweep_delayed_cx", code)
    site_sweep_delayed_cx.launches += 1
    return G_out, sigma_out, accept, det


site_sweep_delayed_cx.launches = 0


def _check(G, sigma, u, signs, dk, det_power):
    name = "site_sweep_delayed_cx"
    if G.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {G.device}")
    if G.dtype != torch.complex64 or u.dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel takes complex64 G and "
                         "float32 u")
    if sigma.dtype != torch.int8:
        raise ValueError(f"{name}: sigma must be int8")
    if G.dim() != 4 or G.shape[2] != G.shape[3]:
        raise ValueError(f"{name}: G must be (C, F, N, N), got {tuple(G.shape)}")
    C, F, N, _ = G.shape
    if (not kernel_supports(N, F, dk) or len(signs) != F
            or det_power not in (1, 2)):
        raise ValueError(f"{name}: no CUDA kernel for N={N}, F={F}, dk={dk} "
                         f"(N >= {MIN_N}, 8 | N, F in (1, 2), dk | N, "
                         f"{smem_bytes(N, F, dk)} of {_build.SMEM_PER_BLOCK} "
                         "bytes of shared memory in the slab layout; "
                         "det_power 1 or 2)")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError(f"{name}: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one device")
    return C, F, N
