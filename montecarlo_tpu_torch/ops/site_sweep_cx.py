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
At F = 2 past N = 64 (the repulsive model in a flux, 9 x 9 to 11 x 11) one
chain's G fits no SM, so each chain runs on a cluster of 2 blocks, one
flavor each, which exchange the diagonal entry of every site
(``flavor_pair``).
"""

from __future__ import annotations

import torch

from . import _build
from .site_sweep import MAX_N, PHASES, tiled_smem_bytes
from .site_sweep import layout as _layout

# the real element type of each complex dtype the kernel takes
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def flavor_pair(N: int, F: int, dtype=torch.complex64) -> bool:
    """Whether a chain runs on a cluster of 2 blocks, one flavor each:
    F = 2 where one block's layout would exceed its shared memory
    (complex128 past N = 64: three planes of 128 KB)."""
    return (F == 2 and dtype in _REAL
            and tiled_smem_bytes(N, 2, True, _REAL[dtype])
            > _build.SMEM_PER_BLOCK)


def smem_bytes(N: int, F: int, dtype=torch.complex64) -> int:
    """Shared memory of one block (``tiled_smem_bytes``; a flavor pair's
    blocks hold one flavor each)."""
    f = 1 if flavor_pair(N, F, dtype) else F
    return tiled_smem_bytes(N, f, True, _REAL[dtype])


def kernel_supports(N: int, F: int, dtype=torch.complex64) -> bool:
    """Shapes the CUDA kernel takes: N <= 128, F in {1, 2}, complex64 or
    complex128. G of one chain over the block's registers; complex64 at
    F = 2 past N = 64: flavor 1 in shared memory (141,184 bytes at N = 128);
    complex128 at F = 1 past N = 64: the imaginary plane in shared memory,
    and at F = 2 past N = 64 a cluster of 2 blocks per chain, one flavor
    each in the F = 1 layout (``flavor_pair``)."""
    return (dtype in _REAL and 1 <= N <= MAX_N and F in (1, 2)
            and smem_bytes(N, F, dtype) <= _build.SMEM_PER_BLOCK)


def layout(N: int, F: int, dtype=torch.complex64) -> str:
    """K8's layout at this shape, in words."""
    if flavor_pair(N, F, dtype):
        return ("a cluster of 2 blocks per chain, one flavor each, the "
                "diagonal entry of every site exchanged: "
                + _layout(N, 1, complex_=True, dtype=_REAL[dtype]))
    return _layout(N, F, complex_=True, dtype=_REAL[dtype])


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
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    accept = torch.empty(C, N, dtype=torch.bool, device=G.device)
    det = torch.empty(C, N, dtype=G.dtype, device=G.device)
    entry = ("site_sweep_cx_c128" if dtype == torch.complex128
             else "site_sweep_cx_c64")
    with torch.cuda.device(G.device):
        code = getattr(_build.load(), entry)(
            G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), accept.data_ptr(),
            det.data_ptr(), C, F, N, float(kw["lamb"]),
            float(kw["signs"][0]), float(kw["signs"][-1]),
            int(kw["det_power"]), int(bool(kw["use_boson"])),
            torch.cuda.current_stream().cuda_stream)
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
