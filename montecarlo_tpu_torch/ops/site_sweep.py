"""Sequential Metropolis site sweep over one time slice (kernel K1).

``site_sweep`` launches the CUDA kernel ``csrc/site_sweep.cu`` on CUDA
tensors; on CPU tensors it runs ``site_sweep_plain``, the plain PyTorch
version of the same algorithm with the same op order. It replaces the Pallas
kernel ``montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel``
(col_read mode, reached through ``_site_sweep_batched``).

Per chain and site i in order (sigma_i = ±1, f over flavor blocks):
  delta_f = exp(sign_f * dEb) - 1,  dEb = -2 * lamb * sigma_i
  r_f     = 1 + delta_f * (1 - G_f[i, i])
  detratio = (prod_f r_f) ** det_power
  accept  = u_i < exp(-dEb)**use_boson * detratio
  on accept: G_f -= (delta_f / r_f) * (e_i - G_f[:, i]) ⊗ G_f[i, :], flip sigma_i
and the accepted and negative-detratio proposals are counted per chain.
delta is exp(x) - 1 as in the Pallas kernel (the JAX XLA loop uses expm1;
the two differ at the last bit of delta only).
"""

from __future__ import annotations

import torch

from . import _build

MAX_N = 128


def kernel_supports(N: int, F: int) -> bool:
    """Shapes the CUDA kernel takes: G of one chain (F*N*(N+1) floats) stays
    in shared memory for the whole sweep, which caps N at 128 for F <= 2."""
    return 1 <= N <= MAX_N and F in (1, 2)


def site_sweep_plain(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """Plain PyTorch site sweep, batched over chains (any N, any float type).

    G: (C, F, N, N), sigma: (C, N) int8 ±1, u: (C, N) uniforms in G's dtype.
    Returns new (G, sigma, acc (C,) int32, nneg (C,) int32); the inputs are
    not modified."""
    C, F, N, _ = G.shape
    G = G.clone()
    sigma = sigma.clone()
    acc = torch.zeros(C, dtype=torch.int32, device=G.device)
    nneg = torch.zeros(C, dtype=torch.int32, device=G.device)
    for i in range(N):
        s = sigma[:, i].to(G.dtype)
        dEb = s * (-2.0 * lamb)
        deltas, rs, rprod = [], [], None
        for f, sg in enumerate(signs):
            delta = torch.exp(dEb * sg) - 1.0
            r = 1.0 + delta * (1.0 - G[:, f, i, i])
            deltas.append(delta)
            rs.append(r)
            rprod = r if rprod is None else rprod * r
        detratio = rprod
        for _ in range(det_power - 1):
            detratio = detratio * rprod
        w = torch.exp(-dEb) if use_boson else 1.0
        accept = u[:, i] < w * detratio
        rows = [G[:, f, i, :].clone() for f in range(F)]
        cols = [G[:, f, :, i].clone() for f in range(F)]
        for f in range(F):
            x = torch.where(accept, deltas[f] / rs[f], 0.0)
            ig = -cols[f]
            ig[:, i] += 1.0
            xig = x[:, None] * ig
            G[:, f] -= xig[:, :, None] * rows[f][:, None, :]
        sigma[:, i] = torch.where(accept, -sigma[:, i], sigma[:, i])
        acc += accept
        nneg += detratio < 0
    return G, sigma, acc, nneg


def site_sweep(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """Site sweep of one time slice for every chain: the CUDA kernel for a
    CUDA tensor, ``site_sweep_plain`` for a CPU tensor. Same arguments and
    results as ``site_sweep_plain``; on CUDA, G must be float32 (C, F, N, N)
    with F in {1, 2} and N <= 128, sigma int8 (C, N) and u float32 (C, N),
    all contiguous on one device."""
    kw = dict(lamb=lamb, signs=signs, det_power=det_power, use_boson=use_boson)
    if G.device.type == "cpu":
        return site_sweep_plain(G, sigma, u, **kw)
    C, F, N = _check(G, sigma, u, signs)
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    acc = torch.empty(C, dtype=torch.int32, device=G.device)
    nneg = torch.empty(C, dtype=torch.int32, device=G.device)
    with torch.cuda.device(G.device):
        code = _build.load().site_sweep_f32(
            G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), acc.data_ptr(),
            nneg.data_ptr(), C, F, N, float(lamb), float(signs[0]),
            float(signs[-1]), int(det_power), int(bool(use_boson)),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("site_sweep", code)
    site_sweep.launches += 1
    return G_out, sigma_out, acc, nneg


site_sweep.launches = 0


def _check(G, sigma, u, signs):
    if G.device.type != "cuda":
        raise ValueError(f"site_sweep: no kernel for device {G.device}")
    if G.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError("site_sweep: the CUDA kernel takes float32 G and u")
    if sigma.dtype != torch.int8:
        raise ValueError("site_sweep: sigma must be int8")
    if G.dim() != 4 or G.shape[2] != G.shape[3]:
        raise ValueError(f"site_sweep: G must be (C, F, N, N), got {tuple(G.shape)}")
    C, F, N, _ = G.shape
    if not kernel_supports(N, F) or len(signs) != F:
        raise ValueError(f"site_sweep: no CUDA kernel for N={N}, F={F} "
                         f"(N <= {MAX_N}, F in (1, 2))")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError("site_sweep: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError("site_sweep: tensors must be contiguous on one device")
    return C, F, N
