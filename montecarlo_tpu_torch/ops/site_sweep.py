"""Sequential Metropolis site sweep over one time slice (kernel K1), in
float32 and in float64.

``site_sweep`` (float32) and ``site_sweep_f64`` launch the CUDA kernels of
``csrc/site_sweep.cu`` on CUDA tensors; on CPU tensors they run
``site_sweep_plain``, the plain PyTorch version of the same algorithm with
the same op order. ``site_sweep`` replaces the Pallas kernel
``montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel`` (col_read mode,
reached through ``_site_sweep_batched``); ``site_sweep_f64`` replaces the XLA
site loop the JAX package runs for float64 updates
(``montecarlo_tpu/dqmc/core.py::sweep_slice``), which has no Pallas kernel
because Mosaic is float32-only.

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
# the C entry point and the element type of each wrapper
_ENTRY = {"site_sweep": ("site_sweep_f32", torch.float32),
          "site_sweep_f64": ("site_sweep_f64", torch.float64)}


def kernel_supports(N: int, F: int, dtype=torch.float32) -> bool:
    """Shapes the CUDA kernels take: G of one chain (F*N*(N+1) elements and
    two staging vectors) stays in shared memory for the whole sweep, with
    N <= 128 and F <= 2: every such shape in float32; in float64 N <= 128
    at F = 1 and N <= 119 at F = 2."""
    el = torch.finfo(dtype).bits // 8
    return (1 <= N <= MAX_N and F in (1, 2)
            and (F * N * (N + 1) + 2 * F * N) * el <= _build.SMEM_PER_BLOCK)


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
    """Site sweep of one time slice for every chain: the float32 CUDA kernel
    for a CUDA tensor, ``site_sweep_plain`` for a CPU tensor. Same arguments
    and results as ``site_sweep_plain``; on CUDA, G must be float32
    (C, F, N, N) with ``kernel_supports(N, F)``, sigma int8 (C, N) and u
    float32 (C, N), all contiguous on one device."""
    return _sweep("site_sweep", site_sweep, G, sigma, u, lamb=lamb,
                  signs=signs, det_power=det_power, use_boson=use_boson)


def site_sweep_f64(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """``site_sweep`` in float64: the float64 CUDA kernel for a CUDA tensor
    (G and u float64, ``kernel_supports(N, F, torch.float64)``),
    ``site_sweep_plain`` for a CPU tensor."""
    return _sweep("site_sweep_f64", site_sweep_f64, G, sigma, u, lamb=lamb,
                  signs=signs, det_power=det_power, use_boson=use_boson)


site_sweep.launches = 0
site_sweep_f64.launches = 0


def _sweep(name, fn, G, sigma, u, **kw):
    """Launch the kernel of wrapper fn (entry point and dtype from _ENTRY)
    on a CUDA tensor, or run the plain version on a CPU one."""
    if G.device.type == "cpu":
        return site_sweep_plain(G, sigma, u, **kw)
    entry, dtype = _ENTRY[name]
    signs = kw["signs"]
    C, F, N = _check(name, dtype, G, sigma, u, signs)
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    acc = torch.empty(C, dtype=torch.int32, device=G.device)
    nneg = torch.empty(C, dtype=torch.int32, device=G.device)
    with torch.cuda.device(G.device):
        code = getattr(_build.load(), entry)(
            G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), acc.data_ptr(),
            nneg.data_ptr(), C, F, N, float(kw["lamb"]), float(signs[0]),
            float(signs[-1]), int(kw["det_power"]),
            int(bool(kw["use_boson"])),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, code)
    fn.launches += 1
    return G_out, sigma_out, acc, nneg


def _check(name, dtype, G, sigma, u, signs):
    if G.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {G.device}")
    if G.dtype != dtype or u.dtype != dtype:
        raise ValueError(f"{name}: the CUDA kernel takes {str(dtype)[6:]} G "
                         "and u")
    if sigma.dtype != torch.int8:
        raise ValueError(f"{name}: sigma must be int8")
    if G.dim() != 4 or G.shape[2] != G.shape[3]:
        raise ValueError(f"{name}: G must be (C, F, N, N), got "
                         f"{tuple(G.shape)}")
    C, F, N, _ = G.shape
    if not kernel_supports(N, F, dtype) or len(signs) != F:
        raise ValueError(f"{name}: no CUDA kernel for N={N}, F={F} "
                         f"(N <= {MAX_N}, F in (1, 2), G of one chain in "
                         "shared memory)")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError(f"{name}: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one "
                             "device")
    return C, F, N
