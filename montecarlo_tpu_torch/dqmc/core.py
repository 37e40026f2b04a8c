"""DQMC propagation core: UDT-stabilized sweeps over batched tensors.

Counterpart of montecarlo_tpu/dqmc/core.py. Where the JAX engine is written
per chain and vmapped, every function here takes tensors with a leading
chain axis C: G (C, F, N, N), HS field conf (C, N, M) int8, stacks
(C, n_el, F, N, N). Slice and segment loops are Python loops.

Index conventions (0-based, as in the JAX package):
  B_l = e^{-dtau*T} e^{-dtau*V(sigma_l)}        effective slice matrix
  G_eff(l) = [I + B_{l-1}...B_0 · B_{M-1}...B_l]^{-1}
        — the Green's function used to update slice l
  stack S[j], j = 0..n_seg:
    after an up sweep: S[j] = UDT(B_{j*sm-1}...B_0)   (left products)
    after a down sweep: S[j] = UDT(B_{j*sm}^†...B_{M-1}^†) for j < n_seg
        (right products; S[n_seg] holds the identity)

Ported: the rank-1 site sweep (sequential, and for F >= 2 in float32 at
even N two sites at a time), the delayed rank-k site sweep, with the QR
stabilizations (stab_method "qr" and "qr_colscaled") for real hopping in
float32, float64 and mixed precision, and the rank-1 and delayed sweeps for
complex hopping (Peierls phases) with their phase-problem statistics: the
imaginary-weight monitor and the running weight phase. Every session
records how large its negative weights were where the JAX package does.
Two A/B modes of the JAX package come as make_context keywords:
fuse_wrap (MC_TPU_FUSE_WRAP=1: the slice's wrap fused into the site sweep,
kernel K13) and qr_wy (MC_TPU_QR_WY=1: the float32 QR emitting its
reflectors, kernel K14, with Q assembled outside); each raises where its
kernel takes no part of the session. The slice multiplies from either
side (B, B^{-1}, B^†, B^{-†}), ``udt_of_product`` and
``greens_from_scratch`` serve the time-displaced path
(``unequal_time.py``).
g_refresh and checkerboard raise NotImplementedError naming their ROADMAP
item; the retired stab_method "cholqr" raises as well.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import qr_blocked as _qr_blocked
from ..ops import qr_cx as _qr_cx
from ..ops import qr_householder as _qrh
from ..ops import site_sweep_cx as _sscx
from ..ops import site_sweep_delayed as _ssd
from ..ops import site_sweep_delayed_cx as _ssdcx
from ..ops.linalg import (CX_QR_MAX_N, FUSED_MAX_N, calculate_greens,
                          permute_rows, scatter_columns, udt_dirty,
                          udt_dirty_colscaled)
from ..ops.site_sweep import (MAX_N, empty_neg, neg_push, pair_supports,
                              site_sweep, site_sweep_f64, site_sweep_pair,
                              site_sweep_plain, site_sweep_single,
                              site_sweep_wrap)
from ..ops.site_sweep import kernel_supports as site_sweep_supports
from ..utils.host import real_dtype, resolve_device


@dataclass(frozen=True)
class DQMCContext:
    """Static data of a DQMC session."""

    N: int            # sites
    M: int            # time slices
    sm: int           # safe_mult
    F: int            # flavor blocks
    lamb: float       # Hirsch lambda
    det_power: int    # detratio = prod_f(r_f) ** det_power (2 for F=1, 1 for F=2)
    use_boson: bool   # include exp(-dE_boson) in the Metropolis weight
    dtype: torch.dtype
    signs: tuple      # flavor signs of the HS coupling
    device: torch.device
    check_propagation_error: bool = True
    # G and the per-slice hot path (wraps, site sweeps) run in update_dtype;
    # the UDT stacks and stabilized recomputations stay in dtype
    update_dtype: torch.dtype = None
    prop_err_threshold: float = 1e-7
    # hand-written kernels on CUDA (K1-K5 and K11 for N <= 128, K6 and K7
    # beyond; complex: K8 and K10 for N <= 128, K9 beyond), their plain
    # versions on CPU; False runs the plain site sweeps and the library
    # QR/solve on any device
    use_kernels: bool = True
    # delayed-update block width K (0 = rank-1): the plain path's rank-K
    # sweep, and the site block of K6 and K9
    delay: int = 0
    # "qr" (udt_dirty: one power-of-two prescale per product) or
    # "qr_colscaled" (udt_dirty_colscaled: every column normalized)
    stab_method: str = "qr"
    # the slice's wrap fused into the site sweep (K13) on the kernel path
    fuse_wrap: bool = False
    # the float32 QR of K4's route as K14 + the WY assembly of Q, on the
    # kernel path
    qr_wy: bool = False

    @property
    def greens_udt_fn(self):
        """The UDT of every stabilization and Green's recomputation."""
        fn = (udt_dirty_colscaled if self.stab_method == "qr_colscaled"
              else udt_dirty)
        return functools.partial(fn, qr_wy=True) if self.qr_wy else fn

    @property
    def udtype(self):
        return self.update_dtype if self.update_dtype is not None else self.dtype

    @property
    def is_complex(self):
        return self.dtype.is_complex

    @property
    def rdtype(self):
        return real_dtype(self.dtype)

    @property
    def urdtype(self):
        return real_dtype(self.udtype)

    @property
    def n_seg(self):
        return self.M // self.sm

    @property
    def n_el(self):
        return self.n_seg + 1


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to montecarlo_tpu_torch yet (ROADMAP {item})")


# complex hopping promotes the session dtypes
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def make_context(model, params, dtype=torch.float64, update_dtype=None,
                 device="cuda", use_kernels: bool = True,
                 stab_method: str = "qr", delay: int = None,
                 checkerboard: bool = False,
                 check_propagation_error: bool = None,
                 g_refresh: bool = False, fuse_wrap: bool = False,
                 qr_wy: bool = False) -> Tuple[DQMCContext, dict]:
    """Build the static context and the hopping-matrix exponentials.

    fuse_wrap and qr_wy are the JAX package's MC_TPU_FUSE_WRAP and
    MC_TPU_QR_WY A/B modes (``_ab_modes`` says where they apply; elsewhere
    they raise ValueError). Both act on the kernel path only: with
    use_kernels=False the session runs the plain unfused path, as the JAX
    package's with use_pallas=False.

    Complex hopping (Peierls phases) promotes the session to complex:
    float32 to complex64 and float64 to complex128 (dtype and update_dtype);
    the D factors, uniforms and drift statistics stay real (ctx.rdtype).

    Returns (ctx, consts) with consts on ``device``:
      eT2, eT2inv: exp(∓ dtau T); eThalf, eThalfinv: exp(∓ dtau/2 T);
      hopping: T; eT2_u, eT2inv_u: exp(∓ dtau T) in the update dtype.
    The exponentials are computed in numpy through eigh exactly as the JAX
    package computes them, so the constants are bit-identical to the JAX
    package's.

    Also turns TF32 off for float32 matmuls process-wide
    (torch.backends.cuda.matmul.allow_tf32 = False, float32 matmul precision
    "highest"): reduced-precision passes bias the Markov chain through wrap
    drift (the JAX reference measured occupation 0.44-0.49 against an exact
    0.5).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = resolve_device(device)
    T = np.asarray(model.hopping_matrix())
    N = len(model.lattice)
    if np.iscomplexobj(T):
        dtype = _COMPLEX.get(dtype, dtype)
        if update_dtype is not None:
            update_dtype = _COMPLEX.get(update_dtype, update_dtype)
    if g_refresh:
        raise _not_ported("g_refresh", "Queue 1 item 5")
    if checkerboard:
        raise _not_ported("checkerboard", "Queue 1 item 6")
    if stab_method == "cholqr":
        raise NotImplementedError(
            "stab_method='cholqr' was retired in the JAX package for drift "
            "blow-ups and is not ported (ROADMAP, Deliberately not ported)")
    if stab_method not in ("qr", "qr_colscaled"):
        raise ValueError(f"unknown stab_method {stab_method!r} (use 'qr' or "
                         "'qr_colscaled')")
    delay = _delay(N, delay)
    udtype = dtype if update_dtype is None else update_dtype
    _ab_modes(N, delay, dtype, udtype, stab_method, fuse_wrap, qr_wy)
    if device.type == "cuda" and use_kernels:
        _check_cuda_kernels(N, model.nflavors, delay, dtype, udtype)

    dtau = params.delta_tau
    w, V = np.linalg.eigh(T)
    expm = lambda c: (V * np.exp(c * w)[None, :]) @ V.conj().T
    mk = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
    eT2, eT2inv = expm(-dtau), expm(dtau)
    consts = {
        "eT2": mk(eT2, dtype),
        "eT2inv": mk(eT2inv, dtype),
        "eThalf": mk(expm(-0.5 * dtau), dtype),
        "eThalfinv": mk(expm(0.5 * dtau), dtype),
        "hopping": mk(T, dtype),
        "eT2_u": mk(eT2, udtype),
        "eT2inv_u": mk(eT2inv, udtype),
    }
    cpe = (params.check_propagation_error
           if check_propagation_error is None else check_propagation_error)
    mixed = update_dtype is not None and update_dtype != dtype
    ctx = DQMCContext(
        N=N, M=params.slices, sm=params.safe_mult, F=model.nflavors,
        lamb=model.lamb(dtau), det_power=2 // model.nflavors,
        use_boson=model.use_boson_weight, dtype=dtype,
        signs=tuple(model.flavor_signs), device=device,
        check_propagation_error=bool(cpe), update_dtype=update_dtype,
        # mixed mode: window-end drift ~cond(window)*eps_f32 is expected;
        # count only catastrophic excursions
        prop_err_threshold=1.0 if mixed else 1e-7,
        use_kernels=bool(use_kernels), delay=delay, stab_method=stab_method,
        fuse_wrap=bool(fuse_wrap), qr_wy=bool(qr_wy),
    )
    return ctx, consts


def _delay(N, delay):
    """The JAX package's delay rule: auto (None) is rank-32 from N = 256 and
    rank-1 below; the block is clamped down to the largest divisor of N, and
    a block of 1 is rank-1 (0)."""
    if delay is None:
        delay = 32 if N >= 256 else 0
    k = max(0, int(delay))
    while k > 1 and N % k:
        k -= 1
    return 0 if k <= 1 else k


def _ab_modes(N, delay, dtype, udtype, stab_method, fuse_wrap, qr_wy):
    """Raise ValueError where an A/B mode would not engage. fuse_wrap: the
    JAX package's rule (core.py::_fuse_wrap_enabled): real hopping, float32
    updates, N <= 128 and delay <= 1 (where K13 takes G of one chain in
    shared memory). qr_wy: a float32 QR on K4's route, i.e. real float32
    stacks at N <= 128 that the fused K2/K3 do not take (stab_method
    "qr_colscaled", or N > 64)."""
    if fuse_wrap and (dtype.is_complex or udtype != torch.float32
                      or N > MAX_N or delay > 1):
        raise ValueError(
            f"fuse_wrap=True needs real hopping, float32 updates, N <= "
            f"{MAX_N} and delay <= 1 (K13's rule, the JAX package's "
            f"MC_TPU_FUSE_WRAP); this session has {str(udtype)[6:]} "
            f"updates, N={N}, delay={delay}")
    if qr_wy and (dtype != torch.float32 or N > MAX_N or (
            stab_method == "qr" and N <= FUSED_MAX_N)):
        raise ValueError(
            f"qr_wy=True needs a float32 QR on K4's route: real float32 "
            f"stacks at N <= {MAX_N}, with stab_method='qr_colscaled' or "
            f"N > {FUSED_MAX_N} (the fused K2/K3 take N <= {FUSED_MAX_N}); "
            f"this session has {str(dtype)[6:]} stacks, N={N}, "
            f"stab_method={stab_method!r}")


def _check_cuda_kernels(N, F, delay, dtype, udtype):
    """Raise unless a kernel takes every shape of a CUDA session, for either
    stabilization. Real sessions: the site sweep (N <= 128: K5 for float32
    updates with F = 2 at even N, else K1 in the update dtype; K6 beyond in
    float32; K5 takes every shape K1 takes at even N) and the QR of the
    stack dtype: float32 K2/K3 for 8 | N <= 64, K4 for 8 | N <= 128 and K7
    for 8 | N > 128, float64 K11 for 8 | N <= 64 (float64 stacks with
    float32 or float64 updates). Complex64 updates at 8 | N: K8 up to
    N = 128 (G of one chain over the block's registers, flavor 1 in shared
    memory at F = 2 past N = 64, so F = 2 stops at N = 119), K9 in blocks of
    max(delay, 1) sites beyond (its buffers in shared memory: not F = 2 at
    N = 256, delay 32); the QR of complex64 stacks is K10 up to N = 128 and
    the library QR beyond, that of complex128 stacks the library QR, as in
    the JAX package (XLA's QR where no Pallas kernel takes the shape)."""
    if dtype.is_complex or udtype.is_complex:
        if udtype != torch.complex64:
            raise _not_ported("CUDA kernels for complex128 updates "
                              "(use_kernels=False runs the plain path)",
                              "Queue 1 item 4")
        dk = max(delay, 1)
        qr_ok = dtype == torch.complex128 or _qr_cx.kernel_supports(N)
        if not (N % 8 == 0 and (
                _sscx.kernel_supports(N, F) and qr_ok
                if N <= CX_QR_MAX_N else _ssdcx.kernel_supports(N, F, dk))):
            raise _not_ported(
                f"the complex64 kernels for N={N}, F={F}, delay={delay} (K8 "
                "and K10 take 8 | N <= 128, K8 with G of one chain over the "
                "block's registers and flavor 1 in shared memory at F = 2 "
                "past N = 64, so F = 2 stops at N = 119; K9 8 | N beyond "
                "with its buffers in shared memory; elsewhere the JAX "
                "package runs XLA's loop or QR)",
                "Queue 1 item 4")
        return
    f64 = dtype == torch.float64
    if f64 and not _qrh.kernel_supports(N, torch.float64):
        raise _not_ported(
            f"the float64 QR for N={N} (K11 takes 8 | N <= 64; beyond, the "
            "JAX package runs XLA's float64 QR)", "Queue 1 item 4")
    if not (site_sweep_supports(N, F, udtype) if N <= MAX_N
            else _ssd.kernel_supports(N, F, max(delay, 1))):
        raise _not_ported(f"the site sweep for N={N}, F={F}, delay={delay} "
                          f"(K1 takes N <= {MAX_N}, K6 4 | N beyond with its "
                          "buffers in shared memory, both F <= 2)",
                          "Queue 1 item 4")
    if f64:
        return
    if not (_qrh.kernel_supports(N) or _qr_blocked.kernel_supports(N)):
        raise _not_ported(
            f"the float32 QR for N={N} (K2/K3 take 8 | N <= 64, K4 "
            "8 | N <= 128, K7 8 | N > 128; for other N the JAX package runs "
            "XLA's QR)",
            "Queue 1 item 4")


# ---------------------------------------------------------------------------
# slice matrix multiplications
# ---------------------------------------------------------------------------

def eV_diag(ctx, sigma_l, power=1.0, dtype=None):
    """diag of exp(-power*dtau*V(l)) as (C, F, N); sigma_l: (C, N) int8.
    lamb*sign is ±lamb exactly, so each factor is exp(±(power*lamb)*sigma)
    rounded once, as in the JAX package."""
    s = sigma_l.to(real_dtype(dtype or ctx.dtype))
    return torch.stack([torch.exp(s * (power * ctx.lamb * sg))
                        for sg in ctx.signs], dim=-2)


def mult_B_left(ctx, consts, sigma_l, M):
    """M ← B_l M = eT2 · diag(eV) · M   (M: (C, F, N, N))."""
    return consts["eT2"] @ (eV_diag(ctx, sigma_l)[..., :, None] * M)


def mult_B_right(ctx, consts, sigma_l, M):
    """M ← M B_l = (M eT2) · diag(eV)."""
    return (M @ consts["eT2"]) * eV_diag(ctx, sigma_l)[..., None, :]


def mult_B_inv_left(ctx, consts, sigma_l, M):
    """M ← B_l^{-1} M = diag(eV)^{-1} · eT2inv · M."""
    return eV_diag(ctx, sigma_l, -1.0)[..., :, None] * (consts["eT2inv"] @ M)


def mult_B_inv_right(ctx, consts, sigma_l, M):
    """M ← M B_l^{-1} = (M · diag(eV)^{-1}) · eT2inv."""
    return (M * eV_diag(ctx, sigma_l, -1.0)[..., None, :]) @ consts["eT2inv"]


def mult_B_dagger_left(ctx, consts, sigma_l, M):
    """M ← B_l^† M = diag(eV) · eT2^† · M (eV real)."""
    return eV_diag(ctx, sigma_l)[..., :, None] * (consts["eT2"].mH @ M)


def mult_B_dagger_right(ctx, consts, sigma_l, M):
    """M ← M B_l^† = (M · diag(eV)) · eT2^†."""
    return (M * eV_diag(ctx, sigma_l)[..., None, :]) @ consts["eT2"].mH


def mult_B_invdag_right(ctx, consts, sigma_l, M):
    """M ← M B_l^{-†} = (M · eT2inv^†) · diag(eV)^{-1}."""
    return (M @ consts["eT2inv"].mH) * eV_diag(ctx, sigma_l, -1.0)[..., None, :]


def wrap_up(ctx, consts, sigma_l, G):
    """G_eff(l) → G_eff(l+1) = B_l G B_l^{-1}, in the update dtype."""
    G = consts["eT2_u"] @ (eV_diag(ctx, sigma_l, dtype=ctx.udtype)[..., :, None] * G)
    eVinv = eV_diag(ctx, sigma_l, -1.0, dtype=ctx.udtype)
    return (G * eVinv[..., None, :]) @ consts["eT2inv_u"]


def wrap_down(ctx, consts, sigma_l, G):
    """G_eff(l+1) → G_eff(l) = B_l^{-1} G B_l, in the update dtype."""
    eVinv = eV_diag(ctx, sigma_l, -1.0, dtype=ctx.udtype)
    G = eVinv[..., :, None] * (consts["eT2inv_u"] @ G)
    eV = eV_diag(ctx, sigma_l, dtype=ctx.udtype)
    return (G @ consts["eT2_u"]) * eV[..., None, :]


# ---------------------------------------------------------------------------
# UDT segment accumulation
# ---------------------------------------------------------------------------

def _identity_udt(ctx, C):
    I = torch.eye(ctx.N, dtype=ctx.dtype, device=ctx.device).expand(
        C, ctx.F, ctx.N, ctx.N)
    D = torch.ones(C, ctx.F, ctx.N, dtype=ctx.rdtype, device=ctx.device)
    return I, D, I


def udt(ctx, A):
    """``udt_dirty`` of A on the session's route (kernels, qr_wy): the UDT of
    every product that is not a stack extension."""
    return udt_dirty(A, ctx.use_kernels, ctx.qr_wy)


def udt_of_product(ctx, consts, conf, slices, mult):
    """UDT of the product mult(slices[-1]) ∘ ... ∘ mult(slices[0]) applied to
    the identity, for every chain, re-decomposed every safe_mult slices and
    after the last (the identity for no slices). mult is one of the
    mult_B_*_left functions; conf (C, N, M)."""
    U, D, T = _identity_udt(ctx, conf.shape[0])
    curr = U
    for count, l in enumerate(slices, 1):
        curr = mult(ctx, consts, conf[:, :, l], curr)
        if count % ctx.sm == 0 or count == len(slices):
            u, d, r, piv = udt(ctx, curr * D[..., None, :])
            T = scatter_columns(r, piv) @ T
            U, D, curr = u, d, u
    return U, D, T


def _restabilize(ctx, curr, D, T):
    u, d, r, piv = ctx.greens_udt_fn(curr * D[..., None, :], ctx.use_kernels)
    return u, d, r @ permute_rows(T, piv)


def extend_left(ctx, consts, conf, j, U, D, T):
    """(U,D,T) = UDT(B_{j*sm-1}...B_0) → UDT(B_{(j+1)*sm-1}...B_0), applying
    the slices of segment j left to right. conf: (C, N, M)."""
    curr = U
    for s in range(ctx.sm):
        curr = mult_B_left(ctx, consts, conf[:, :, j * ctx.sm + s], curr)
    return _restabilize(ctx, curr, D, T)


def extend_right(ctx, consts, conf, j, U, D, T):
    """(U,D,T) = UDT(B_{(j+1)*sm}^†...B_{M-1}^†) → UDT(B_{j*sm}^†...B_{M-1}^†)."""
    curr = U
    for s in reversed(range(ctx.sm)):
        curr = mult_B_dagger_left(ctx, consts, conf[:, :, j * ctx.sm + s], curr)
    return _restabilize(ctx, curr, D, T)


# ---------------------------------------------------------------------------
# local updates
# ---------------------------------------------------------------------------

def sweep_slice(ctx, G, sigma, u):
    """Sequential Metropolis over all sites of one time slice, for every
    chain. G: (C, F, N, N) in the update dtype, sigma: (C, N) int8, u: (C, N)
    uniforms. Returns new (G, sigma, acc (C,), nneg (C,), neg) on every
    route; the inputs are not modified. neg is the per-chain (C, 3) min, max
    and sum of log10|detratio| over the negative proposals
    (``site_sweep.neg_push``) where the route records them, None where it
    keeps the count alone (K1 and K5 in float32, K6: the Pallas kernels'
    rule). Complex sessions return (G, sigma, accept (C, N), det (C, N),
    None) instead: every site's accept flag and complex detratio, for
    ``_track_detratio_batch``, which folds the statistics itself.

    Dispatch as in the JAX engine: the kernel path runs, for N <= 128, K5
    (two sites at a time) for float32 G with F >= 2 at even N and K1
    (rank-1, float32 or float64 as G) otherwise (for one float32 chain
    through its one-chain entry K12), and K8 for complex G;
    beyond, K6 (delayed, blocks of max(delay, 1) sites) and K9 (its
    complex instance); the plain path runs ``sweep_slice_delayed`` when
    delay > 1, else the plain version of the rank-1 kernel (K1's, or K8's
    for complex G)."""
    sigma, u = sigma.contiguous(), u.contiguous()
    kw = dict(lamb=ctx.lamb, signs=ctx.signs, det_power=ctx.det_power,
              use_boson=ctx.use_boson)
    dk = max(ctx.delay, 1)
    if G.is_complex():
        if ctx.use_kernels:
            if ctx.N <= MAX_N:
                return (*_sscx.site_sweep_cx(G, sigma, u, **kw), None)
            return (*_ssdcx.site_sweep_delayed_cx(G, sigma, u, dk=dk, **kw),
                    None)
        if ctx.delay > 1:
            return sweep_slice_delayed(ctx, G, sigma, u)
        return (*_sscx.site_sweep_cx_plain(G, sigma, u, **kw), None)
    if ctx.use_kernels:
        if ctx.N > MAX_N:
            return (*_ssd.site_sweep_delayed(G, sigma, u, dk=dk, **kw), None)
        if G.dtype == torch.float64:
            return site_sweep_f64(G, sigma, u, **kw)
        if ctx.F >= 2 and pair_supports(ctx.N, ctx.F, G.dtype):
            return (*site_sweep_pair(G, sigma, u, **kw), None)
        if G.shape[0] == 1:
            out = site_sweep_single(G[0], sigma[0], u[0], **kw)
            return (*(x[None] for x in out), None)
        return (*site_sweep(G, sigma, u, **kw), None)
    if ctx.delay > 1:
        return sweep_slice_delayed(ctx, G, sigma, u)
    return site_sweep_plain(G, sigma, u, **kw)


def _fuse_wrap_enabled(ctx):
    """The slice visits run K13 (the JAX package's MC_TPU_FUSE_WRAP=1 on its
    Pallas path): fuse_wrap on the kernel path; make_context has checked the
    session against the rule (``_ab_modes``)."""
    return ctx.fuse_wrap and ctx.use_kernels


def _sweep_slice_fused_wrap(ctx, consts, G, sigma, u, direction):
    """``sweep_slice`` and the slice's wrap in one launch of K13: the wrap
    down before the sweep with the pre-update sigma (direction -1) or the
    wrap up after it with the post-update sigma (+1). Same results as
    ``sweep_slice`` (neg None: K13 counts the negative detratios only, as
    K1)."""
    if direction > 0:
        Ml, Mr = consts["eT2_u"], consts["eT2inv_u"]
    else:
        Ml, Mr = consts["eT2inv_u"], consts["eT2_u"]
    out = site_sweep_wrap(G, sigma.contiguous(), u.contiguous(), Ml, Mr,
                          lamb=ctx.lamb, signs=ctx.signs,
                          det_power=ctx.det_power, use_boson=ctx.use_boson,
                          wrap_dir=direction)
    return (*out, None)


def visit_slice(ctx, consts, G, sigma, u, direction):
    """One slice visit of a sweep: the wrap down before the site sweep with
    the pre-update sigma (direction -1), or the site sweep and then the
    wrap up with the post-update sigma (+1); in one launch of K13 where
    ``_fuse_wrap_enabled``. Returns ``sweep_slice``'s five results, G
    wrapped."""
    if _fuse_wrap_enabled(ctx):
        return _sweep_slice_fused_wrap(ctx, consts, G, sigma, u, direction)
    if direction < 0:
        G = wrap_down(ctx, consts, sigma, G)
    G, sigma, a, b, neg = sweep_slice(ctx, G, sigma, u)
    if direction > 0:
        G = wrap_up(ctx, consts, sigma, G)
    return G, sigma, a, b, neg


def sweep_slice_delayed(ctx, G, sigma, u):
    """Delayed (rank-K) plain sweep, K = ctx.delay: the Markov chain of the
    rank-1 sweep, with accepted flips accumulated as skinny factors
    A (C, F, N, K) and B (C, F, K, N), G_curr = G - A·B, and folded into G
    with one batched product per block of K sites (port of the JAX
    package's XLA ``sweep_slice_delayed``; delta is expm1 as there, and a
    complex G decides on Re(detratio)). Same arguments and results as
    ``sweep_slice`` (real G: the negative-weight statistics included,
    complex G: None in their place); K | N."""
    C, F, N, _ = G.shape
    K = ctx.delay
    cx = G.is_complex()
    rd = real_dtype(G.dtype)
    signs = torch.tensor(ctx.signs, dtype=rd, device=G.device)
    sigma = sigma.clone()
    acc = torch.zeros(C, dtype=torch.int32, device=G.device)
    nneg = torch.zeros(C, dtype=torch.int32, device=G.device)
    neg = empty_neg(C, rd, G.device)
    accept_all = torch.zeros(C, N, dtype=torch.bool, device=G.device)
    det_all = G.new_zeros(C, N)
    for b in range(N // K):
        A = G.new_zeros(C, F, N, K)
        B = G.new_zeros(C, F, K, N)
        for j in range(K):
            i = b * K + j
            dEb = sigma[:, i].to(rd) * (-2.0 * ctx.lamb)           # (C,)
            delta = torch.expm1(signs * dEb[:, None])              # (C, F)
            Arow, Bcol = A[:, :, i, :], B[:, :, :, i]              # (C, F, K)
            gii = G[:, :, i, i] - (Arow * Bcol).sum(-1)
            r = 1.0 + delta * (1.0 - gii)
            rprod = torch.prod(r, dim=-1)
            detratio = rprod
            for _ in range(ctx.det_power - 1):
                detratio = detratio * rprod
            w = torch.exp(-dEb) if ctx.use_boson else 1.0
            accept = u[:, i] < w * (detratio.real if cx else detratio)
            x = delta / r
            row = G[:, :, i, :] - (Arow[:, :, None, :] @ B)[:, :, 0, :]
            col = G[:, :, :, i] - (A @ Bcol[..., None])[..., 0]
            coef = torch.where(accept[:, None], x, 0.0)
            IG = -col
            IG[:, :, i] += 1.0
            A[:, :, :, j] = coef[..., None] * IG
            B[:, :, j, :] = row
            sigma[:, i] = torch.where(accept, -sigma[:, i], sigma[:, i])
            if cx:
                accept_all[:, i], det_all[:, i] = accept, detratio
            else:
                acc += accept
                nneg += detratio < 0
                neg = neg_push(neg, detratio)
        G = G - A @ B
    if cx:
        return G, sigma, accept_all, det_all, None
    return G, sigma, acc, nneg, neg


# ---------------------------------------------------------------------------
# stack construction and the full sweep pair
# ---------------------------------------------------------------------------

# exceedance edges for the propagation-drift histogram
PROP_ERR_EDGES = (1e-6, 1e-3, 1e-1, 1e1)

# the magnitudes of the negative weights (Re(detratio) < 0) as log10: min,
# max and sum per chain (where the site sweep records them, sweep_slice)
NEG_KEYS = ("ls_neg_min", "ls_neg_max", "ls_neg_sum")
# per-chain counters, reset when DQMC drains them to host integers
COUNTER_KEYS = ("prop", "acc", "neg_prob", "prop_err_max", "prop_err_count",
                "prop_err_sum", "prop_err_n", "prop_err_hist") + NEG_KEYS
# complex sessions add the phase-problem statistics, reset on drain as well:
# the count of |Im(detratio)| above IMAG_PROB_THRESHOLD and its magnitudes
# as log10 (min, max, sum)
CX_COUNTER_KEYS = ("ls_imag_count", "ls_imag_min", "ls_imag_max",
                   "ls_imag_sum")
# ... and the running configuration-weight phase ls_phase with its snapshot
# phase_meas at the measurement point, which the drain leaves alone

# an imaginary detratio part above this counts as an imaginary probability
# (the JAX package's monitor, after the reference's)
IMAG_PROB_THRESHOLD = 1e-6


def counter_keys(ctx):
    return COUNTER_KEYS + (CX_COUNTER_KEYS if ctx.is_complex else ())


def fresh_counters(ctx, C):
    """Every counter of ``counter_keys(ctx)`` at its empty value, per chain:
    zero, and +inf / -inf for the log-magnitude minima / maxima."""
    kw = dict(device=ctx.device)
    ints = lambda *shape: torch.zeros(C, *shape, dtype=torch.int64, **kw)
    real = lambda v=0.0: torch.full((C,), v, dtype=ctx.rdtype, **kw)
    inf = float("inf")
    out = {"prop": ints(), "acc": ints(), "neg_prob": ints(),
           "prop_err_max": real(), "prop_err_count": ints(),
           # window-end drift distribution: sum/n give the mean, the
           # histogram counts exceedances over PROP_ERR_EDGES
           "prop_err_sum": real(), "prop_err_n": ints(),
           "prop_err_hist": ints(len(PROP_ERR_EDGES)),
           "ls_neg_min": real(inf), "ls_neg_max": real(-inf),
           "ls_neg_sum": real()}
    if ctx.is_complex:
        out.update(ls_imag_count=ints(), ls_imag_min=real(inf),
                   ls_imag_max=real(-inf), ls_imag_sum=real())
    return out


def _track_negative(ls, neg):
    """Fold one slice's per-chain negative-weight statistics neg (C, 3)
    (min, max, sum of log10|detratio|; sweep_slice) into ls_neg_*; nothing
    where the route records none (neg None)."""
    if neg is None:
        return {}
    neg = neg.to(ls["ls_neg_sum"].dtype)
    return {"ls_neg_min": torch.minimum(ls["ls_neg_min"], neg[:, 0]),
            "ls_neg_max": torch.maximum(ls["ls_neg_max"], neg[:, 1]),
            "ls_neg_sum": ls["ls_neg_sum"] + neg[:, 2]}


def _track_detratio_batch(ls, det, accept):
    """Fold one slice's proposals of every chain into the statistics: det
    (C, N) complex detratios, accept (C, N) bool. Counts accepted and
    negative-weight (Re det < 0) proposals, the log10-magnitude statistics of
    the negative weights and of the imaginary parts above
    IMAG_PROB_THRESHOLD, and multiplies the running weight phase ls_phase by
    the phase det/|det| of every accepted flip (the boson factor is real
    positive). Every statistic is order-independent, so this equals the
    sequential per-proposal bookkeeping of the JAX package up to rounding.
    Returns the updated entries."""
    neg = det.real < 0
    bad = det.imag.abs() > IMAG_PROB_THRESHOLD
    out = {"acc": ls["acc"] + accept.sum(-1),
           "neg_prob": ls["neg_prob"] + neg.sum(-1),
           "ls_imag_count": ls["ls_imag_count"] + bad.sum(-1)}
    for prefix, value, mask in (("ls_neg", det.real, neg),
                                ("ls_imag", det.imag, bad)):
        rd = ls[prefix + "_sum"].dtype
        lv = torch.log10(value.abs().clamp_min(1e-38)).to(rd)
        inf = torch.full_like(lv, float("inf"))
        out[prefix + "_min"] = torch.minimum(
            ls[prefix + "_min"], torch.where(mask, lv, inf).amin(-1))
        out[prefix + "_max"] = torch.maximum(
            ls[prefix + "_max"], torch.where(mask, lv, -inf).amax(-1))
        out[prefix + "_sum"] = ls[prefix + "_sum"] + torch.where(
            mask, lv, 0.0).sum(-1)
    phase = ls["ls_phase"]
    det = det.to(phase.dtype)
    ph = det / det.abs().clamp_min(1e-38)
    out["ls_phase"] = _normalize_phase(
        phase * torch.prod(torch.where(accept, ph, 1.0), dim=-1))
    return out


def _normalize_phase(phase):
    return phase / phase.abs().clamp_min(1e-30)


def udt_weight_phase(ctx, U, D, T):
    """Phase of the fermionic configuration weight prod_f det(I + B_f)^p per
    chain, from the UDT factors (C, F, ...) of the full slice product
    B = B_{M-1}...B_0. Range-safe: I + UDT = U·Dp·(Dp⁻¹U† + Dm·T) with
    Dp = max(D, 1), Dm = min(D, 1), so det(I + UDT) = det(U)·det(Dp)·
    det(Dp⁻¹U† + Dm·T) with det(Dp) real positive; only the signs (unit
    phases) of the two determinants are used. Real sessions return 1.
    (C,) in ctx.dtype."""
    if not ctx.is_complex:
        return torch.ones(U.shape[0], dtype=ctx.dtype, device=U.device)
    Dp, Dm = D.clamp_min(1.0), D.clamp_max(1.0)
    Mmid = U.mH / Dp[..., :, None] + Dm[..., :, None] * T
    s = torch.linalg.slogdet(U).sign * torch.linalg.slogdet(Mmid).sign
    p = torch.prod(s, dim=-1)
    ph = p
    for _ in range(ctx.det_power - 1):
        ph = ph * p
    return _normalize_phase(ph).to(ctx.dtype)


def phase_from_conf(ctx, consts, conf):
    """The configuration-weight phase recomputed from the HS field conf
    (C, N, M) alone: UDT(B_{M-1}...B_0) restabilized every safe_mult slices,
    then ``udt_weight_phase``. The running chain tracks the same phase
    incrementally (``_track_detratio_batch``)."""
    U, D, T = udt_of_product(ctx, consts, conf, range(ctx.M), mult_B_left)
    return udt_weight_phase(ctx, U, D, T)


def greens_from_scratch(ctx, consts, conf, slice_idx: int):
    """G_eff(slice_idx) (C, F, N, N) recomputed from the HS field conf
    (C, N, M) alone, for 0 <= slice_idx <= M: the left product
    B_{slice_idx-1}...B_0 and the right product B_{slice_idx}^†...B_{M-1}^†,
    each decomposed every safe_mult slices, then ``calculate_greens``."""
    left = udt_of_product(ctx, consts, conf, range(slice_idx), mult_B_left)
    right = udt_of_product(ctx, consts, conf,
                           range(ctx.M - 1, slice_idx - 1, -1),
                           mult_B_dagger_left)
    return calculate_greens(*left, *right, ctx.use_kernels, ctx.greens_udt_fn)


def init_state(ctx, consts, conf):
    """Build the initial stack and G_eff(M) from a configuration conf
    (C, N, M) int8. Returns the state dict (all tensors with a leading chain
    axis); complex sessions start the running weight phase (and its
    measurement snapshot) from ``udt_weight_phase`` of the full product."""
    C = conf.shape[0]
    n_el = ctx.n_el
    S_U = torch.zeros(C, n_el, ctx.F, ctx.N, ctx.N, dtype=ctx.dtype,
                      device=ctx.device)
    S_D = torch.zeros(C, n_el, ctx.F, ctx.N, dtype=ctx.rdtype, device=ctx.device)
    S_T = torch.zeros_like(S_U)
    U, D, T = iU, iD, iT = _identity_udt(ctx, C)
    for j in range(ctx.n_seg):
        S_U[:, j], S_D[:, j], S_T[:, j] = U, D, T
        U, D, T = extend_left(ctx, consts, conf, j, U, D, T)
    S_U[:, ctx.n_seg], S_D[:, ctx.n_seg], S_T[:, ctx.n_seg] = U, D, T
    # a valid G_eff(M) from the fresh stack makes the drift check at the
    # first turnaround meaningful
    G0 = calculate_greens(U, D, T, iU, iD, iT, ctx.use_kernels,
                          ctx.greens_udt_fn)
    state = {"conf": conf, "S_U": S_U, "S_D": S_D, "S_T": S_T,
             "G": G0.to(ctx.udtype), **fresh_counters(ctx, C)}
    if ctx.is_complex:
        phase = udt_weight_phase(ctx, U, D, T)
        state.update(ls_phase=phase, phase_meas=phase)
    return state


def _track_prop_err(ctx, perr, G, G_re):
    """Fold one window-end drift max|G - G_re| per chain into the drift
    statistics (G in the update dtype against G_re in dtype, as in JAX)."""
    diff = (G - G_re).abs().amax(dim=(-3, -2, -1))
    perr["prop_err_max"] = torch.maximum(perr["prop_err_max"], diff)
    perr["prop_err_count"] = perr["prop_err_count"] + (diff > ctx.prop_err_threshold)
    perr["prop_err_sum"] = perr["prop_err_sum"] + diff.to(perr["prop_err_sum"].dtype)
    perr["prop_err_n"] = perr["prop_err_n"] + 1
    perr["prop_err_hist"] = perr["prop_err_hist"] + torch.stack(
        [diff > e for e in PROP_ERR_EDGES], dim=-1)


def sweep_pair(ctx, consts, state, u=None, generator=None):
    """One full [down sweep; up sweep] pass over imaginary time, updating every
    site of every slice twice, for every chain.

    u: (C, 2M, N) uniforms in the update dtype, one row per slice visit in
    visit order (down sweep l = M-1..0, then up sweep l = 0..M-1) — the order
    in which the JAX package splits its per-chain key. Drawn from
    ``generator`` when not given.

    Returns (state, G_meas, conf_meas): the new state (the input state is not
    modified) and the effective G and HS field at the measurement point
    (after the slice-0 site updates of the up sweep). Complex sessions keep
    the running weight phase at that point in state["phase_meas"]."""
    C = state["conf"].shape[0]
    M, N, sm, n_seg = ctx.M, ctx.N, ctx.sm, ctx.n_seg
    if u is None:
        u = torch.rand((C, 2 * M, N), generator=generator, device=ctx.device,
                       dtype=ctx.urdtype)
    u = u.transpose(0, 1).contiguous()         # (2M, C, N): one row per visit
    conf = state["conf"].clone()
    S_U, S_D, S_T = (state[k].clone() for k in ("S_U", "S_D", "S_T"))
    G = state["G"]
    # Metropolis statistics: acc, neg_prob, the negative weights'
    # magnitudes and, complex, the phase problem's
    ls = {k: state[k] for k in ("acc", "neg_prob") + NEG_KEYS + (
        CX_COUNTER_KEYS + ("ls_phase",) if ctx.is_complex else ())}
    perr = {k: state[k] for k in COUNTER_KEYS if k.startswith("prop_err")}
    visit = 0

    def sweep(G, l, direction=0):
        """Visit slice l: its site sweep alone (direction 0) or with its
        wrap (``visit_slice``)."""
        nonlocal visit
        if direction:
            G, conf[:, :, l], a, b, neg = visit_slice(
                ctx, consts, G, conf[:, :, l], u[visit], direction)
        else:
            G, conf[:, :, l], a, b, neg = sweep_slice(ctx, G, conf[:, :, l],
                                                      u[visit])
        if ctx.is_complex:          # a, b: per-site accept flags and det
            ls.update(_track_detratio_batch(ls, b, a))
        else:                       # a, b: accepted and negative counts
            ls["acc"], ls["neg_prob"] = ls["acc"] + a, ls["neg_prob"] + b
            ls.update(_track_negative(ls, neg))
        visit += 1
        return G

    def recompute(G, lU, lD, lT, rU, rD, rT):
        G_re = calculate_greens(lU, lD, lT, rU, rD, rT, ctx.use_kernels,
                                ctx.greens_udt_fn)
        if ctx.check_propagation_error:
            _track_prop_err(ctx, perr, G, G_re)
        return G_re.to(ctx.udtype)

    # ---- down sweep. Entering segment j: the left product is read from slot
    # j+1, then the right-product carry, extended by the just-swept segment
    # j+1, is stored into the same slot (j = n_seg-1 starts from identity).
    rU, rD, rT = iU, iD, iT = _identity_udt(ctx, C)
    for j in range(n_seg - 1, -1, -1):
        if j != n_seg - 1:
            rU, rD, rT = extend_right(ctx, consts, conf, j + 1, rU, rD, rT)
        G = recompute(G, S_U[:, j + 1], S_D[:, j + 1], S_T[:, j + 1],
                      rU, rD, rT)                       # G_eff((j+1)*sm)
        S_U[:, j + 1], S_D[:, j + 1], S_T[:, j + 1] = rU, rD, rT
        for l in range(j * sm + sm - 1, j * sm - 1, -1):
            G = sweep(G, l, -1)          # wrap down with the pre-update sigma
    rU, rD, rT = extend_right(ctx, consts, conf, 0, rU, rD, rT)
    S_U[:, 0], S_D[:, 0], S_T[:, 0] = rU, rD, rT

    # ---- up sweep; segment 0 is peeled: it holds the measurement point,
    # so slice 0's wrap stays unfused (as in the JAX package)
    G = calculate_greens(iU, iD, iT, rU, rD, rT, ctx.use_kernels,
                         ctx.greens_udt_fn).to(ctx.udtype)   # G_eff(0)
    S_U[:, 0], S_D[:, 0], S_T[:, 0] = iU, iD, iT
    G = sweep(G, 0)
    G_meas, conf_meas, phase_meas = G, conf.clone(), ls.get("ls_phase")
    G = wrap_up(ctx, consts, conf[:, :, 0], G)             # updated sigma
    for l in range(1, sm):
        G = sweep(G, l, +1)              # wrap up with the updated sigma
    lU, lD, lT = extend_left(ctx, consts, conf, 0, iU, iD, iT)
    for j in range(1, n_seg):
        G = recompute(G, lU, lD, lT, S_U[:, j], S_D[:, j], S_T[:, j])
        S_U[:, j], S_D[:, j], S_T[:, j] = lU, lD, lT
        for l in range(j * sm, j * sm + sm):
            G = sweep(G, l, +1)
        lU, lD, lT = extend_left(ctx, consts, conf, j, lU, lD, lT)
    S_U[:, n_seg], S_D[:, n_seg], S_T[:, n_seg] = lU, lD, lT

    new = dict(state)
    new.update(perr)
    new.update(ls)
    new.update(conf=conf, S_U=S_U, S_D=S_D, S_T=S_T, G=G,
               prop=state["prop"] + 2 * M * N)
    if ctx.is_complex:
        new["phase_meas"] = phase_meas
    return new, G_meas, conf_meas


def unwrap_greens(ctx, consts, G_eff):
    """Effective → physical equal-time Green's function
    G = e^{+dtau T/2} G_eff e^{-dtau T/2}, in the session dtype (a mixed
    session's float32 G_eff is promoted, as jnp promotes it)."""
    G_eff = G_eff.to(consts["eThalf"].dtype)
    return consts["eThalfinv"] @ G_eff @ consts["eThalf"]
