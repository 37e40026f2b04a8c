"""Sequential Metropolis site sweep over one time slice: kernel K1 in float32
and in float64, its delay-2 paired-site form, kernel K5, its one-chain entry,
kernel K12, and K1 with the slice's wrap fused in, kernel K13.

``site_sweep`` (float32), ``site_sweep_f64`` and ``site_sweep_pair``
(float32) launch the CUDA kernels of ``csrc/site_sweep.cu`` on CUDA tensors;
on CPU tensors they run ``site_sweep_plain`` (K1) or ``site_sweep_pair_plain``
(K5), the plain PyTorch versions of the same algorithms with the same op
order. ``site_sweep`` replaces the Pallas kernel
``montecarlo_tpu/ops/pallas_site_sweep.py::_batched_kernel`` (col_read mode,
reached through ``_site_sweep_batched``); ``site_sweep_pair`` replaces
``_batched_kernel_pair`` of the same file, which the JAX package takes for
F >= 2 at even N; ``site_sweep_f64`` replaces the XLA site loop the JAX
package runs for float64 updates (``montecarlo_tpu/dqmc/core.py::
sweep_slice``), which has no Pallas kernel because Mosaic is float32-only.

Per chain and site i in order (sigma_i = ±1, f over flavor blocks):
  delta_f = exp(sign_f * dEb) - 1,  dEb = -2 * lamb * sigma_i
  r_f     = 1 + delta_f * (1 - G_f[i, i])
  detratio = (prod_f r_f) ** det_power
  accept  = u_i < exp(-dEb)**use_boson * detratio
  on accept: G_f -= (delta_f / r_f) * (e_i - G_f[:, i]) ⊗ G_f[i, :], flip sigma_i
and the accepted and negative-detratio proposals are counted per chain. The
plain version and K1 in float64 also return how large the negative
detratios were, per chain: the min, max and sum of log10|detratio| over
them (``neg_push``), as the JAX package's XLA loop records them
(``_push_mag``); the float32 kernels keep the count alone, as the Pallas
kernels do.
delta is exp(x) - 1 as in the Pallas kernel (the JAX XLA loop uses expm1;
the two differ at the last bit of delta only). K5 computes the same chain
(bit for bit) two sites at a time: see ``site_sweep_pair_plain``.

``site_sweep_single`` (K12) is K1's launch for ONE chain, with the JAX
signature of ``pallas_site_sweep.py::site_sweep_pallas`` (G (F, N, N), sigma
(N,) of any integer dtype): the Pallas kernel it replaces, ``_kernel``, runs
K1's algorithm one grid step per site for one chain, and K1 is one block per
chain already. ``site_sweep_wrap`` (K13) runs K1's sweep and the slice's
wrap in one launch (``csrc/site_sweep_wrap.cu``; its plain version
``site_sweep_wrap_plain``), replacing ``_batched_kernel`` with wrap_dir = ±1
(``get_fused_site_sweep_wrap``, MC_TPU_FUSE_WRAP=1 in the JAX package).
"""

from __future__ import annotations

import torch

from . import _build

MAX_N = 128
# the phases of K1 (float32 and float64), K5 and K8 (tiled::sweep_chain and
# sweep_chain_pair, csrc/site_sweep_tiled.cuh) that a build with
# -DMC_PHASE_STAMPS times (chip_profile.py)
PHASES = ("load", "decision", "update", "publish", "barrier", "store")
# ... and of K13 (csrc/site_sweep_wrap.cu): K1's and its wrap's two
WRAP_PHASES = PHASES + ("wrap: diagonals, staging and Z = M Mr",
                        "wrap: Ml Z")
# the threads per chain of K1, K5 and K8 at every shape (csrc/
# site_sweep_tiled.cuh::with_layout): the fastest of 128 to 1024 wherever
# they were timed (PERF.md)
THREADS = 256


def padded(N: int) -> int:
    """N padded to the tiled layout's NP (csrc/site_sweep_tiled.cuh::
    with_layout)."""
    return 32 if N <= 32 else 64 if N <= 64 else 128


def _planes_in_registers(N: int, F: int, complex_: bool,
                         dtype=torch.float32) -> int:
    """Planes of G in registers (flavor f, plane v: q = f * NV + v; complex
    has two planes per flavor): all where their tiles take a thread at most
    128 registers, else as many whole planes as 128 registers hold
    (complex64 and float64 at F = 2 past NP = 64: flavor 0; complex128 at
    F = 1 past NP = 64: the real plane; csrc/site_sweep_tiled.cuh::
    planes_in_registers). dtype: the real element type."""
    words = (dtype.itemsize // 4) * (padded(N) ** 2 // THREADS)
    planes = F * (2 if complex_ else 1)
    return planes if planes * words <= 128 else 128 // words


def tiled_smem_bytes(N: int, F: int, complex_: bool = False,
                     dtype=torch.float32, sites: int = 1) -> int:
    """Shared memory of one block of K1 (complex_: K8; sites=2: K5), as
    csrc/site_sweep_tiled.cuh::smem_bytes counts it: the staging double
    buffer of row and column per flavor, plane and staged site, u, the
    complex det per site, the planes kept in shared memory (complex64 and
    float64 F = 2 past NP = 64: flavor 1; complex128 F = 1 past NP = 64:
    the imaginary plane; NP x NP elements each), all of them elements of
    dtype (the real element type), then sigma in and out and the complex
    accept flags."""
    NP, nv, el = padded(N), 2 if complex_ else 1, dtype.itemsize
    qr = _planes_in_registers(N, F, complex_, dtype)
    return (el * (4 * sites * nv * F * NP + NP + (2 * NP if complex_ else 0)
                  + (F * nv - qr) * NP * NP) + NP * (3 if complex_ else 2))


def layout(N: int, F: int, complex_: bool = False,
           dtype=torch.float32) -> str:
    """K1's (complex_: K8's) layout at this shape, in words."""
    NP, threads = padded(N), THREADS
    nv = 2 if complex_ else 1
    qr = _planes_in_registers(N, F, complex_, dtype)
    where = ("G in registers" if qr == F * nv
             else "flavor 0 in registers, flavor 1 in shared memory"
             if qr == nv else
             "the real plane in registers, the imaginary plane in shared "
             "memory" if F == 1 else
             f"{qr} of {F * nv} planes in registers, the rest in shared "
             "memory")
    return (f"one block of {threads} threads per chain, "
            f"{NP * NP // threads} elements of each {NP} x {NP} flavor per "
            f"thread, {where}, {tiled_smem_bytes(N, F, complex_, dtype)} "
            "bytes of shared memory")


def kernel_supports(N: int, F: int, dtype=torch.float32) -> bool:
    """Shapes the K1 kernels take, float32 or float64: every N <= 128 at
    F <= 2 (G over the registers, csrc/site_sweep_tiled.cuh; float64 F = 2
    past N = 64 with flavor 1 in shared memory, 140,544 bytes at
    N = 128)."""
    return (1 <= N <= MAX_N and F in (1, 2)
            and dtype in (torch.float32, torch.float64)
            and tiled_smem_bytes(N, F, dtype=dtype) <= _build.SMEM_PER_BLOCK)


def pair_supports(N: int, F: int, dtype=torch.float32) -> bool:
    """Shapes K5 takes: float32, even N <= 128, F <= 2 (G over the
    registers as in K1, rows and columns of two sites staged:
    ``tiled_smem_bytes(N, F, sites=2)``, 8,960 bytes at F = 2, N = 128)."""
    return (dtype == torch.float32 and 2 <= N <= MAX_N and N % 2 == 0
            and F in (1, 2)
            and tiled_smem_bytes(N, F, sites=2) <= _build.SMEM_PER_BLOCK)


def wrap_smem_bytes(N: int, F: int) -> int:
    """Shared memory of one block of K13, as csrc/site_sweep_wrap.cu::
    wrap_smem_bytes counts it: K1's (``tiled_smem_bytes``, rounded up to
    16 bytes), then the wrap's two NP x (NP + 4) float matrices (X: M^T,
    then Z; W: Mr, then Ml^T)."""
    NP = padded(N)
    return -(-tiled_smem_bytes(N, F) // 16) * 16 + 2 * NP * (NP + 4) * 4


def wrap_supports(N: int, F: int, dtype=torch.float32) -> bool:
    """Shapes K13 takes: float32, N <= 128, F <= 2 (G in registers as in
    K1, and ``wrap_smem_bytes``, 140,032 bytes at F = 2, N = 128, within a
    block's shared memory)."""
    return (dtype == torch.float32 and 1 <= N <= MAX_N and F in (1, 2)
            and wrap_smem_bytes(N, F) <= _build.SMEM_PER_BLOCK)


def _decide(diag, s, u_i, *, lamb, signs, det_power, use_boson):
    """Metropolis decision of one site for every chain from the flavors'
    current diagonal entries diag[f] (C,), the site's field s (C,) in G's
    dtype and its uniforms u_i (C,). Returns (accept, detratio, x) with
    x[f] = delta_f / r_f where accepted, else 0."""
    dEb = s * (-2.0 * lamb)
    deltas, rs, rprod = [], [], None
    for f, sg in enumerate(signs):
        delta = torch.exp(dEb * sg) - 1.0
        r = 1.0 + delta * (1.0 - diag[f])
        deltas.append(delta)
        rs.append(r)
        rprod = r if rprod is None else rprod * r
    detratio = rprod
    for _ in range(det_power - 1):
        detratio = detratio * rprod
    w = torch.exp(-dEb) if use_boson else 1.0
    accept = u_i < w * detratio
    x = [torch.where(accept, d / r, 0.0) for d, r in zip(deltas, rs)]
    return accept, detratio, x


def empty_neg(C, dtype, device):
    """Negative-weight statistics (C, 3) of no proposal: min +inf, max
    -inf, sum 0."""
    return torch.tensor([float("inf"), float("-inf"), 0.0], dtype=dtype,
                        device=device).repeat(C, 1)


def neg_push(neg, detratio):
    """Fold one site's detratios (C,) into the per-chain statistics neg
    (C, 3): min, max and sum of log10|detratio| over the negative ones, with
    |detratio| floored at 1e-38 (the JAX package's _push_mag)."""
    lv = torch.log10(detratio.abs().clamp_min(1e-38))
    m = detratio < 0
    return torch.stack([torch.where(m, torch.minimum(neg[:, 0], lv), neg[:, 0]),
                        torch.where(m, torch.maximum(neg[:, 1], lv), neg[:, 1]),
                        neg[:, 2] + torch.where(m, lv, 0.0)], dim=1)


def _xig(x, col, i):
    """x (e_i - col) for every chain: x (C,), col (C, N)."""
    ig = -col
    ig[:, i] += 1.0
    return x[:, None] * ig


def site_sweep_plain(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """Plain PyTorch site sweep, batched over chains (any N, any float type).

    G: (C, F, N, N), sigma: (C, N) int8 ±1, u: (C, N) uniforms in G's dtype.
    Returns new (G, sigma, acc (C,) int32, nneg (C,) int32, neg (C, 3)):
    neg holds the negative-weight statistics in G's dtype (``neg_push``);
    the inputs are not modified."""
    C, F, N, _ = G.shape
    kw = dict(lamb=lamb, signs=signs, det_power=det_power, use_boson=use_boson)
    G = G.clone()
    sigma = sigma.clone()
    acc = torch.zeros(C, dtype=torch.int32, device=G.device)
    nneg = torch.zeros(C, dtype=torch.int32, device=G.device)
    neg = empty_neg(C, G.dtype, G.device)
    for i in range(N):
        accept, detratio, x = _decide([G[:, f, i, i] for f in range(F)],
                                      sigma[:, i].to(G.dtype), u[:, i], **kw)
        rows = [G[:, f, i, :].clone() for f in range(F)]
        cols = [G[:, f, :, i].clone() for f in range(F)]
        for f in range(F):
            xig = _xig(x[f], cols[f], i)
            G[:, f] -= xig[:, :, None] * rows[f][:, None, :]
        sigma[:, i] = torch.where(accept, -sigma[:, i], sigma[:, i])
        acc += accept
        nneg += detratio < 0
        neg = neg_push(neg, detratio)
    return G, sigma, acc, nneg, neg


def site_sweep_pair_plain(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """Plain PyTorch version of K5, the delay-2 paired-site sweep (even N,
    any float type); same arguments as ``site_sweep_plain``, and its first
    four results, bit-equal to them.

    Per pair of sites (i, j = i+1): site i is decided from the current G;
    site j's row, column and diagonal are corrected from site i's rank-1
    terms exactly as the sequential update would change them,
      row'_j = G[j, :] - xIG_i[j] * row_i,  col'_j = G[:, j] - xIG_i * row_i[j],
    site j is decided from them, and both updates are applied together:
      G <- (G - xIG_i ⊗ row_i) - xIG_j ⊗ row'_j."""
    C, F, N, _ = G.shape
    if N % 2:
        raise ValueError(f"site_sweep_pair: N={N} is odd")
    kw = dict(lamb=lamb, signs=signs, det_power=det_power, use_boson=use_boson)
    G = G.clone()
    sigma = sigma.clone()
    acc = torch.zeros(C, dtype=torch.int32, device=G.device)
    nneg = torch.zeros(C, dtype=torch.int32, device=G.device)
    for i in range(0, N, 2):
        j = i + 1
        acc_i, det_i, x_i = _decide([G[:, f, i, i] for f in range(F)],
                                    sigma[:, i].to(G.dtype), u[:, i], **kw)
        rows_i = [G[:, f, i, :].clone() for f in range(F)]
        xig_i = [_xig(x_i[f], G[:, f, :, i], i) for f in range(F)]
        rows_j = [G[:, f, j, :] - xig_i[f][:, j, None] * rows_i[f]
                  for f in range(F)]
        cols_j = [G[:, f, :, j] - xig_i[f] * rows_i[f][:, j, None]
                  for f in range(F)]
        acc_j, det_j, x_j = _decide([rows_j[f][:, j] for f in range(F)],
                                    sigma[:, j].to(G.dtype), u[:, j], **kw)
        for f in range(F):
            xig_j = _xig(x_j[f], cols_j[f], j)
            G[:, f] -= xig_i[f][:, :, None] * rows_i[f][:, None, :]
            G[:, f] -= xig_j[:, :, None] * rows_j[f][:, None, :]
        for idx, accept, detratio in ((i, acc_i, det_i), (j, acc_j, det_j)):
            sigma[:, idx] = torch.where(accept, -sigma[:, idx], sigma[:, idx])
            acc += accept
            nneg += detratio < 0
    return G, sigma, acc, nneg


def wrap_plain(G, sigma, Ml, Mr, *, lamb, signs, wrap_dir):
    """K13's wrap of G (C, F, N, N) with the field sigma (C, N), in K13's
    association and rounding: with ev = exp(lamb·sg·sigma) and evinv =
    exp(-lamb·sg·sigma) per flavor,
      wrap_dir = +1:  G <- Ml · ((ev ⊙_row G ⊙_col evinv) · Mr),
      wrap_dir = -1:  G <- evinv ⊙_row (Ml · (G · Mr)) ⊙_col ev.
    lamb·sg is ±lamb exactly, so each factor is exp(±lamb·sigma) rounded
    once, as the TPU kernel's exp(float32(power·lamb·sg)·sigma)."""
    s = sigma.to(G.dtype)
    out = []
    for f, sg in enumerate(signs):
        ev = torch.exp(s * (lamb * sg))
        evinv = torch.exp(s * (-lamb * sg))
        g = G[:, f]
        if wrap_dir > 0:
            g = (g * ev[:, :, None]) * evinv[:, None, :]
        g = Ml @ (g @ Mr)
        if wrap_dir < 0:
            g = (g * evinv[:, :, None]) * ev[:, None, :]
        out.append(g)
    return torch.stack(out, dim=1)


def site_sweep_wrap_plain(G, sigma, u, Ml, Mr, *, lamb, signs, det_power,
                          use_boson, wrap_dir):
    """Plain PyTorch version of K13 (any N, any float type): the wrap
    (``wrap_plain``) before the sweep with the pre-update sigma (wrap_dir =
    -1) or after it with the post-update sigma (+1) around
    ``site_sweep_plain``. Ml, Mr (N, N): (exp(-dtau T), exp(+dtau T)) for
    +1, (exp(+dtau T), exp(-dtau T)) for -1. Returns (G, sigma, acc, nneg)."""
    if wrap_dir not in (1, -1):
        raise ValueError(f"wrap_dir must be +1 or -1, got {wrap_dir!r}")
    wkw = dict(lamb=lamb, signs=signs, wrap_dir=wrap_dir)
    if wrap_dir < 0:
        G = wrap_plain(G, sigma, Ml, Mr, **wkw)
    G, sigma, acc, nneg, _ = site_sweep_plain(
        G, sigma, u, lamb=lamb, signs=signs, det_power=det_power,
        use_boson=use_boson)
    if wrap_dir > 0:
        G = wrap_plain(G, sigma, Ml, Mr, **wkw)
    return G, sigma, acc, nneg


def site_sweep(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """Site sweep of one time slice for every chain: the float32 CUDA kernel
    for a CUDA tensor, ``site_sweep_plain`` for a CPU tensor. Same arguments
    and results as ``site_sweep_plain`` without the negative-weight
    statistics (the first four); on CUDA, G must be float32
    (C, F, N, N) with ``kernel_supports(N, F)``, sigma int8 (C, N) and u
    float32 (C, N), all contiguous on one device."""
    return _sweep("site_sweep", site_sweep, G, sigma, u, lamb=lamb,
                  signs=signs, det_power=det_power, use_boson=use_boson)


def site_sweep_f64(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """``site_sweep`` in float64: the float64 CUDA kernel for a CUDA tensor
    (G and u float64, ``kernel_supports(N, F, torch.float64)``),
    ``site_sweep_plain`` for a CPU tensor. Both also return the
    negative-weight statistics (C, 3) float64: the same five results as
    ``site_sweep_plain``."""
    return _sweep("site_sweep_f64", site_sweep_f64, G, sigma, u, lamb=lamb,
                  signs=signs, det_power=det_power, use_boson=use_boson)


def site_sweep_pair(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """``site_sweep`` two sites at a time: K5 for a CUDA tensor (G and u
    float32, ``pair_supports(N, F)``: even N), ``site_sweep_pair_plain``
    for a CPU tensor. Bit-equal to ``site_sweep``."""
    return _sweep("site_sweep_pair", site_sweep_pair, G, sigma, u, lamb=lamb,
                  signs=signs, det_power=det_power, use_boson=use_boson)


def site_sweep_single(G, sigma, u, *, lamb, signs, det_power, use_boson):
    """The site sweep of ONE chain (kernel K12, the JAX package's
    site_sweep_pallas): G (F, N, N), sigma (N,) ±1 of any integer dtype, u
    (N,). K1's launch at C = 1 for a CUDA tensor (float32,
    ``kernel_supports(N, F)``), ``site_sweep_plain`` for a CPU tensor.
    Returns (G, sigma in sigma's dtype, acc, nneg), acc and nneg 0-d int32."""
    out = _sweep("site_sweep_single", site_sweep_single, G[None],
                 sigma.to(torch.int8)[None], u[None], lamb=lamb, signs=signs,
                 det_power=det_power, use_boson=use_boson)
    return out[0][0], out[1][0].to(sigma.dtype), out[2][0], out[3][0]


def site_sweep_wrap(G, sigma, u, Ml, Mr, *, lamb, signs, det_power,
                    use_boson, wrap_dir):
    """The site sweep with the slice's wrap fused in (kernel K13): the CUDA
    kernel for a CUDA tensor, ``site_sweep_wrap_plain`` for a CPU tensor.
    Same arguments and results; on CUDA, G float32 (C, F, N, N) with
    ``wrap_supports(N, F)``, sigma int8 (C, N), u float32 (C, N), Ml and Mr
    float32 (N, N), all contiguous on one device."""
    kw = dict(lamb=lamb, signs=signs, det_power=det_power,
              use_boson=use_boson)
    if G.device.type == "cpu":
        return site_sweep_wrap_plain(G, sigma, u, Ml, Mr, wrap_dir=wrap_dir,
                                     **kw)
    if wrap_dir not in (1, -1):
        raise ValueError(f"wrap_dir must be +1 or -1, got {wrap_dir!r}")
    N = G.shape[-1]
    for M in (Ml, Mr):
        if (M.dtype != torch.float32 or tuple(M.shape) != (N, N)
                or M.device != G.device or not M.is_contiguous()):
            raise ValueError("site_sweep_wrap: Ml and Mr must be contiguous "
                             f"float32 ({N}, {N}) on G's device")
    return _sweep("site_sweep_wrap", site_sweep_wrap, G, sigma, u,
                  ptrs=(Ml.data_ptr(), Mr.data_ptr()), ints=(int(wrap_dir),),
                  **kw)


site_sweep.launches = 0
site_sweep_f64.launches = 0
site_sweep_pair.launches = 0
site_sweep_single.launches = 0
site_sweep_wrap.launches = 0

# per wrapper: the C entry point, its element type, the shapes it takes and
# what they are, and the plain version a CPU tensor runs
_ENTRY = {
    "site_sweep": ("site_sweep_f32", torch.float32, kernel_supports,
                   f"N <= {MAX_N}, F in (1, 2)", site_sweep_plain),
    "site_sweep_f64": ("site_sweep_f64", torch.float64, kernel_supports,
                       f"N <= {MAX_N}, F in (1, 2)", site_sweep_plain),
    "site_sweep_pair": ("site_sweep_pair_f32", torch.float32, pair_supports,
                        f"even N <= {MAX_N}, F in (1, 2)",
                        site_sweep_pair_plain),
    "site_sweep_single": ("site_sweep_f32", torch.float32, kernel_supports,
                          f"N <= {MAX_N}, F in (1, 2)", site_sweep_plain),
    "site_sweep_wrap": ("site_sweep_wrap_f32", torch.float32, wrap_supports,
                        f"N <= {MAX_N}, F in (1, 2)", site_sweep_wrap_plain)}


def _sweep(name, fn, G, sigma, u, ptrs=(), ints=(), **kw):
    """Launch the kernel of wrapper fn (entry point and dtype from _ENTRY)
    on a CUDA tensor, or run its plain version on a CPU one. The float64
    wrapper returns the negative-weight statistics as a fifth result, the
    float32 ones four results. ptrs (after nneg) and ints (after use_boson)
    are K13's wrap operands and direction."""
    entry, dtype, supports, limits, plain = _ENTRY[name]
    f64 = dtype == torch.float64
    if G.device.type == "cpu":
        return plain(G, sigma, u, **kw)[:5 if f64 else 4]
    signs = kw["signs"]
    C, F, N = _check(name, dtype, supports, limits, G, sigma, u, signs)
    G_out = torch.empty_like(G)
    sigma_out = torch.empty_like(sigma)
    acc = torch.empty(C, dtype=torch.int32, device=G.device)
    nneg = torch.empty(C, dtype=torch.int32, device=G.device)
    # K1 in float64 writes the statistics
    neg = torch.empty(C, 3, dtype=dtype, device=G.device) if f64 else None
    extra = (neg.data_ptr(),) if f64 else ptrs
    with torch.cuda.device(G.device):
        code = getattr(_build.load(), entry)(
            G.data_ptr(), G_out.data_ptr(), sigma.data_ptr(),
            sigma_out.data_ptr(), u.data_ptr(), acc.data_ptr(),
            nneg.data_ptr(), *extra, C, F, N, float(kw["lamb"]),
            float(signs[0]), float(signs[-1]), int(kw["det_power"]),
            int(bool(kw["use_boson"])), *ints,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, code)
    fn.launches += 1
    return (G_out, sigma_out, acc, nneg) + ((neg,) if f64 else ())


def _check(name, dtype, supports, limits, G, sigma, u, signs):
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
    if not supports(N, F, dtype) or len(signs) != F:
        raise ValueError(f"{name}: no CUDA kernel for N={N}, F={F} "
                         f"({limits})")
    if tuple(sigma.shape) != (C, N) or tuple(u.shape) != (C, N):
        raise ValueError(f"{name}: sigma and u must be (C, N)")
    for t in (G, sigma, u):
        if t.device != G.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one "
                             "device")
    return C, F, N
