"""Time-displaced Green's functions (counterpart of
montecarlo_tpu/dqmc/unequal_time.py), batched over chains.

G(k, l) comes from three stabilized UDT blocks: forward B(l..1), backward
B(M..k+1)^†, and the inverse chain B^{-1}(l+1..k), combined with the
Dmax/Dmin splitting algebra that keeps both huge and tiny scales in diagonal
factors. Every function takes the HS field conf (C, N, M) of all chains and
returns (C, F, N, N) Green's functions (UDT triples: U, T (C, F, N, N), D
(C, F, N)); the slice and segment schedules are static Python loops, the
same for every chain.

Index conventions (0-based slice matrices B_0..B_{M-1}, τ gridpoints 0..M):
  forward(k)  = UDT(B_{k-1} ⋯ B_0)
  backward(k) = UDT(B_k^† ⋯ B_{M-1}^†)        (so B_{M-1}⋯B_k = T† D U†)
  inv(l→k)    = UDT(B_l^{-1} B_{l+1}^{-1} ⋯ B_{k-1}^{-1})
  G(k, l), k ≥ l:  [inv(l→k) + forward(l)·(B_{M-1}⋯B_k)]^{-1}   — full1
  G(k, l), k < l:  -[B_{l-1}⋯B_k + (forward(k)·backward(l)-prod)^{-1}]^{-1}

``build_ut_stacks`` builds the forward / backward / cumulative-inverse UDT
stacks once (O(M/sm) UDTs), and the iterators read them:
  combined_greens_apply — (G(0,l), G(l,0), G(l,l)) for l = 1..M, fused with
      measurement accumulation
  greens_range_apply    — G(k, l) for k = l..M at fixed l
Both have three tiers — quick advance / safe_mult stabilization / full
recalculation every ``recalculate`` slices — and an accuracy self-check
against the direct computation (``combined_accuracy``,
``greens_range_accuracy``).

Every UDT is ``ops.linalg.udt_dirty`` on the session's route (``core.udt``),
and every equal-time recalculation ``calculate_greens`` with
``ctx.greens_udt_fn``: in float32 at 8 | N <= 64 on the card, kernels K2
and K3. Every product runs at full float32 precision: make_context turns
TF32 off (the JAX package measured pairing susceptibilities of ~4e6 at
beta = 10 in float32 without full-precision products).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from ..ops.linalg import calculate_greens, rdiv_dirty, scatter_columns
from . import core


def _restab(ctx, curr, D, T):
    """Re-UDT (curr · diag(D)) and fold its triangular factor into T."""
    u, d, r, piv = core.udt(ctx, curr * D[..., None, :])
    return u, d, scatter_columns(r, piv) @ T


def _udt_full(ctx, A):
    u, d, r, piv = core.udt(ctx, A)
    return u, d, scatter_columns(r, piv)


def forward_block(ctx, consts, conf, k: int):
    """UDT(B_{k-1}...B_0), re-decomposed every safe_mult slices."""
    return core.udt_of_product(ctx, consts, conf, range(k), core.mult_B_left)


def backward_block(ctx, consts, conf, k: int):
    """UDT(B_k^†...B_{M-1}^†), re-decomposed every safe_mult slices."""
    return core.udt_of_product(ctx, consts, conf, range(ctx.M - 1, k - 1, -1),
                               core.mult_B_dagger_left)


def inverse_block(ctx, consts, conf, low: int, high: int):
    """UDT(B_low^{-1} B_{low+1}^{-1} ⋯ B_{high-1}^{-1}), built right to left
    so that the accumulated factor stays a left unitary."""
    return core.udt_of_product(ctx, consts, conf, range(high - 1, low - 1, -1),
                               core.mult_B_inv_left)


def _dmax_inv(D):
    return 1.0 / D.clamp_min(1.0)


def _dmin(D):
    return D.clamp_max(1.0)


# ---------------------------------------------------------------------------
# full1 / full2 Dmax/Dmin-split algebra on UDT triples
# ---------------------------------------------------------------------------

def full1_algebra(ctx, inv_udt, fwd_udt, bwd_udt):
    """G(k≥l) = [inv(l→k) + forward(l)·(backward(k)-product)]^{-1} from the
    three UDT triples."""
    U, D, T = inv_udt
    Ul, Dl, Tl = fwd_udt
    Ur, Dr, Tr = bwd_udt
    # inner = Dl (Tl Tr†) Dr ; udt
    M_ = Tl @ Tr.mH
    M_ = M_ * Dr[..., None, :]
    M_ = M_ * Dl[..., :, None]
    u1, d1, g1, p1 = core.udt(ctx, M_)
    Tl2 = Ul @ u1
    Ur2 = rdiv_dirty(Ur, g1, p1)
    # [U D T + Tl2 d1 Ur2^†-ish]^{-1} with the D split:
    Tr3 = (_dmax_inv(D)[..., :, None] * (U.mH @ Tl2)) * _dmin(d1)[..., None, :]
    Tl3 = (_dmin(D)[..., :, None] * (T @ Ur2)) * _dmax_inv(d1)[..., None, :]
    u2, d2, g2, p2 = core.udt(ctx, Tl3 + Tr3)
    # G = Ur2 · diag(1/max(1,d1)) · t2^{-1} · diag(1/d2) · u2† · diag(1/max(1,D)) · U†
    n = g2.shape[-1]
    X = torch.eye(n, dtype=g2.dtype, device=g2.device) * _dmax_inv(d1)[..., :, None]
    X = rdiv_dirty(X, g2, p2)
    X = X / d2[..., None, :]
    X = X @ u2.mH
    X = X * _dmax_inv(D)[..., None, :]
    return Ur2 @ (X @ U.mH)


def full2_algebra(ctx, inv_udt, fwd_udt, bwd_udt):
    """G(k<l) = -[B_{l-1}⋯B_k + (forward(k)·backward(l)-prod)^{-1}]^{-1} from
    UDT triples: inv_udt = inv(k→l), fwd_udt = forward(k), bwd_udt =
    backward(l)."""
    U, D, T = inv_udt
    Ul, Dl, Tl = fwd_udt
    Ur, Dr, Tr = bwd_udt
    M_ = Tl @ Tr.mH
    M_ = Dl[..., :, None] * M_
    M_ = M_ * Dr[..., None, :]
    u1, d1, g1, p1 = core.udt(ctx, M_)
    Tl2 = Ul @ u1
    Ul3 = (_dmax_inv(D)[..., :, None] * (U.mH @ Tl2)) * _dmin(d1)[..., None, :]
    Y = rdiv_dirty(T @ Ur, g1, p1)
    Tr3 = (_dmin(D)[..., :, None] * Y) * _dmax_inv(d1)[..., None, :]
    u2, d2, g2, p2 = core.udt(ctx, Tr3 + Ul3)
    n = g2.shape[-1]
    X = torch.eye(n, dtype=g2.dtype, device=g2.device) * _dmin(d1)[..., :, None]
    X = rdiv_dirty(X, g2, p2)
    X = X / d2[..., None, :]
    X = X @ u2.mH
    X = X * _dmin(D)[..., None, :]
    return -(Tl2 @ (X @ T))


def greens_kl(ctx, consts, conf, k: int, l: int):
    """Effective time-displaced G(k ← l) (C, F, N, N) for gridpoints
    0 ≤ k, l ≤ M, the three blocks built from scratch: accurate, O(M) work
    (the iterators below amortize it through the precomputed stacks)."""
    if k >= l:
        inv = inverse_block(ctx, consts, conf, l, k)
        fwd = forward_block(ctx, consts, conf, l)
        bwd = backward_block(ctx, consts, conf, k)
        return full1_algebra(ctx, inv, fwd, bwd)
    inv = inverse_block(ctx, consts, conf, k, l)
    fwd = forward_block(ctx, consts, conf, k)
    bwd = backward_block(ctx, consts, conf, l)
    return full2_algebra(ctx, inv, fwd, bwd)


def greens_kl_udts(ctx, k: int, l: int):
    """The number of ``udt_dirty`` calls of one ``greens_kl(k, l)``: one per
    safe_mult slices begun in each of its three blocks, and two in the
    full1 / full2 algebra."""
    blocks = (abs(k - l), min(k, l), ctx.M - max(k, l))
    return sum(-(-n // ctx.sm) for n in blocks) + 2


# ---------------------------------------------------------------------------
# precomputed UDT stacks
# ---------------------------------------------------------------------------

def _segment_product(ctx, consts, conf, j, mult_fn, rev: bool):
    """Dense product of segment j's slice operators: mult_fn applied to the
    identity for s = 0..sm-1 (rev=False) or s = sm-1..0 (rev=True)."""
    curr = core._identity_udt(ctx, conf.shape[0])[0]
    order = range(ctx.sm - 1, -1, -1) if rev else range(ctx.sm)
    for s in order:
        curr = mult_fn(ctx, consts, conf[:, :, j * ctx.sm + s], curr)
    return curr


def build_ut_stacks(ctx, consts, conf):
    """All three UDT stacks as lists of n_el (U, D, T) triples, j = 0..n_seg:

      fwd[j] = UDT(B_{j·sm-1} ⋯ B_0)            (fwd[0] = I)
      bwd[j] = UDT(B_{j·sm}^† ⋯ B_{M-1}^†)      (bwd[n_seg] = I)
      inv[j] = UDT(B_0^{-1} ⋯ B_{j·sm-1}^{-1})  (cumulative; inv[0] = I)

    n_seg segment extensions each; the iterators only ever need
    inv(0→boundary), so the inverse is kept cumulative."""
    n_seg = ctx.n_seg
    ident = core._identity_udt(ctx, conf.shape[0])

    fwd = [ident]
    for j in range(n_seg):
        U, D, T = fwd[-1]
        curr = _segment_product(ctx, consts, conf, j, core.mult_B_left,
                                rev=False) @ U
        fwd.append(_restab(ctx, curr, D, T))

    bwd = [ident]
    for j in range(n_seg - 1, -1, -1):
        U, D, T = bwd[-1]
        curr = _segment_product(ctx, consts, conf, j, core.mult_B_dagger_left,
                                rev=True) @ U
        bwd.append(_restab(ctx, curr, D, T))
    bwd.reverse()

    # C_{j+1} = C_j · (B_{j·sm}^{-1} ⋯ B_{(j+1)·sm-1}^{-1}) as a right
    # extension: C·P = U · [(D (T P)) = u d t] → (U u) d t
    inv = [ident]
    for j in range(n_seg):
        U, D, T = inv[-1]
        P = _segment_product(ctx, consts, conf, j, core.mult_B_inv_left,
                             rev=True)
        u, d, r, piv = core.udt(ctx, D[..., :, None] * (T @ P))
        inv.append((U @ u, d, scatter_columns(r, piv)))

    return {"fwd": fwd, "bwd": bwd, "inv": inv}


def _check_recalculate(ctx, recalculate):
    """recalculate (default safe_mult) over safe_mult: the boundaries between
    full recalculations."""
    if recalculate is None:
        recalculate = ctx.sm
    if recalculate % ctx.sm:
        raise ValueError(f"recalculate={recalculate} must be a multiple of "
                         f"safe_mult={ctx.sm}")
    return recalculate // ctx.sm


def _compose(F):
    U, D, T = F
    return (U * D[..., None, :]) @ T


# ---------------------------------------------------------------------------
# combined iterator
# ---------------------------------------------------------------------------

def combined_greens_apply(ctx, consts, conf, G00_eff, acc0, step_fn: Callable,
                          recalculate: int = None, stacks=None):
    """Iterate (G(0,l), G(l,0), G(l,l)) for l = 1..M over every chain,
    calling ``acc = step_fn(acc, G0l, Gl0, Gll)`` with the *physical*
    (unwrapped) Green's functions (C, F, N, N) at each step; no (M, N, N)
    history is kept.

    Tiers per slice: l % recalculate == 0 → full recomputation from the
    precomputed stacks; l % safe_mult == 0 → advance + re-UDT
    stabilization; otherwise a quick advance. Default recalculate =
    safe_mult (a recalculation reads the stacks and costs about what a
    stabilization does; the Gll similarity advance amplifies factor errors
    ~2-3x per slice at U = 4, so long windows lose accuracy).

    Recurrences on the effective Green's functions:
      Gl0(l) = B_l Gl0(l-1),   Gl0(0) = G00
      G0l(l) = G0l(l-1) B_l^{-1},   G0l(0) = G00 - I
      Gll(l) = B_l Gll(l-1) B_l^{-1},  Gll(0) = G00
    """
    sm = ctx.sm
    c = _check_recalculate(ctx, recalculate)
    if stacks is None:
        stacks = build_ut_stacks(ctx, consts, conf)
    unwrap = partial(core.unwrap_greens, ctx, consts)
    ident = core._identity_udt(ctx, conf.shape[0])

    def advance(factors, l):
        """Multiply B_l into all three factor sets (slice matrix l-1)."""
        (lU, lD, lT), (rU, rD, rT), (gU, gD, gT) = factors
        sigma = conf[:, :, l - 1]
        lU = core.mult_B_left(ctx, consts, sigma, lU)
        rT = core.mult_B_inv_right(ctx, consts, sigma, rT)
        gU = core.mult_B_left(ctx, consts, sigma, gU)
        gT = core.mult_B_inv_right(ctx, consts, sigma, gT)
        return (lU, lD, lT), (rU, rD, rT), (gU, gD, gT)

    def emit(acc, factors):
        lF, rF, gF = factors
        return step_fn(acc, unwrap(_compose(rF)), unwrap(_compose(lF)),
                       unwrap(_compose(gF)))

    def stabilize(factors):
        """Re-UDT all three factor sets."""
        (lU, lD, lT), (rU, rD, rT), (gU, gD, gT) = factors
        lF = _restab(ctx, lU, lD, lT)
        # G0l: re-UDT from the right side: (diag(rD) rT) = u d t
        u, d, r_, piv = core.udt(ctx, rD[..., :, None] * rT)
        rF = (rU @ u, d, scatter_columns(r_, piv))
        # Gll: two-sided re-UDT — gT accumulates B^{-1} scales on the right,
        # so a left-only restab loses them
        u1, d1_, r1, p1 = core.udt(ctx, gU * gD[..., None, :])
        T1 = scatter_columns(r1, p1) @ gT
        u2, d2_, r2, p2 = core.udt(ctx, d1_[..., :, None] * T1)
        gF = (u1 @ u2, d2_, scatter_columns(r2, p2))
        return lF, rF, gF

    def recalc(jb):
        """Fresh (Gl0, G0l, Gll) at boundary slice l = jb·sm from the stacks:
        full1/full2 with forward(0) = I, and the equal-time G(l,l)."""
        inv, bwd, fwd = stacks["inv"][jb], stacks["bwd"][jb], stacks["fwd"][jb]
        Gl0 = full1_algebra(ctx, inv, ident, bwd)
        G0l = full2_algebra(ctx, inv, ident, bwd)
        Gll = calculate_greens(*fwd, *bwd, ctx.use_kernels, ctx.greens_udt_fn)
        return Gl0, G0l, Gll

    eye = ident[0]
    factors = (_udt_full(ctx, G00_eff), _udt_full(ctx, G00_eff - eye),
               _udt_full(ctx, G00_eff))
    acc = acc0
    for j in range(ctx.n_seg):
        for t in range(1, sm):                  # quick advances
            factors = advance(factors, j * sm + t)
            acc = emit(acc, factors)
        jb = j + 1                              # boundary l = jb·sm
        if jb % c == 0:
            Gl0, G0l, Gll = recalc(jb)
            acc = step_fn(acc, unwrap(G0l), unwrap(Gl0), unwrap(Gll))
            factors = (_udt_full(ctx, Gl0), _udt_full(ctx, G0l),
                       _udt_full(ctx, Gll))
        else:
            factors = stabilize(advance(factors, jb * sm))
            acc = emit(acc, factors)
    return acc


def combined_udt_launches(ctx, recalculate: int = None):
    """(udt, greens): the number of ``udt_dirty`` and ``calculate_greens``
    calls of one ``combined_greens_apply`` with its own stacks, from the
    schedule alone: the stacks 3·n_seg, the initial factors 3, per
    recalculation 7 and one ``calculate_greens``, per stabilization 4. On the
    card in float32 at 8 | N <= 64 they are K2's and K3's launches."""
    c = _check_recalculate(ctx, recalculate)
    n_recalc = ctx.n_seg // c
    n_stab = ctx.n_seg - n_recalc
    return 3 * ctx.n_seg + 3 + 7 * n_recalc + 4 * n_stab, n_recalc


def _accuracy_points(ctx, recalculate, lo, hi):
    """Sample points for the accuracy self-checks: the slice before each
    tier transition (worst accumulated drift), the transition itself, and
    the ends of the range."""
    pts = set()
    for l in range(lo, hi + 1):
        if l % recalculate in (0, recalculate - 1) or l % ctx.sm == 0:
            pts.add(l)
    pts.update((lo, lo + 1, hi - 1, hi))
    return sorted(p for p in pts if lo <= p <= hi)


def _max_err(A, B):
    """Per-chain max |A - B| over (C, F, N, N)."""
    return (A - B).abs().flatten(1).amax(1)


def combined_accuracy(ctx, consts, conf, G00_eff, recalculate: int = None):
    """Per-chain (C,) max |iterator − direct| over sampled l for each of
    (G0l, Gl0, Gll), the direct values from ``greens_kl``; the sampling
    covers the worst slices of every tier window (``_accuracy_points``)."""
    rec = recalculate if recalculate is not None else ctx.sm
    points = _accuracy_points(ctx, rec, 1, ctx.M)
    unwrap = partial(core.unwrap_greens, ctx, consts)
    direct = {l: (unwrap(greens_kl(ctx, consts, conf, 0, l)),
                  unwrap(greens_kl(ctx, consts, conf, l, 0)),
                  unwrap(greens_kl(ctx, consts, conf, l, l)))
              for l in points}

    def step(acc, G0l, Gl0, Gll):
        err, l = acc
        if l in direct:
            d0, d1, d2 = direct[l]
            err = torch.maximum(err, torch.maximum(_max_err(G0l, d0), torch.maximum(
                _max_err(Gl0, d1), _max_err(Gll, d2))))
        return err, l + 1

    err0 = torch.zeros(conf.shape[0], dtype=ctx.rdtype, device=ctx.device)
    err, _ = combined_greens_apply(ctx, consts, conf, G00_eff, (err0, 1),
                                   step, recalculate=rec)
    return err


def verify_combined(ctx, consts, conf, G00_eff, maxerror=1e-6,
                    recalculate: int = None) -> bool:
    """Every chain's ``combined_accuracy`` below maxerror."""
    return bool((combined_accuracy(ctx, consts, conf, G00_eff,
                                   recalculate=recalculate) < maxerror).all())


# ---------------------------------------------------------------------------
# general iterator
# ---------------------------------------------------------------------------

def greens_range_apply(ctx, consts, conf, l: int, acc0, step_fn: Callable,
                       recalculate: int = None, stacks=None):
    """All G(k, l) for k = l..M at fixed l, calling
    ``acc = step_fn(acc, k, G_kl)`` with the *physical* G (C, F, N, N) at
    each k.

    Tiers per k: k % recalculate == 0 → fresh full1 from the precomputed
    stacks; k % safe_mult == 0 → advance + re-UDT; else quick advance.
    Advancing k multiplies B_k into the U factor: G(k+1, l) = B_{k+1}
    G(k, l). The recalculation tier needs inv(l→k), kept as a fourth,
    right-extended UDT carry re-decomposed at every boundary."""
    sm, M = ctx.sm, ctx.M
    c = _check_recalculate(ctx, recalculate)
    if stacks is None:
        stacks = build_ut_stacks(ctx, consts, conf)
    unwrap = partial(core.unwrap_greens, ctx, consts)
    ident = core._identity_udt(ctx, conf.shape[0])

    # k = l start: G(l,l) via full1(l, l)
    fwd_l = forward_block(ctx, consts, conf, l)
    bwd_l = backward_block(ctx, consts, conf, l)
    G = full1_algebra(ctx, ident, fwd_l, bwd_l)
    acc = step_fn(acc0, l, unwrap(G))
    gF = _udt_full(ctx, G)
    invF = ident                      # inv(l→l) = I

    def advance_k(gF, invF, k):
        """k → k+1: left-multiply B_{k+1} into G's U factor; right-extend the
        inverse carry with B_k^{-1} (0-based slice matrix index k)."""
        gU, gD, gT = gF
        iU, iD, iT = invF
        sigma = conf[:, :, k]
        gU = core.mult_B_left(ctx, consts, sigma, gU)
        iT = core.mult_B_inv_right(ctx, consts, sigma, iT)
        return (gU, gD, gT), (iU, iD, iT)

    def restab_inv(invF):
        iU, iD, iT = invF
        u, d, r_, piv = core.udt(ctx, iD[..., :, None] * iT)
        return iU @ u, d, scatter_columns(r_, piv)

    def emit(acc, k, gF):
        return step_fn(acc, k, unwrap(_compose(gF)))

    # advance within the first (possibly partial) segment up to the first
    # boundary k = ceil(l/sm)*sm
    first_boundary = min(((l // sm) + (1 if l % sm else 0)) * sm, M)
    if l % sm == 0 and l < M:
        first_boundary = l  # already on a boundary; the segments do the rest
    for k in range(l, first_boundary):
        gF, invF = advance_k(gF, invF, k)
        acc = emit(acc, k + 1, gF)
        if (k + 1) % sm == 0 or k + 1 == M:
            gF = _restab(ctx, *gF)
            invF = restab_inv(invF)

    for j in range(first_boundary // sm, ctx.n_seg):
        for t in range(sm - 1):
            k = j * sm + t            # slice matrix index being applied
            gF, invF = advance_k(gF, invF, k)
            acc = emit(acc, k + 1, gF)
        jb = j + 1                    # boundary step to k = jb·sm
        gF, invF = advance_k(gF, invF, jb * sm - 1)
        if jb % c == 0 and jb * sm != l:
            # stabilize the inverse carry first, then a fresh full1
            invF = restab_inv(invF)
            G = full1_algebra(ctx, invF, fwd_l, stacks["bwd"][jb])
            acc = step_fn(acc, jb * sm, unwrap(G))
            gF = _udt_full(ctx, G)
        else:
            gF = _restab(ctx, *gF)
            invF = restab_inv(invF)
            acc = emit(acc, jb * sm, gF)
    return acc


def greens_range_accuracy(ctx, consts, conf, l: int = 0,
                          recalculate: int = None):
    """Per-chain (C,) max |iterator − direct| over sampled k = l..M."""
    rec = recalculate if recalculate is not None else ctx.sm
    points = _accuracy_points(ctx, rec, l, ctx.M)
    unwrap = partial(core.unwrap_greens, ctx, consts)
    direct = {k: unwrap(greens_kl(ctx, consts, conf, k, l)) for k in points}

    def step(err, k, G):
        if k in direct:
            err = torch.maximum(err, _max_err(G, direct[k]))
        return err

    err0 = torch.zeros(conf.shape[0], dtype=ctx.rdtype, device=ctx.device)
    return greens_range_apply(ctx, consts, conf, l, err0, step,
                              recalculate=rec)


def verify_range(ctx, consts, conf, l: int = 0, maxerror=1e-6,
                 recalculate: int = None) -> bool:
    """Every chain's ``greens_range_accuracy`` below maxerror."""
    return bool((greens_range_accuracy(ctx, consts, conf, l,
                                       recalculate=recalculate)
                 < maxerror).all())
