"""Kernels K1-K3 and K5-K7 of the PyTorch/CUDA port (montecarlo_tpu_torch)
against the Pallas kernels they replace (the complex kernels K8 and K10 are
held in test_torch_complex.py), the wrappers' device rule and the build.

On the CPU each wrapper runs its kernel's plain PyTorch version; the Pallas
kernels run in interpret mode, as the JAX package's own tests run them. The
same numpy inputs go to both. Bounds are those of the JAX package's kernel
tests (test_pallas_matches_xla_sweep, test_fused_udt_*): decisions exact,
G within 1e-5, Q/Rs/X within 1e-5 of their largest entry, d to 1e-6
relative -- float32 sums taken in another order differ at that level.

The CUDA halves (each kernel against its plain version on the card) are in
test_torch_cuda.py.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops import pallas_qr
from montecarlo_tpu.ops import pallas_site_sweep as pss
from montecarlo_tpu_torch.ops import KERNELS, _build, qr, qr_blocked as qb
from montecarlo_tpu_torch.ops import qr_cx as qcx
from montecarlo_tpu_torch.ops import qr_householder as qh
from montecarlo_tpu_torch.ops import site_sweep as ss
from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
from torch_port_inputs import LAMB, MODELS, accept_patterns, pair_inputs
from torch_port_inputs import graded as _graded
from torch_port_inputs import sweep_inputs as _sweep_inputs


def _close(a, b, tol):
    """max|a - b| <= tol * max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b))
    assert err <= tol * np.max(np.abs(b)), (err, np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# K1: site sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,N", [("attractive", 16), ("repulsive", 16),
                                     ("attractive", 32)])
def test_site_sweep_matches_pallas(model, N):
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = _sweep_inputs(N + F, 3, F, N)
    Gj, sj, aj, nj = pss._site_sweep_batched(
        jnp.asarray(G), jnp.asarray(sigma, jnp.int32), jnp.asarray(u),
        _force_colread=True, _force_pair=False, **kw)
    Gt, st, at, nt = ss.site_sweep(torch.from_numpy(G), torch.from_numpy(sigma),
                                   torch.from_numpy(u), **kw)
    assert st.dtype == torch.int8
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert 0 < at.sum() < 3 * N                  # both branches exercised
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-5


def test_site_sweep_plain_leaves_inputs():
    G, sigma, u = _sweep_inputs(5, 2, 1, 8)
    Gt, st = torch.from_numpy(G.copy()), torch.from_numpy(sigma.copy())
    ss.site_sweep_plain(Gt, st, torch.from_numpy(u), lamb=LAMB,
                        **MODELS["attractive"])
    np.testing.assert_array_equal(Gt.numpy(), G)
    np.testing.assert_array_equal(st.numpy(), sigma)


def test_site_sweep_kernel_shapes():
    assert ss.kernel_supports(64, 1) and ss.kernel_supports(128, 2)
    assert not ss.kernel_supports(129, 1)
    assert not ss.kernel_supports(64, 3)
    f64 = torch.float64       # tiles of doubles; F = 2 past N = 64: flavor
    assert ss.kernel_supports(128, 1, f64) and ss.kernel_supports(64, 2, f64)
    assert ss.kernel_supports(119, 2, f64)    # 1 in shared memory
    assert ss.kernel_supports(120, 2, f64) and ss.kernel_supports(128, 2, f64)
    assert not ss.kernel_supports(129, 1, f64)
    assert not ss.kernel_supports(64, 1, torch.float16)


@pytest.mark.parametrize("F", [1, 2])
def test_tiled_kernels_take_every_earlier_shape(F):
    """K1 (float32 and float64), K5 and K8 take every (N, F) that G of one
    chain in shared memory took before the tiled layout (K1: F*N*(N+1) +
    2*F*N elements, K5: F*N*(N+1) + 4*F*N floats, K8: two planes and four
    staging vectors within one block's shared memory), with the layout the
    wrappers launch built and its shared memory within one block's."""
    f64 = torch.float64
    for N in range(1, 129):
        k1 = (F * N * (N + 1) + 2 * F * N) * 4 <= _build.SMEM_PER_BLOCK
        k1_64 = (F * N * (N + 1) + 2 * F * N) * 8 <= _build.SMEM_PER_BLOCK
        k5 = (N % 2 == 0 and N >= 2 and (F * N * (N + 1) + 4 * F * N) * 4
              <= _build.SMEM_PER_BLOCK)
        k8 = (2 * F * N * (N + 1) + 4 * F * N) * 4 <= _build.SMEM_PER_BLOCK
        assert ss.kernel_supports(N, F) >= k1, N
        assert ss.kernel_supports(N, F, f64) >= k1_64, N
        assert ss.pair_supports(N, F) >= k5, N
        assert sscx.kernel_supports(N, F) >= k8, N
        for cx in (False, True):
            assert ss.tiled_smem_bytes(N, F, cx) <= _build.SMEM_PER_BLOCK
            assert f"{ss.THREADS} threads" in ss.layout(N, F, cx)
        assert ss.tiled_smem_bytes(N, F, dtype=f64) <= _build.SMEM_PER_BLOCK
        assert f"{ss.THREADS} threads" in ss.layout(N, F, dtype=f64)
        assert ss.tiled_smem_bytes(N, F, sites=2) <= _build.SMEM_PER_BLOCK
    assert ss.kernel_supports(128, 2) and sscx.kernel_supports(119, 2)
    assert ss.kernel_supports(128, F, f64) and ss.pair_supports(128, F)


# hand-counted shared memory of one block (csrc/site_sweep_tiled.cuh::
# smem_bytes): K1 in float64 stages row and column per flavor in two
# buffers (4 F NP doubles), u (NP doubles), at F = 2, NP = 128 flavor 1
# (NP^2 doubles), and sigma in and out (2 NP bytes); K5 stages rows and
# columns i and j (8 F NP floats), u (NP floats) and sigma in and out
@pytest.mark.parametrize("N,F,f64_bytes,pair_bytes", [
    (64, 1, 8 * (4 * 64 + 64) + 2 * 64, 4 * (8 * 64 + 64) + 2 * 64),
    (128, 1, 8 * (4 * 128 + 128) + 2 * 128, 4 * (8 * 128 + 128) + 2 * 128),
    (64, 2, 8 * (8 * 64 + 64) + 2 * 64, 4 * (16 * 64 + 64) + 2 * 64),
    (128, 2, 8 * (8 * 128 + 128 + 128 * 128) + 2 * 128,
     4 * (16 * 128 + 128) + 2 * 128)])
def test_tiled_smem_mirror_hand_counted(N, F, f64_bytes, pair_bytes):
    assert ss.tiled_smem_bytes(N, F, dtype=torch.float64) == f64_bytes
    assert ss.tiled_smem_bytes(N, F, sites=2) == pair_bytes
    in_smem = "flavor 1 in shared memory" in ss.layout(N, F,
                                                       dtype=torch.float64)
    assert in_smem == (N == 128 and F == 2)
    assert "G in registers" in ss.layout(N, F)


def _tiled_geoms():
    """The layouts csrc/site_sweep_tiled.cuh launches: (TR, TC, RT, CT) of
    each Geom in its with_layout, in the order of NP."""
    import re
    src = (_build.CSRC_DIR / "site_sweep_tiled.cuh").read_text()
    body = src[src.index("int with_layout("):]
    body = body[:body.index("\n}\n")]
    return [tuple(map(int, m)) for m in re.findall(
        r"Geom<(\d+), (\d+), (\d+), (\d+)(?:, T)?>", body)]


def test_tiled_layouts_cover_g_once():
    """The kernels' layout at each padded N (32, 64, 128) has THREADS
    threads, and its threads' rows and columns (Geom::row, Geom::col:
    chunks of up to 16 bytes of consecutive indices, 4 floats or 2
    doubles) cover 0..NP-1 once each."""
    geoms = _tiled_geoms()
    assert [tr * rt for tr, _, rt, _ in geoms] == [
        ss.padded(n) for n in (32, 64, 128)]
    for tr, tc, rt, ct in geoms:
        np_, nt = tr * rt, tr * tc
        assert nt == ss.THREADS and tc * ct == np_
        for vw in (4, 2):
            for t, per, n in ((tr, rt, "rows"), (tc, ct, "cols")):
                w = min(per, vw)
                idx = sorted((k // w) * (t * w) + th * w + k % w
                             for th in range(t) for k in range(per))
                assert idx == list(range(np_)), (np_, nt, n, vw)


# ---------------------------------------------------------------------------
# K5: delay-2 paired-site sweep
# ---------------------------------------------------------------------------

ALL_PATTERNS = {(False, False), (False, True), (True, False), (True, True)}


@pytest.mark.parametrize("model", ["attractive", "repulsive"])
def test_site_sweep_pair_matches_pallas(model):
    """K5's plain version against the Pallas pair kernel
    (_batched_kernel_pair) in interpret mode at N = 16: decisions exact, G
    within 1e-5; every accept pattern of a pair occurs."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F, N = len(kw["signs"]), 16
    G, sigma, u = pair_inputs(60 + F, 8, F, N)
    Gj, sj, aj, nj = pss._site_sweep_batched(
        jnp.asarray(G), jnp.asarray(sigma, jnp.int32), jnp.asarray(u),
        _force_colread=True, _force_pair=True, **kw)
    Gt, st, at, nt = ss.site_sweep_pair(
        *map(torch.from_numpy, (G, sigma, u)), **kw)
    assert st.dtype == torch.int8
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert accept_patterns(sigma, st) == ALL_PATTERNS
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-5


@pytest.mark.parametrize("model,N", [("attractive", 16), ("repulsive", 16),
                                     ("repulsive", 24)])
def test_site_sweep_pair_plain_bit_equal_sequential(model, N):
    """The pair's corrected row, column and diagonal are the very values the
    sequential sweep reads after its site-i update, so K5's plain version
    equals K1's bit for bit; the inputs are left as they were."""
    kw = dict(lamb=LAMB, **MODELS[model])
    G, sigma, u = map(torch.from_numpy, pair_inputs(N + 70, 8, len(kw["signs"]),
                                                    N))
    G0, s0 = G.clone(), sigma.clone()
    pair = ss.site_sweep_pair_plain(G, sigma, u, **kw)
    seq = ss.site_sweep_plain(G, sigma, u, **kw)
    for a, b in zip(pair, seq):
        assert torch.equal(a, b)
    assert accept_patterns(sigma, pair[1]) == ALL_PATTERNS
    assert torch.equal(G, G0) and torch.equal(sigma, s0)
    with pytest.raises(ValueError, match="odd"):
        ss.site_sweep_pair_plain(G[:, :, :15, :15], sigma[:, :15], u[:, :15],
                                 **kw)


def test_site_sweep_pair_kernel_shapes():
    assert ss.pair_supports(64, 2) and ss.pair_supports(128, 2)
    assert ss.pair_supports(2, 1) and ss.pair_supports(20, 1)
    assert not ss.pair_supports(63, 2)              # odd N stays on K1
    assert not ss.pair_supports(130, 2)             # K6's range
    assert not ss.pair_supports(64, 3)
    assert not ss.pair_supports(64, 2, torch.float64)


def _tiled_mirror(G, sigma, u, *, lamb, signs, det_power, use_boson, pair):
    """CPU mirror of csrc/site_sweep_tiled.cuh's operations in their order,
    for real G of any float dtype, batched over chains: tiled::Decision's
    per-launch table (delta_f and the boson weight per field value, from
    -2 lamb in G's dtype), then sweep_chain's update per site or, with
    pair, sweep_chain_pair's corrections and its one pass of both rank-1
    terms per site pair. Returns (G, sigma, acc, nneg)."""
    dt = G.dtype
    C, F, N, _ = G.shape
    one, zero = torch.tensor(1.0, dtype=dt), torch.tensor(0.0, dtype=dt)
    neg2lamb = torch.tensor(-2.0, dtype=dt) * torch.tensor(lamb, dtype=dt)
    ep, em = neg2lamb * one, neg2lamb * -one
    sgs = [torch.tensor(sg, dtype=dt) for sg in signs]
    dp = [torch.exp(sg * ep) - one for sg in sgs]
    dm = [torch.exp(sg * em) - one for sg in sgs]
    wp, wm = (torch.exp(-ep), torch.exp(-em)) if use_boson else (one, one)

    def decide(diag, s, u_i):
        up = s > 0
        rprod, xs = None, []
        for f in range(F):
            d = torch.where(up, dp[f], dm[f])
            r = one + d * (one - diag[f])
            rprod = r if f == 0 else rprod * r
            xs.append(d / r)
        det = rprod
        for _ in range(det_power - 1):
            det = det * rprod
        return u_i < torch.where(up, wp, wm) * det, det, xs

    G, sigma = G.clone(), sigma.clone()
    acc = torch.zeros(C, dtype=torch.int32)
    nneg = torch.zeros(C, dtype=torch.int32)
    rows = torch.arange(N)
    keep = lambda a, new, old: torch.where(a[:, None, None], new, old)
    for i in range(0, N, 2 if pair else 1):
        j = i + 1
        e_i = torch.where(rows == i, one, zero)
        a_i, det_i, xi = decide([G[:, f, i, i] for f in range(F)],
                                sigma[:, i], u[:, i])
        sites = [(i, a_i, det_i)]
        if pair:
            e_j = torch.where(rows == j, one, zero)
            cj = [xi[f] * (zero - G[:, f, j, i]) for f in range(F)]
            ri = [G[:, f, i, j] for f in range(F)]
            gd = [torch.where(a_i, G[:, f, j, j] - cj[f] * ri[f],
                              G[:, f, j, j]) for f in range(F)]
            a_j, det_j, xj = decide(gd, sigma[:, j], u[:, j])
            sites.append((j, a_j, det_j))
        for f in range(F):
            cvi, rvi = G[:, f, :, i].clone(), G[:, f, i, :].clone()
            yi = xi[f][:, None] * (e_i - cvi)
            g = keep(a_i, G[:, f] - yi[:, :, None] * rvi[:, None, :], G[:, f])
            if pair:
                cvj, rvj = G[:, f, :, j].clone(), G[:, f, j, :].clone()
                rj = torch.where(a_i[:, None], rvj - cj[f][:, None] * rvi, rvj)
                colj = torch.where(a_i[:, None], cvj - yi * ri[f][:, None],
                                   cvj)
                yj = xj[f][:, None] * (e_j - colj)
                g = keep(a_j, g - yj[:, :, None] * rj[:, None, :], g)
            G[:, f] = g
        for n, a, det in sites:
            sigma[:, n] = torch.where(a, -sigma[:, n], sigma[:, n])
            acc += a
            nneg += det < 0
    return G, sigma, acc, nneg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["attractive", "repulsive"])
def test_tiled_op_order_equals_plain(model, dtype):
    """The tiled loops' decision table (exp once per launch for sigma = +1
    and -1) gives the plain versions' per-site exp(sign_f dEb) - 1 and
    exp(-dEb) bit for bit, since sign_f dEb is +-2 lamb exactly; and K1's
    (float32, float64) and K5's operations in their kernels' order equal
    site_sweep_plain and site_sweep_pair_plain bit for bit, G included,
    with every accept pattern of a site pair."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F, N = len(kw["signs"]), 16
    G, sigma, u = (torch.from_numpy(x) for x in pair_inputs(N + 90, 8, F, N))
    G, u = G.to(dtype), u.to(dtype)
    for lamb in (LAMB, 0.3, 1.7):
        neg2lamb = torch.tensor(-2.0, dtype=dtype) * torch.tensor(lamb,
                                                                  dtype=dtype)
        for s in (1, -1):
            dEb = torch.tensor([float(s)], dtype=dtype) * (-2.0 * lamb)
            for sg in (1.0, -1.0):
                table = torch.exp(torch.tensor(sg, dtype=dtype)
                                  * (neg2lamb * float(s))) - 1.0
                assert torch.equal(table.reshape(1),
                                   torch.exp(dEb * sg) - 1.0)
    for pair, plain in ((False, ss.site_sweep_plain),
                        (True, ss.site_sweep_pair_plain)):
        out = _tiled_mirror(G, sigma, u, pair=pair, **kw)
        ref = plain(G, sigma, u, **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b.to(a.dtype)), pair
    assert accept_patterns(sigma, out[1]) == ALL_PATTERNS


# ---------------------------------------------------------------------------
# K6: delayed site-major sweep
# ---------------------------------------------------------------------------

def _sweep_args(model, N, seed):
    kw = dict(lamb=LAMB, **MODELS[model])
    G, sigma, u = _sweep_inputs(seed, 3, len(kw["signs"]), N)
    jx = (jnp.asarray(G), jnp.asarray(sigma, jnp.int32), jnp.asarray(u))
    return kw, jx, tuple(map(torch.from_numpy, (G, sigma, u)))


def _same_sweep(out_t, out_j, N):
    """Decisions identical and G within 1e-5. The Pallas kernels run under
    XLA's CPU compiler, which may fuse a product and a difference into one
    FMA where the port rounds twice, so G differs at the 1e-6 level (the
    JAX package holds its delayed kernel to 1e-4 against its per-site one)."""
    Gt, st, at, nt, negt = out_t
    Gj, sj, aj, nj = out_j
    assert negt is None
    assert st.dtype == torch.int8
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert 0 < at.sum() < 3 * N
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-5


@pytest.mark.parametrize("mxu", [True, False])
@pytest.mark.parametrize("model", ["attractive", "repulsive"])
def test_site_sweep_delayed_matches_pallas(model, mxu):
    """dk = 4 against _site_sweep_sitemajor_delayed with its fold as per-chain
    dots (mxu=True) or as rank-1 updates (mxu=False)."""
    kw, jx, tx = _sweep_args(model, 16, 40 + mxu)
    out_j = pss._site_sweep_sitemajor_delayed(*jx, force_cb=8, force_dk=4,
                                               force_mxu=mxu, **kw)
    _same_sweep(ssd.site_sweep_delayed(*tx, dk=4, **kw), out_j, 16)


@pytest.mark.parametrize("model", ["attractive", "repulsive"])
def test_site_sweep_delayed_dk1_matches_pallas_per_site(model):
    """dk = 1 is the per-site site-major kernel _site_sweep_sitemajor."""
    kw, jx, tx = _sweep_args(model, 16, 44)
    out_j = pss._site_sweep_sitemajor(*jx, force_cb=8, _force_scratch=True,
                                      **kw)
    _same_sweep(ssd.site_sweep_delayed(*tx, dk=1, **kw), out_j, 16)


def test_site_sweep_delayed_matches_rank1_plain():
    """Every block width gives K1's Markov chain: decisions identical to
    site_sweep_plain, G to rounding; the inputs are left as they were."""
    kw = dict(lamb=LAMB, **MODELS["repulsive"])
    G, sigma, u = map(torch.from_numpy, _sweep_inputs(45, 3, 2, 24))
    G0, s0 = G.clone(), sigma.clone()
    ref = ss.site_sweep_plain(G, sigma, u, **kw)
    for dk in (1, 3, 8, 24):
        out = ssd.site_sweep_delayed_plain(G, sigma, u, dk=dk, **kw)
        for a, b in zip(out[1:], ref[1:]):
            assert torch.equal(a, b), dk
        assert (out[0] - ref[0]).abs().max().item() <= 1e-5
    assert torch.equal(G, G0) and torch.equal(sigma, s0)


def test_site_sweep_delayed_kernel_shapes():
    assert ssd.kernel_supports(256, 1, 32) and ssd.kernel_supports(256, 2, 32)
    assert ssd.kernel_supports(144, 1, 1) and ssd.kernel_supports(144, 2, 24)
    assert not ssd.kernel_supports(128, 1, 32)      # K1's range
    assert not ssd.kernel_supports(256, 1, 24)      # dk does not divide N
    assert not ssd.kernel_supports(256, 3, 32)
    assert not ssd.kernel_supports(1024, 2, 32)     # slabs past shared memory


# cluster_plan's blocks per chain for the shapes the configurations and
# tests run, per kernel and flavor count; None where the kernel takes no
# layout
CLUSTER_PLANS = {
    # (N, dk):  K6 F=1, K6 F=2, K9 F=1, K9 F=2
    (256, 32): (2, 2, 2, 2),
    (256, 16): (2, 2, 2, 2),
    (256, 8): (2, 2, 2, 2),
    (256, 1): (2, 2, 2, 2),
    (144, 24): (2, 2, 2, 2),
    (144, 16): (2, 2, 2, 2),
    (144, 8): (2, 2, 2, 2),
    (144, 1): (2, 2, 2, 2),
    (136, 8): (2, 2, 2, 2),
    (136, 1): (2, 2, 2, 2),
}


@pytest.mark.parametrize("N,dk", sorted(CLUSTER_PLANS))
@pytest.mark.parametrize("kernel,F", [("K6", 1), ("K6", 2), ("K9", 1),
                                      ("K9", 2)])
def test_cluster_plan_layouts(kernel, F, N, dk):
    """K6's and K9's layout at each shape, and its block's shared memory
    within the card's: a cluster of two blocks per chain, each folding N/2
    rows (complex64 F = 2 at N = 256, dk = 32 in two column passes)."""
    mod = ssd if kernel == "K6" else ssdcx
    want = CLUSTER_PLANS[N, dk][2 * (kernel == "K9") + F - 1]
    assert mod.kernel_supports(N, F, dk) == (want is not None)
    if want is None:
        assert not mod.fits(N, F, dk, 1)
        return
    cs = mod.cluster_plan(N, F, dk)
    assert cs == want
    assert mod.fits(N, F, dk, cs)
    assert mod.smem_bytes(N, F, dk, cs) <= _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("kernel", ["K6", "K9"])
def test_cluster_plan_takes_every_slab_shape(kernel):
    """kernel_supports takes every shape the one-block slab layout takes,
    and every layout it picks fits the card's shared memory."""
    mod, q = (ssd, 4) if kernel == "K6" else (ssdcx, 8)
    for N in range(mod.MIN_N, 521):
        for F in (1, 2):
            for dk in (d for d in range(1, N + 1) if N % d == 0):
                slab = N % q == 0 and mod.fits(N, F, dk, 1)
                assert mod.kernel_supports(N, F, dk) >= slab, (N, F, dk)
                if mod.kernel_supports(N, F, dk):
                    assert mod.fits(N, F, dk, mod.cluster_plan(N, F, dk))


# ---------------------------------------------------------------------------
# K2 / K3: fused UDT and fused UDT + solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N", [(3, 16), (6, 32)])
def test_udt_qr_matches_pallas(B, N):
    Ap, mx = _graded(B * N, B, N)
    Qj, Rj, dj = pallas_qr._udt_fused_batched(jnp.asarray(Ap.numpy()),
                                              jnp.asarray(mx.numpy()))
    Qt, Rt, dt = qr.udt_qr(Ap, mx)
    _close(Qt, Qj, 1e-5)
    _close(Rt, Rj, 1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    # the decomposition itself: Ap = Q diag(d/mx) Rs
    rec = (Qt.double() * (dt.double() / mx.double()[:, None])[:, None, :]
           @ Rt.double())
    _close(rec, Ap.double(), 2e-5)


def test_udt_qr_flushed_columns_match_pallas():
    """Exactly-zero columns: tau = 0, exact zero fill, R_jj = +floor, so the
    normalized diagonal is exactly +1 and d is the floor (times mx)."""
    Ap, mx = _graded(4, 2, 16, decades=2.0)
    Ap[:, :, -4:] = 0.0
    Qj, Rj, dj = pallas_qr._udt_fused_batched(jnp.asarray(Ap.numpy()),
                                              jnp.asarray(mx.numpy()))
    Qt, Rt, dt = qr.udt_qr(Ap, mx)
    _close(Qt, Qj, 1e-5)
    _close(Rt, Rj, 1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    diag = torch.diagonal(Rt, dim1=-2, dim2=-1)
    assert torch.equal(diag[:, -4:], torch.ones(2, 4))
    assert torch.equal(dt[:, -4:], qr.F32_FLOOR * mx[:, None].expand(2, 4))
    assert torch.equal(torch.tril(Rt, -1), torch.zeros_like(Rt))
    assert bool(torch.isfinite(Rt).all())


@pytest.mark.parametrize("B,N", [(3, 16), (6, 32)])
def test_udt_qr_solve_matches_pallas(B, N):
    Ap, mx = _graded(B * N + 1, B, N, decades=6.0)
    Z = torch.from_numpy(np.random.default_rng(B).normal(
        size=(B, N, N)).astype(np.float32))
    Qj, Xj = pallas_qr._udt_solve_batched(jnp.asarray(Ap.numpy()),
                                          jnp.asarray(Z.numpy()),
                                          jnp.asarray(mx.numpy()))
    Qt, Xt = qr.udt_qr_solve(Ap, Z, mx)
    _close(Qt, Qj, 1e-5)
    _close(Xt, Xj, 1e-5)
    # X solves X R = Z / mx with R the unnormalized triangular factor
    _, Rs, d = qr.udt_qr_plain(Ap.double(), mx.double())
    R = Rs * (d / mx.double()[:, None])[:, :, None]
    _close(Xt.double() @ R, Z.double() / mx.double()[:, None, None], 1e-5)


@pytest.mark.parametrize("solve", [False, True])
def test_udt_qr_subnormal_reflector_stays_finite(solve):
    """A column whose remaining tail has a subnormal v·v: tau = 0 (the TPU's
    flush-to-zero result) instead of 2 / v·v = inf and a NaN matrix."""
    A = torch.eye(8) * 2.0 ** 40
    A[:, 1] = 3e-21                              # v·v ~ 1e-40 at column 1
    mx = torch.ones(1)
    if solve:
        outs = qr.udt_qr_solve(A[None], torch.ones(1, 8, 8), mx)
    else:
        outs = qr.udt_qr(A[None], mx)
        assert torch.equal(torch.diagonal(outs[1][0]).abs(), torch.ones(8))
    assert all(bool(torch.isfinite(t).all()) for t in outs)


def test_udt_qr_plain_float64_floor():
    """The float64 plain path floors at finfo.tiny, not at 2^-70."""
    A = torch.zeros(1, 8, 8, dtype=torch.float64)
    A[0, :, 0] = 1.0
    Q, Rs, d = qr.udt_qr_plain(A, torch.ones(1, dtype=torch.float64))
    assert d[0, 1].item() == torch.finfo(torch.float64).tiny
    assert torch.equal(torch.diagonal(Rs[0]), torch.tensor(
        [-1.0] + [1.0] * 7, dtype=torch.float64))


def test_udt_kernel_shapes():
    assert [n for n in range(1, 129) if qr.kernel_supports(n)] == \
        [8, 16, 24, 32, 40, 48, 56, 64]


# ---------------------------------------------------------------------------
# K7: blocked compact-WY QR
# ---------------------------------------------------------------------------

def _qr_pair(A):
    """(Q, R) of the port's plain version and of qr_lanes_mxu on A."""
    Qj, Rj = pallas_qr.qr_lanes_mxu()(jnp.asarray(A))
    Qt, Rt = qb.qr_blocked(torch.from_numpy(A))
    return (Qt.numpy(), Rt.numpy()), (np.asarray(Qj), np.asarray(Rj))


def _same_qr(out_t, out_j, A):
    """Q within 2e-5 and R within 2e-4 of the largest |R| (the JAX package's
    bounds between its QR kernels, tests/test_pallas_qr.py, relative here
    because graded columns put R's entries far above 1); R exactly upper
    triangular; Q R = A to float32 rounding."""
    (Qt, Rt), (Qj, Rj) = out_t, out_j
    assert np.max(np.abs(Qt - Qj)) <= 2e-5
    assert np.max(np.abs(Rt - Rj)) <= 2e-4 * max(1.0, np.max(np.abs(Rj)))
    assert np.array_equal(np.tril(Rt, -1), np.zeros_like(Rt))
    rec = Qt.astype(np.float64) @ Rt.astype(np.float64)
    assert np.max(np.abs(rec - A)) <= 1e-5 * np.max(np.abs(A))


@pytest.mark.parametrize("graded", [False, True])
def test_qr_blocked_matches_pallas(graded):
    """(5, 32, 32) random and (4, 32, 32) graded over +-12 e-folds, as
    tests/test_pallas_qr.py::test_qr_mxu_* draw them."""
    rng = np.random.default_rng(50 + graded)
    A = rng.normal(size=(4 if graded else 5, 32, 32))
    if graded:
        A = A * np.exp(np.linspace(12.0, -12.0, 32))[None, None, :]
    A = A.astype(np.float32)
    _same_qr(*_qr_pair(A), A)


def test_qr_blocked_matches_pallas_t_merge(monkeypatch):
    """The Pallas kernel's merged-T path (two KB0 = 8 base panels in one
    KB = 16 panel, as test_qr_mxu_recursive_t_merge runs it) at N = 16."""
    monkeypatch.setattr(pallas_qr, "MXU_QR_KB", 16)
    monkeypatch.setattr(pallas_qr, "MXU_QR_KB0", 8)
    A = np.random.default_rng(52).normal(size=(3, 16, 16)).astype(np.float32)
    _same_qr(*_qr_pair(A), A)


def test_qr_blocked_zero_tails_match_pallas():
    """Upper-triangular columns and an all-zero column: tau = 0 where v.v is
    zero, the TPU kernel's sign on a zero tail, exact zero fill."""
    rng = np.random.default_rng(53)
    A = np.triu(rng.normal(size=(2, 16, 16))).astype(np.float32)
    A[:, :, 5] = 0.0
    (Qt, Rt), (Qj, Rj) = _qr_pair(A)
    _same_qr((Qt, Rt), (Qj, Rj), A)
    assert np.all(np.isfinite(Qt)) and np.all(Rt[:, 5, 5] == 0.0)


def test_qr_blocked_subnormal_reflector_stays_finite():
    """A column whose remaining tail has a subnormal v.v: tau = 0 (the TPU's
    flush-to-zero result) instead of 2 / v.v = inf and a NaN matrix."""
    A = torch.eye(16) * 2.0 ** 40
    A[:, 1] = 3e-21                              # v.v ~ 1e-40 at column 1
    Q, R = qb.qr_blocked(A[None])
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert torch.equal(torch.tril(R, -1), torch.zeros_like(R))


@pytest.mark.parametrize("graded", [False, True])
def test_qr_blocked_two_panels_match_pallas(graded):
    """(3, 64, 64): two of K7's 32-column panels (one of the Pallas
    kernel's 64), random and graded over +-12 e-folds, as
    test_qr_blocked_matches_pallas holds them."""
    rng = np.random.default_rng(54 + graded)
    A = rng.normal(size=(3, 64, 64))
    if graded:
        A = A * np.exp(np.linspace(12.0, -12.0, 64))[None, None, :]
    A = A.astype(np.float32)
    _same_qr(*_qr_pair(A), A)


@pytest.mark.parametrize("N", [20, 136, 144])
def test_qr_blocked_backward_q_matches_forward(N):
    """float64: Q formed backward by panels (K7) against Q accumulated
    forward over all rows (the TPU kernel's order), and R identical; at
    panels of 8 with a narrower last one (N = 20), 8 and 16."""
    A = torch.from_numpy(np.random.default_rng(56).normal(size=(2, N, N)))
    Qb, Rb = qb.qr_blocked_plain(A)
    Qf, Rf = qb.qr_blocked_forward_plain(A)
    assert (Qb - Qf).abs().max().item() <= 1e-13
    assert torch.equal(Rb, Rf)
    assert (Qb.mT @ Qb - torch.eye(N, dtype=A.dtype)).abs().max().item() \
        <= 1e-13


def test_qr_blocked_cluster_plan():
    """CS from the batch: two blocks per matrix while 2 B fits the H100's
    132 SMs (l16's 64 matrices: 128 SMs), else one; the chunk width from
    the shared memory left beside the panel, 4 columns in one buffer where
    two buffers of 8 do not fit."""
    assert [qb.cluster_plan(256, b) for b in (1, 33, 34, 64, 66, 67, 256)] \
        == [2, 2, 2, 2, 2, 1, 1]
    assert [qb.chunk_width(n) for n in (136, 144, 256, 512, 880, 1424,
                                        2744)] == [8, 16, 32, 32, 16, 4, 4]
    assert all(qb.smem_bytes(n) <= 232448
               for n in (136, 256, 512, 880, 1424, 2744))


def test_qr_blocked_kernel_shapes():
    """The shapes K7 takes: N > 128 with 8 | N, and every N that its
    earlier layout (the panel, its V, T, VᵀV and a 32 x 33 tile in shared
    memory) took, up to N = 3544."""
    assert [n for n in range(120, 177) if qb.kernel_supports(n)] == \
        [136, 144, 152, 160, 168, 176]
    assert qb.kernel_supports(256) and qb.kernel_supports(512)
    assert [qb.panel_width(n) for n in (256, 144, 136, 20)] == [32, 16, 8, 8]

    def earlier(n):
        kb = qb.panel_width(n)
        return (n > 128 and n % 8 == 0 and 4 * (2 * kb * n + 2 * kb * kb
                                                + kb + 1 + 32 * 33) <= 232448)
    taken = [n for n in range(129, 4097) if earlier(n)]
    assert taken[-1] == 3544
    assert all(qb.kernel_supports(n) for n in taken)


# ---------------------------------------------------------------------------
# wrappers: a tensor off the CPU never runs the plain version
# ---------------------------------------------------------------------------

def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor on another device (here `meta`) goes to the kernel checks,
    which raise; nothing falls back to the plain version."""
    m = dict(device="meta")
    G = torch.empty(2, 1, 16, 16, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ss.site_sweep(G, torch.empty(2, 16, dtype=torch.int8, **m),
                      torch.empty(2, 16, **m), lamb=LAMB,
                      **MODELS["attractive"])
    A = torch.empty(2, 16, 16, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        qr.udt_qr(A, torch.empty(2, **m))
    with pytest.raises(ValueError, match="no kernel for device"):
        qr.udt_qr_solve(A, A, torch.empty(2, **m))
    G = torch.empty(2, 1, 136, 136, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd.site_sweep_delayed(G, torch.empty(2, 136, dtype=torch.int8, **m),
                               torch.empty(2, 136, **m), dk=8, lamb=LAMB,
                               **MODELS["attractive"])
    with pytest.raises(ValueError, match="no kernel for device"):
        qb.qr_blocked(torch.empty(2, 136, 136, **m))
    G = torch.empty(2, 1, 16, 16, dtype=torch.complex64, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        sscx.site_sweep_cx(G, torch.empty(2, 16, dtype=torch.int8, **m),
                           torch.empty(2, 16, **m), lamb=LAMB,
                           **MODELS["attractive"])
    with pytest.raises(ValueError, match="no kernel for device"):
        qcx.qr_cx(torch.empty(2, 16, 16, dtype=torch.complex64, **m))
    with pytest.raises(ValueError, match="no kernel for device"):
        qh.qr_f32(torch.empty(2, 16, 16, **m))
    with pytest.raises(ValueError, match="no kernel for device"):
        qh.qr_f64(torch.empty(2, 16, 16, dtype=torch.float64, **m))
    G = torch.empty(2, 1, 16, 16, dtype=torch.float64, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ss.site_sweep_f64(G, torch.empty(2, 16, dtype=torch.int8, **m),
                          torch.empty(2, 16, dtype=torch.float64, **m),
                          lamb=LAMB, **MODELS["attractive"])
    G = torch.empty(2, 2, 16, 16, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ss.site_sweep_pair(G, torch.empty(2, 16, dtype=torch.int8, **m),
                           torch.empty(2, 16, **m), lamb=LAMB,
                           **MODELS["repulsive"])
    G = torch.empty(2, 1, 136, 136, dtype=torch.complex64, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ssdcx.site_sweep_delayed_cx(
            G, torch.empty(2, 136, dtype=torch.int8, **m),
            torch.empty(2, 136, **m), dk=8, lamb=LAMB, **MODELS["attractive"])
    f64 = dict(dtype=torch.float64, **m)
    s136 = torch.empty(2, 136, dtype=torch.int8, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd.site_sweep_delayed_f64(torch.empty(2, 1, 136, 136, **f64), s136,
                                   torch.empty(2, 136, **f64), dk=8,
                                   lamb=LAMB, **MODELS["attractive"])
    with pytest.raises(ValueError, match="no kernel for device"):
        sscx.site_sweep_cx_c128(
            torch.empty(2, 1, 16, 16, dtype=torch.complex128, **m),
            torch.empty(2, 16, dtype=torch.int8, **m),
            torch.empty(2, 16, **f64), lamb=LAMB, **MODELS["attractive"])
    with pytest.raises(ValueError, match="no kernel for device"):
        ssdcx.site_sweep_delayed_cx_c128(
            torch.empty(2, 1, 136, 136, dtype=torch.complex128, **m), s136,
            torch.empty(2, 136, **f64), dk=8, lamb=LAMB,
            **MODELS["attractive"])
    assert set(KERNELS) == {"site_sweep", "udt_qr", "udt_qr_solve",
                            "site_sweep_delayed", "qr_blocked",
                            "site_sweep_cx", "qr_cx", "qr_f32", "qr_f64",
                            "site_sweep_f64", "site_sweep_pair",
                            "site_sweep_delayed_cx", "site_sweep_wrap",
                            "qr_vtau", "site_sweep_single", "ising_sweep",
                            "wolff_step", "site_sweep_delayed_f64",
                            "site_sweep_cx_c128",
                            "site_sweep_delayed_cx_c128"}
    assert all(fn.launches == 0 for fn in KERNELS.values())


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_build_command_targets_sm90a_into_ignored_dir(tmp_path):
    """One nvcc per source (-c, sm_90a, -O3, -fPIC), then one link of the
    objects into the shared library under the ignored build directory."""
    out = _build.library_path()
    assert [p.name for p in _build.sources()] == [
        "ising.cu", "qr_blocked.cu", "qr_cx.cu", "qr_f64.cu", "site_sweep.cu",
        "site_sweep_cx.cu", "site_sweep_delayed.cu",
        "site_sweep_delayed_cx.cu", "site_sweep_wrap.cu", "udt_qr.cu"]
    assert [p.name for p in _build.headers()] == ["phase_clock.cuh",
                                                  "site_sweep_rank1.cuh",
                                                  "site_sweep_tiled.cuh"]
    for src in _build.sources():
        cmd = _build.compile_command("nvcc", src, tmp_path / "k.o")
        assert cmd[0] == "nvcc" and str(src) in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-O3", "-c", "-fPIC"} <= set(cmd)
    objs = [tmp_path / "a.o", tmp_path / "b.o"]
    cmd = _build.link_command("nvcc", objs, out)
    assert cmd[0] == "nvcc" and "-shared" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert all(str(o) in cmd for o in objs)
    assert set(_build.SIGNATURES) == {
        "site_sweep_f32", "udt_qr_f32", "udt_qr_solve_f32",
        "site_sweep_delayed_f32", "qr_blocked_f32", "site_sweep_cx_c64",
        "qr_cx_c64", "qr_f32", "qr_f64", "site_sweep_f64",
        "site_sweep_pair_f32", "site_sweep_delayed_cx_c64",
        "site_sweep_wrap_f32", "qr_vtau_f32",
        "site_sweep_delayed_f32_max_clusters",
        "site_sweep_delayed_cx_c64_max_clusters",
        "site_sweep_delayed_f32_stamps", "site_sweep_delayed_cx_c64_stamps",
        "qr_cx_c64_stamps", "qr_blocked_f32_stamps",
        "site_sweep_f32_stamps", "site_sweep_cx_c64_stamps",
        "udt_qr_f32_stamps", "udt_qr_solve_f32_stamps", "qr_f64_stamps",
        "site_sweep_wrap_f32_stamps", "qr_f32_stamps", "ising_sweep_i8",
        "wolff_step_u8", "site_sweep_delayed_f64",
        "site_sweep_delayed_f64_max_clusters", "site_sweep_delayed_f64_stamps",
        "site_sweep_cx_c128", "site_sweep_delayed_cx_c128",
        "site_sweep_delayed_cx_c128_max_clusters",
        "site_sweep_delayed_cx_c128_stamps",
        # the rank-1 layouts at dk = 1 and K9-c128's flavor layout
        "site_sweep_delayed_f64_rank1",
        "site_sweep_delayed_f64_rank1_max_clusters",
        "site_sweep_delayed_cx_c128_rank1",
        "site_sweep_delayed_cx_c128_rank1_max_clusters",
        "site_sweep_delayed_cx_c128_flavors",
        "site_sweep_delayed_cx_c128_flavors_max_clusters",
        # K8-c128 past N = 64 in the rank-1 layout
        "site_sweep_cx_c128_rank1", "site_sweep_cx_c128_rank1_max_clusters"}
    assert out.parent == _build.PACKAGE_DIR / "_build"
    # the build directory is listed in .gitignore
    root = _build.PACKAGE_DIR.parent
    rel = out.parent.relative_to(root)
    res = subprocess.run(["git", "check-ignore", "-q", f"{rel}/x.so"],
                         cwd=root, capture_output=True)
    assert res.returncode == 0, f"{rel}/ is not ignored by git"


def test_build_key_follows_sources(monkeypatch, tmp_path):
    """The library name hashes the sources: an edited kernel is rebuilt."""
    before = _build.library_path()
    src = tmp_path / "site_sweep.cu"
    src.write_text("// edited\n")
    monkeypatch.setattr(_build, "sources", lambda: [src])
    assert _build.library_path() != before


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "CUDA_NVCC", _build.Path("/nonexistent/nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_check_launch_raises_on_error_code():
    _build.check_launch("x", 0)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _build.check_launch("x", 1)
