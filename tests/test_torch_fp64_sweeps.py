"""The float64 and complex128 site sweeps of the PyTorch/CUDA port
(montecarlo_tpu_torch) past the float32 kernels' limits: kernel K6-f64 (the
delayed sweep in float64, N > 128), K8-c128 and K9-c128 (the complex sweeps
in complex128), on the CPU through their plain versions. Their CUDA route
table (which sessions run on the card, and the refusals left), the layouts'
shared-memory counts at float64 and complex128, the dispatch of
core.sweep_slice, and the float64 delayed sweep's negative-weight
statistics against the JAX package's XLA loop (test_torch_fp64_runs.py runs
DQMC sessions at the new routes' settings against the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.dqmc import core as jcore

from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import site_sweep as ss
from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
from test_torch_dqmc import _contexts

F32, F64 = torch.float32, torch.float64
C64, C128 = torch.complex64, torch.complex128


# ---------------------------------------------------------------------------
# the CUDA route table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,F,delay,dtype,udtype", [
    (256, 1, 32, F64, F64),      # the 16x16 attractive model: K6-f64
    (256, 2, 32, F64, F64),      # ... repulsive: two column passes
    (144, 1, 0, F64, F64),       # 12x12, rank-1: K6-f64 at dk = 1
    (144, 2, 0, F64, F64),
    (144, 1, 24, F64, F64),
    (256, 1, 32, F64, F32),      # float32 updates over float64 stacks: K6
    (64, 1, 0, C128, C128),      # the 8x8 Peierls model: K8-c128
    (64, 2, 0, C128, C128),      # ... repulsive, all four planes in registers
    (128, 1, 0, C128, C128),     # the imaginary plane in shared memory
    (100, 1, 0, C128, C128),     # 8 does not divide N: the library QR
    (16, 2, 0, C128, C128),
    (256, 1, 32, C128, C128),    # complex16: K9-c128, two column passes
    (144, 1, 0, C128, C128),
    (256, 2, 16, C128, C128),
    (130, 1, 0, F64, F64),       # 4 does not divide N: K6-f64 on padded G
    (128, 2, 0, C128, C128),     # K8-c128 in the rank-1 layout
    (72, 2, 0, C128, C128),
    (256, 2, 32, C128, C128),    # K9-c128 in two flavor stages
    (132, 1, 0, C128, C128)])    # 8 does not divide N: K9-c128 on padded G
def test_check_cuda_kernels_fp64_routes(N, F, delay, dtype, udtype):
    """A CUDA session in float64 past N = 128 and in complex128 runs a hand
    site sweep (K6-f64, K8-c128, K9-c128): no refusal."""
    tcore._check_cuda_kernels(N, F, delay, dtype, udtype)


@pytest.mark.parametrize("N,F,delay,dtype,text", [
    (256, 3, 32, F64, "both F <= 2"),
    (256, 2, 64, F64, "with their buffers in shared memory"),
    (64, 3, 0, C128, "K8 and K8-c128 take N <= 128"),
    (256, 3, 32, C128, "all F <= 2"),
    (256, 2, 128, C128, "K9 and K9-c128 beyond with their buffers in "
                        "shared memory")])
def test_check_cuda_kernels_fp64_refusals(N, F, delay, dtype, text):
    """Each refusal left (F = 3, which no model of the JAX package has;
    buffers that no layout fits at a delay above the default) names ROADMAP
    Queue 1 item 4 and states the limits of the kernels that refuse."""
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 4") as e:
        tcore._check_cuda_kernels(N, F, delay, dtype, dtype)
    assert text in str(e.value), str(e.value)


# ---------------------------------------------------------------------------
# the layouts at float64 and complex128 byte counts
# ---------------------------------------------------------------------------

def _k6_cluster_bytes(N, F, dk, cs, passes, el):
    """csrc/site_sweep_delayed.cu::cluster_smem_elems by hand: b over N/P
    columns, a over N/cs rows, the two staged tables (rows of dk padded to
    4, plus 4), A2 and B2, the diagonal block (rows of dk + 1), its
    diagonal and x, u, delta and the boson weight, the slots' sites and
    count, sigma."""
    ld = (dk + 3) // 4 * 4 + 4
    return el * (F * dk * (N // passes) + F * dk * (N // cs) + 2 * F * dk * ld
                 + 2 * F * dk * dk + F * dk * (dk + 1) + 2 * F * dk
                 + (F + 2) * N + dk + 4 + (N + 3) // 4)


@pytest.mark.parametrize("N,F,dk,dtype,cs,passes", [
    (256, 1, 32, F64, 2, 1), (256, 2, 32, F64, 2, 2), (144, 1, 1, F64, 2, 1),
    (144, 2, 1, F64, 2, 1), (144, 2, 24, F64, 2, 1), (256, 1, 32, F32, 2, 1),
    (256, 2, 32, F32, 2, 1)])
def test_k6_f64_layouts(N, F, dk, dtype, cs, passes):
    """K6's delayed cluster layout and column passes count bytes per
    element: in float64 the 16x16 F = 1 still runs one pass, F = 2 two
    (227,616 bytes, within one block's 232,448), and float32 keeps its
    one-pass layouts. Float64 at dk = 1 runs the rank-1 layout in clusters
    of the same size or of 4 (tests/test_torch_rank1_layouts.py); the
    delayed layout stays among ``layouts`` there for A/B timing."""
    el = dtype.itemsize
    rank1 = dk == 1 and dtype == F64
    lay = ssd.plan_layout(N, F, dk, dtype)
    assert lay.kind == ("rank1" if rank1 else "cluster")
    assert ssd.cluster_plan(N, F, dk, dtype) == cs
    cluster = ssd.cluster_layout(N, F, dk, cs, dtype)
    if rank1:
        r1 = ssd.rank1_layout(N, F, dk, dtype)
        assert lay == r1 and r1.cs == (2 if F == 1 else 4)
        assert r1.smem == ssd.rank1_smem(N, F, r1.cs, *r1.geometry) <= \
            _build.SMEM_PER_BLOCK
        assert ssd.layouts(N, F, dk, dtype)[:2] == [r1, cluster]
    else:
        assert lay == cluster
    assert ssd.column_passes(N, F, dk, cs, dtype) == passes
    assert cluster.geometry == (passes,)
    assert ssd.smem_bytes(N, F, dk, cs, dtype) == cluster.smem == \
        _k6_cluster_bytes(N, F, dk, cs, passes, el) <= _build.SMEM_PER_BLOCK
    assert ssd.fits(N, F, dk, cs, dtype) and ssd.kernel_supports(N, F, dk,
                                                                 dtype)
    # the same shape in one pass of twice the bytes does not fit where it
    # takes two
    one = _k6_cluster_bytes(N, F, dk, cs, 1, el)
    assert (one <= _build.SMEM_PER_BLOCK) == (passes == 1)


def test_k6_f64_refused_shapes():
    """float64 K6-f64 takes N past 128 (G padded to a multiple of 8 where 4
    does not divide N), F <= 2, and not the buffers of dk = 64 at F = 2
    (no layout fits). At dk = 1 the rank-1 layout takes N = 132 (where the
    delayed layouts have only the slab) and N = 130 in clusters of 2."""
    assert ssd.kernel_supports(132, 1, 1, F64)          # rank-1 layout
    assert ssd.cluster_plan(132, 1, 1, F64) == 1        # the slab's
    assert ssd.plan_layout(132, 1, 1, F64)[:2] == ("rank1", 2)
    assert ssd.kernel_supports(130, 1, 1, F64)          # padded to 136
    assert ssd.cluster_plan(130, 1, 1, F64) == 2
    assert ssd.plan_layout(130, 1, 1, F64)[:2] == ("rank1", 2)
    assert not ssd.kernel_supports(130, 1, 4, F64)      # dk | N
    assert not ssd.kernel_supports(128, 1, 32, F64)     # K1-f64's range
    assert not ssd.kernel_supports(256, 3, 32, F64)
    assert not ssd.kernel_supports(256, 2, 64, F64)
    assert not ssd.fits(256, 2, 32, 1, F64)             # the slab's 270 KB
    assert not ssd.kernel_supports(256, 1, 32, C128)


@pytest.mark.parametrize("N,F,dk,cs,passes,ok", [
    (256, 1, 32, 2, 2, True), (256, 2, 16, 2, 2, True),
    (256, 2, 8, 2, 1, True), (144, 2, 24, 2, 2, True),
    (144, 1, 1, 2, 1, True), (256, 2, 32, 4, 4, True),
    (256, 2, 64, 1, 1, False)])
def test_k9_c128_layouts(N, F, dk, cs, passes, ok):
    """K9-c128's plan at complex128 byte counts: two float64 planes of every
    buffer; complex16 (F = 1, dk = 32) in clusters of 2 blocks and two
    column passes (225,568 bytes); F = 2 at dk = 32 in clusters of 4
    blocks, two flavor stages and four passes (216,864 bytes); F = 2 at
    dk = 64 fits no layout."""
    assert ssdcx.kernel_supports(N, F, dk, C128) == ok
    # the delayed layouts' plan; where the plan runs the rank-1 layout (dk
    # = 1) or, for 64 chains, the flavor layout (F = 2 at dk = 32) instead,
    # that layout's own (tests/test_torch_rank1_layouts.py)
    assert ssdcx.cluster_plan(N, F, dk, C128) == cs
    kind = ("rank1" if dk == 1 else "flavors" if (F, dk) == (2, 32)
            else "cluster" if ok else None)
    lay = ssdcx.plan_layout(N, F, dk, C128, 64)
    assert (lay and lay.kind) == kind
    if not ok:
        assert ssdcx.smem_bytes(N, F, dk, 1, C128) > _build.SMEM_PER_BLOCK
        return
    stages = 2 if (F, dk) == (2, 32) else 1
    assert ssdcx.plan(N, F, dk, cs, C128) == (passes, stages)
    fs, ld = F // stages, (dk + 3) // 4 * 4 + 4
    want = 8 * (2 * fs * dk * (N // passes) + 2 * fs * dk * (N // cs)
                + 4 * F * dk * ld + 4 * fs * dk * dk + 2 * F * dk * (dk + 1)
                + 4 * F * dk + (F + 2) * N + dk + 4 + (N + 3) // 4)
    assert ssdcx.smem_bytes(N, F, dk, cs, C128) == want
    assert ssdcx.cluster_layout(N, F, dk, cs, C128).smem == want
    assert want <= _build.SMEM_PER_BLOCK
    # complex64 keeps one pass at every shape it took before, and runs
    # F = 2 at dk = 32 in two
    if ssdcx.kernel_supports(N, F, dk, C64):
        cs64 = ssdcx.cluster_plan(N, F, dk)
        assert ssdcx.plan(N, F, dk, cs64, C64) == (
            (2, 1) if (N, F, dk) == (256, 2, 32) else (1, 1))


@pytest.mark.parametrize("N,F,dk,dtype,NP", [
    (169, 1, 1, F64, 176), (225, 2, 1, F64, 232), (130, 2, 1, F32, 136),
    (289, 2, 17, F64, 296), (250, 1, 1, F64, 256), (225, 1, 15, F32, 232)])
def test_k6_padded_layouts(N, F, dk, dtype, NP):
    """K6 and K6-f64 where 4 does not divide N: G padded with zero rows and
    columns to NP, a multiple of 8, in clusters of 2 blocks of NP / 2 rows
    and one column pass; the shared memory counted at NP. Float64 at dk = 1
    runs the rank-1 layout on the same padded G (clusters of 2 blocks, at
    F = 2 past N = 200 of 4); the delayed layout stays launchable there."""
    assert ssd.padded(N) == NP and ssd.padded(NP) == NP
    assert ssd.kernel_supports(N, F, dk, dtype)
    assert ssd.cluster_plan(N, F, dk, dtype) == 2
    assert ssd.column_passes(N, F, dk, 2, dtype) == 1
    cluster = ssd.cluster_layout(N, F, dk, 2, dtype)
    assert ssd.smem_bytes(N, F, dk, 2, dtype) == cluster.smem == \
        _k6_cluster_bytes(NP, F, dk, 2, 1, dtype.itemsize) <= \
        _build.SMEM_PER_BLOCK
    assert ssd.layout(N, F, dk, cluster, dtype).startswith(
        f"G padded to {NP} x {NP}, cluster of 2 blocks")
    if dk == 1 and dtype == F64:
        r1 = ssd.rank1_layout(N, F, dk, dtype)
        assert ssd.plan_layout(N, F, dk, dtype) == r1
        assert ssd.layout(N, F, dk, dtype=dtype).startswith(
            f"G padded to {NP} x {NP}, rank-1: cluster of {r1.cs} blocks")
    else:
        assert ssd.plan_layout(N, F, dk, dtype) == cluster


@pytest.mark.parametrize("N,F,dk,dtype,NP,cs,passes,stages", [
    (196, 1, 1, C128, 200, 2, 1, 1), (169, 2, 1, C128, 176, 2, 1, 1),
    (132, 1, 1, C64, 136, 2, 1, 1), (225, 2, 1, C64, 232, 2, 1, 1),
    (256, 2, 32, C64, 256, 2, 2, 1), (256, 2, 32, C128, 256, 4, 4, 2)])
def test_k9_new_layouts(N, F, dk, dtype, NP, cs, passes, stages):
    """K9 and K9-c128 where 8 does not divide N (G padded to NP) and the
    16x16 repulsive model in a flux at delay 32: complex64 in two column
    passes (223,120 bytes), complex128 in clusters of 4 blocks, four passes
    and two flavor stages (216,864 bytes); each count by hand, with the
    fold's buffers of one stage's flavors."""
    el, fs, ld = dtype.itemsize // 2, F // stages, (dk + 3) // 4 * 4 + 4
    assert ssdcx.padded(N) == NP and ssdcx.kernel_supports(N, F, dk, dtype)
    # the delayed layouts' plan; complex128 runs the rank-1 layout at dk = 1
    # and, past one wave of its clusters (64 chains), the flavor layout at
    # F = 2, dk = 32 instead (tests/test_torch_rank1_layouts.py); the
    # delayed one stays among ``layouts`` for A/B timing
    assert ssdcx.cluster_plan(N, F, dk, dtype) == cs
    kind = ("rank1" if dtype == C128 and dk == 1 else "flavors"
            if stages > 1 else "cluster")
    assert ssdcx.plan_layout(N, F, dk, dtype, 64).kind == kind
    assert ssdcx.plan(N, F, dk, cs, dtype) == (passes, stages)
    want = el * (2 * fs * dk * (NP // passes) + 2 * fs * dk * (NP // cs)
                 + 4 * F * dk * ld + 4 * fs * dk * dk
                 + 2 * F * dk * (dk + 1) + 4 * F * dk + (F + 2) * NP + dk
                 + 4 + (NP + 3) // 4)
    cluster = ssdcx.cluster_layout(N, F, dk, cs, dtype)
    assert ssdcx.smem_bytes(N, F, dk, cs, dtype) == cluster.smem == want
    assert want <= _build.SMEM_PER_BLOCK
    # one stage of both flavors, or fewer passes, would not fit
    if stages > 1:
        assert ssdcx._smem(N, F, dk, cs, el, passes, 1) > \
            _build.SMEM_PER_BLOCK
    if passes > 1:
        assert ssdcx._smem(N, F, dk, cs, el, passes // 2, stages) > \
            _build.SMEM_PER_BLOCK
    assert (f"G padded to {NP} x {NP}" in ssdcx.layout(
        N, F, dk, dtype=dtype, chains=64)) == (NP != N)
    assert ssdcx.layout(N, F, dk, cluster, dtype).count(
        f"cluster of {cs} blocks") == 1


@pytest.mark.parametrize("N,F,ok,smem,where", [
    (64, 1, True, 8 * (4 * 2 * 64 + 64 + 128) + 3 * 64, "G in registers"),
    (64, 2, True, 8 * (4 * 4 * 64 + 64 + 128) + 3 * 64, "G in registers"),
    (128, 1, True, 8 * (4 * 2 * 128 + 128 + 256 + 128 * 128) + 3 * 128,
     "the real plane in registers, the imaginary plane in shared memory"),
    (100, 1, True, 8 * (4 * 2 * 128 + 128 + 256 + 128 * 128) + 3 * 128,
     "the imaginary plane in shared memory"),
    (16, 2, True, 8 * (4 * 4 * 32 + 32 + 64) + 3 * 32, "G in registers"),
    (72, 2, True, 8 * (4 * 4 * 128 + 128 + 256 + 3 * 128 * 128) + 3 * 128,
     "rank-1: one block of 432 threads per chain, 72 rows a block"),
    (128, 2, True, 8 * (4 * 4 * 128 + 128 + 256 + 3 * 128 * 128) + 3 * 128,
     "the imaginary plane in shared memory"),
    (129, 2, False, 8 * (4 * 4 * 128 + 128 + 256 + 3 * 128 * 128) + 3 * 128,
     None)], ids=[
    "64-1-True-5824-G in registers", "64-2-True-9920-G in registers",
    "128-1-True-142720-the real plane in registers, the imaginary plane in "
    "shared memory",
    "100-1-True-142720-the imaginary plane in shared memory",
    "16-2-True-4960-G in registers",
    "72-2-True-413056-a cluster of 2 blocks per chain, one flavor each",
    "128-2-True-413056-the imaginary plane in shared memory",
    "129-2-False-413056-None"])
def test_k8_c128_layouts(N, F, ok, smem, where):
    """K8-c128 on the tiled layout (csrc/site_sweep_tiled.cuh) with double
    planes: at N <= 64 every plane in registers (F = 2: 128 registers a
    thread, as K1-f64 at N = 128); at F = 1 past 64 the imaginary plane in
    shared memory; F = 2 past 64 would need three planes there (smem, one
    block's count), so the one-block layout runs each chain on a cluster of
    two blocks, one flavor each in the F = 1 layout (142,720 bytes a
    block), which the plan keeps past N = 104; up to 104 the plan takes the
    rank-1 layout (csrc/site_sweep_rank1.cuh), which ran faster there on an
    H100 (PERF.md; the ids keep the one-block layout's words)."""
    assert sscx.kernel_supports(N, F, C128) == ok
    assert ss.tiled_smem_bytes(N, F, True, F64) == smem
    pair = sscx.flavor_pair(N, F, C128)
    assert pair == (F == 2 and N > 64)
    assert sscx.smem_bytes(N, F, C128) == (
        ss.tiled_smem_bytes(N, 1, True, F64) if pair else smem)
    if ok:
        assert where in sscx.layout(N, F, C128)
        assert (sscx.plan_layout(N, F, C128).kind == "rank1") == (
            F == 2 and 64 < N <= sscx.RANK1_MAX_N)
    # complex64 and float64 keep their layouts: flavor 1 in shared memory
    # at F = 2 past 64, all in registers below
    assert ("flavor 1 in shared memory" in ss.layout(N, 2, True)) == (N > 64)
    assert ("flavor 1 in shared memory"
            in ss.layout(N, 2, dtype=F64)) == (N > 64)


# ---------------------------------------------------------------------------
# sweep_slice's dispatch and the float64 delayed sweep's statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,dtype,kernel,n_out", [
    (144, F64, "site_sweep_delayed_f64", 5),
    (16, C128, "site_sweep_cx_c128", 4),
    (144, C128, "site_sweep_delayed_cx_c128", 4),
    (144, F32, "site_sweep_delayed", 5),
    (16, C64, "site_sweep_cx", 4)])
def test_sweep_slice_dispatch(monkeypatch, N, dtype, kernel, n_out):
    """On the kernel path sweep_slice calls K6-f64 for float64 G past
    N = 128 (and passes on the negative-weight statistics that K6 and
    K6-f64 return fifth), K8-c128 and
    K9-c128 for complex128 G, and the float32 / complex64 kernels
    otherwise, once per slice."""
    mods = {"site_sweep_delayed_f64": ssd, "site_sweep_delayed": ssd,
            "site_sweep_cx_c128": sscx, "site_sweep_cx": sscx,
            "site_sweep_delayed_cx_c128": ssdcx,
            "site_sweep_delayed_cx": ssdcx}
    calls = []
    for name, mod in mods.items():
        def spy(G, *a, _n=name, **kw):
            calls.append(_n)
            return tuple(f"{_n}[{i}]" for i in range(n_out))
        monkeypatch.setattr(mod, name, spy)
    ctx = tcore.DQMCContext(
        N=N, M=10, sm=5, F=1, lamb=0.5, det_power=2, use_boson=True,
        dtype=dtype, signs=(1.0,), device=torch.device("cpu"),
        delay=8 if N > 128 else 0)
    G = torch.zeros(2, 1, N, N, dtype=dtype)
    out = tcore.sweep_slice(ctx, G, torch.ones(2, N, dtype=torch.int8),
                            torch.zeros(2, N, dtype=ctx.urdtype))
    assert calls == [kernel]
    assert out[:4] == tuple(f"{kernel}[{i}]" for i in range(4))
    assert out[4] == (f"{kernel}[4]" if n_out == 5 else None)


def test_site_sweep_delayed_f64_negative_magnitudes_match_jax():
    """K6-f64's plain version (its CPU route) on repulsive-sign F = 2
    inputs whose diagonal leaves [0, 1], where r_up r_dn < 0 happens,
    against the JAX package's XLA delayed sweep in blocks of 8: decisions
    and counts identical, G to 1e-12, the negative weights' log10
    magnitudes (min, max, sum per chain) to 1e-12; the float32 wrapper
    returns None for them."""
    (jctx, _), (tctx, _) = _contexts(1.0, 5, "f64", use_kernels=False,
                                     delay=8, repulsive=True)
    kw = dict(lamb=tctx.lamb, signs=tctx.signs, det_power=tctx.det_power,
              use_boson=tctx.use_boson)
    rng = np.random.default_rng(81)
    C, N = 3, tctx.N
    G = (0.5 * np.eye(N) + 0.8 / np.sqrt(N) * rng.normal(size=(C, 2, N, N))
         + np.einsum("cfn,nm->cfnm", 0.8 * rng.normal(size=(C, 2, N)),
                     np.eye(N)))
    sigma = rng.choice(np.array([-1, 1], np.int8), size=(C, N))
    u = rng.uniform(size=(C, N))

    def jax_sweep(G, s, u):
        G, s, ls = jcore.sweep_slice_delayed(jctx, G, s, u,
                                             jcore.init_local_stats(jctx))
        return G, s, ls["acc"], ls["nneg"], jnp.stack(
            [ls["neg_min"], ls["neg_max"], ls["neg_sum"]], -1)

    Gj, sj, aj, nj, negj = jax.jit(jax.vmap(jax_sweep))(
        jnp.asarray(G), jnp.asarray(sigma), jnp.asarray(u))
    Gt, st, at, nt, negt = ssd.site_sweep_delayed_f64(
        torch.from_numpy(G), torch.from_numpy(sigma), torch.from_numpy(u),
        dk=8, **kw)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert nt.sum() > 0
    np.testing.assert_allclose(negt.numpy(), np.asarray(negj), rtol=1e-12,
                               atol=1e-12)
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-12
    out32 = ssd.site_sweep_delayed(torch.from_numpy(G).float(),
                                   torch.from_numpy(sigma),
                                   torch.from_numpy(u).float(), dk=8, **kw)
    assert len(out32) == 5 and out32[4] is None
