"""The layouts the plan gives K6-f64 and K9-c128 at dk = 1 past N = 128 (the
rank-1 layout, csrc/site_sweep_rank1.cuh) and K9-c128 at F = 2 where the
delayed cluster layout needs two flavor stages (the flavor layout,
csrc/site_sweep_delayed_cx.cu::site_sweep_delayed_cx_flavors, past one wave
of the cluster layout's chains): cluster sizes, threads, passes and bytes
per block, counted by hand, within one block's shared memory and its
register budget. Plan arithmetic only: no sweep runs here (the kernels'
parity is tests/test_torch_cuda.py's, on the card)."""

import re
from pathlib import Path

import pytest
import torch

from montecarlo_tpu_torch.dqmc import core
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
from montecarlo_tpu_torch.ops.site_sweep_delayed import Layout

F64, C128 = torch.float64, torch.complex128
# the item 4 runs' chains; DQMC's default chain count
RUN_CHAINS, DEFAULT_CHAINS = 64, 16
CSRC = Path(ssd.__file__).resolve().parent.parent / "csrc"
# 32-bit registers of one SM
REGISTERS = 65536


def _rank1_bytes(NP, F, cs, tr, cx):
    """csrc/site_sweep_rank1.cuh::smem_bytes by hand: the rows of G past the
    16 / F a thread keeps in registers, 16 bytes a unit (two float64
    columns, one complex128 element) per thread; the row double buffer
    (units a row), the column and coefficient double buffers (the block's
    rows); u and sigma per site, and in float64 each site's detratio and
    new sigma."""
    units = NP if cx else NP // 2
    rows = NP // cs
    per_thread = rows // tr - 16 // F
    return (16 * (F * per_thread * tr * units + 2 * F * units + 4 * F * rows)
            + (9 if cx else 18) * NP)


# (N, F, padded N, cluster size, thread rows, threads a block)
RANK1_F64 = [(130, 1, 136, 2, 4, 272), (144, 1, 144, 2, 4, 288),
             (169, 1, 176, 2, 4, 352), (225, 1, 232, 2, 4, 464),
             (250, 1, 256, 2, 4, 512), (144, 2, 144, 4, 4, 288),
             (169, 2, 176, 4, 4, 352), (225, 2, 232, 4, 2, 232),
             (250, 2, 256, 4, 4, 512), (289, 2, 296, 8, 1, 148)]
RANK1_C128 = [(144, 1, 144, 2, 3, 432), (196, 1, 200, 2, 2, 400),
              (130, 1, 136, 2, 2, 272), (250, 1, 256, 4, 2, 512),
              (144, 2, 144, 4, 3, 432), (169, 2, 176, 4, 2, 352),
              (196, 2, 200, 8, 1, 200), (225, 2, 232, 8, 1, 232),
              (250, 2, 256, 8, 2, 512)]


@pytest.mark.parametrize("N,F,NP,cs,tr,threads", RANK1_F64)
def test_k6_f64_rank1_plan(N, F, NP, cs, tr, threads):
    """K6-f64 at dk = 1: the rank-1 layout, G padded to NP, clusters of cs
    blocks of tr x NP/2 threads (the most thread rows that fit), its bytes
    per block by hand, within one block's shared memory; the plan's Layout
    and layout name it, at every chain count."""
    assert ssd.padded(N) == NP
    want = _rank1_bytes(NP, F, cs, tr, False)
    lay = Layout("rank1", cs, (tr,), want)
    assert ssd.rank1_layout(N, F, 1, F64) == lay
    for chains in (1, DEFAULT_CHAINS, RUN_CHAINS):
        assert ssd.plan_layout(N, F, 1, F64, chains) == lay
    assert ssd.layouts(N, F, 1, F64)[0] == lay
    assert tr * NP // 2 == threads <= ssd.RANK1_MAX_THREADS
    assert want <= _build.SMEM_PER_BLOCK
    assert ssd.kernel_supports(N, F, 1, F64)
    text = ssd.layout(N, F, 1, dtype=F64)
    assert f"rank-1: cluster of {cs} blocks of {threads} threads" in text
    assert f"{want} bytes per block" in text
    assert ("G padded" in text) == (NP != N)


@pytest.mark.parametrize("N,F,NP,cs,tr,threads", RANK1_C128)
def test_k9_c128_rank1_plan(N, F, NP, cs, tr, threads):
    """K9-c128 at dk = 1: the rank-1 layout with one complex128 element a
    unit; the 14x14 in clusters of 2 blocks of 400 threads (232,200 bytes,
    248 short of one block's shared memory), F = 2 in clusters of 4, and of
    8 past N = 192, where 4 blocks do not hold both flavors' G."""
    assert ssdcx.padded(N) == NP
    want = _rank1_bytes(NP, F, cs, tr, True)
    lay = Layout("rank1", cs, (tr,), want)
    assert ssdcx.rank1_layout(N, F, 1, C128) == lay
    for chains in (1, DEFAULT_CHAINS, RUN_CHAINS):
        assert ssdcx.plan_layout(N, F, 1, C128, chains) == lay
    assert tr * NP == threads <= ssd.RANK1_MAX_THREADS
    assert want <= _build.SMEM_PER_BLOCK
    text = ssdcx.layout(N, F, 1, lay, C128)
    assert f"rank-1: cluster of {cs} blocks of {threads} threads" in text


def test_rank1_bytes_at_the_runs_shapes():
    """The shapes of the item 4 runs by hand: l15_f64 111,824 bytes,
    flux14_c128 232,200; F = 2 at dk = 1, N = 144 in float64 in clusters
    of 4 (the plan tries no cluster of 2 at F = 2): 21,024; the repulsive
    14x14 in a flux (complex128 F = 2, N = 196) in clusters of 8: 126,600,
    where clusters of 4 would need more than one block's shared memory."""
    assert ssd.rank1_layout(225, 1, 1, F64).smem == 111824
    assert ssdcx.rank1_layout(196, 1, 1, C128).smem == 232200
    assert ssd.rank1_layout(144, 2, 1, F64).smem == 21024
    assert ssdcx.rank1_layout(196, 2, 1, C128).smem == 126600
    assert ssd.RANK1_SIZES == {1: (2, 4), 2: (4, 8)}
    assert min(_rank1_bytes(200, 2, 4, tr, True) for tr in (1, 2)) > \
        _build.SMEM_PER_BLOCK
    # one more thread row would not fit the complex128 block's registers'
    # thread cap, one fewer its shared memory
    assert 4 * 200 > ssd.RANK1_MAX_THREADS
    assert _rank1_bytes(200, 1, 2, 1, True) > _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("F,cx", [(1, False), (2, False), (1, True),
                                  (2, True)])
def test_rank1_budgets(F, cx):
    """Wherever the rank-1 layout is planned (every N from 129 to 256) it
    fits: whole units, rows and thread rows, at least 16 / F rows a thread
    (the register rows), at most 512 threads (128 registers a thread within
    the SM's 65,536: the kernel's __launch_bounds__), the shared memory
    within one block's; and the register rows take 64 registers (32
    doubles) a thread. Float64 and complex128 take every N at both F
    (complex128 F = 2 past N = 192 in clusters of 8)."""
    dtype, mod = (C128, ssdcx) if cx else (F64, ssd)
    assert 2 * 2 * ssd.rank1_regs(F) * F == 64
    for N in range(129, 257):
        lay = mod.rank1_layout(N, F, 1, dtype)
        NP = mod.padded(N)
        assert lay is not None, N
        if F == 2:
            assert lay.cs == (8 if cx and NP > 192 else 4)
        cs, (tr,) = lay.cs, lay.geometry
        units = NP if cx else NP // 2
        rows = NP // cs
        assert cs in ssd.RANK1_SIZES[F]
        assert NP % cs == 0 and rows % tr == 0
        assert rows // tr >= ssd.rank1_regs(F)
        threads = tr * units
        assert threads <= ssd.RANK1_MAX_THREADS
        assert threads * (REGISTERS // ssd.RANK1_MAX_THREADS) <= REGISTERS
        assert lay.smem == ssd.rank1_smem(NP, F, cs, tr, cx) <= \
            _build.SMEM_PER_BLOCK


def test_rank1_header_agrees():
    """csrc/site_sweep_rank1.cuh's constants and byte count are the ones the
    plan uses: 512 threads at most, 16 / F register rows, the same sums.
    The bound on threads is max_threads(F, KR), which gives the delayed
    sweeps' instances (KR = 16 / F: 64 registers of G) all 512."""
    src = (CSRC / "site_sweep_rank1.cuh").read_text()
    assert re.search(r"constexpr int kMaxThreads = (\d+);", src).group(1) \
        == str(ssd.RANK1_MAX_THREADS)
    assert "return 16 / F;" in src
    assert "__launch_bounds__(max_threads(F, KR))" in src
    assert "65536 / (4 * F * KR + 48) / 32 * 32 < kMaxThreads" in src
    assert all(65536 // (4 * F * ssd.rank1_regs(F) + 48) // 32 * 32
               >= ssd.RANK1_MAX_THREADS for F in (1, 2))
    assert ("16 * ((size_t)F * RS * NT + 2 * (size_t)F * UR + "
            "4 * (size_t)F * RQ)") in src
    assert "(cx ? 9 : 18) * (size_t)NP" in src


@pytest.mark.parametrize("N,F,dk,dtype,kind", [
    (256, 1, 32, F64, "cluster"), (256, 2, 32, F64, "cluster"),
    (144, 2, 24, F64, "cluster"), (132, 1, 2, F64, "slab"),
    (256, 1, 32, torch.float32, "cluster"), (169, 1, 1, torch.float32,
                                             "cluster"),
    (256, 1, 32, C128, "cluster"), (256, 2, 16, C128, "cluster"),
    (196, 1, 1, torch.complex64, "cluster"), (196, 2, 2, C128, "cluster")])
def test_other_shapes_keep_their_layouts(N, F, dk, dtype, kind):
    """dk > 1, float32 and complex64 keep the delayed layouts (cluster or
    slab); so does complex128 F = 2 at dk = 2 past N = 192."""
    mod = ssdcx if dtype.is_complex else ssd
    assert mod.plan_layout(N, F, dk, dtype, RUN_CHAINS).kind == kind
    assert mod.rank1_layout(N, F, dk, dtype) is None
    assert mod.kernel_supports(N, F, dk, dtype)


def test_k9_c128_flavor_plan():
    """K9-c128 at F = 2, N = 256, dk = 32 (the repulsive 16x16 in a flux):
    clusters of 2 blocks, one flavor each, in 2 row and 2 column passes,
    230,288 bytes a block by hand; 64 chains take 128 blocks, one wave on
    132 SMs, where the delayed cluster layout took clusters of 4 in two
    flavor stages and four passes (256 blocks, two waves of 30 clusters).
    Up to 30 chains that cluster layout runs in one wave and stays the
    plan's (DQMC's default 16 chains among them), and so do clusters of 4
    at N = 192, where the plan took clusters of 2 before; at N = 160 the
    flavor layout takes one row pass and stays the plan at every count."""
    dk, ld = 32, (32 + 3) // 4 * 4 + 4
    want = (8 * (2 * dk * 128 + 2 * dk * 128 + 4 * dk * ld + 4 * dk * dk
                 + 2 * dk * (dk + 1) + 4 * dk + 5 * 256)
            + 4 * (dk + 4 + 256) + 256)
    assert want == 230288
    flavors = Layout("flavors", 2, (2, 2), want)
    assert ssdcx.flavors_layout(256, 2, 32, C128) == flavors
    assert ssdcx.flavors_smem(256, 32, 2, 2) == want <= _build.SMEM_PER_BLOCK
    # fewer passes would not fit
    for p, r in ((1, 1), (2, 1), (1, 2)):
        assert ssdcx.flavors_smem(256, 32, p, r) > _build.SMEM_PER_BLOCK
    assert 64 * 2 <= 132
    cluster = ssdcx.cluster_layout(256, 2, 32, 4, C128)
    assert cluster == Layout("cluster", 4, (4, 2), 216864)
    assert ssdcx.CLUSTERS_AT_ONCE[4] == 30
    for chains in (31, 33, RUN_CHAINS, 160):
        assert ssdcx.plan_layout(256, 2, 32, C128, chains) == flavors
        assert ssdcx.layouts(256, 2, 32, C128, chains) == [flavors, cluster]
    for chains in (1, 8, DEFAULT_CHAINS, 30):
        assert ssdcx.plan_layout(256, 2, 32, C128, chains) == cluster
        assert ssdcx.layouts(256, 2, 32, C128, chains) == [cluster, flavors]
    for N, rows in ((160, 1), (192, 2)):
        four = ssdcx.cluster_layout(N, 2, 32, 4, C128)
        flavors = ssdcx.flavors_layout(N, 2, 32, C128)
        assert four.geometry == (2, 2) and flavors.geometry == (2, rows)
        assert ssdcx.cluster_plan(N, 2, 32, C128) == 2
        assert ssdcx.plan_layout(N, 2, 32, C128, DEFAULT_CHAINS) == (
            four if rows > 1 else flavors)
        assert ssdcx.plan_layout(N, 2, 32, C128, RUN_CHAINS) == flavors
    text = ssdcx.layout(256, 2, 32, dtype=C128, chains=RUN_CHAINS)
    assert text.startswith("flavors: cluster of 2 blocks")
    assert "2 row passes and 2 column passes" in text
    assert ssdcx.layout(256, 2, 32, dtype=C128, chains=DEFAULT_CHAINS) \
        .startswith("cluster of 4 blocks")


@pytest.mark.parametrize("N,dk", [(256, 16), (256, 8), (144, 24), (256, 64),
                                  (200, 40)])
def test_flavor_plan_only_where_stages_were(N, dk):
    """The flavor layout takes complex128 F = 2 only where the delayed
    cluster layout would need two flavor stages; complex64 and F = 1
    never."""
    stages = None
    cs = ssdcx.cluster_plan(N, 2, dk, C128)
    if cs > 1:
        stages = ssdcx.plan(N, 2, dk, cs, C128)[1]
    fl = ssdcx.flavors_layout(N, 2, dk, C128)
    if stages == 1:
        assert fl is None
    assert ssdcx.flavors_layout(N, 2, dk, torch.complex64) is None
    assert ssdcx.flavors_layout(N, 1, dk, C128) is None


# complex128 F = 2 shapes the delayed cluster layout takes in two flavor
# stages where no flavor layout fits (dk does not divide N/R, or 4 does not
# divide N/R): (N, dk, CS, column passes)
TWO_STAGES = [(140, 35, 4, 4), (170, 34, 4, 4), (175, 35, 4, 4),
              (186, 31, 2, 4), (204, 34, 4, 4), (217, 31, 2, 4),
              (224, 32, 4, 4), (243, 27, 2, 2), (252, 28, 2, 4)]


@pytest.mark.parametrize("N,dk,cs,passes", TWO_STAGES)
def test_two_flavor_stages_still_planned(N, dk, cs, passes):
    """The cluster layout's two flavor stages stay the plan at every chain
    count where the flavor layout does not fit (complex128 F = 2 at a
    delay past the default, such as 224 sites at dk = 32)."""
    lay = ssdcx.plan_layout(N, 2, dk, C128, RUN_CHAINS)
    assert ssdcx.flavors_layout(N, 2, dk, C128) is None
    assert lay == ssdcx.cluster_layout(N, 2, dk, cs, C128)
    assert lay.geometry == (passes, 2)
    assert lay.smem <= _build.SMEM_PER_BLOCK
    assert ssdcx.plan_layout(N, 2, dk, C128, 1) == lay


def test_two_stages_only_where_planned():
    """The converse: wherever the plan runs two flavor stages (complex128 F =
    2, every N from 129 to 256 and every dk | N), no flavor layout fits, or
    the chains run in one wave of clusters of 4 where the flavor layout
    needs two row passes; and TWO_STAGES lists every shape of the first
    kind."""
    seen = []
    for N in range(129, 257):
        for dk in (d for d in range(1, N + 1) if N % d == 0):
            for chains in (DEFAULT_CHAINS, RUN_CHAINS):
                lay = ssdcx.plan_layout(N, 2, dk, C128, chains)
                if lay is None or lay.kind != "cluster" \
                        or lay.geometry[1] == 1:
                    continue
                flavors = ssdcx.flavors_layout(N, 2, dk, C128)
                assert flavors is None or (
                    lay.cs == 4 and chains <= ssdcx.CLUSTERS_AT_ONCE[4]
                    and flavors.geometry[1] == 2), (N, dk, chains)
                if flavors is None and chains == RUN_CHAINS:
                    seen.append((N, dk, lay.cs, lay.geometry[0]))
    assert seen == TWO_STAGES


@pytest.mark.parametrize("L,repulsive,dtype", [
    (L, rep, dt) for L in (12, 13, 14, 15) for rep in (False, True)
    for dt in (F64, C128)])
def test_every_hubbard_session_keeps_a_hand_sweep(L, repulsive, dtype):
    """_check_cuda_kernels takes every L x L session of 12 <= L <= 15 at
    the default delay (dk = 1) in both FP64 dtypes and both models, and the
    plan runs the rank-1 layout there (complex128 F = 2 past N = 192 in
    clusters of 8)."""
    N, F = L * L, 2 if repulsive else 1
    udtype = dtype
    core._check_cuda_kernels(N, F, core._delay(N, None), dtype, udtype)
    mod = ssdcx if dtype.is_complex else ssd
    lay = mod.plan_layout(N, F, 1, dtype, RUN_CHAINS)
    wide = dtype.is_complex and F == 2 and mod.padded(N) > 192
    assert lay.kind == "rank1"
    assert (lay.cs == 8) == wide
