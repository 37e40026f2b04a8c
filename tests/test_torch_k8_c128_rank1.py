"""K8-c128 (the complex128 rank-1 site sweep, ``site_sweep_cx_c128``) past
N = 64 in the rank-1 layout of ``csrc/site_sweep_rank1.cuh``: G of a chain
on chip in one block or a cluster of two, where that ran faster on an H100.

On the CPU: the rank-1 layout's plain version (``site_sweep_delayed_cx_plain``
at dk = 1) is bit-equal to K8's (``site_sweep_cx_plain``), so a kernel that is
bit-equal to the one is bit-equal to the other; and the plan's layout at
every complex128 shape 64 < N <= 128 is the measured one, within one
block's limits. The ``cuda`` cases hold the kernel bit-equal to
``site_sweep_cx_plain`` on the card and skip without one. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_k8_c128_rank1.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
from torch_port_inputs import (LAMB, MODELS, cx_sweep_inputs,  # noqa: F401
                               one_torch_thread)

C128 = torch.complex128
CSRC = Path(sscx.__file__).resolve().parent.parent / "csrc"
MODEL = {1: "attractive", 2: "repulsive"}


def _inputs(N, C, F, device="cpu"):
    """complex128 G, sigma and float64 u from a numpy seed."""
    G, sigma, u = cx_sweep_inputs(N + 7 * F, C, F, N)
    return (torch.from_numpy(G.astype(np.complex128)).to(device),
            torch.from_numpy(sigma).to(device),
            torch.from_numpy(u.astype(np.float64)).to(device))


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("N", [65, 72, 81, 100, 121, 128])
def test_rank1_plain_is_k8_plain(N, F):
    """site_sweep_delayed_cx_plain at dk = 1 and site_sweep_cx_plain give
    the same G, sigma, accept flags and det bit for bit in complex128."""
    kw = dict(lamb=LAMB, **MODELS[MODEL[F]])
    G, sigma, u = _inputs(N, 2, F)
    out_r = ssdcx.site_sweep_delayed_cx_plain(G, sigma, u, dk=1, **kw)
    out_k = sscx.site_sweep_cx_plain(G, sigma, u, **kw)
    for a, b in zip(out_r, out_k):
        assert torch.equal(a, b)
    assert 0 < out_k[2].sum().item() < 2 * N


def _planned(N, F, chains):
    """(CS, KR) of the rank-1 layout the plan should take, or None (the
    one-block layout or its flavor pair): PERF.md's measured choices."""
    wide = chains > sscx.CLUSTERS_AT_ONCE
    if wide and ssdcx.padded(N) <= sscx.ONE_BLOCK_MAX_N:
        return (1, 20) if F == 1 else (1, 11)
    if F == 1:
        return None if wide else (2, 16)
    return (2, 10) if N <= sscx.RANK1_MAX_N else None


@pytest.mark.parametrize("F", [1, 2])
def test_plan_past_64(F):
    """At every complex128 N from 65 to 128 and 1, 16 or 256 chains the
    plan takes the layout that ran fastest there on an H100 (PERF.md): the
    rank-1 layout with one block per chain up to N = 88 past one wave of
    clusters (66 chains), in clusters of 2 below that count (F = 1 to
    N = 128) and at F = 2 up to N = 104; else the one-block layout (F = 1:
    the imaginary plane in shared memory) or its flavor pair (F = 2). Each
    rank-1 layout is a built instance within one block's shared memory and
    its thread cap, with at most 11 rows a thread and flavor in shared
    memory."""
    for N in range(65, 129):
        NP = ssdcx.padded(N)
        for chains in (1, 16, 256):
            lay = sscx.plan_layout(N, F, C128, chains)
            assert lay == sscx.layouts(N, F, C128, chains)[0]
            assert sscx.kernel_supports(N, F, C128)
            want = _planned(N, F, chains)
            if want is None:
                assert lay.kind == ("tiled" if F == 1 else "flavors"), N
                continue
            tr, kr = lay.geometry
            rows = NP // lay.cs
            assert lay.kind == "rank1" and (lay.cs, kr) == want, (N, lay)
            assert (F, lay.cs, kr) in sscx.RANK1_BUILDS
            assert NP % lay.cs == 0 and rows % tr == 0
            assert rows // tr - kr <= 11
            assert lay.smem == sscx.rank1_smem(NP, F, lay.cs, tr, True, kr)
            assert lay.smem <= _build.SMEM_PER_BLOCK == 232448
            assert tr * NP <= sscx.rank1_max_threads(F, kr) <= 512
            assert "rank-1" in sscx.layout(N, F, C128, lay)
    assert not sscx.kernel_supports(129, F, C128)
    assert (sscx.RANK1_MAX_N, sscx.ONE_BLOCK_MAX_N,
            sscx.CLUSTERS_AT_ONCE) == (104, 88, 66)


@pytest.mark.parametrize("F", [1, 2])
def test_plan_keeps_one_block_to_64(F):
    """At N <= 64 the plan keeps K8's one-block layout in complex128 (every
    plane in registers), and lists the rank-1 layouts after it for timing;
    complex64 keeps the one-block layout at every N <= 128."""
    for N in (1, 16, 33, 63, 64):
        lays = sscx.layouts(N, F, C128, 256)
        assert lays[0] == sscx.plan_layout(N, F, C128, 256)
        assert lays[0].kind == "tiled" and lays[0].cs == 1
        assert "G in registers" in sscx.layout(N, F, C128)
        assert all(lay.kind == "rank1" for lay in lays[1:])
    for N in (64, 100, 128):
        assert [lay.kind for lay in sscx.layouts(N, F)] == ["tiled"]


def test_rank1_builds_agree_with_the_source():
    """The (F, CS, KR) instances the plan picks from are the ones
    site_sweep_cx.cu builds, and max_threads is the header's: 512 threads
    where G takes up to 80 registers a thread, fewer beyond (416 at 104:
    a block of 13 warps gets at most 128 registers a thread)."""
    src = (CSRC / "site_sweep_cx.cu").read_text()
    body = src[src.index("using K8Rank1"):src.index(";", src.index(
        "using K8Rank1"))]
    built = {tuple(map(int, m)) for m in
             re.findall(r"Inst<(\d+), (\d+), (\d+)>", body)}
    assert built == set(sscx.RANK1_BUILDS)
    header = (CSRC / "site_sweep_rank1.cuh").read_text()
    assert "65536 / (4 * F * KR + 48) / 32 * 32 < kMaxThreads" in header
    assert [sscx.rank1_max_threads(F, kr) for F, kr in
            ((1, 16), (1, 20), (2, 10), (2, 11), (2, 13))] == \
        [512, 512, 512, 480, 416]


def test_launch_needs_cuda():
    """The wrapper launches the kernel for a CUDA tensor only: a CPU tensor
    takes the plain version, and launch() refuses it."""
    kw = dict(lamb=LAMB, **MODELS["repulsive"])
    G, sigma, u = _inputs(100, 1, 2)
    n0 = sscx.site_sweep_cx_c128.launches
    out = sscx.site_sweep_cx_c128(G, sigma, u, **kw)
    assert sscx.site_sweep_cx_c128.launches == n0
    assert torch.equal(out[0], sscx.site_sweep_cx_plain(G, sigma, u, **kw)[0])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        sscx.launch(G, sigma, u, sscx.plan_layout(100, 2, C128), **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see README: PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 16, 256])
@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("N", [65, 81, 100, 121, 128])
def test_k8_c128_rank1_kernel_matches_plain(cuda, N, F, C):
    """K8-c128 in the plan's layout and in every rank-1 layout at the
    shape: G, sigma, accept and det bit-equal to site_sweep_cx_plain's; one
    launch counted per call."""
    kw = dict(lamb=LAMB, **MODELS[MODEL[F]])
    G, sigma, u = _inputs(N, C, F, cuda)
    assert (sscx.plan_layout(N, F, C128, C).kind == "rank1") == (
        _planned(N, F, C) is not None)
    out_p = sscx.site_sweep_cx_plain(G, sigma, u, **kw)
    n0 = sscx.site_sweep_cx_c128.launches
    out_k = sscx.site_sweep_cx_c128(G, sigma, u, **kw)
    assert sscx.site_sweep_cx_c128.launches == n0 + 1
    outs = [out_k] + [sscx.launch(G, sigma, u, lay, **kw)
                      for lay in sscx.layouts(N, F, C128, C)
                      if lay.kind == "rank1"]
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(out, out_p):
            assert torch.equal(a, b)
    assert 0 < out_k[2].sum().item() < C * N
