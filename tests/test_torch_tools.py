"""The chip scripts' bookkeeping for the redesigned kernels K2, K3, K4, K14,
K11, K13, K1-f64 and K5, on the CPU: chip_ab.py's case selection,
chip_profile.py's stamps, device shares and configurations, and the phases
the stamped builds of csrc/udt_qr.cu, csrc/qr_f64.cu and
csrc/site_sweep_wrap.cu report. No card is needed: nothing here launches a
kernel."""

import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_ab  # noqa: E402
import chip_profile  # noqa: E402
from montecarlo_tpu_torch.ops import qr  # noqa: E402

UDT_CASES = ["udt_qr (256, 64, 64)", "udt_qr_solve (256, 64, 64)",
             "udt_qr (512, 64, 64)", "udt_qr_solve (512, 64, 64)"]


@pytest.mark.parametrize("prefixes,expected", [
    ([], list(chip_ab.CASES)),
    (["udt"], UDT_CASES),
    (["udt_qr_solve"], UDT_CASES[1::2]),
    (["udt_qr (512", "qr_blocked"], ["qr_blocked (64, 256, 256)",
                                     "udt_qr (512, 64, 64)"]),
    (["no such case"], []),
])
def test_chip_ab_selects_cases_by_prefix(prefixes, expected):
    assert chip_ab.selected(prefixes) == expected


def test_chip_ab_times_k2_k3_at_the_headline_and_repulsive_shapes():
    assert all(name in chip_ab.CASES for name in UDT_CASES)


@pytest.mark.parametrize("solve,label", [(False, "K2"), (True, "K3")])
def test_chip_profile_names_k2_k3(solve, label):
    """Stamped and shared under the kernel name the profiler reports for
    each instantiation (udt_kernel<SOLVE, N>)."""
    assert label in chip_profile.STAMPED
    name = (f"void (anonymous namespace)::udt_kernel<{str(solve).lower()}, "
            "64>(float const*, float const*, float const*, float*, float*, "
            "float*, float*)")
    assert [k for k, frags in chip_profile.SHARES.items()
            if any(f in name.lower() for f in frags)] == [label]


def test_udt_stamp_phases_fit_the_phase_clock():
    """csrc/udt_qr.cu laps phases 0..len(PHASES)-1, within kPhases."""
    src = (ROOT / "montecarlo_tpu_torch/csrc/udt_qr.cu").read_text()
    header = (ROOT / "montecarlo_tpu_torch/csrc/phase_clock.cuh").read_text()
    k_phases = int(re.search(r"kPhases = (\d+);", header).group(1))
    laps = {int(p) for p in re.findall(r"clk\.lap\((\d+)\)", src)}
    assert laps == set(range(len(qr.PHASES)))
    assert len(qr.PHASES) <= k_phases


def test_chip_profile_single_runs_one_chain():
    model, safe_mult, chains, plain, session = chip_profile.CONFIGS["single"]
    assert chains == 1 and plain and session == {"dtype": "float32"}


def test_chip_ab_times_k11_and_k13_at_their_runs_shapes():
    """K11 at the f64 run's shape and K13 at the fusewrap run's, each
    direction: the cases the parent and the change are timed on."""
    assert chip_ab.selected(["qr_f64", "site_sweep_wrap"]) == [
        "qr_f64 (128, 64, 64)", "site_sweep_wrap up (256, 1, 64, 64)",
        "site_sweep_wrap down (256, 1, 64, 64)"]


@pytest.mark.parametrize("label,name", [
    ("K4", "void (anonymous namespace)::qr_f32_kernel<false, 64>(float "
           "const*, float*, float*, float*)"),
    ("K14", "void (anonymous namespace)::qr_f32_kernel<true, 128>(float "
            "const*, float*, float*, float*)"),
    ("K4", "void (anonymous namespace)::qr_kernel<false>(float const*, "
           "float*, float*, float*, int)"),
    ("K14", "void (anonymous namespace)::qr_kernel<true>(float const*, "
            "float*, float*, float*, int)"),
    ("K11", "void (anonymous namespace)::qr_f64_kernel<64, 4>(double const*, "
            "double*, double*)"),
    ("K13", "void (anonymous namespace)::site_sweep_wrap_kernel<1, 1, "
            "tiled::Geom<16, 16, 4, 4> >(float const*, float*, signed char "
            "const*, signed char*, float const*, int*, int*, float const*, "
            "float const*, int, float, float, float, int, int)")])
def test_chip_profile_names_the_householder_kernels(label, name):
    """Shared under the kernel name the profiler reports, by one label only
    (K4's and K14's qr_f32_kernel<VTAU, N>, and their former
    qr_kernel<VTAU> for A/B runs against older checkouts, apart from K11's
    qr_f64_kernel and K2's and K3's udt_kernel); each is stamped."""
    assert label in chip_profile.STAMPED
    assert [k for k, frags in chip_profile.SHARES.items()
            if any(f in name.lower() for f in frags)] == [label]


@pytest.mark.parametrize("source,phases", [
    ("qr_f64.cu", "qr_householder.PHASES_F64"),
    ("site_sweep_wrap.cu", "site_sweep.WRAP_PHASES")])
def test_k11_k13_stamp_phases_fit_the_phase_clock(source, phases):
    """The stamped build of each kernel laps phases 0..len(PHASES)-1 (K13:
    K1's loop's laps and its wrap's), within kPhases."""
    from montecarlo_tpu_torch.ops import qr_householder, site_sweep
    names = {"qr_householder": qr_householder, "site_sweep": site_sweep}
    mod, attr = phases.split(".")
    phases = getattr(names[mod], attr)
    csrc = ROOT / "montecarlo_tpu_torch/csrc"
    src = (csrc / source).read_text()
    if source == "site_sweep_wrap.cu":
        src += (csrc / "site_sweep_tiled.cuh").read_text()
    header = (csrc / "phase_clock.cuh").read_text()
    k_phases = int(re.search(r"kPhases = (\d+);", header).group(1))
    laps = {int(p) for p in re.findall(r"clk\.lap\((\d+)\)", src)}
    assert laps == set(range(len(phases)))
    assert len(phases) <= k_phases


def test_chip_profile_mixed_runs_float32_updates_over_float64():
    """mixed: the f64 run's model, safe_mult and chains, float64 stacks
    (DQMC's default dtype) under float32 updates (K1 and K11)."""
    f64 = chip_profile.CONFIGS["f64"]
    mixed = chip_profile.CONFIGS["mixed"]
    assert mixed[:4] == f64[:4] and f64[4] == {}
    assert mixed[4] == {"update_dtype": "float32"}


def test_chip_ab_compares_outputs_bit_for_bit():
    """chip_ab's parent-and-change output check: equal lists are bit-equal
    with no difference; a changed float entry reads its difference; a
    dtype change is not bit-equal."""
    import torch
    a = [torch.tensor([1.0, 2.0], dtype=torch.float64),
         torch.tensor([1, -1], dtype=torch.int8)]
    assert chip_ab.compare_outputs(a, [t.clone() for t in a]) == (True, 0.0)
    b = [torch.tensor([1.0, 2.5], dtype=torch.float64), a[1].clone()]
    assert chip_ab.compare_outputs(a, b) == (False, 0.5)
    c = [a[0].float(), a[1]]
    assert chip_ab.compare_outputs(a, c)[0] is False


def test_chip_ab_times_k1_f64_and_k5_beside_k1():
    """K1 in float64 at the f64 run's shape and at F = 2, K5 at the
    repulsive run's shape and at F = 1, and K1 on K5's inputs: each group
    selected by its own prefix; the prefix site_sweep takes them all."""
    f64 = ["site_sweep_f64 (128, 1, 64, 64)", "site_sweep_f64 (64, 2, 64, 64)"]
    pair = ["site_sweep_pair (256, 2, 64, 64)",
            "site_sweep_pair (256, 1, 64, 64)"]
    k1 = ["site_sweep on K5's inputs (256, 2, 64, 64)",
          "site_sweep on K5's inputs (256, 1, 64, 64)"]
    assert chip_ab.selected(["site_sweep_f64"]) == f64
    assert chip_ab.selected(["site_sweep_pair"]) == pair
    assert chip_ab.selected(["site_sweep on"]) == k1
    assert set(f64 + pair + k1) <= set(chip_ab.selected(["site_sweep"]))


@pytest.mark.parametrize("label,name", [
    ("K1-f64", "void (anonymous namespace)::site_sweep_tiled_f64<1, "
               "tiled::Geom<16, 16, 4, 4, double> >(double const*, double*, "
               "signed char const*, signed char*, double const*, int*, int*, "
               "double*, int, double, double, double, int, int)"),
    ("K1-f64", "void (anonymous namespace)::site_sweep_kernel<double, 1>("
               "double const*, double*, signed char const*, signed char*, "
               "double const*, int*, int*, double*, int, double, double, "
               "double, int, int)"),
    ("K5", "void (anonymous namespace)::site_sweep_pair_tiled<2, "
           "tiled::Geom<16, 16, 4, 4, float> >(float const*, float*, signed "
           "char const*, signed char*, float const*, int*, int*, int, float, "
           "float, float, int, int)"),
    ("K5", "void (anonymous namespace)::site_sweep_pair_kernel<2>(float "
           "const*, float*, signed char const*, signed char*, float const*, "
           "int*, int*, int, float, float, float, int, int)"),
    ("K1", "void (anonymous namespace)::site_sweep_tiled_f32<2, "
           "tiled::Geom<16, 16, 4, 4, float> >(float const*, float*, signed "
           "char const*, signed char*, float const*, int*, int*, int, float, "
           "float, float, int, int)")])
def test_chip_profile_names_k1_f64_and_k5(label, name):
    """K1-f64 and K5 are stamped, and shared under one label each, under
    their kernels' names and their former ones (A/B runs against the
    parent), apart from K1 in float32."""
    assert label in chip_profile.STAMPED
    assert [k for k, frags in chip_profile.SHARES.items()
            if any(f in name.lower() for f in frags)] == [label]


def test_k1_f64_k5_stamp_phases_fit_the_phase_clock():
    """csrc/site_sweep.cu's kernels (K1 in float32 and float64, K5) run the
    loops of csrc/site_sweep_tiled.cuh, which lap phases 0..len(PHASES)-1,
    within kPhases, read by the file's one readout."""
    from montecarlo_tpu_torch.ops import _build, site_sweep
    csrc = ROOT / "montecarlo_tpu_torch/csrc"
    src = (csrc / "site_sweep.cu").read_text()
    loops = (csrc / "site_sweep_tiled.cuh").read_text()
    header = (csrc / "phase_clock.cuh").read_text()
    k_phases = int(re.search(r"kPhases = (\d+);", header).group(1))
    for loop in ("sweep_chain(", "sweep_chain_pair("):
        body = loops[loops.index(loop):]
        body = body[:body.index("\n}\n")]
        laps = {int(p) for p in re.findall(r"clk\.lap\((\d+)\)", body)}
        assert laps == set(range(len(site_sweep.PHASES))), loop
    assert len(site_sweep.PHASES) <= k_phases
    assert src.count("clk.store(g_stamps, c)") == 3   # K1, K1-f64, K5
    assert 'extern "C" int site_sweep_f32_stamps(' in src
    assert "site_sweep_f32_stamps" in _build.SIGNATURES
    assert "site_sweep_loop" not in src


def test_chip_ab_times_k4_and_k14_at_their_runs_shapes():
    """K4 at the colscaled run's shape and at N = 128, K14 at the
    colscaled_wy run's and at N = 128: each kernel selected by its own
    prefix, apart from K11's qr_f64."""
    k4 = ["qr_f32 (256, 64, 64)", "qr_f32 (64, 128, 128)"]
    k14 = ["qr_vtau (256, 64, 64)", "qr_vtau (256, 128, 128)"]
    assert chip_ab.selected(["qr_f32"]) == k4
    assert chip_ab.selected(["qr_vtau"]) == k14
    assert chip_ab.selected(["qr_f"]) == ["qr_f64 (128, 64, 64)"] + k4


@pytest.mark.parametrize("label", ["K4", "K14"])
def test_k4_k14_are_stamped_on_the_udt_loop(label):
    """K4 and K14 run csrc/udt_qr.cu's column loop (the shared-memory
    qr_householder.cu is gone), whose laps test_udt_stamp_phases_fit_the_
    phase_clock holds to ops/qr.py's PHASES: stamped, read by
    qr_f32_stamps, launched through their C entry points."""
    from montecarlo_tpu_torch.ops import _build
    assert label in chip_profile.STAMPED
    csrc = ROOT / "montecarlo_tpu_torch/csrc"
    assert not (csrc / "qr_householder.cu").exists()
    src = (csrc / "udt_qr.cu").read_text()
    assert 'extern "C" int qr_f32_stamps(' in src
    assert "qr_f32_stamps" in _build.SIGNATURES
    for entry in ('extern "C" int qr_f32(', 'extern "C" int qr_vtau_f32('):
        assert entry in src
