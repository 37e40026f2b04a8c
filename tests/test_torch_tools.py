"""The chip scripts' bookkeeping for the fused UDT kernels K2 and K3, on the
CPU: chip_ab.py's case selection, chip_profile.py's stamps, device shares
and configurations, and the phases the stamped build of csrc/udt_qr.cu
reports. No card is needed: nothing here launches a kernel."""

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
