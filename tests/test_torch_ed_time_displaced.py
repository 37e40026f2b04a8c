"""The PyTorch/CUDA port's DQMC against exact diagonalization: the
time-displaced observables (the port of tests/test_ed_time_displaced.py).

Unequal-time Green's functions at the reference's (k, l) pairs and the
charge, spin (x, y, z), pairing and current-current susceptibilities of the
2x2 attractive and repulsive Hubbard models at beta=1, dtau=0.1, within the
Trotter tolerance 2*dtau^2 = 0.02. The run goes through the public entry
point, DQMC(...).run(), in float64 on the CPU (the kernel route's plain
versions), with the JAX test's chains, sweeps and measure rate.
"""

import numpy as np
import pytest

import montecarlo_tpu_torch as mt

from ed_oracle import EDSolution

DTAU = 0.1
ATOL = 2 * DTAU ** 2

# (k, l) pairs as in tests/test_ed_time_displaced.py
KL_PAIRS = [(1, 0), (7, 3), (5, 5), (2, 7), (1, 3), (10, 0)]


def _run_dqmc(model, seed=33):
    mc = mt.DQMC(model, beta=1.0, delta_tau=DTAU, safe_mult=5, n_chains=32,
                 seed=seed, thermalization=300, sweeps=1500, measure_rate=3,
                 print_rate=10 ** 9, measurements={}, device="cpu")
    for i, (k, l) in enumerate(KL_PAIRS):
        mc[f"UTG{i}"] = mt.greens_measurement(mc, model, greens_at=(k, l))
    mc["CDS"] = mt.charge_density_susceptibility(mc, model)
    for d in ("x", "y", "z"):
        mc[f"SDS{d}"] = mt.spin_density_susceptibility(mc, model, d)
    mc["PS"] = mt.pairing_susceptibility(mc, model, K=4)
    mc["CCS"] = mt.current_current_susceptibility(mc, model, K=4)
    assert mc.run(verbose=False)
    return mc


def _check(name, dqmc_val, ed_val, atol=ATOL):
    err = np.max(np.abs(np.asarray(dqmc_val) - np.asarray(ed_val)))
    assert err < atol, (f"{name}: max|dqmc-ed| = {err:.4f} > {atol}\n"
                        f"dqmc={np.round(np.asarray(dqmc_val), 4)}\n"
                        f"ed={np.round(np.asarray(ed_val), 4)}")


@pytest.mark.slow
@pytest.mark.parametrize("which", ["attractive", "repulsive"])
def test_port_dqmc_vs_ed_time_displaced(which):
    if which == "attractive":
        model = mt.HubbardModelAttractive(dims=2, L=2, U=1.0, mu=1.0, t=1.0)
        ed = EDSolution(model.lattice, t=1.0, U=1.0, mu=1.0, attractive=True)
    else:
        model = mt.HubbardModelRepulsive(dims=2, L=2, U=1.0, t=1.0)
        ed = EDSolution(model.lattice, t=1.0, U=1.0, mu=0.0, attractive=False)

    mc = _run_dqmc(model)
    obs = mc.observables()
    beta = 1.0

    for i, (k, l) in enumerate(KL_PAIRS):
        utg = obs[f"UTG{i}"]["greens"].mean  # (F, N, N)
        _check(f"UTG(k={k},l={l}) up", utg[0],
               ed.utg_spin(beta, k * DTAU, l * DTAU, 0, 0))
        if model.nflavors == 2:
            _check(f"UTG(k={k},l={l}) dn", utg[1],
                   ed.utg_spin(beta, k * DTAU, l * DTAU, 1, 1))

    _check("CDS", obs["CDS"]["cds"].mean, ed.cds_by_distance(beta, DTAU))
    for d in ("x", "y", "z"):
        _check(f"SDS{d}", obs[f"SDS{d}"][f"sds_{d}"].mean,
               ed.sds_by_distance(beta, DTAU, d))
    _check("PS", obs["PS"]["ps"].mean, ed.ps_by_distance(beta, DTAU, K=4))
    T = model.hopping_matrix()
    _check("CCS", obs["CCS"]["ccs"].mean,
           ed.ccs_by_distance(beta, DTAU, K=4, T=T))
