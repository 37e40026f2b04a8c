"""The PyTorch/CUDA port's DQMC against exact diagonalization, on the CPU.

The JAX package's central correctness gate (tests/test_ed_equal_time.py) for
the observables the port has: the equal-time Green's function, the
occupation, the charge density correlation, the magnetizations and spin
density correlations (x, y, z) and the pairing correlation (K = 4) of the
2x2 attractive and repulsive Hubbard models at beta=1, dtau=0.1, within the
Trotter tolerance 2*dtau^2 = 0.02. The run goes through the public entry
point, DQMC(...).run(), in float64 on the CPU (the kernel route's plain
versions; 256 chains x 100 measured sweeps: the largest error is ~0.005,
with standard errors ~0.001); the attractive model also with
stab_method="qr_colscaled".
"""

import numpy as np
import pytest

import montecarlo_tpu_torch as mt

from ed_oracle import EDSolution
from torch_port_inputs import one_torch_thread  # noqa: F401

ATOL = 2 * 0.1 ** 2  # 2*dtau^2
BETA = 1.0


def _check(name, dqmc_val, ed_val):
    err = np.max(np.abs(np.asarray(dqmc_val) - np.asarray(ed_val)))
    assert err < ATOL, (f"{name}: max|dqmc - ed| = {err:.4f} > {ATOL}\n"
                        f"dqmc={np.round(np.asarray(dqmc_val), 4)}\n"
                        f"ed={np.round(np.asarray(ed_val), 4)}")


@pytest.mark.parametrize("which", ["attractive", "repulsive",
                                   "attractive-qr_colscaled"])
def test_port_dqmc_vs_ed_equal_time(which):
    stab_method = "qr_colscaled" if which.endswith("colscaled") else "qr"
    if which.startswith("attractive"):
        model = mt.HubbardModelAttractive(dims=2, L=2, U=1.0, mu=1.0, t=1.0)
        ed = EDSolution(model.lattice, t=1.0, U=1.0, mu=1.0, attractive=True)
    else:
        model = mt.HubbardModelRepulsive(dims=2, L=2, U=1.0, t=1.0)
        ed = EDSolution(model.lattice, t=1.0, U=1.0, mu=0.0, attractive=False)
    sim = mt.DQMC(model, beta=BETA, delta_tau=0.1, safe_mult=5, n_chains=256,
                  seed=21, device="cpu", measure_rate=1,
                  stab_method=stab_method)
    sim["CDC"] = mt.charge_density_correlation(sim, model)
    for d in ("x", "y", "z"):
        sim[f"M{d}"] = mt.magnetization(sim, model, d)
        sim[f"SDC{d}"] = mt.spin_density_correlation(sim, model, d)
    sim["PC"] = mt.pairing_correlation(sim, model, K=4)
    assert sim.run(thermalization=40, sweeps=100, verbose=False)
    assert sim.analysis.propagation_error.count == 0
    obs = sim.observables()
    G = obs["greens"]["greens"].mean                       # (F, N, N)
    occ = obs["occ"]["occ"].mean                           # (F, N)
    for f in range(model.nflavors):
        G_ed = ed.greens_spin(BETA, f, f)
        _check(f"greens {f}", G[f], G_ed)
        _check(f"occupation {f}", occ[f], 1.0 - np.diag(G_ed))
    _check("CDC", obs["CDC"]["cdc"].mean, ed.cdc_by_distance(BETA))
    for d in ("x", "y", "z"):
        _check(f"M{d}", obs[f"M{d}"][f"m_{d}"].mean, ed.magnetization(BETA, d))
        _check(f"SDC{d}", obs[f"SDC{d}"][f"sdc_{d}"].mean,
               ed.sdc_by_distance(BETA, d))
    _check("PC", obs["PC"]["pc"].mean, ed.pc_by_distance(BETA, K=4))
