"""The PyTorch/CUDA port's DQMC against exact diagonalization, on the CPU.

The JAX package's central correctness gate (tests/test_ed_equal_time.py) for
the observables the port has: the equal-time Green's function and the
occupation of the 2x2 attractive and repulsive Hubbard models at beta=1,
dtau=0.1, within the Trotter tolerance 2*dtau^2 = 0.02. The run goes
through the public entry point, DQMC(...).run(), in float64 on the CPU (the
kernel route's plain versions; 256 chains x 100 measured sweeps: the largest
error is ~0.005, with standard errors ~0.001); the attractive model also
with stab_method="qr_colscaled".
"""

import numpy as np
import pytest

import montecarlo_tpu_torch as mt

from ed_oracle import EDSolution

ATOL = 2 * 0.1 ** 2  # 2*dtau^2


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
    sim = mt.DQMC(model, beta=1.0, delta_tau=0.1, safe_mult=5, n_chains=256,
                  seed=21, device="cpu", measure_rate=1,
                  stab_method=stab_method)
    assert sim.run(thermalization=40, sweeps=100, verbose=False)
    assert sim.analysis.propagation_error.count == 0
    obs = sim.observables()
    G = obs["greens"]["greens"].mean                       # (F, N, N)
    occ = obs["occ"]["occ"].mean                           # (F, N)
    for f in range(model.nflavors):
        G_ed = ed.greens_spin(1.0, f, f)
        assert np.max(np.abs(G[f] - G_ed)) < ATOL, (f, G[f], G_ed)
        assert np.max(np.abs(occ[f] - (1.0 - np.diag(G_ed)))) < ATOL
