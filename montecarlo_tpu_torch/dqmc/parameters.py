"""DQMC parameters (counterpart of montecarlo_tpu/dqmc/parameters.py)."""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass


@dataclass
class DQMCParameters:
    """Any two of (beta, delta_tau, slices) determine the third; beta alone
    takes delta_tau=0.1. safe_mult shrinks to the largest divisor of slices.
    Defaults: delta_tau=0.1, safe_mult=10, measure_rate=10,
    thermalization=100, sweeps=100."""

    beta: float = None
    delta_tau: float = None
    slices: int = None

    global_moves: bool = False
    global_rate: int = 5
    thermalization: int = 100
    sweeps: int = 100
    silent: bool = False
    check_sign_problem: bool = True
    check_propagation_error: bool = True
    safe_mult: int = 10
    measure_rate: int = 10
    print_rate: int = 10
    warn_round: bool = True

    def __post_init__(self):
        beta, dtau, slices = self.beta, self.delta_tau, self.slices
        given = {k for k, v in
                 (("beta", beta), ("delta_tau", dtau), ("slices", slices))
                 if v is not None}
        if given == {"beta"}:
            dtau = 0.1
            given.add("delta_tau")
        if given == {"beta", "delta_tau", "slices"}:
            calc = round(beta / dtau)
            if calc != slices:
                raise ValueError(
                    f"Given slices ({slices}) does not match beta/delta_tau "
                    f"≈ {calc}")
        elif given == {"beta", "slices"}:
            dtau = beta / slices
        elif given == {"delta_tau", "slices"}:
            beta = dtau * slices
        elif given == {"beta", "delta_tau"}:
            slices = round(beta / dtau)
            if self.warn_round and abs(slices - beta / dtau) > 1e-9:
                warnings.warn(
                    f"beta/delta_tau = {beta / dtau} not an integer. "
                    f"Rounded to {slices}")
        else:
            raise ValueError(
                "DQMCParameters needs at least two of beta/delta_tau/slices "
                f"(got {given or 'none'})")
        self.beta = float(beta)
        self.delta_tau = float(dtau)
        self.slices = int(slices)
        if self.slices % self.safe_mult != 0:
            sm = self.safe_mult
            while self.slices % sm != 0:
                sm -= 1
            self.safe_mult = sm

    def as_dict(self):
        return dataclasses.asdict(self)
