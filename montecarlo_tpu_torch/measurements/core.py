"""Generic measurement engine (counterpart of
montecarlo_tpu/measurements/core.py).

A measurement is a named bundle of a ``measure_fn`` returning
{obs_name: (C, *obs_shape) tensor}, one LogBinner state per observable
(batched over chains) and an optional ``finish_fn`` deriving observables from
the binner statistics at the end of a run. Its ``kind`` says which Green's
functions the driver hands it: the equal-time G, a time-displaced G(k, l)
(``greens_at``), or the (G00, G0l, Gl0, Gll) of every slice of the combined
iterator (``combined``, the susceptibilities).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.binner import LogBinner


KINDS = ("equal", "greens_at", "combined")


@dataclass
class Measurement:
    """One measurement: a kernel plus per-observable logarithmic binners.

    obs_shapes maps observable name -> per-chain shape (without the chain
    axis); measure_fn returns {name: tensor of shape (C, *obs_shape)}, every
    Green's function physical (unwrapped) with shape (C, F, N, N):

      kind "equal"      measure_fn(greens=G, conf=(C, N, M), phase=(C,)
                        complex weight phase of a complex session, else None)
      kind "greens_at"  measure_fn(utg=G(k, l), greens=G, conf=conf), with
                        greens_at = (k, l)
      kind "combined"   measure_fn(G00=G, G0l=, Gl0=, Gll=) is a step
                        function; the driver sums its contributions over
                        l = 1..M and multiplies the sum by delta_tau

    combined_acc_shapes (combined): when set, the driver sums the raw
    contributions of these per-chain shapes in the Green's dtype and applies
    combined_finish_fn(acc) once after the iteration (the direction binning
    out of the τ loop); else it sums measure_fn's obs_shapes contributions
    in float64. finish_fn(stats, context) -> {name: value} may derive
    additional observables. dtype is the binners' accumulator type: float64,
    or complex128 for complex values."""

    name: str
    obs_shapes: Dict[str, Tuple[int, ...]]
    measure_fn: Callable[..., Dict[str, torch.Tensor]]
    finish_fn: Optional[Callable] = None
    dtype: Any = torch.float64
    kind: str = "equal"
    greens_at: Optional[Tuple[int, int]] = None
    combined_acc_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
    combined_finish_fn: Optional[Callable] = None
    binners: Dict[str, LogBinner] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown measurement kind {self.kind!r} (one of "
                             f"{', '.join(KINDS)})")

    def bind(self, n_chains: int, device):
        """Create the binners and their empty states for a chain batch."""
        self.binners = {k: LogBinner(shape=shape, dtype=self.dtype)
                        for k, shape in self.obs_shapes.items()}
        return {k: b.empty_state(n_chains, device)
                for k, b in self.binners.items()}

    def push(self, states, values):
        """Push one batch of per-chain observable values."""
        for k, b in self.binners.items():
            b.push(states[k], values[k])
        return states


class ObservableResult:
    """Host-side statistics view of one observable's binner state."""

    def __init__(self, state):
        self._state = state

    @property
    def per_chain_mean(self):
        return LogBinner.mean(self._state)

    @property
    def mean(self):
        return LogBinner.combined_mean(self._state)

    @property
    def std_error(self):
        return LogBinner.combined_std_error(self._state)

    @property
    def per_chain_std_error(self):
        return LogBinner.std_error(self._state)

    @property
    def var(self):
        return LogBinner.var(self._state)

    @property
    def tau(self):
        """Per-component integrated autocorrelation time, per chain."""
        return LogBinner.tau(self._state)

    @property
    def max_tau(self):
        t = self.tau
        return float(np.max(t)) if np.ndim(t) else float(t)

    @property
    def count(self):
        return LogBinner.count(self._state)

    def __repr__(self):
        m = self.mean
        if np.ndim(m) == 0:
            return f"{float(m):.6g} ± {float(self.std_error):.2g} (n={self.count})"
        return f"<ObservableResult shape={np.shape(m)} n={self.count}>"


class MeasurementRegistry:
    """Named measurements and their binner states for one stage."""

    def __init__(self):
        self.measurements: Dict[str, Measurement] = {}
        self.states: Dict[str, Dict] = {}

    def add(self, key: str, meas: Measurement, n_chains: int, device):
        self.measurements[key] = meas
        self.states[key] = meas.bind(n_chains, device)

    def remove(self, key: str):
        self.measurements.pop(key, None)
        self.states.pop(key, None)

    def __getitem__(self, key) -> Dict[str, ObservableResult]:
        meas = self.measurements[key]
        states = self.states[key]
        return {k: ObservableResult(states[k]) for k in meas.obs_shapes}

    def observables(self, context=None) -> Dict[str, Dict[str, Any]]:
        """All observable results, with finish_fn-derived values included."""
        out = {}
        for key, meas in self.measurements.items():
            stats = self[key]
            if meas.finish_fn is not None:
                stats = dict(stats)
                stats.update(meas.finish_fn(stats, context))
            out[key] = stats
        return out
