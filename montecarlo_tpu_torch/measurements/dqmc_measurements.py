"""Standard equal-time DQMC observables (counterpart of
montecarlo_tpu/measurements/dqmc_measurements.py; only ``greens`` and
``occupation`` are ported so far, the rest is ROADMAP Queue 1 item 6).

Green's functions carry a flavor-block axis: (C, F, N, N).
"""

from __future__ import annotations

import torch

from .core import Measurement


def greens_measurement(mc, model, greens_at=None, **kwargs) -> Measurement:
    """Full equal-time Green's function, shape (F, N, N) per chain."""
    if greens_at is not None:
        raise NotImplementedError(
            "greens_at (time-displaced G) is not ported to montecarlo_tpu_torch "
            "yet (ROADMAP Queue 1 item 7)")
    F, N = model.nflavors, len(model.lattice)

    def measure(greens, **_):
        return {"greens": greens}

    return Measurement("greens", {"greens": (F, N, N)}, measure)


def occupation(mc, model, **kwargs) -> Measurement:
    """n(i) = 1 - G[i, i] per flavor, shape (F, N) per chain."""
    F, N = model.nflavors, len(model.lattice)

    def measure(greens, **_):
        return {"occ": 1.0 - torch.diagonal(greens, dim1=-2, dim2=-1)}

    return Measurement("occupation", {"occ": (F, N)}, measure)
