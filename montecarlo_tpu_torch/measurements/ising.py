"""Ising observables (counterpart of montecarlo_tpu/measurements/ising.py).

IsingEnergyMeasurement: E, E2, e per configuration; the specific heat
C = beta^2/N (<E^2> - <E>^2) at finish time. IsingMagnetizationMeasurement:
M = |sum s|, M2, m; the susceptibility chi = beta/N (<M^2> - <M>^2) at
finish time. Each measure_fn takes the configuration (C, N) int8.
"""

from __future__ import annotations

import numpy as np

from .core import Measurement


def IsingEnergyMeasurement(mc, model) -> Measurement:
    energy_fn = model.make_energy_fn()
    invN = 1.0 / len(model.lattice)
    beta = mc.parameters.beta

    def measure(conf, **_):
        E = energy_fn(conf)
        return {"E": E, "E2": E ** 2, "e": E * invN}

    def finish(stats, _context):
        E = stats["E"].per_chain_mean
        E2 = stats["E2"].per_chain_mean
        return {"C": float(np.mean(beta ** 2 * invN * (E2 - E ** 2)))}

    return Measurement(name="Energy", obs_shapes={"E": (), "E2": (), "e": ()},
                       measure_fn=measure, finish_fn=finish)


def IsingMagnetizationMeasurement(mc, model) -> Measurement:
    mag_fn = model.make_magnetization_fn()
    invN = 1.0 / len(model.lattice)
    beta = mc.parameters.beta

    def measure(conf, **_):
        M = mag_fn(conf)
        return {"M": M, "M2": M ** 2, "m": M * invN}

    def finish(stats, _context):
        M = stats["M"].per_chain_mean
        M2 = stats["M2"].per_chain_mean
        return {"chi": float(np.mean(beta * invN * (M2 - M ** 2)))}

    return Measurement(name="Magn", obs_shapes={"M": (), "M2": (), "m": ()},
                       measure_fn=measure, finish_fn=finish)
