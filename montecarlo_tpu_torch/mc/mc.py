"""Classical Monte Carlo flavor (counterpart of montecarlo_tpu/mc/mc.py).

The simulation state is a (C, N) int8 tensor of ±1 spins, one row per
independent chain. ``run`` is a Python loop over sweeps: each sweep draws
its uniforms from the session's ``torch.Generator`` (so the chunk size
never changes the stream), runs the model's Metropolis sweep (one K17
launch), on the global-move schedule the Wolff move (one K18 launch and one
host read per BFS level), and on the measurement schedule pushes the
measurements into device-side binners. The counters stay on the device
and are drained into host integers once per chunk of sweeps, each chunk a
``timer("mc_block")`` section (``utils.timing``); a recorder copies each
recorded configuration to the host.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..io.checkpoint import SaveSchedule, common_state, restore_common
from ..io.recorder import Discarder
from ..measurements.core import MeasurementRegistry
from ..utils.host import generator_state, resolve_device, set_generator_state
from ..utils.timing import timer


@dataclass
class MCParameters:
    """The run's schedule (``T`` in MC's keywords becomes beta = 1/T)."""

    beta: float = 1.0
    sweeps: int = 1000
    thermalization: int = 0
    global_moves: bool = False
    global_rate: int = 5
    measure_rate: int = 1
    print_rate: int = 1000

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclass
class MCAnalysis:
    """Acceptance bookkeeping: local (Metropolis) proposals and acceptances
    counted per site, global (Wolff) ones per chain and move, a global move
    accepted where its cluster has more than one site; levels_global counts
    the BFS levels of all global moves (each one K18 launch and one host
    synchronization)."""

    acc_rate: float = 0.0
    prop_local: int = 0
    acc_local: int = 0
    acc_rate_global: float = 0.0
    prop_global: int = 0
    acc_global: int = 0
    levels_global: int = 0


class MC:
    """Classical Monte Carlo over a batch of independent chains.

    device defaults to "cuda" and raises when CUDA is absent (pass
    device="cpu"); use_kernels=True runs K17 and K18 on a CUDA device and
    their plain versions on the CPU, False the plain versions anywhere."""

    def __init__(self, model, n_chains: int = 32, seed: int = 0,
                 beta: float = None, T: float = None,
                 measurements: str | Dict = "default",
                 thermalization_measurements: Optional[Dict] = None,
                 recorder=None, recording_rate: int = None,
                 last_sweep: int = 0, device="cuda", use_kernels: bool = True,
                 **params):
        if T is not None:
            beta = 1.0 / T
        if beta is not None:
            params["beta"] = beta
        self.device = resolve_device(device)
        self.model = model
        self.parameters = self.p = MCParameters(**params)
        self.analysis = self.a = MCAnalysis()
        self.n_chains = int(n_chains)
        self.last_sweep = int(last_sweep)
        self.use_kernels = bool(use_kernels)
        # one generator draws the initial configuration and every sweep's
        # random numbers: the same seed gives the same run
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.conf = model.rand_conf(self.generator, self.n_chains, self.device)

        self.configs = recorder if recorder is not None else Discarder()
        if recording_rate is not None:
            self.configs.rate = recording_rate

        self.measurements = MeasurementRegistry()
        self.thermalization_measurements = MeasurementRegistry()
        if measurements == "default":
            measurements = model.default_measurements(self)
        for k, m in measurements.items():
            self.measurements.add(k, m, self.n_chains, self.device)
        for k, m in (thermalization_measurements or {}).items():
            self.thermalization_measurements.add(k, m, self.n_chains,
                                                 self.device)
        self._moves_at = None

    def reset(self):
        """Rebuild every measurement's binners, empty, and restart the sweep
        count; the chain state is kept."""
        for registry in (self.measurements, self.thermalization_measurements):
            registry.rebind(self.n_chains, self.device)
        self.last_sweep = 0
        return self

    def __setitem__(self, key, measurement):
        """mc[key] = measurement: add a measurement (empty binners)."""
        self.measurements.add(key, measurement, self.n_chains, self.device)

    def __delitem__(self, key):
        self.measurements.remove(key)

    def __getitem__(self, key):
        """The observable results of measurement ``key``."""
        return self.measurements[key]

    def __repr__(self):
        return (f"MC simulation of {self.model!r} (beta={self.parameters.beta}, "
                f"{self.n_chains} chains)")

    # ------------------------------------------------------------------ run
    def _moves(self):
        """(sweep, global move or None) of the current parameters, built
        once per beta and schedule."""
        p = self.parameters
        key = (p.beta, p.global_moves)
        if self._moves_at is None or self._moves_at[0] != key:
            kw = dict(device=self.device, use_kernels=self.use_kernels)
            sweep = self.model.make_sweep_fn(p.beta, **kw)
            glob = (self.model.make_global_move_fn(p.beta, **kw)
                    if p.global_moves else None)
            self._moves_at = (key, sweep, glob)
        return self._moves_at[1:]

    def run(self, sweeps: int = None, thermalization: int = None,
            verbose: bool = True, safe_before: float = None,
            safe_every: float = None, grace_period: float = 60.0,
            filename: str = None, chunk: int = 256) -> bool:
        """Run thermalization and measurement sweeps (sweeps counted from
        1). A global move follows the sweeps whose index is a multiple of
        global_rate, a measurement those that are multiples of
        measure_rate; the recorder sees every measurement-stage sweep. The
        counters are drained every ``chunk`` sweeps.

        safe_before: an absolute wall-clock deadline (time.time() seconds):
        when the next two chunks and grace_period would pass it, a
        resumable checkpoint is written to ``filename`` and run returns
        False. safe_every: a period in seconds between checkpoints."""
        p = self.parameters
        sweeps = sweeps if sweeps is not None else p.sweeps
        thermalization = (thermalization if thermalization is not None
                          else p.thermalization)
        total = sweeps + thermalization
        sweep_fn, global_fn = self._moves()
        C, N = self.conf.shape
        z = self.model.lattice.coordination
        dev = self.device
        record = not isinstance(self.configs, Discarder)
        saves = SaveSchedule(safe_before, safe_every, grace_period)

        i = self.last_sweep
        while i < total:
            in_th = i < thermalization
            registry = (self.thermalization_measurements if in_th
                        else self.measurements)
            limit = thermalization if in_th else total
            n = min(chunk, limit - i)
            t0 = time.perf_counter()
            acc_l = torch.zeros(C, dtype=torch.int64, device=dev)
            acc_g = torch.zeros((), dtype=torch.int64, device=dev)
            n_global = 0
            with timer("mc_block", dev):
                for sweep_idx in range(i + 1, i + n + 1):
                    self.conf, acc_l = sweep_fn(
                        self.conf, self._uniforms((C, N)), acc_l)
                    if (global_fn is not None
                            and sweep_idx % p.global_rate == 0):
                        self.conf, size, levels = global_fn(
                            self.conf, self._seed_sites(N),
                            lambda: self._uniforms((C, N, z)))
                        acc_g += (size > 1).sum()
                        n_global += 1
                        self.analysis.levels_global += levels
                    if (registry.measurements
                            and sweep_idx % p.measure_rate == 0):
                        for k, m in registry.measurements.items():
                            m.push(registry.states[k],
                                   m.measure_fn(self.conf))
                    if (record and not in_th
                            and sweep_idx % self.configs.rate == 0):
                        self.configs.push(sweep_idx, self.conf.cpu().numpy())
            acc_local, acc_global = torch.stack(
                [acc_l.sum(), acc_g]).tolist()   # synchronizes
            dur = time.perf_counter() - t0
            a = self.analysis
            a.prop_local += n * C * N
            a.acc_local += acc_local
            a.prop_global += n_global * C
            a.acc_global += acc_global
            i += n
            self.last_sweep = i

            if verbose and (i % p.print_rate < chunk):
                acc = a.acc_local / max(1, a.prop_local)
                print(f"[MC] sweep {i}/{total}  acc={acc:.3f}  "
                      f"({dur / n * 1e3:.2f} ms/sweep)")

            if saves.after_chunk(self, dur, filename, verbose):
                return False

        a = self.analysis
        a.acc_rate = a.acc_local / max(1, a.prop_local)
        if a.prop_global > 0:
            a.acc_rate_global = a.acc_global / a.prop_global
        return True

    def _uniforms(self, shape):
        """The next float64 uniforms of the session's stream: (C, N) for a
        sweep (class order), (C, N, z) for a BFS level."""
        return torch.rand(shape, generator=self.generator, device=self.device,
                          dtype=torch.float64)

    def _seed_sites(self, N):
        """The next global move's first sites, (C,) in [0, N)."""
        return torch.randint(0, N, (self.n_chains,), generator=self.generator,
                             device=self.device)

    # --------------------------------------------------------------- replay
    def replay(self, configurations=None, verbose: bool = False) -> bool:
        """Measure every recorded configuration again (default: the
        recorder's), into fresh binners."""
        configurations = (configurations if configurations is not None
                          else self.configs)
        registry = self.measurements
        registry.rebind(self.n_chains, self.device)
        for conf in configurations:
            conf = torch.as_tensor(np.asarray(conf)).to(self.device)
            for k, m in registry.measurements.items():
                m.push(registry.states[k], m.measure_fn(conf))
        return True

    # ---------------------------------------------------------- observables
    def observables(self, stage: str = "ME"):
        registry = (self.measurements if stage == "ME"
                    else self.thermalization_measurements)
        return registry.observables(context=self)

    # ---------------------------------------------------------- persistence
    def state_dict(self):
        return {
            "type": "MC",
            "parameters": self.parameters.as_dict(),
            "use_kernels": self.use_kernels,
            "conf": self.conf.cpu().numpy(),
            "rng": [generator_state(self.generator)],
            **common_state(self),
        }

    def load_state(self, state):
        """Restore a ``state_dict``: parameters, configuration, generator
        (ValueError when it was saved on another device type), recorder,
        binner states and counters."""
        conf = torch.as_tensor(np.asarray(state["conf"]))
        if tuple(conf.shape) != tuple(self.conf.shape):
            raise ValueError(f"checkpoint conf {tuple(conf.shape)} does not "
                             f"match this simulation's "
                             f"{tuple(self.conf.shape)}")
        set_generator_state(self.generator, state["rng"][0])
        self.parameters = self.p = MCParameters(**state["parameters"])
        self.conf = conf.to(self.device)
        restore_common(self, state)
        self.analysis = self.a = MCAnalysis(**state["analysis"])
