"""DQMC simulation driver (counterpart of montecarlo_tpu/dqmc/dqmc.py).

A Python loop over sweep pairs (core.sweep_pair, batched over chains) with
measurements pushed into device-side binners: equal-time ones from the G at
the measurement point, time-displaced ones from ``unequal_time.greens_kl``
(``greens_at``) and from one pass of the combined iterator over all chains
(``combined``, the susceptibilities). The per-chain device counters are
drained into host integers after every chunk of sweeps, each chunk a
``timer("dqmc_block")`` section (``utils.timing``). A recorder keeps a
host copy of every rate-th measurement-stage configuration (``replay``
measures them again); ``state_dict`` / ``load_state`` carry the source
state of a checkpoint (``io.checkpoint``), from which the stacks are
rebuilt.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from . import core
from . import unequal_time as ut
from .parameters import DQMCParameters
from ..io.checkpoint import SaveSchedule, common_state, restore_common
from ..io.recorder import Discarder
from ..measurements.core import MeasurementRegistry
from ..utils.host import generator_state, resolve_device, set_generator_state
from ..utils.timing import timer


@dataclass
class MagnitudeStats:
    """Min/max/geometric-mean/count of a monitored quantity (the JAX
    package's MagnitudeStats): min and max linear, the sum in the log10
    domain. The drift fills max and count; the negative and the imaginary
    weights fill all four, the negative ones only count where the site
    sweep keeps the count alone (float32 kernels)."""

    min: float = math.inf
    max: float = 0.0
    log_sum: float = 0.0
    count: int = 0

    @property
    def mean(self):
        return 10.0 ** (self.log_sum / self.count) if self.count else 0.0

    def absorb_device(self, log_min, log_max, log_sum, count):
        """Fold in per-chain device reductions of log10 magnitudes (min, max,
        sum) and a count; no events leave the statistics as they were, and
        non-finite extrema (no magnitudes recorded) leave min and max."""
        if int(count) == 0:
            return
        lm, lx = float(log_min), float(log_max)
        if math.isfinite(lm):
            self.min = min(self.min, 10.0 ** lm)
        if math.isfinite(lx):
            self.max = max(self.max, 10.0 ** lx)
        self.log_sum += float(log_sum)
        self.count += int(count)


@dataclass
class DQMCAnalysis:
    acc_rate: float = 0.0
    prop_local: int = 0
    acc_local: int = 0
    sweep_duration: float = 0.0
    negative_probability: MagnitudeStats = dataclasses.field(default_factory=MagnitudeStats)
    # complex sessions: |Im(detratio)| > core.IMAG_PROB_THRESHOLD events
    imaginary_probability: MagnitudeStats = dataclasses.field(default_factory=MagnitudeStats)
    propagation_error: MagnitudeStats = dataclasses.field(default_factory=MagnitudeStats)
    # mean configuration-weight phase over chains at the last drain, the
    # average sign: |avg_phase| << 1 means the phase problem is biasing the
    # Re-projected estimators (complex sessions; 1 otherwise)
    avg_phase: complex = 1.0 + 0.0j
    # window-end drift distribution (see core.PROP_ERR_EDGES)
    prop_err_sum: float = 0.0
    prop_err_n: int = 0
    prop_err_hist: list = dataclasses.field(
        default_factory=lambda: [0] * len(core.PROP_ERR_EDGES))

    @property
    def prop_err_mean(self):
        return self.prop_err_sum / max(1, self.prop_err_n)


class DQMC:
    """Determinant quantum Monte Carlo over a batch of independent chains.

    use_kernels=True (the default) runs the hand-written CUDA kernels on a
    CUDA device and their plain PyTorch versions on the CPU; False runs the
    plain site sweep and the library QR/solve on either device. device
    defaults to "cuda" and raises when CUDA is absent (pass device="cpu").
    fuse_wrap and qr_wy are the JAX package's MC_TPU_FUSE_WRAP and
    MC_TPU_QR_WY A/B modes on the kernel path; g_refresh runs the
    conservative mode (G recomputed at every slice) and checkerboard the
    checkerboard hopping operator (core.make_context).

    seed may be a sequence: each seed's own generator draws the initial
    configuration and every sweep's uniforms of its block of n_chains
    chains, the blocks concatenated on the chain axis (chains
    i*n_chains..(i+1)*n_chains-1 are seed[i]'s, as len(seed) separate
    sessions would run them) and n_chains multiplied by len(seed)."""

    def __init__(self, model, n_chains: int = 16,
                 seed: Union[int, Sequence[int]] = 0,
                 dtype=torch.float64, update_dtype=None,
                 use_kernels: bool = True, device="cuda",
                 stab_method: str = "qr", delay: int = None,
                 checkerboard: bool = False, g_refresh: bool = False,
                 fuse_wrap: bool = False, qr_wy: bool = False,
                 measurements: str | Dict = "default",
                 thermalization_measurements: Optional[Dict] = None,
                 recorder=None, recording_rate: int = None,
                 last_sweep: int = 0, **params):
        self.device = resolve_device(device)
        self.model = model
        self.parameters = self.p = DQMCParameters(**params)
        self.analysis = self.a = DQMCAnalysis()
        self.n_chains = int(n_chains)
        self.last_sweep = int(last_sweep)
        self.ctx, self.consts = core.make_context(
            model, self.parameters, dtype, update_dtype=update_dtype,
            device=self.device, use_kernels=use_kernels,
            stab_method=stab_method, delay=delay, checkerboard=checkerboard,
            g_refresh=g_refresh, fuse_wrap=fuse_wrap, qr_wy=qr_wy)
        # one generator per seed drives its block's initial configuration
        # and every sweep's uniforms: the same seeds give the same run
        seeds = tuple(seed) if isinstance(seed, (tuple, list)) else (seed,)
        self.generators = [torch.Generator(device=self.device).manual_seed(
            int(s)) for s in seeds]
        self.generator = self.generators[0]
        conf = torch.cat([model.rand_conf(g, self.n_chains,
                                          self.parameters.slices, self.device)
                          for g in self.generators])
        self.n_chains *= len(seeds)
        self.state = core.init_state(self.ctx, self.consts, conf)

        self.configs = recorder if recorder is not None else Discarder()
        if recording_rate is not None:
            self.configs.rate = recording_rate

        self.measurements = MeasurementRegistry()
        self.thermalization_measurements = MeasurementRegistry()
        if measurements == "default":
            measurements = self.default_measurements()
        for k, m in measurements.items():
            self.measurements.add(k, m, self.n_chains, self.device)
        for k, m in (thermalization_measurements or {}).items():
            self.thermalization_measurements.add(k, m, self.n_chains, self.device)

    def default_measurements(self):
        from ..measurements import dqmc_measurements as dm
        out = {"occ": dm.occupation(self, self.model),
               "greens": dm.greens_measurement(self, self.model)}
        if self.ctx.is_complex:
            # its mean away from 1 is the sign that the phase problem biases
            # the Re-projected estimators
            out["sign"] = dm.sign_measurement(self, self.model)
        return out

    @property
    def conf(self):
        return self.state["conf"]

    def reset(self):
        """Rebuild every measurement's binners, empty, and restart the sweep
        count; the chain state is kept."""
        for registry in (self.measurements, self.thermalization_measurements):
            registry.rebind(self.n_chains, self.device)
        self.last_sweep = 0
        return self

    def __setitem__(self, key, measurement):
        """sim[key] = measurement: add a measurement (empty binners)."""
        self.measurements.add(key, measurement, self.n_chains, self.device)

    def __delitem__(self, key):
        self.measurements.remove(key)

    def __getitem__(self, key):
        """The observable results of measurement ``key``."""
        return self.measurements[key]

    def __repr__(self):
        p = self.parameters
        return (f"DQMC simulation of {self.model!r} (beta={p.beta}, "
                f"dtau={p.delta_tau}, M={p.slices}, {self.n_chains} chains)")

    # ------------------------------------------------------------------- run
    def run(self, sweeps: int = None, thermalization: int = None,
            verbose: bool = True, safe_before: float = None,
            safe_every: float = None, grace_period: float = 60.0,
            filename: str = None, chunk: int = 16) -> bool:
        """Run thermalization + measurement sweeps. One sweep = one full
        [down; up] pass over imaginary time (2*slices*N site updates per
        chain). Measurements are taken every measure_rate sweeps (sweeps
        counted from 1); the recorder sees every measurement-stage sweep
        (``configs.rate`` picks); counters are drained every ``chunk``
        sweeps.

        safe_before: an absolute wall-clock deadline (time.time() seconds):
        when the next two chunks and grace_period would pass it, a
        resumable checkpoint is written to ``filename`` and run returns
        False. safe_every: a period in seconds between checkpoints."""
        p = self.parameters
        sweeps = sweeps if sweeps is not None else p.sweeps
        thermalization = (thermalization if thermalization is not None
                          else p.thermalization)
        total = sweeps + thermalization
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
            with timer("dqmc_block", self.device):
                for sweep_idx in range(i + 1, i + n + 1):
                    self.state, G_meas, conf_meas = core.sweep_pair(
                        self.ctx, self.consts, self.state,
                        u=self._uniforms())
                    if (registry.measurements
                            and sweep_idx % p.measure_rate == 0):
                        self._measure_all(registry, G_meas, conf_meas,
                                          self.state.get("phase_meas"))
                    if (record and not in_th
                            and sweep_idx % self.configs.rate == 0):
                        # the configuration at the sweep's end, to the host
                        self.configs.push(sweep_idx,
                                          self.state["conf"].cpu().numpy())
            self._drain_counters()      # reads device values: synchronizes
            dur = time.perf_counter() - t0
            self.analysis.sweep_duration = dur / n
            i += n
            self.last_sweep = i
            if verbose and (i % p.print_rate < chunk):
                print(f"[DQMC] sweep {i}/{total}  "
                      f"acc={self.analysis.acc_rate:.3f}  "
                      f"({dur / n * 1e3:.1f} ms/sweep)  "
                      f"prop_err_max={self.analysis.propagation_error.max:.2e}")
            if saves.after_chunk(self, dur, filename, verbose):
                return False
        if verbose and not p.silent:
            self._report_errors()
        return True

    def _uniforms(self):
        """One sweep pair's uniforms (C, 2M, N): each seed's generator draws
        its block's."""
        C = self.n_chains // len(self.generators)
        shape = (C, 2 * self.ctx.M, self.ctx.N)
        return torch.cat([torch.rand(shape, generator=g, device=self.device,
                                     dtype=self.ctx.urdtype)
                          for g in self.generators])

    def _measure_all(self, registry, G_meas, conf_meas, phase=None):
        """Push every measurement of a stage, grouped by the Green's
        functions it needs so that each is computed once: the equal-time
        ones from the physical G at the measurement point, each distinct
        G(k, l) of the ``greens_at`` ones from ``ut.greens_kl``, and the
        ``combined`` ones from one pass of the combined iterator. phase:
        the configuration-weight phase (C,) of a complex session."""
        ctx, consts = self.ctx, self.consts
        items = registry.measurements.items()
        G_phys = core.unwrap_greens(ctx, consts, G_meas)
        for k, m in items:
            if m.kind == "equal":
                m.push(registry.states[k], m.measure_fn(
                    greens=G_phys, conf=conf_meas, phase=phase))
        utgs = {}
        for k, m in items:
            if m.kind == "greens_at":
                if m.greens_at not in utgs:
                    utgs[m.greens_at] = core.unwrap_greens(
                        ctx, consts, ut.greens_kl(ctx, consts, conf_meas,
                                                  *m.greens_at))
                m.push(registry.states[k], m.measure_fn(
                    utg=utgs[m.greens_at], greens=G_phys, conf=conf_meas))
        comb = [(k, m) for k, m in items if m.kind == "combined"]
        if comb:
            accs = self._measure_combined(comb, G_meas, G_phys, conf_meas)
            for k, m in comb:
                m.push(registry.states[k], accs[k])

    def _measure_combined(self, comb, G_meas, G_phys, conf_meas):
        """One combined-iterator pass over all chains for the measurements
        of kind "combined": those with combined_acc_shapes sum their raw
        contributions in the Green's dtype and reduce them once afterwards
        (combined_finish_fn), the rest sum theirs in float64; every sum is
        then weighted by delta_tau (the τ integral)."""
        ctx = self.ctx
        C = conf_meas.shape[0]
        acc0 = {}
        for k, m in comb:
            shapes, dtype = ((m.combined_acc_shapes, ctx.dtype)
                             if m.combined_acc_shapes is not None
                             else (m.obs_shapes, torch.float64))
            acc0[k] = {n: torch.zeros((C,) + tuple(s), dtype=dtype,
                                      device=ctx.device)
                       for n, s in shapes.items()}

        def step_fn(acc, G0l, Gl0, Gll):
            out = {}
            for k, m in comb:
                contrib = m.measure_fn(G00=G_phys, G0l=G0l, Gl0=Gl0, Gll=Gll)
                out[k] = {n: acc[k][n] + contrib[n] for n in contrib}
            return out

        acc = ut.combined_greens_apply(ctx, self.consts, conf_meas,
                                       G_meas.to(ctx.dtype), acc0, step_fn)
        dtau = self.parameters.delta_tau
        out = {}
        for k, m in comb:
            a = (m.combined_finish_fn(acc[k])
                 if m.combined_finish_fn is not None else acc[k])
            out[k] = {n: v * dtau for n, v in a.items()}
        return out

    def _drain_counters(self):
        """Accumulate the per-chain device counters into host Python ints and
        reset them, with the negative weights' magnitudes; complex sessions
        also fold in the phase-problem statistics and read the average
        weight phase (the running phase itself is not reset)."""
        st = self.state
        host = {k: st[k].cpu() for k in core.counter_keys(self.ctx)}
        a = self.analysis
        a.prop_local += int(host["prop"].sum())
        a.acc_local += int(host["acc"].sum())
        a.acc_rate = a.acc_local / max(1, a.prop_local)
        a.negative_probability.absorb_device(
            host["ls_neg_min"].min(), host["ls_neg_max"].max(),
            host["ls_neg_sum"].sum(), host["neg_prob"].sum())
        if self.ctx.is_complex:
            a.imaginary_probability.absorb_device(
                host["ls_imag_min"].min(), host["ls_imag_max"].max(),
                host["ls_imag_sum"].sum(), host["ls_imag_count"].sum())
            a.avg_phase = complex(st["ls_phase"].mean().item())
        a.propagation_error.max = max(a.propagation_error.max,
                                      float(host["prop_err_max"].max()))
        a.propagation_error.count += int(host["prop_err_count"].sum())
        a.prop_err_sum += float(host["prop_err_sum"].sum())
        a.prop_err_n += int(host["prop_err_n"].sum())
        a.prop_err_hist = [x + int(y) for x, y in
                           zip(a.prop_err_hist, host["prop_err_hist"].sum(0))]
        self.state = {**st, **core.fresh_counters(self.ctx, self.n_chains)}

    def _report_errors(self):
        a = self.analysis
        if a.negative_probability.count > 0:
            n = a.negative_probability
            print(f"[DQMC] {n.count} negative probabilities (sign problem?) "
                  f"|p|: min {n.min:.2e} / geo-mean {n.mean:.2e} / "
                  f"max {n.max:.2e}")
        if a.imaginary_probability.count > 0:
            im = a.imaginary_probability
            print(f"[DQMC] {im.count} imaginary probabilities (|Im detratio| "
                  f"> {core.IMAG_PROB_THRESHOLD:g}: phase problem!) |Im|: min "
                  f"{im.min:.2e} / geo-mean {im.mean:.2e} / max {im.max:.2e}")
        if self.ctx.is_complex:
            ph = a.avg_phase
            print(f"[DQMC] average weight phase <s> = {ph.real:+.4f}"
                  f"{ph.imag:+.4f}i (|<s>| = {abs(ph):.4f}; values far from 1 "
                  "mean Re-projected estimators are biased, see the 'sign' "
                  "observable)")
        if a.propagation_error.count > 0:
            print(f"[DQMC] {a.propagation_error.count} propagation "
                  f"instabilities > {self.ctx.prop_err_threshold:g} "
                  f"(max {a.propagation_error.max:.2e})")

    # ---------------------------------------------------------------- greens
    def greens(self, slice_idx: int = 0, l: int = None):
        """Physical Green's function (C, F, N, N), recomputed from the current
        configurations: ``greens()`` / ``greens(slice)`` the equal-time G at
        a slice, ``greens(k, l)`` the time-displaced G(kΔτ ← lΔτ) for
        0 ≤ k, l ≤ slices."""
        conf = self.state["conf"]
        if l is None:
            G = core.greens_from_scratch(self.ctx, self.consts, conf,
                                         slice_idx)
        else:
            G = ut.greens_kl(self.ctx, self.consts, conf, slice_idx, l)
        return core.unwrap_greens(self.ctx, self.consts, G)

    def replay(self, configurations=None, verbose: bool = False) -> bool:
        """Measure every recorded HS field again (default: the recorder's),
        into fresh binners: G_eff(0) of each field from scratch
        (``core.greens_from_scratch``, n_seg UDTs and one Green's solve:
        K2 and K3 on the float32 kernel route) and, for a complex session,
        its weight phase, then the measurement pass."""
        configurations = (configurations if configurations is not None
                          else self.configs)
        ctx, consts, registry = self.ctx, self.consts, self.measurements
        registry.rebind(self.n_chains, self.device)
        for conf in configurations:
            conf = torch.as_tensor(np.asarray(conf)).to(self.device)
            G = core.greens_from_scratch(ctx, consts, conf, 0)
            phase = (core.phase_from_conf(ctx, consts, conf)
                     if ctx.is_complex else None)
            self._measure_all(registry, G, conf, phase)
        return True

    # ------------------------------------------------------------ observables
    def observables(self, stage: str = "ME"):
        registry = (self.measurements if stage == "ME"
                    else self.thermalization_measurements)
        return registry.observables(context=self)

    # ------------------------------------------------------------ persistence
    def state_dict(self):
        """The session's source state: parameters, numeric switches, the
        field, each seed's generator, the recorder, the binner states and
        the analysis. The stacks and G are derived and not saved."""
        ctx = self.ctx
        return {
            "type": "DQMC",
            "parameters": {k: v for k, v in self.parameters.as_dict().items()
                           if k != "warn_round"},
            # every switch of the session's numerics, so that a float32
            # checkpoint resumes float32 on the same route
            "numerics": {
                "dtype": str(ctx.dtype),
                "update_dtype": (None if ctx.update_dtype is None
                                 else str(ctx.update_dtype)),
                "stab_method": ctx.stab_method,
                "use_kernels": ctx.use_kernels,
                "delay": ctx.delay,
                "checkerboard": ctx.checkerboard,
                "g_refresh": ctx.g_refresh,
                "fuse_wrap": ctx.fuse_wrap,
                "qr_wy": ctx.qr_wy,
            },
            "conf": self.state["conf"].cpu().numpy(),
            "rng": [generator_state(g) for g in self.generators],
            **common_state(self),
        }

    def load_state(self, state):
        """Restore a ``state_dict``: the stacks and G are rebuilt from the
        field by ``core.init_state`` (the counters start fresh), each
        generator's state is restored (ValueError when it was saved on
        another device type), then the recorder, binner states and
        analysis."""
        conf = torch.as_tensor(np.asarray(state["conf"]))
        if (tuple(conf.shape) != tuple(self.state["conf"].shape)
                or len(state["rng"]) != len(self.generators)):
            raise ValueError(
                f"checkpoint conf {tuple(conf.shape)} with "
                f"{len(state['rng'])} generators does not match this "
                f"simulation's {tuple(self.state['conf'].shape)} with "
                f"{len(self.generators)}")
        for g, saved in zip(self.generators, state["rng"]):
            set_generator_state(g, saved)
        self.parameters = self.p = DQMCParameters(**state["parameters"])
        self.state = core.init_state(self.ctx, self.consts,
                                     conf.to(self.device))
        restore_common(self, state)
        an = dict(state["analysis"])
        for k in ("negative_probability", "imaginary_probability",
                  "propagation_error"):
            an[k] = MagnitudeStats(**an[k])
        self.analysis = self.a = DQMCAnalysis(**an)
