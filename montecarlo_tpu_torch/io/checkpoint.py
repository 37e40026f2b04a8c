"""Checkpoint and resume (counterpart of montecarlo_tpu/io/checkpoint.py).

A checkpoint holds only source state: the configurations, the random
generators' states, the binner states, last_sweep, the parameters, the
numeric switches of a DQMC session and the recorded configurations. All
derived state (the DQMC stacks and Green's functions) is rebuilt from the
configurations on load (``dqmc.core.init_state``), so a resumed run repeats
the uninterrupted one.

Format: a pickled dict {"VERSION": 1, "package": "montecarlo_tpu_torch",
"type": "MC" or "DQMC", "state": a tree of numpy arrays and Python values};
each random generator's state is ``get_state()`` as a numpy uint8 array
beside the device type it draws on (``utils.host.generator_state``). The
save protocol: rename (x_1, x_2, ...) or overwrite with a backup that is
removed once the new file is in place. Load only files this package wrote:
unpickling runs code.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time

import torch

from .recorder import recorder_from_state

VERSION = 1
PACKAGE = "montecarlo_tpu_torch"


def save(filename: str, mc, overwrite: bool = False, rename: bool = True,
         backup: bool = True) -> str:
    """Save a simulation to ``filename``; returns the name written.

    An existing file is kept: rename=True writes base_1.ext, base_2.ext, ...
    instead, rename=False raises FileExistsError. overwrite=True replaces it;
    with backup=True the old file is moved aside until the new one is
    written, and put back if the write fails."""
    if os.path.exists(filename) and not overwrite:
        if not rename:
            raise FileExistsError(filename)
        base, ext = os.path.splitext(filename)
        i = 1
        while os.path.exists(f"{base}_{i}{ext}"):
            i += 1
        filename = f"{base}_{i}{ext}"

    payload = {"VERSION": VERSION, "package": PACKAGE,
               "type": type(mc).__name__, "state": mc.state_dict()}

    backup_name = None
    if os.path.exists(filename) and overwrite and backup:
        backup_name = filename + ".backup"
        os.replace(filename, backup_name)
    try:
        dirn = os.path.dirname(os.path.abspath(filename))
        fd, tmp = tempfile.mkstemp(dir=dirn, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=4)
        os.replace(tmp, filename)
        if backup_name:
            os.remove(backup_name)
    except BaseException:
        if backup_name and os.path.exists(backup_name):
            os.replace(backup_name, filename)
        raise
    return filename


class SaveSchedule:
    """When a run saves itself (``run``'s safe_before, safe_every and
    grace_period): before the wall-clock deadline safe_before (time.time()
    seconds), when the next two chunks and grace_period would pass it, and
    every safe_every seconds."""

    def __init__(self, safe_before=None, safe_every=None, grace_period=60.0):
        self.safe_before, self.safe_every = safe_before, safe_every
        self.grace_period = grace_period
        self.last_save = time.time()
        self.max_chunk = 0.0

    def after_chunk(self, mc, seconds, filename=None, verbose=False) -> bool:
        """Save mc if a save is due after a chunk of ``seconds``, to
        filename (default <type>_checkpoint_<unix time>.mctorch),
        overwriting it. True when the deadline stops the run."""
        self.max_chunk = max(self.max_chunk, seconds)
        now = time.time()
        stop = (self.safe_before is not None and now + 2 * self.max_chunk
                + self.grace_period > self.safe_before)
        if stop or (self.safe_every is not None
                    and now - self.last_save > self.safe_every):
            kind = type(mc).__name__
            filename = (filename or
                        f"{kind.lower()}_checkpoint_{int(now)}.mctorch")
            save(filename, mc, overwrite=True)
            self.last_save = now
            if verbose:
                print(f"[{kind}] saved resumable checkpoint to {filename}")
        return stop


def common_state(sim):
    """The part of a ``state_dict`` both flavors share: n_chains,
    last_sweep, the recorder, both stages' binner states, the analysis and
    the model (its type, parameters and lattice)."""
    return {
        "n_chains": sim.n_chains,
        "last_sweep": sim.last_sweep,
        "configs": sim.configs.state_dict(),
        "measurement_states": sim.measurements.host_states(),
        "th_measurement_states":
            sim.thermalization_measurements.host_states(),
        "analysis": dataclasses.asdict(sim.analysis),
        "model": {
            "type": type(sim.model).__name__,
            "parameters": sim.model.parameters(),
            "lattice": sim.model.lattice.state_dict(),
        },
    }


def restore_common(sim, state):
    """Restore last_sweep, the recorder and the binner states that
    ``common_state`` saved (the analysis is the flavor's own type)."""
    sim.last_sweep = int(state["last_sweep"])
    sim.configs = recorder_from_state(state["configs"])
    sim.measurements.restore_states(state["measurement_states"], "ME",
                                    sim.device)
    sim.thermalization_measurements.restore_states(
        state.get("th_measurement_states", {}), "TH", sim.device)


def _reconstruct_model(model_info):
    """The model of a checkpoint: its class from this package's models, its
    parameters, and its lattice rebuilt from the lattice's state_dict (an
    ``ArbitraryLattice`` for kind "arbitrary", else a ``Lattice``), never
    from the parameters' dims and L."""
    from .. import models
    from ..lattices import ArbitraryLattice, Lattice

    cls = getattr(models, model_info["type"])
    params = dict(model_info["parameters"])
    lat = model_info.get("lattice")
    if lat is not None:
        params["l"] = (ArbitraryLattice.from_state(lat)
                       if lat.get("kind") == "arbitrary"
                       else Lattice.from_state(lat))
        params.pop("L", None)
        params.pop("dims", None)
    return cls(**params)


def _torch_dtype(name):
    """torch.float32 from "torch.float32" (str of a torch dtype)."""
    return None if name is None else getattr(torch, name.rsplit(".", 1)[-1])


def load(filename: str, device="cuda"):
    """The simulation saved in a checkpoint, rebuilt on ``device`` (default
    "cuda", which raises without CUDA): its model, its parameters and (DQMC)
    its numeric switches, then ``load_state``. A file this package did not
    write, and a checkpoint whose generators draw on another device type
    (``load_state``), raise ValueError."""
    with open(filename, "rb") as f:
        payload = pickle.load(f)
    if (payload.get("package") != PACKAGE
            or payload.get("VERSION") != VERSION):
        raise ValueError(
            f"{filename} is not a version-{VERSION} {PACKAGE} checkpoint "
            f"(package {payload.get('package')!r}, version "
            f"{payload.get('VERSION')!r})")
    kind, state = payload["type"], payload["state"]
    model = _reconstruct_model(state["model"])
    if kind == "MC":
        from ..mc.mc import MC
        mc = MC(model, n_chains=state["n_chains"], device=device,
                use_kernels=state["use_kernels"], **state["parameters"])
    elif kind == "DQMC":
        from ..dqmc.dqmc import DQMC
        num = state["numerics"]
        n_seeds = len(state["rng"])
        mc = DQMC(model, n_chains=state["n_chains"] // n_seeds,
                  seed=tuple(range(n_seeds)), device=device,
                  dtype=_torch_dtype(num["dtype"]),
                  update_dtype=_torch_dtype(num["update_dtype"]),
                  stab_method=num["stab_method"],
                  use_kernels=num["use_kernels"], delay=num["delay"],
                  checkerboard=num["checkerboard"],
                  g_refresh=num["g_refresh"], fuse_wrap=num["fuse_wrap"],
                  qr_wy=num["qr_wy"], **state["parameters"])
    else:
        raise ValueError(f"Unknown simulation type {kind!r}")
    mc.load_state(state)
    return mc


def resume(filename: str, device="cuda", **kwargs):
    """Load a checkpoint on ``device`` and continue running it
    (``run(**kwargs)``). Returns (run's result, the simulation)."""
    mc = load(filename, device=device)
    ok = mc.run(**kwargs)
    return ok, mc
