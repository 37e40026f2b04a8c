"""Run a function on a world of ranks, one process each, and the sharded
session runs those ranks make.

``spawn(fn, n, *args)`` starts n processes with torch.multiprocessing
(start method "spawn"), joins them into one process group on a FileStore
in a temporary directory and calls ``fn(mesh, *args)`` on every rank with
the world's ``chain_mesh``; it returns every rank's result, and any rank's
exception fails the call. fn must be importable (a spawned process imports
the module of its target), which is why the functions the ranks run live
here: ``run_jobs`` runs several of them in one world, ``run_sharded`` runs
a session sharded over the mesh (with a checkpoint and a sharded resume
between its stops, where asked), and ``chain_means`` reduces a block of
values across ranks. ``session_result`` is what a run produced, the same on
every rank and equal to an unsharded run's where the sharding holds its
promise, and ``differences`` lists where two such results differ. Under
torchrun, call ``chain_mesh()`` in every rank instead.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.host import resolve_device
from .mesh import (TIMEOUT, chain_mesh, cross_chain_mean, pmean_tree,
                   resolve_backend, shard_chain_state, shard_simulation)


def spawn(fn, n: int, *args, device="cuda", backend: str = None) -> list:
    """fn(mesh, *args) on n ranks, each its own process, on ``device`` (rank
    r on cuda:(r % device_count) for CUDA) over a ``backend`` group
    (``mesh.resolve_backend``'s rule, checked before any process starts).
    The ranks inherit this process's environment (OMP_NUM_THREADS sets
    their intra-op threads). Returns the ranks' results in rank order
    (pickled through files in the temporary directory); raises when any
    rank raises."""
    backend = resolve_backend(device, backend, n)
    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="mctorch_ranks_") as tmp:
        mp.start_processes(_rank_main, nprocs=n, join=True,
                           start_method="spawn",
                           args=(n, tmp, fn, args, device, backend))
        out = []
        for rank in range(n):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _rank_main(rank, n, tmp, fn, args, device, backend):
    """One rank of ``spawn``: join the group, run fn, write its result."""
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=TIMEOUT)
    try:
        result = fn(chain_mesh(device=device, backend=backend), *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()          # no rank tears down while another works
    finally:
        dist.destroy_process_group()


def run_jobs(mesh, jobs) -> list:
    """Each job (function, args) of jobs in turn, as function(mesh, *args):
    several runs in one world, whose processes start once."""
    return [fn(mesh, *args) for fn, args in jobs]


def session_result(sim) -> dict:
    """What a run of sim produced, as host values: the configuration and
    (DQMC) G of every chain, the analysis, and each observable's mean and
    standard error (a value a measurement derives, as it is). On a sharded
    session a collective whose result every rank gets, equal to the
    unsharded session's where the sharding keeps its promise."""
    tensors = sim.shard.gather(
        [sim.conf] + ([sim.state["G"]] if hasattr(sim, "state") else []))
    out = {"conf": tensors[0].cpu().numpy(),
           "analysis": dataclasses.asdict(sim.analysis),
           "observables": {}}
    if len(tensors) > 1:
        out["G"] = tensors[1].cpu().numpy()
    for group, stats in sim.observables().items():
        out["observables"][group] = {
            name: ((v.mean, v.std_error) if hasattr(v, "std_error")
                   else np.asarray(v))
            for name, v in stats.items()}
    return out


def differences(a, b, path: str = "") -> list:
    """The leaves where two results (``session_result``s, checkpoints'
    payloads: nested dicts, lists and values) differ: arrays bit for bit,
    NaN equal to NaN, dtypes and shapes included; other values exactly.
    The timings and launch counts (``sweep_duration``, ``seconds``,
    ``launches``) are not compared. [] where they are identical."""
    if isinstance(a, dict):
        skip = {"sweep_duration", "seconds", "launches"}
        if not isinstance(b, dict) or a.keys() - skip != b.keys() - skip:
            return [f"{path} keys"]
        return [d for k in a.keys() - skip
                for d in differences(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differences(x, y, f"{path}[{i}]")]
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        same = (x.shape == y.shape and x.dtype == y.dtype
                and np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"))
        return [] if same else [path]
    return [] if (a == b or (a != a and b != b)) else [path]


def run_sharded(mesh, make, sweeps=(None,), checkpoint: str = None,
                **run_kw) -> dict:
    """make() a session, shard it over mesh and run it to each sweep count
    of ``sweeps`` in turn (None: its parameters' count), each with
    ``run(verbose=False, **run_kw)``. With a checkpoint file name the
    session is saved after every count but the last, loaded (unsharded)
    and sharded again. Returns ``session_result``, the wall seconds of the
    runs (synchronized on CUDA) and each kernel's launches in this process
    from make() on."""
    from ..io.checkpoint import load, save
    from ..ops import KERNELS

    before = {k: fn.launches for k, fn in KERNELS.items()}
    sim = shard_simulation(make(), mesh)
    seconds = 0.0
    for i, n in enumerate(sweeps):
        t0 = time.perf_counter()
        sim.run(sweeps=n, verbose=False, **run_kw)
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        if checkpoint is not None and i < len(sweeps) - 1:
            save(checkpoint, sim, overwrite=True)
            sim = shard_simulation(load(checkpoint, device=sim.device), mesh)
    return {**session_result(sim), "seconds": seconds,
            "launches": {k: fn.launches - before[k]
                         for k, fn in KERNELS.items()}}


def chain_means(mesh, values):
    """cross_chain_mean of this rank's block of values (numpy, chains
    first), and pmean_tree of a dict and list of the block and its double,
    as numpy."""
    block = shard_chain_state(torch.from_numpy(np.asarray(values)), mesh)
    tree = pmean_tree({"x": block, "y": [2 * block]}, mesh)
    return (cross_chain_mean(block, mesh).cpu().numpy(),
            {"x": tree["x"].cpu().numpy(), "y": [tree["y"][0].cpu().numpy()]})
