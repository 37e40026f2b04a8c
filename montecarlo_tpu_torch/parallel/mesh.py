"""Chain parallelism over a torch.distributed process group (counterpart of
montecarlo_tpu/parallel/mesh.py).

The unit of parallelism is the independent Markov chain. The JAX package
shards one global array over a ``jax.sharding.Mesh`` and lets XLA partition
it; here one process runs per rank (SPMD, under torchrun or
``launch.spawn``), every rank builds the same session, ``shard_simulation``
keeps only the rank's contiguous block of chains, and every number that
crosses chains goes through an explicit collective on the mesh's process
group. Chains never talk during a sweep, so the sweeps, their kernels and
the measurements run unchanged on a block; what changes is the bookkeeping
around them:

* random numbers: every generator draws the whole session's numbers, as one
  process would, and the rank keeps its block (a torch generator's numbers
  cannot be addressed by element);
* counters, observables, recorded configurations and checkpoints: gathered
  (``ChainSharding.gather``, one collective for a set of tensors) and then
  reduced on each rank exactly as one process reduces them, so a sharded
  session gives bit-identical results to the same session in one process;
* decisions that must agree (a checkpoint's time, the end of a Wolff
  search): rank 0's, broadcast, or the maximum over ranks.

A session that is not sharded holds ``ChainSharding()``: one rank with
every chain, whose collectives return their input, so a session has one
path whether it is sharded or not.

Checkpoints hold the gathered arrays, written by rank 0 (the JAX package's
docstring speaks of host-local shards, but its checkpoint too pickles
gathered arrays).

The backend rule: ``backend=None`` is "nccl" for a CUDA device and "gloo"
for the CPU; NCCL with more ranks than visible GPUs raises (two ranks on
one GPU need backend="gloo"); rank r runs on cuda:(r % device_count). A
gloo group runs its collectives on host copies of CUDA tensors (gloo has no
CUDA all-gather): ``collective_device`` names where a mesh's collectives
run.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.host import resolve_device

CHAIN_AXIS = "chains"

#: How long a collective waits for the other ranks before it raises
TIMEOUT = timedelta(minutes=10)


def resolve_backend(device, backend=None, world_size=1) -> str:
    """The process group backend for ranks on ``device``: backend=None is
    "nccl" on CUDA and "gloo" on the CPU. NCCL on the CPU, or with more
    ranks than visible GPUs, raises ValueError: nothing is substituted."""
    dev_type = torch.device(device).type
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if backend == "nccl":
        gpus = torch.cuda.device_count()
        if dev_type != "cuda":
            raise ValueError("backend='nccl' needs device='cuda'; pass "
                             "backend='gloo' for CPU ranks")
        if world_size > gpus:
            raise ValueError(
                f"backend='nccl' with {world_size} ranks but {gpus} visible "
                "GPUs: NCCL refuses two ranks on one GPU; pass "
                "backend='gloo' (collectives on host copies)")
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r} (use 'nccl' or "
                         "'gloo')")
    return backend


def chain_mesh(n_devices: int = None, device="cuda",
               backend: str = None) -> DeviceMesh:
    """A 1-D DeviceMesh over every rank of the world, its one dimension
    named CHAIN_AXIS. Without a default process group it initializes one:
    from the environment torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), else a world of this one process. n_devices, where given,
    must equal the world size. On CUDA the rank's device becomes
    cuda:(rank % device_count)."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        have = dist.get_backend()
        if backend not in (None, have):
            raise ValueError(f"backend {backend!r} asked for, but the default "
                             f"process group runs {have!r}")
        backend = have
    elif "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        world, rank = 1, 0
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the world has {world} "
                         "ranks")
    backend = resolve_backend(device, backend, world)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=TIMEOUT)
    return DeviceMesh(dev.type, torch.arange(world),
                      mesh_dim_names=(CHAIN_AXIS,))


def collective_device(mesh: DeviceMesh) -> torch.device:
    """Where the mesh's collectives run: the rank's GPU for NCCL, the host
    for gloo (whose collectives take host copies of CUDA tensors)."""
    if dist.get_backend(mesh.get_group()) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class ChainSharding:
    """The rank's block of the chains and the collectives over the mesh.

    The chains of a session split into ``size`` contiguous blocks of equal
    length; rank r holds block r (``block``, ``take``). ``gather``
    concatenates every rank's block, ``all_max`` and ``all_sum`` reduce over
    ranks and ``decide`` hands every rank rank 0's value. Without a mesh it
    is an unsharded session's: one rank holding every chain, whose
    collectives return their input."""

    def __init__(self, mesh: DeviceMesh = None):
        self.mesh = mesh
        if mesh is None:
            self.group, self.size, self.rank, self.device = None, 1, 0, None
        else:
            self.group = mesh.get_group()
            self.size = mesh.size()
            self.rank = mesh.get_local_rank()
            self.device = collective_device(mesh)

    def __repr__(self):
        if self.mesh is None:
            return "ChainSharding(one process, every chain)"
        return (f"ChainSharding(rank {self.rank} of {self.size}, collectives "
                f"on {self.device})")

    def block(self, n_chains: int) -> slice:
        """This rank's chains of n_chains (ValueError unless size divides
        n_chains)."""
        if n_chains % self.size != 0:
            raise ValueError(f"n_chains={n_chains} must be divisible by mesh "
                             f"size {self.size}")
        c = n_chains // self.size
        return slice(self.rank * c, (self.rank + 1) * c)

    def take(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's block of t, whose axis ``axis`` holds every chain:
        contiguous (no copy where the block is all of t)."""
        b = self.block(t.shape[axis])
        return t.narrow(axis, b.start, b.stop - b.start).contiguous()

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.mesh is None:
            return t
        x = t.to(self.device, copy=True)
        dist.all_reduce(x, op=op, group=self.group)
        return x.to(t.device)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of t over ranks."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of t over ranks."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def gather(self, tensors: Sequence[torch.Tensor],
               axis: int = 0) -> List[torch.Tensor]:
        """Every rank's blocks of tensors, concatenated along the chain axis
        ``axis`` in rank order, each on its tensor's device: one all-gather
        of the tensors' bytes. Every rank passes tensors of equal shapes."""
        if self.mesh is None:
            return list(tensors)
        moved = [t.movedim(axis, 0).contiguous() for t in tensors]
        flat = [t.reshape(-1).view(torch.uint8) for t in moved]
        buf = torch.cat(flat).to(self.device)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        out, off = [], 0
        for t, f in zip(moved, flat):
            n = f.numel()
            blocks = [p[off:off + n].clone().view(t.dtype).reshape(t.shape)
                      for p in parts]
            out.append(torch.cat(blocks).movedim(0, axis).contiguous().to(
                t.device))
            off += n
        return out

    def decide(self, values: list) -> list:
        """Rank 0's values (a list of picklable objects) on every rank."""
        values = list(values)
        if self.mesh is not None:
            dist.broadcast_object_list(values, src=0, group=self.group,
                                       device=self.device)
        return values


def stage_registry(sim, stage: str = "ME"):
    """A session's registry of a stage ("ME" measurement, else
    thermalization), its binners over every chain of every rank (gathered
    on a sharded session: a collective)."""
    registry = (sim.measurements if stage == "ME"
                else sim.thermalization_measurements)
    return registry.gathered(sim.shard)


def chain_sharding(mesh: DeviceMesh) -> ChainSharding:
    """The rank's block of a chain axis sharded over the mesh: the world
    size, the rank, ``block(n_chains)`` and the collectives."""
    return ChainSharding(mesh)


def shard_chain_state(state, mesh: DeviceMesh, axis: int = 0):
    """Keep the rank's block of the chain axis ``axis`` of every tensor in a
    state (a dict or list of them, nested); numpy arrays and other leaves,
    which every chain shares, are kept whole."""
    sh = chain_sharding(mesh)

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        return sh.take(x, axis) if torch.is_tensor(x) else x

    return cut(state)


def shard_simulation(mc, mesh: DeviceMesh):
    """Keep this rank's block of a simulation's chains (DQMC or MC): the
    chain state (DQMC's state dict, MC's conf) and the binner states of
    both measurement stages (chain axis second, their host counts shared),
    and record the sharding as ``mc.shard`` (an unsharded session's is
    ``ChainSharding()``, one rank holding every chain). From then on the
    session draws every chain's random numbers and keeps its block's, and
    gathers or reduces what crosses chains, so its results equal the
    unsharded session's bit for bit. ValueError when
    the mesh size does not divide n_chains or the session is sharded
    already."""
    if mc.n_chains % mesh.size() != 0:
        raise ValueError(
            f"n_chains={mc.n_chains} must be divisible by mesh size "
            f"{mesh.size()}")
    if mc.shard.mesh is not None:
        raise ValueError("the simulation is sharded already")
    if hasattr(mc, "state"):
        mc.state = shard_chain_state(mc.state, mesh)
    else:  # classical MC keeps its configuration directly
        mc.conf = shard_chain_state(mc.conf, mesh)
    for registry in (mc.measurements, mc.thermalization_measurements):
        registry.states = shard_chain_state(registry.states, mesh, axis=1)
    mc.shard = chain_sharding(mesh)
    return mc


def cross_chain_mean(values: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Mean over the chain axis (axis 0) of the chains of every rank: the
    rank's sum, an all-reduce (SUM) on the mesh's collective device, divided
    by the global chain count (the JAX package's psum)."""
    sh = chain_sharding(mesh)
    total = sh.all_sum(values.sum(dim=0))
    return total / (values.shape[0] * sh.size)


def pmean_tree(tree, mesh: DeviceMesh):
    """cross_chain_mean of every tensor of a dict or list (nested)."""
    if isinstance(tree, dict):
        return {k: pmean_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(pmean_tree(v, mesh) for v in tree)
    return cross_chain_mean(tree, mesh)
