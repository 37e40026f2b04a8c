"""Ising model (counterpart of montecarlo_tpu/models/ising.py).

H = - sum_<i,j> s_i s_j (J = 1). Configurations are (C, N) int8 ±1
tensors, batched over chains. The two moves run on hand-written kernels
(``ops/ising.py``):

* the Metropolis sweep, checkerboard-colored: the sites of one color class
  of ``Lattice.site_colors`` have no bond between them, so one class is
  decided at once, classes in order (kernel K17, one launch per sweep);
* the Wolff cluster move as a batched breadth-first search (the JAX
  package's lax.while_loop), run in batches of levels: one launch of kernel
  K18 runs a batch, and the host reads its status once (one host
  synchronization a batch) to learn whether another batch is needed.

The moves take their random numbers as arguments (the sweep its uniforms,
the cluster move its seeds and a callable drawing a batch of levels'
uniforms and taking back those the search did not use), so a caller can
feed them the JAX package's stream; ``mc.MC`` draws them from the session's
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .base import Model
from ..lattices.lattice import Lattice
from ..lattices.library import choose_lattice
from ..ops import ising as kising
from ..parallel.mesh import ChainSharding

#: Exact critical temperature of the 2D Ising model
IsingTc = 2.0 / math.log(1.0 + math.sqrt(2.0))

#: The most bytes the float64 uniforms of one batch of Wolff levels take
BATCH_BYTES = 512 << 20


def batch_levels(last, done, C, N, z):
    """The levels of the Wolff move's next batch. The cap is N + 1 (a
    search ends within N levels) and the levels whose uniforms fit in
    BATCH_BYTES (at least one). The first batch of a move takes the
    previous move's level count plus an eighth plus 2 (the cap on a
    session's first move, last None); a later batch of the same move a
    quarter of that, at least 2. done: the levels the move has run. A
    level drawn and handed back costs its torch.rand; a batch too short,
    one more host read."""
    cap = max(1, min(N + 1, BATCH_BYTES // max(1, 8 * C * N * z)))
    if last is None:
        return cap
    first = min(cap, last + last // 8 + 2)
    return first if done == 0 else min(cap, max(2, first // 4))


class IsingModel(Model):
    """Ising model on a chain, square or cubic lattice (dims and L) or any
    lattice of even coordination (l). A lattice whose neighbor table is
    padded with -1 raises ValueError (``ops.ising.check_table``)."""

    def __init__(self, dims: int = None, L: int = None, l: Lattice = None,
                 **kwargs):
        if l is None:
            if dims is None or L is None:
                raise ValueError("IsingModel requires either l=lattice or "
                                 "dims and L")
            l = choose_lattice(dims, L)
        kising.check_table(l.neighbor_table)
        self.lattice = l

    def parameters(self) -> Dict:
        return {"dims": self.lattice.dim, "L": self.lattice.shape[0]}

    def __repr__(self):
        return f"IsingModel({len(self.lattice)} sites)"

    def rand_conf(self, generator: torch.Generator, n_chains: int,
                  device=None) -> torch.Tensor:
        """Random ±1 spins, (C, N) int8, drawn from ``generator`` (which
        must live on ``device``; default: the generator's device)."""
        device = generator.device if device is None else device
        bits = torch.randint(0, 2, (n_chains, len(self.lattice)),
                             generator=generator, device=device,
                             dtype=torch.int8)
        return 2 * bits - 1

    def make_energy_fn(self):
        """E(conf) per chain, (C,) float64: -sum over bonds s_src s_trg."""
        bonds = torch.as_tensor(self.lattice.bonds[:, :2]).long()
        on = {}                         # the bond list on each device

        def energy(conf):
            b = on.get(conf.device)
            if b is None:
                b = on[conf.device] = bonds.to(conf.device)
            s = conf.to(torch.float64)
            return -(s[:, b[:, 0]] * s[:, b[:, 1]]).sum(dim=1)

        return energy

    def make_magnetization_fn(self):
        """|M|(conf) per chain, (C,) float64."""
        def magnetization(conf):
            return conf.to(torch.float64).sum(dim=1).abs()

        return magnetization

    def make_sweep_fn(self, beta: float, device, use_kernels: bool = True):
        """One checkerboard Metropolis sweep over all sites:
        sweep(conf, u, acc) -> (conf, acc) with u (C, N) float64 in class
        order (``ops.ising.ising_sweep_plain``) and acc (C,) int64, to which
        each chain's accepted count is added in place. K17 on CUDA
        tensors (use_kernels=False: its plain version on any device)."""
        tabs = kising.make_tables(self.lattice, beta, device)
        step = kising.ising_sweep if use_kernels else kising.ising_sweep_plain

        def sweep(conf, u, acc):
            return step(conf, u, tabs, acc)

        return sweep

    def make_global_move_fn(self, beta: float, device,
                            use_kernels: bool = True,
                            shard: ChainSharding = None):
        """The Wolff cluster move of every chain as a batched BFS:
        global_move(conf, seeds, draw) -> (flipped conf, cluster sizes (C,),
        levels). seeds (C,) are the clusters' first sites; draw(k) returns
        the next k levels' uniforms stacked (k, C, N, z) float64 and a
        function rewind(used) that leaves the stream just after the
        used-th of them. The search runs in batches of levels
        (``batch_levels``' choice from the previous move's level count),
        each one K18 launch on CUDA tensors
        (use_kernels=False: its plain version) and one host read of its
        status, until no chain's frontier has a site; then the unused
        levels are handed back, so a move consumes exactly ``levels`` draws
        (the JAX loop's body runs) whatever the batch size. Every candidate
        bond is tried at most once. ``global_move.batches`` counts the
        batches run (the host reads). shard (``parallel.chain_sharding``;
        by default one process's, every chain): conf holds this rank's block
        of the session's chains, draw(k) its block of every chain's levels;
        a batch's status is the maximum over ranks (one all-reduce after the
        host read a batch takes), so every rank runs and hands back the
        levels one process would, and the batch size is that of the whole
        session."""
        shard = shard or ChainSharding()
        tabs = kising.make_tables(self.lattice, beta, device)
        step = kising.wolff_step if use_kernels else kising.wolff_step_plain
        N, z = tabs.N, tabs.z
        last = [None]                    # the previous move's level count

        def global_move(conf, seeds, draw):
            C = conf.shape[0]
            seeds = seeds.long()[:, None]
            in_cluster = torch.zeros(C, N, dtype=torch.bool,
                                     device=conf.device).scatter_(1, seeds,
                                                                  True)
            seed_spin = conf.gather(1, seeds)
            frontier = in_cluster
            levels = 0
            while True:
                k = batch_levels(last[0], levels, C * shard.size, N, z)
                u, rewind = draw(k)
                in_cluster, frontier, status = step(
                    conf, in_cluster, frontier, seed_spin, u, tabs)
                # a search ends when no chain of any rank has a frontier
                ran, left = shard.all_max(status).tolist()   # one host sync
                global_move.batches += 1
                levels += ran
                if not left:
                    rewind(ran)
                    break
            last[0] = levels
            flipped = torch.where(in_cluster, -conf, conf)
            return flipped, in_cluster.sum(dim=1), levels

        global_move.batches = 0
        return global_move

    def default_measurements(self, mc):
        from ..measurements.ising import (IsingEnergyMeasurement,
                                          IsingMagnetizationMeasurement)
        return {"Energy": IsingEnergyMeasurement(mc, self),
                "Magn": IsingMagnetizationMeasurement(mc, self)}
