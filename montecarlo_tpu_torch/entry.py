"""Entry points for compile and launch checks (counterpart of the JAX
package's ``__graft_entry__.py``).

entry() — one full DQMC [down; up] sweep pair on the flagship model (the
attractive Hubbard model on a 2×2 lattice, 4 chains), as a function of the
state and the pair's uniforms, with its example arguments.

dryrun_multichip(n) — the sweep and measurement step of a chain-sharded
session on n ranks, one process each: every rank builds the 2×2 session
with 2n chains, keeps its block (``parallel.shard_simulation``), runs one
sweep with measurements, and ``cross_chain_mean`` reduces the occupation
across ranks. Any rank's exception fails the call.
"""

from __future__ import annotations

import torch

from .dqmc import DQMC, core
from .models import HubbardModelAttractive
from .parallel import cross_chain_mean, shard_simulation
from .parallel.launch import spawn


def _tiny_dqmc(n_chains, device, L=2, beta=1.0):
    model = HubbardModelAttractive(dims=2, L=L, U=4.0, mu=0.5)
    return DQMC(model, beta=beta, delta_tau=0.1, safe_mult=5,
                n_chains=n_chains, seed=0, thermalization=0, sweeps=4,
                measure_rate=1, print_rate=10 ** 9, device=device)


def entry(device="cuda"):
    """Returns (fn, example_args): fn(state, u) is one full sweep pair of
    the 2×2 session's 4 chains on uniforms u (C, 2M, N), returning the new
    state; the example arguments are the session's state and its first
    pair's uniforms."""
    sim = _tiny_dqmc(4, device)

    def step(state, u):
        new_state, G_meas, conf_meas = core.sweep_pair(sim.ctx, sim.consts,
                                                       state, u=u)
        return new_state

    return step, (sim.state, sim._uniforms())


def _dryrun_rank(mesh, device):
    """One rank of ``dryrun_multichip``: the mean occupation over every
    rank's chains after one sweep with measurements."""
    sim = shard_simulation(_tiny_dqmc(2 * mesh.size(), device), mesh)
    sim.run(thermalization=0, sweeps=1, verbose=False)
    occ = 1.0 - torch.diagonal(sim.state["G"], dim1=-2, dim2=-1)  # (C, F, N)
    mean_occ = cross_chain_mean(occ.reshape(occ.shape[0], -1), mesh)
    return float(mean_occ.mean())


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: str = None) -> None:
    """The sweep and measurement step over n_devices ranks, each its own
    process on ``device`` (``parallel.launch.spawn``; backend by the mesh's
    rule: NCCL for CUDA, which needs a GPU a rank, gloo for the CPU), and
    the occupation reduced across them."""
    mean_occ = spawn(_dryrun_rank, n_devices, device, device=device,
                     backend=backend)[0]
    print(f"dryrun_multichip({n_devices}): OK — sweep+measure step executed, "
          f"psum-reduced occupation mean = {mean_occ:.4f}")
