"""The Ising model's moves: the checkerboard Metropolis sweep (kernel K17)
and a batch of levels of the Wolff cluster's breadth-first search (kernel
K18).

``ising_sweep`` and ``wolff_step`` launch the CUDA kernels of
``csrc/ising.cu`` on CUDA tensors; on CPU tensors they run
``ising_sweep_plain`` and ``wolff_step_plain``, the plain PyTorch versions
of the same functions. Neither replaces a TPU kernel: the JAX package runs
both as XLA loops inside its jitted scan (``montecarlo_tpu/models/
ising.py:88-103`` and the while-loop body at ``:131-148``), as it runs its
float64 DQMC site loop, for which the port has K1-f64.

The static data both take (``IsingTables``) is built once per lattice,
device and beta: the neighbor table (N, z) int32, the color classes as one
site order (N,) with class offsets, for N <= 64 each class position's
neighbors as a bit mask over class positions (K17's tile layout), the
acceptance thresholds thr[h] = exp(-2 beta h) for h = 0..z in float64
(computed once on the host, so the kernel and the plain version compare
the same numbers), and for K18 the reverse table rev[t] = the flat bond
indices i*z + k with table[i, k] = t.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import _build


@dataclass(frozen=True)
class IsingTables:
    """A lattice's static data for K17 and K18, on one device."""

    table: torch.Tensor     # (N, z) int32 neighbor table
    order: torch.Tensor     # (N,) int32: the color classes' sites in order
    offsets: torch.Tensor   # (n_classes + 1,) int32 class boundaries in order
    bounds: tuple           # the same offsets as Python ints
    masks: torch.Tensor     # (N,) int64 neighbor masks (K17), or None
    thr: torch.Tensor       # (z + 1,) float64: exp(-2 beta h), h = 0..z
    rev: torch.Tensor       # (N, zr) int32 reverse table, -1 padded
    p_add: float            # Wolff bond probability 1 - exp(-2 beta)

    @property
    def N(self):
        return self.table.shape[0]

    @property
    def z(self):
        return self.table.shape[1]


#: K17's tile layout holds a chain's spins as a 64-bit mask up to this
#: many sites; K18's register layout its cluster and frontier, where at
#: most REG_BONDS bonds lead onto a site
REG_SITES, REG_BONDS = 64, 8


def neighbor_masks(table, order):
    """(N,) int64 for N <= REG_SITES, in class positions: bit r of masks[p]
    is set when site order[r] neighbors site order[p], so with bit r of up
    the spin of site order[r] up, the neighbor sum of position p is
    2 popc(up & masks[p]) - z. None where a site lists a neighbor twice
    (the 2x2), which K17 sweeps in its shared-memory layout."""
    N = len(order)
    counts = np.zeros((N, N), np.int64)          # [p, site]
    for p, i in enumerate(order):
        np.add.at(counts[p], table[i], 1)
    if counts.max(initial=0) > 1:
        return None
    weights = np.left_shift(np.uint64(1), np.arange(N, dtype=np.uint64))
    return (counts[:, order] * weights).sum(axis=1,
                                            dtype=np.uint64).view(np.int64)


def check_table(table):
    """Raise ValueError on a neighbor table padded with -1 (a lattice of
    uneven coordination): the JAX package's gathers read index -1 as the
    last site there (ROADMAP Queue 3), which the port does not copy."""
    if (np.asarray(table) < 0).any():
        raise ValueError(
            "the Ising moves need every site to have the same number of "
            "neighbors: this lattice's neighbor table is padded with -1 "
            "(uneven coordination), which the JAX package's gathers read as "
            "the last site (ROADMAP Queue 3)")


def make_tables(lattice, beta: float, device) -> IsingTables:
    """The static data of K17 and K18 for a lattice at inverse temperature
    beta (``check_table`` first)."""
    table = np.asarray(lattice.neighbor_table, np.int32)
    check_table(table)
    N, z = table.shape
    colors = lattice.site_colors
    order = np.concatenate(colors).astype(np.int32)
    offsets = np.cumsum([0] + [len(c) for c in colors]).astype(np.int32)
    beta = float(beta)
    thr = np.exp(-beta * (2.0 * np.arange(z + 1, dtype=np.float64)))
    ins = [[] for _ in range(N)]
    for e, t in enumerate(table.reshape(-1)):
        ins[t].append(e)
    zr = max((len(x) for x in ins), default=0)
    rev = -np.ones((N, zr), np.int32)
    for t, x in enumerate(ins):
        rev[t, :len(x)] = x
    dev = lambda a: torch.from_numpy(a).to(device)
    masks = neighbor_masks(table, order) if N <= REG_SITES else None
    masks = None if masks is None else dev(masks)
    return IsingTables(table=dev(table), order=dev(order),
                       offsets=dev(offsets), bounds=tuple(int(o) for o in offsets),
                       masks=masks, thr=dev(thr), rev=dev(rev),
                       p_add=1.0 - math.exp(-2.0 * beta))


# ------------------------------------------------------------------ K17
def ising_sweep_plain(conf, u, tabs: IsingTables, acc):
    """One checkerboard Metropolis sweep of every chain (the JAX package's
    make_sweep_fn): per color class in order, h = s_i sum_nn s_j (dE = 2h),
    accept when h <= 0 or u < thr[h], flip the accepted sites.

    conf (C, N) int8 ±1; u (C, N) float64 in class order (column p is the
    p-th site of ``tabs.order``: class 0's uniforms, then class 1's, ...);
    acc (C,) int64, to which each chain's accepted count is added in place.
    Returns (new conf, acc); conf is not modified."""
    conf = conf.clone()
    table = tabs.table.long()
    b = tabs.bounds
    for k in range(len(b) - 1):
        idx = tabs.order[b[k]:b[k + 1]].long()
        s = conf.to(torch.int32)
        h = s[:, idx] * s[:, table[idx]].sum(dim=2)
        accept = (h <= 0) | (u[:, b[k]:b[k + 1]] < tabs.thr[h.clamp_min(0)])
        conf[:, idx] = torch.where(accept, -conf[:, idx], conf[:, idx])
        acc += accept.sum(dim=1)
    return conf, acc


def ising_sweep(conf, u, tabs: IsingTables, acc):
    """One checkerboard Metropolis sweep: K17 for a CUDA tensor,
    ``ising_sweep_plain`` for a CPU tensor. Same arguments and results; on
    CUDA conf must be int8 (C, N), u float64 (C, N), acc int64 (C,), all
    contiguous on the tables' device. acc is updated in place."""
    if conf.device.type == "cpu":
        return ising_sweep_plain(conf, u, tabs, acc)
    C, N = _check("ising_sweep", conf, tabs, (u, torch.float64, 2),
                  (acc, torch.int64, 1))
    out = torch.empty_like(conf)
    with torch.cuda.device(conf.device):
        code = _build.load().ising_sweep_i8(
            conf.data_ptr(), out.data_ptr(), u.data_ptr(),
            tabs.table.data_ptr(), tabs.order.data_ptr(),
            tabs.offsets.data_ptr(),
            0 if tabs.masks is None else tabs.masks.data_ptr(),
            tabs.thr.data_ptr(), acc.data_ptr(), C, N, tabs.z,
            len(tabs.bounds) - 1, int(tabs.bounds[1:] == (32, N)),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("ising_sweep", code)
    ising_sweep.launches += 1
    return out, acc


# ------------------------------------------------------------------ K18
def wolff_level(conf, in_cluster, frontier, seed_spin, u, table, p_add):
    """One level of the Wolff cluster's breadth-first search (the body of
    the JAX package's lax.while_loop): bond (i, k) activates table[i, k]
    when i is on the frontier, the neighbor has the seed's spin and is not
    yet in the cluster, and u[c, i, k] < p_add; the targets are OR-ed
    together (a scatter with max, as JAX's .at[].max). table (N, z) int64,
    u (C, N, z). Returns the new (in_cluster, frontier)."""
    try_add = (frontier[:, :, None] & (conf[:, table] == seed_spin[:, :, None])
               & ~in_cluster[:, table] & (u < p_add))
    C, N = conf.shape
    new = torch.zeros(C, N, dtype=torch.uint8, device=conf.device)
    new.scatter_reduce_(1, table.reshape(1, -1).expand(C, -1),
                        try_add.reshape(C, -1).to(torch.uint8), "amax")
    new_frontier = new.bool() & ~in_cluster
    return in_cluster | new_frontier, new_frontier


def wolff_step_plain(conf, in_cluster, frontier, seed_spin, u,
                     tabs: IsingTables, status=None):
    """Up to Lb BFS levels of the Wolff clusters, levels in order over the
    stacked uniforms u (Lb, C, N, z) float64 (level ell reads u[ell]); a
    level runs while some chain's frontier holds a site (a host check: on
    the card only the tests and chip_smoke.py call this version).

    conf (C, N) int8, in_cluster and frontier (C, N) bool, seed_spin (C, 1)
    int8. Returns (in_cluster, frontier, status): the cluster and frontier
    after the batch, and status (2,) int32, the levels run (the JAX loop's
    body runs) and 1 when a frontier is left (given status is set in
    place)."""
    table = tabs.table.long()
    ran = 0
    for level in u:
        if not bool(frontier.any()):
            break
        in_cluster, frontier = wolff_level(conf, in_cluster, frontier,
                                           seed_spin, level, table,
                                           tabs.p_add)
        ran += 1
    out = torch.tensor([ran, int(bool(frontier.any()))], dtype=torch.int32,
                       device=conf.device)
    if status is None:
        status = out
    else:
        status.copy_(out)
    return in_cluster, frontier, status


def wolff_scratch(N, zr):
    """Whether K18 keeps a chain's state in device memory (a (C, N) uint8
    scratch buffer): in the block layout (N > REG_SITES or more than
    REG_BONDS bonds onto a site) where its 4N bytes exceed a block's shared
    memory."""
    return (N > REG_SITES or zr > REG_BONDS) and 4 * N > _build.SMEM_PER_BLOCK


def wolff_step(conf, in_cluster, frontier, seed_spin, u, tabs: IsingTables,
               status=None):
    """A batch of Lb BFS levels of the Wolff clusters: one K18 launch for a
    CUDA tensor, ``wolff_step_plain`` for a CPU tensor. Same arguments and
    results; on CUDA conf int8 (C, N), in_cluster and frontier bool (C, N),
    seed_spin int8 (C, 1), u float64 (Lb, C, N, z), all contiguous on the
    tables' device; status, where given, two zeroed int32 (a fresh pair
    otherwise), which K18 sets to the levels run and whether a frontier is
    left."""
    if conf.device.type == "cpu":
        return wolff_step_plain(conf, in_cluster, frontier, seed_spin, u,
                                tabs, status)
    C, N = _check("wolff_step", conf, tabs, (in_cluster, torch.bool, 2),
                  (frontier, torch.bool, 2), (seed_spin, torch.int8, 2))
    if (u.dtype != torch.float64 or u.dim() != 4 or u.shape[0] < 1
            or tuple(u.shape[1:]) != (C, N, tabs.z)
            or tuple(seed_spin.shape) != (C, 1)):
        raise ValueError("wolff_step: u must be float64 (Lb, C, N, z) with "
                         "Lb >= 1, seed_spin (C, 1)")
    if u.device != conf.device or not u.is_contiguous():
        raise ValueError("wolff_step: tensors must be contiguous on one "
                         "device")
    if status is None:
        status = torch.zeros(2, dtype=torch.int32, device=conf.device)
    elif (status.dtype != torch.int32 or status.numel() != 2
          or status.device != conf.device):
        raise ValueError("wolff_step: status must be two int32 on the card")
    in_out = torch.empty_like(in_cluster)
    front_out = torch.empty_like(frontier)
    zr = tabs.rev.shape[1]
    scratch = (torch.empty(C, N, dtype=torch.uint8, device=conf.device)
               if wolff_scratch(N, zr) else None)
    with torch.cuda.device(conf.device):
        code = _build.load().wolff_step_u8(
            conf.data_ptr(), in_cluster.data_ptr(), frontier.data_ptr(),
            seed_spin.data_ptr(), u.data_ptr(), tabs.rev.data_ptr(),
            in_out.data_ptr(), front_out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), status.data_ptr(),
            float(tabs.p_add), C, N, tabs.z, zr, u.shape[0],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("wolff_step", code)
    wolff_step.launches += 1
    return in_out, front_out, status


ising_sweep.launches = 0
wolff_step.launches = 0


def _check(name, conf, tabs, *others):
    """conf int8 (C, N) on a CUDA device, the tables and every (tensor,
    dtype, ndim) of others contiguous on its device with leading dims
    (C, N) (u of the sweep: (C, N); acc: (C,)). Returns (C, N)."""
    if conf.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {conf.device}")
    if conf.dtype != torch.int8 or conf.dim() != 2:
        raise ValueError(f"{name}: conf must be int8 (C, N)")
    C, N = conf.shape
    if N != tabs.N:
        raise ValueError(f"{name}: conf has {N} sites, the tables {tabs.N}")
    for t, dtype, ndim in others:
        if t.dtype != dtype or t.dim() != ndim or t.shape[0] != C:
            raise ValueError(f"{name}: expected {str(dtype)[6:]} with "
                             f"{ndim} dims and {C} chains, got "
                             f"{str(t.dtype)[6:]} {tuple(t.shape)}")
        if ndim >= 2 and t.shape[1] not in (N, 1):
            raise ValueError(f"{name}: {tuple(t.shape)} does not match N={N}")
    for t in (conf, *(o[0] for o in others), tabs.table, tabs.rev):
        if t.device != conf.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one "
                             "device")
    return C, N
