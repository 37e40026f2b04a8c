"""User-defined DQMC measurements: any Wick kernel over any lattice iterator
(counterpart of montecarlo_tpu/measurements/custom.py).

A kernel returns a whole kernel matrix (or vector) for all chains at once,
and the lattice iterator selects the reduction that bins it: one product
by a one-hot direction matrix, as the shipped observables do
(``dqmc_measurements.py``).

Kernels are batch-first, as the shipped kernels (``cdc_matrix``,
``cdc4_matrix``): every Green's function has a leading chain axis,
(C, F, N, N), F the flavor-block axis (G[:, 0] the up block, G[:, -1] the
down block), and the kernel returns (C, *raw). No ``vmap`` is applied (the
JAX package maps a per-chain kernel over the chains instead).

* equal-time (``Greens``) and ``GreensAt(k, l)``: ``kernel(G) -> raw``
* ``CombinedGreensIterator`` (susceptibilities):
  ``kernel(G00, G0l, Gl0, Gll) -> raw``, summed over the M slices and
  weighted by delta_tau by the driver.

The raw shape per chain for each lattice iterator (N sites, K quad
directions, F flavors):

| lattice iterator                 | raw (per chain)  | stored (per chain)  |
|----------------------------------|------------------|---------------------|
| EachSite / OnSite                | (N,)             | (N,)                |
| EachSiteAndFlavor(lattice, F)    | (N·F,)           | (N·F,)              |
| EachSitePair                     | (N, N)           | (N, N) / N          |
| EachSitePairByDistance (default) | (N, N)           | (n_dirs,), binned/N |
| EachLocalQuadByDistance(K)       | (K, K, N, N)     | (n_dirs, K, K)      |
| EachLocalQuadBySyncedDistance(K) | (K, N, N)        | (n_dirs, K)         |

For quad kernels ``selection_matrices(lattice, K)`` gathers the
direction-k targets: ``S[k] @ G[c] @ S[q].T`` is ``G[c, t(s1, k),
t(s2, q)]`` indexed ``[s1, s2]`` (zero rows mask missing targets).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..lattices import iterators as it
from .core import Measurement
from .dqmc_measurements import (CombinedGreensIterator, Greens, GreensAt,
                                _OnDevice, _bin_by_dir, _dir_onehot,
                                _selection_matrices, _session_eltype)


def selection_matrices(lattice, K: int):
    """The (K, N, N) one-hot target-selection matrices of quad kernels,
    numpy float32: S[k, s, t(s, k)] = 1 where site s has a target t at
    direction k, the row zero where it has none."""
    return _selection_matrices(lattice, K)


def _reduction(li, lattice):
    """(raw shape per chain, reduce_fn) of a lattice iterator: reduce_fn
    maps (C, *raw) to (C, *stored)."""
    N = len(lattice)
    if isinstance(li, it.EachSitePair):
        return (N, N), lambda raw: raw / N
    if isinstance(li, (it.EachSite, it.OnSite, it.EachSiteAndFlavor)):
        return tuple(li.output_size(lattice)), lambda raw: raw
    if not isinstance(li, (it.EachSitePairByDistance,
                           it.EachLocalQuadByDistance,
                           it.EachLocalQuadBySyncedDistance)):
        raise TypeError(f"unsupported lattice iterator: {li!r}")
    P = _OnDevice(_dir_onehot(lattice))

    def binned(raw):                 # (C, ..., N, N) -> (C, ..., n_dirs)
        return _bin_by_dir(raw, P.like(raw), N)

    if isinstance(li, it.EachSitePairByDistance):
        return (N, N), binned
    if isinstance(li, it.EachLocalQuadByDistance):
        # (C, K, K, n_dirs) -> (C, n_dirs, K, K)
        return ((li.K, li.K, N, N),
                lambda raw: torch.movedim(binned(raw), -1, -3))
    return (li.K, N, N), lambda raw: binned(raw).mT


def custom_measurement(mc, model, kernel: Callable, *, name: str = "custom",
                       lattice_iterator=None, greens_iterator=Greens,
                       dtype=None) -> Measurement:
    """A Measurement from a batch-first user kernel and a lattice iterator;
    register it with ``mc[name] = measurement``.

    greens_iterator: Greens (equal-time, the default), GreensAt(k, l) or
    CombinedGreensIterator (a τ-integrated susceptibility kernel).
    lattice_iterator: an instance from ``montecarlo_tpu_torch.lattices``
    (default EachSitePairByDistance()). dtype: the binners' dtype (default:
    complex128 for a complex session, else float64). A kernel whose output
    is not (C, *raw) raises ValueError at its first measurement."""
    lat = model.lattice
    li = (lattice_iterator if lattice_iterator is not None
          else it.EachSitePairByDistance())
    if isinstance(li, type):
        li = li()
    eltype = dtype if dtype is not None else _session_eltype(mc)
    out_shape = tuple(li.output_size(lat))
    raw_shape, reduce_fn = _reduction(li, lat)

    def checked(raw):
        if tuple(raw.shape[1:]) != raw_shape:
            raise ValueError(
                f"custom measurement {name!r}: the kernel returned "
                f"{tuple(raw.shape)}, expected (chains, *{raw_shape}) for "
                f"{type(li).__name__} (kernels are batch-first)")
        return raw

    gi = greens_iterator
    if gi is Greens or isinstance(gi, Greens):
        def measure(greens, **_):
            return {name: reduce_fn(checked(kernel(greens)))}

        return Measurement(name, {name: out_shape}, measure, dtype=eltype)

    if isinstance(gi, GreensAt):
        def measure_at(utg, **_):
            return {name: reduce_fn(checked(kernel(utg)))}

        return Measurement(name, {name: out_shape}, measure_at,
                           kind="greens_at", dtype=eltype, greens_at=gi.kl)

    if gi is CombinedGreensIterator or isinstance(gi, CombinedGreensIterator):
        def step(G00, G0l, Gl0, Gll, **_):
            return {name: checked(kernel(G00, G0l, Gl0, Gll))}

        def finish(acc):
            return {name: reduce_fn(acc[name])}

        return Measurement(name, {name: out_shape}, step, kind="combined",
                           dtype=eltype,
                           combined_acc_shapes={name: raw_shape},
                           combined_finish_fn=finish)

    raise TypeError(f"unsupported greens iterator: {gi!r}")
