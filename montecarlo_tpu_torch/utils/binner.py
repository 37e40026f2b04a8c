"""Logarithmic binning analysis (counterpart of montecarlo_tpu/utils/binner.py).

Level k holds means of 2^k consecutive samples. Every chain of a batch pushes
at the same time, so the per-level sample counts and carry flags are shared by
the batch and live on the host; the running sums, sums of squares and carry
values are float64 (complex128 for complex observables) tensors on the
device, of shape (D, C, *obs_shape) (level axis first); sums of squares
are of |x|^2 and real, as in the JAX binner. A push touches only the levels
its carry reaches — two on average — with the same cascade as the JAX
binner: a level holding a pending value emits the mean of the pair to the
level above.

mean / var / std_error / tau are computed on the host from the final state.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .host import real_dtype

DEFAULT_DEPTH = 32


class LogBinner:
    """Factory/namespace for logarithmic binner state and operations.

    State (dict):
      count        (D,) int64 numpy   samples pushed into each level
      has_pending  (D,) bool numpy
      total        (D, C, *shape)     running sum per level
      sumsq        (D, C, *shape)     running sum of |x|^2 per level (real)
      pending      (D, C, *shape)     carry slot per level
    """

    def __init__(self, shape: Tuple[int, ...] = (), dtype=torch.float64,
                 depth: int = DEFAULT_DEPTH):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.depth = int(depth)

    def empty_state(self, n_chains: int, device):
        D = self.depth
        z = lambda dt: torch.zeros((D, n_chains) + self.shape, dtype=dt,
                                   device=device)
        return {"count": np.zeros(D, np.int64),
                "has_pending": np.zeros(D, bool),
                "total": z(self.dtype), "sumsq": z(real_dtype(self.dtype)),
                "pending": z(self.dtype)}

    def push(self, state, value):
        """Push one sample per chain, value (C, *shape). Updates the state in
        place and returns it."""
        val = value.to(self.dtype)
        for k in range(self.depth):
            state["count"][k] += 1
            state["total"][k] += val
            state["sumsq"][k] += (val.abs().square() if val.is_complex()
                                  else val * val)
            if not state["has_pending"][k]:
                state["pending"][k] = val
                state["has_pending"][k] = True
                break
            val = (state["pending"][k] + val) * 0.5
            state["has_pending"][k] = False
        return state

    # ---------------------------------------------------------- checkpoints
    DEVICE_KEYS = ("total", "sumsq", "pending")

    @staticmethod
    def to_host(state):
        """A numpy copy of a state (for a checkpoint)."""
        return {k: v.cpu().numpy() if torch.is_tensor(v) else np.array(v)
                for k, v in state.items()}

    @staticmethod
    def from_host(state, device):
        """The state of a ``to_host`` copy, its sums on ``device``."""
        return {k: (torch.from_numpy(np.array(v)).to(device)
                    if k in LogBinner.DEVICE_KEYS else np.array(v))
                for k, v in state.items()}

    # ------------------------------------------------------------ statistics
    @staticmethod
    def _normalized(state):
        return (state["count"], state["total"].cpu().numpy(),
                state["sumsq"].cpu().numpy())

    @staticmethod
    def count(state, level: int = 0) -> int:
        return int(state["count"][level])

    @staticmethod
    def mean(state):
        counts, total, _ = LogBinner._normalized(state)
        if counts[0] == 0:
            return np.zeros_like(total[0])
        return total[0] / counts[0]

    @staticmethod
    def _level_stats(state):
        """Per-level (count, variance-of-level-samples, sq-std-error-of-mean)."""
        counts, total, sumsq = LogBinner._normalized(state)
        out = []
        for k in range(len(counts)):
            n = counts[k]
            if n < 2:
                out.append((int(n), None, None))
                continue
            m = total[k] / n
            var = (sumsq[k] / n - np.abs(m) ** 2) * n / (n - 1)
            var = np.maximum(var, 0.0)
            out.append((int(n), var, var / n))
        return out

    @staticmethod
    def var(state, level: int = 0):
        n, var, _ = LogBinner._level_stats(state)[level]
        if var is None:
            return np.zeros(state["total"].shape[1:], dtype=float)
        return var

    @staticmethod
    def std_error(state, min_count: int = 32):
        """Std error of the mean from the binning plateau: the largest
        per-level error estimate among levels with >= min_count samples."""
        stats = LogBinner._level_stats(state)
        candidates = [se for (n, _, se) in stats if se is not None and n >= min_count]
        if not candidates:
            candidates = [se for (n, _, se) in stats if se is not None]
        if not candidates:
            return np.zeros(state["total"].shape[1:], dtype=float)
        return np.sqrt(np.max(np.stack(candidates, 0), axis=0))

    @staticmethod
    def tau(state, min_count: int = 32):
        """Integrated autocorrelation time estimate:
        tau = 0.5 * (2^k * var_k / var_0 - 1) at the plateau level."""
        stats = LogBinner._level_stats(state)
        n0, var0, _ = stats[0]
        if var0 is None:
            return np.zeros(state["total"].shape[1:], dtype=float)
        best = np.zeros_like(var0)
        for k, (n, var, se) in enumerate(stats):
            if var is None or n < min_count:
                continue
            tau_k = 0.5 * ((2.0 ** k) * var / np.where(var0 == 0, 1.0, var0) - 1.0)
            best = np.maximum(best, tau_k)
        return best

    @staticmethod
    def combined_mean(state, chain_axis: int = 0):
        """Mean over samples and the chain axis."""
        return np.mean(LogBinner.mean(state), axis=chain_axis)

    @staticmethod
    def combined_std_error(state, chain_axis: int = 0, min_count: int = 32):
        """Std error of the chain-averaged mean (independent chains)."""
        se = LogBinner.std_error(state, min_count)
        C = se.shape[chain_axis]
        return np.sqrt(np.sum(se ** 2, axis=chain_axis)) / C
