"""Carry constants and chain state between montecarlo_tpu and this package.

numpy in, torch out (and back); nothing here imports JAX. The JAX side
converts its arrays with ``numpy.asarray`` before calling these.
"""

from __future__ import annotations

import numpy as np
import torch

from .dqmc.core import COUNTER_KEYS, CX_COUNTER_KEYS

_STATE_KEYS = ("conf", "S_U", "S_D", "S_T", "G") + COUNTER_KEYS
# a complex session's phase-problem statistics and weight phase
_CX_KEYS = CX_COUNTER_KEYS + ("ls_phase", "phase_meas")
_INT_KEYS = ("prop", "acc", "neg_prob", "prop_err_count", "prop_err_n",
             "prop_err_hist", "ls_imag_count")


def consts_from_numpy(consts, device="cpu"):
    """make_context's constants dict from numpy arrays (same keys)."""
    return {k: torch.as_tensor(np.array(v)).to(device) for k, v in consts.items()}


def state_from_numpy(state_np, device="cpu"):
    """The port's state dict from a chain-batched montecarlo_tpu state (the
    vmapped init_state / sweep_pair output as numpy arrays: conf (C, N, M),
    stacks (C, n_el, F, N, N), G (C, F, N, N), per-chain counters; complex
    sessions also the phase-problem statistics and the weight phase). The
    JAX RNG key is dropped; counters become int64."""
    keys = _STATE_KEYS + (_CX_KEYS if "ls_phase" in state_np else ())
    out = {}
    for k in keys:
        t = torch.as_tensor(np.array(state_np[k]))
        if k in _INT_KEYS:
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


def state_to_numpy(state):
    """numpy copy of a port state dict (the inverse of state_from_numpy)."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
