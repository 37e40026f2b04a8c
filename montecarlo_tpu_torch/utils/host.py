"""Device and dtype helpers (counterpart of montecarlo_tpu/utils/host.py)."""

from __future__ import annotations

import torch


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real counterpart of a (possibly complex) torch dtype."""
    return torch.empty((), dtype=dtype).real.dtype


def resolve_device(device="cuda") -> torch.device:
    """The torch device a session runs on. ``"cuda"`` (the default) raises
    when CUDA is absent instead of falling back to the CPU: a run that asked
    for the GPU must never quietly measure the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
