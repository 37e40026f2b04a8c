"""Device and dtype helpers (counterpart of montecarlo_tpu/utils/host.py)."""

from __future__ import annotations

import numpy as np
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


def generator_state(generator: torch.Generator) -> dict:
    """A generator's state for a checkpoint: the device type it draws on and
    ``get_state()`` as a numpy uint8 array."""
    return {"device": generator.device.type,
            "state": generator.get_state().numpy().copy()}


def set_generator_state(generator: torch.Generator, saved: dict):
    """Restore ``generator_state``'s copy into generator. A state saved on
    another device type raises ValueError: the stream of one device does not
    continue on another, and reseeding would change the run."""
    if saved["device"] != generator.device.type:
        raise ValueError(
            f"the checkpoint's random generators draw on {saved['device']!r} "
            f"but this simulation runs on {generator.device.type!r}: load "
            f"it with device={saved['device']!r} (a generator's stream does "
            "not carry over between devices, and reseeding would change the "
            "run)")
    generator.set_state(torch.from_numpy(
        np.asarray(saved["state"], dtype=np.uint8).copy()))
