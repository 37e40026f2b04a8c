"""Numeric difference helpers (counterpart of
montecarlo_tpu/utils/compare.py). Every argument may be a tensor (on any
device), an array or a sequence."""

import numpy as np
import torch


def _host(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _rel(x, y):
    """Elementwise 2|x - y| / (|x| + |y|), 0 where both are 0."""
    denom = np.abs(x) + np.abs(y)
    return np.where(denom == 0.0, 0.0,
                    2.0 * np.abs(x - y) / np.where(denom == 0, 1.0, denom))


def absdiff(x, y):
    """Maximum elementwise absolute difference |x - y|."""
    return float(np.max(np.abs(_host(x) - _host(y))))


def reldiff(x, y):
    """Maximum elementwise relative difference 2|x-y| / (|x|+|y|)."""
    return float(np.max(_rel(_host(x, np.float64), _host(y, np.float64))))


def effreldiff(x, y, atol=1e-14):
    """Relative difference ignoring entries that agree within ``atol``."""
    x, y = _host(x, np.float64), _host(y, np.float64)
    rel = np.where(np.abs(x - y) < atol, 0.0, _rel(x, y))
    return float(np.max(rel))


def compare(x, y, atol=1e-14, rtol=1e-6):
    """True if x and y agree elementwise within atol or rtol."""
    x, y = _host(x), _host(y)
    return bool(np.all((np.abs(x - y) < atol) | (_rel(x, y) < rtol)))
