"""Named section timers (counterpart of montecarlo_tpu/utils/timing.py).

A process-wide tree of wall-clock timers. Each enabled section is also a
``torch.profiler.record_function`` range and, on CUDA, an NVTX range, so
it shows in profiler traces (``chip_profile.py``). On CUDA the section
synchronizes the device when it opens and before it reads the clock at
its end, so it times the work it enqueued, not its launches. Disabled
(the default) a section costs one flag test.

Usage::

    from montecarlo_tpu_torch import enable_benchmarks, print_timer, timer

    enable_benchmarks()
    with timer("propagate"):
        ...
    print_timer()
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict

import torch

_ENABLED = False


@dataclass
class _Node:
    name: str
    total: float = 0.0
    count: int = 0
    children: Dict[str, "_Node"] = field(default_factory=dict)


_ROOT = _Node("root")
_STACK = [_ROOT]


def enable_benchmarks():
    """Turn the timers on."""
    global _ENABLED
    _ENABLED = True


def disable_benchmarks():
    """Turn the timers off (the default)."""
    global _ENABLED
    _ENABLED = False


def benchmarks_enabled() -> bool:
    return _ENABLED


def reset_timer():
    """Forget every timed section."""
    global _ROOT, _STACK
    _ROOT = _Node("root")
    _STACK = [_ROOT]


def _on_cuda(device) -> bool:
    """Whether a section on ``device`` times CUDA work: a CUDA device, or
    with no device named, a process that has initialized CUDA."""
    if device is None:
        return torch.cuda.is_available() and torch.cuda.is_initialized()
    return torch.device(device).type == "cuda"


@contextmanager
def timer(name: str, device=None):
    """Time a named section; nested sections build a tree. device: the
    device whose work the section times (default: CUDA once the process
    has initialized it); on CUDA the section synchronizes that device at
    its start and end and is an NVTX range."""
    if not _ENABLED:
        yield
        return
    parent = _STACK[-1]
    node = parent.children.get(name)
    if node is None:
        node = parent.children[name] = _Node(name)
    _STACK.append(node)
    cuda = _on_cuda(device)
    with torch.profiler.record_function(name):
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.nvtx.range_push(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if cuda:
                torch.cuda.nvtx.range_pop()
            node.total += dt
            node.count += 1
            _STACK.pop()


def timer_data() -> dict:
    """The timer tree as nested dicts {name: {"total_s", "count",
    "children"}}."""

    def rec(node: _Node):
        return {k: {"total_s": v.total, "count": v.count,
                    "children": rec(v)}
                for k, v in node.children.items()}

    return rec(_ROOT)


def print_timer(file=None):
    """Print the timer tree, the longest sections first: name, total ms and
    count, children indented."""
    file = file or sys.stdout

    def rec(node: _Node, depth: int):
        for name, child in sorted(node.children.items(),
                                  key=lambda kv: -kv[1].total):
            print(f"{'  ' * depth}{name:<30s} {child.total * 1e3:12.3f} ms  "
                  f"x{child.count}", file=file)
            rec(child, depth + 1)

    rec(_ROOT, 0)
