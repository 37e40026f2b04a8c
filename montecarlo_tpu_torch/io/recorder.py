"""Configuration recording (counterpart of montecarlo_tpu/io/recorder.py).

ConfigRecorder keeps a bit-packed host copy of every rate-th configuration
for ``replay``; Discarder keeps nothing. A configuration arrives as a host
numpy array of ±1 (the simulation copies it off the device: one host
synchronization per recorded sweep) and is packed to one bit per spin.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class Discarder:
    """Throws away everything pushed into it."""

    def __init__(self, rate: int = 10):
        self.rate = rate

    def push(self, sweep: int, conf) -> None:
        pass

    def __len__(self):
        return 0

    def __iter__(self):
        return iter(())

    def state_dict(self):
        return {"type": "Discarder", "rate": self.rate}

    @staticmethod
    def from_state(state):
        return Discarder(state.get("rate", 10))


class ConfigRecorder:
    """Rate-limited, bit-packed configuration store."""

    def __init__(self, rate: int = 10):
        self.rate = int(rate)
        self._shapes: List[Tuple[int, ...]] = []
        self._packed: List[np.ndarray] = []

    def push(self, sweep: int, conf) -> None:
        """Store conf (an integer array of ±1) if sweep % rate == 0."""
        if sweep % self.rate != 0:
            return
        arr = np.asarray(conf)
        self._shapes.append(arr.shape)
        self._packed.append(np.packbits((arr > 0).reshape(-1)))

    def __len__(self):
        return len(self._packed)

    def __getitem__(self, i) -> np.ndarray:
        shape = self._shapes[i]
        n = int(np.prod(shape))
        bits = np.unpackbits(self._packed[i])[:n].reshape(shape)
        return 2 * bits.astype(np.int8) - 1

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def state_dict(self):
        return {"type": "ConfigRecorder", "rate": self.rate,
                "shapes": self._shapes, "packed": self._packed}

    @staticmethod
    def from_state(state):
        rec = ConfigRecorder(state["rate"])
        rec._shapes = [tuple(s) for s in state["shapes"]]
        rec._packed = [np.asarray(p, dtype=np.uint8) for p in state["packed"]]
        return rec


def recorder_from_state(state):
    """The recorder of a ``state_dict``."""
    return (ConfigRecorder.from_state(state)
            if state["type"] == "ConfigRecorder"
            else Discarder.from_state(state))
