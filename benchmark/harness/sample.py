"""The requests the reference judges: a uniform sample of the window's,
drawn from the seed as they complete (so a run holds only the sample's
answers, whatever the window's length), with the largest request always
among them."""

from __future__ import annotations

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The run's random stream `stream` from its seed (any whole number
    >= 0, wider than 32 bits too)."""
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, *stream])


class Reservoir:
    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = rng(seed, 5)
        self.items: list = []
        self.seen = 0
        self.largest = None       # (size, item)

    def add(self, item, size: int) -> None:
        if self.largest is None or size > self.largest[0]:
            self.largest = (size, item)
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item

    def sample(self) -> list:
        out = list(self.items)
        if self.largest is not None and not any(
                x is self.largest[1] for x in out):
            out.append(self.largest[1])
        return out
