"""The one generator of request streams, driven by a traffic mix's file.

A mix names ``temperatures``: per nodeset id, the range ``[lo, hi]`` its
temperature is drawn from, independently per set.  Draws are stratified
in blocks of ``BLOCK`` requests: within a block each set takes one value
from each of ``BLOCK`` equal slices of its range, at a uniform point of
the slice, in an order drawn from the seed.  Every value is still uniform
on the range, and every seed sends the same spread of temperatures, so
seeds differ in order, not in work.

``stream`` keeps the warm-up's requests apart from the window's.  Seeds
are any whole numbers (taken modulo 2**63).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["requests"]

WINDOW, WARMUP, SAMPLE = 0, 1, 2
BLOCK = 256


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def requests(mix: dict, seed: int, stream: int = WINDOW
             ) -> Iterator[Dict[int, float]]:
    """Endless temperatures ``{set id: value}``, one dict per request."""
    g = rng(seed, stream)
    ranges = {int(k): (float(v[0]), float(v[1]))
              for k, v in sorted(mix["temperatures"].items(),
                                 key=lambda kv: int(kv[0]))}
    while True:
        cols = {}
        for sid, (lo, hi) in ranges.items():
            u = (g.permutation(BLOCK) + g.random(BLOCK)) / BLOCK
            cols[sid] = lo + (hi - lo) * u
        for k in range(BLOCK):
            yield {sid: float(v[k]) for sid, v in cols.items()}
