"""The least work of the consolidation search's two kernels, from the
shapes of the problem the reference judges (N nodes, G request groups, R
resource columns, S subsets), whatever implements them.

A (the screen's fit count): for every (node, group) pair and resource,
a division, the slack's add, a floor and the running minimum, then the
clamp at 0 and the eligibility select. It reads each node's headroom
[N, R] f32 and each group's request [G, R] f32 once, the eligibility
one byte a pair, and writes k [N, G] f32 once. The screen and the
tournament each run it once a pass.

C (the subset tournament after k): per (subset, node, group) cell, 3
operations to seed the fractional repack, 2R + 7 for each of the ITERS
proportional-fitting iterations (the load over resources, the scale,
the sums, the slack, the update) and 2R + 2 for the last capacity
projection and the residual's sum, plus the column sum of k once. It
reads k and the counts [N, G] f32, the masks [S, N] f32, the headroom
[N, R], the requests [G, R], the prices [N] and the per-slot prices [G]
once, and writes four f32 a subset.

`scan.bound_s` turns (bytes, operations) into the least time against
the card's published peaks.
"""

from __future__ import annotations

from typing import Tuple

from .scan import bound_s  # noqa: F401  (the one bound for every kernel)

ITERS = 6   # the relaxation's proportional-fitting iterations


def screen_k(N: int, G: int, R: int) -> Tuple[int, int]:
    nbytes = N * R * 4 + G * R * 4 + N * G + N * G * 4
    ops = N * G * (4 * R + 2)
    return nbytes, ops


def tournament(S: int, N: int, G: int, R: int,
               iters: int = ITERS) -> Tuple[int, int]:
    nbytes = (4 * (2 * N * G + S * N + N * R + G * R + N + G)
              + 4 * 4 * S)
    ops = S * N * G * (3 + iters * (2 * R + 7) + 2 * R + 2) + N * G
    return nbytes, ops
