"""The least work of the scale-up scan's two kernels, from the problem's
shapes, whatever implements them.

B0 (the offer argmin): for every group and type, the pods a fresh node
holds (a floor-division and a min over each resource) and, for every
(zone, capacity type) offering, whether it is admissible and its price
per pod slot (an and, a division, a compare). It reads the catalog once
(allocatable [T, R] f32, price [T, Z, C] f32, availability one bit an
offering) and each group's row once (request [R] f32, count i32,
compatibility one bit a type, zone and capacity-type masks one bit
each), and writes one (type, slots) pair a group.

B (the first-fit scan): at every group step, each node already open is
looked at once (a fit count over R resources, its zone and capacity
masks, a min and the running take); that is the plan's `node_steps`. It
reads each group's row and B0's pair once, and writes each node's final
state once (type i32, requests [R] f32, zone and capacity bits) and each
(group, node) placement that took pods once (two i32).

`bound_s` is the least time for (bytes, operations) against the card's
published peaks (`peaks.json`): the larger of bytes over the memory rate
and operations over the fp32 rate.
"""

from __future__ import annotations

import json
import os
from typing import Tuple


def _bits(n: int) -> int:
    return -(-n // 8)


def offer_argmin(G: int, T: int, Z: int, C: int, R: int) -> Tuple[int, int]:
    nbytes = (T * R * 4 + T * Z * C * 4 + _bits(T * Z * C)
              + G * (R * 4 + 4 + _bits(T) + _bits(Z) + _bits(C))
              + G * 8)
    ops = G * T * (2 * R + 3 * Z * C)
    return nbytes, ops


def solve_scan(G: int, T: int, Z: int, C: int, R: int, nodes: int,
               node_steps: int, placements: int) -> Tuple[int, int]:
    nbytes = (T * R * 4 + _bits(T * Z * C)
              + G * (R * 4 + 4 + _bits(T) + _bits(Z) + _bits(C) + 8)
              + nodes * (4 + R * 4 + _bits(Z) + _bits(C))
              + placements * 8)
    ops = node_steps * (2 * R + Z * C + 4)
    return nbytes, ops


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f)


def bound_s(nbytes: int, ops: int) -> float:
    p = peaks()
    return max(nbytes / p["hbm_bytes_per_s"], ops / p["fp32_ops_per_s"])
