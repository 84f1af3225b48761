"""Seeded candidate-subset generation for the repack tournament.

The port's own copy of `karpenter_tpu/optimizer/subsets.py`, unchanged.

The greedy multi-node pass only ever considers PREFIXES of the
cost-ordered candidate list; the search space of the global optimizer
is arbitrary size-2..K subsets. Exhaustive enumeration is exact for
small candidate pools; past the subset budget the generator goes
guided + sampled:

- **guided**: candidates are ranked by a screen-slack evictability
  score (how much per-group headroom the OTHER nodes hold for this
  node's pods, from the consolidation screen's slack output) broken by
  price (bigger savings first), and the densest region of the ranking
  is enumerated exhaustively;
- **sampled**: the remaining budget is filled with subsets drawn by a
  keyed blake2b hash of (seed, draw index) — deterministic by
  construction, no RNG stream is consumed, so the chaos repeat
  contract (`--repeat 2` identical hashes with the optimizer armed)
  holds without coordinating with the FaultPlan's generator.

Everything returns subsets as tuples of CANDIDATE positions in a fixed
deterministic order; the caller scatters them into [S, N] victim masks
over the full node-view axis.
"""

from __future__ import annotations

import hashlib
from itertools import combinations
from math import comb
from typing import List, Sequence, Tuple

import numpy as np

MAX_SUBSETS = 256      # default tournament batch bound
MAX_K = 5              # largest joint eviction considered by default
_GUIDED_PAIR_POOL = 24  # top-of-ranking pool enumerated pairwise
_GUIDED_TRIPLE_POOL = 10
_GUIDED_DEEP_POOL = 8   # top pool enumerated at sizes 4..max_k


def evictability(slack: np.ndarray, counts: np.ndarray,
                 prices: np.ndarray, cand_idx: Sequence[int],
                 per_slot: np.ndarray) -> np.ndarray:
    """Guide score per candidate (higher = more promising victim): the
    node's standalone NET-savings upper bound — its price minus the
    per-slot replacement cost of its own resident pods (the same rate
    card the subset ranking prices residues with). A cheap node full of
    expensive-to-rehome pods guides low; an expensive node whose pods
    rehome for pennies guides high. The screen's slack margin (`others
    - need`) breaks ties toward nodes the cluster can absorb
    replacement-free."""
    out = np.zeros(len(cand_idx), np.float32)
    pmax = float(prices.max()) if len(prices) else 1.0
    for j, i in enumerate(cand_idx):
        resident = counts[i] > 0
        rehome = float((counts[i] * np.minimum(per_slot, 1e6)).sum())
        margin = float(slack[i][resident].min()) if resident.any() else 0.0
        out[j] = (float(prices[i]) - rehome
                  + 1e-3 * np.tanh(margin) * max(pmax, 1e-9))
    return out


def _hash_draw(seed: int, draw: int, size: int, pool: int) -> Tuple[int, ...]:
    """Deterministic subset of `size` distinct indices out of `pool`,
    keyed by (seed, draw) — a keyed hash, never a shared RNG stream."""
    members: List[int] = []
    salt = 0
    while len(members) < size:
        h = hashlib.blake2b(f"{seed}|{draw}|{salt}".encode(),
                            digest_size=8).digest()
        idx = int.from_bytes(h, "big") % pool
        if idx not in members:
            members.append(idx)
        salt += 1
        if salt > 16 * size:   # degenerate pool; bail deterministically
            break
    return tuple(sorted(members))


def generate_subsets(n_candidates: int, guide: np.ndarray,
                     max_k: int = MAX_K,
                     max_subsets: int = MAX_SUBSETS,
                     seed: int = 0) -> Tuple[List[Tuple[int, ...]], bool]:
    """Size-2..max_k subsets of candidate positions, at most
    `max_subsets`, in a deterministic order. Returns (subsets,
    exhaustive) — exhaustive=True means every subset in range was
    enumerated, so a miss is a true negative of the tournament, not a
    sampling artifact."""
    C = int(n_candidates)
    max_k = max(2, min(int(max_k), C))
    if C < 2:
        return [], True
    total = sum(comb(C, k) for k in range(2, max_k + 1))
    if total <= max_subsets:
        out = [s for k in range(2, max_k + 1)
               for s in combinations(range(C), k)]
        return out, True
    # guided region: stable descending-evictability order, with the
    # subset budget SLICED per size — pairs must not starve the deep
    # joint evictions (a 5-victim squeeze is exactly the shape the
    # search exists for)
    order = [int(i) for i in np.argsort(-guide, kind="stable")]
    seen = set()
    out: List[Tuple[int, ...]] = []
    n_sizes = max_k - 1
    per_size = max(8, max_subsets // n_sizes)

    def push(subset: Tuple[int, ...]) -> bool:
        if subset in seen:
            return False
        seen.add(subset)
        out.append(subset)
        return len(out) >= max_subsets

    pools = {2: _GUIDED_PAIR_POOL, 3: _GUIDED_TRIPLE_POOL}
    for k in range(2, max_k + 1):
        pool = order[:min(C, pools.get(k, _GUIDED_DEEP_POOL))]
        taken = 0
        for combo in combinations(range(len(pool)), k):
            if taken >= per_size:
                break
            if push(tuple(sorted(pool[t] for t in combo))):
                return out, False
            taken += 1
    # sampled tail: deterministic keyed draws over the WHOLE candidate
    # pool (diversity past the guided region)
    draw = 0
    misses = 0
    while len(out) < max_subsets and misses < 4 * max_subsets:
        size = 2 + (draw % (max_k - 1)) if max_k > 2 else 2
        s = _hash_draw(seed, draw, size, C)
        draw += 1
        if len(s) != size or s in seen:
            misses += 1
            continue
        seen.add(s)
        out.append(s)
    return out, False
