"""The offer-argmin pre-pass and kernel B's layout, on the CPU.

`offer_argmin_plain` (the plain version of kernel B0) is held against a
direct numpy evaluation of the reference's step 2
(`karpenter_tpu/ops/solver.py:425-448`, written out here group by group) on
seeded catalogs built to exercise the tie-break and the edge cases:
duplicated types (equal price / slots, so the first index must win),
all-infeasible groups (index 0), max_per_node clamps and a zone-overhead
catalog. `_scan_layout` is checked for the properties the kernel relies
on: it fits the H100's per-block shared memory, never exceeds a cluster of
16, only grows with the node budget, and puts the node slices in global
scratch only past the cluster's capacity.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.ops import solve_scan as ss
from karpenter_tpu_torch.ops.binpack import BIG, EPS

F32_MAX = np.finfo(np.float32).max


def ref_step2(alloc, price, avail, req, compat, gzone, gcap, mpn, zovh):
    """The reference's step-2 formula, one group at a time, in numpy."""
    T, Z, C = price.shape
    out = []
    for g in range(req.shape[0]):
        cap_per = BIG if mpn[g] == 0 else int(mpn[g])
        adm = (avail & compat[g][:, None, None] & gzone[g][None, :, None]
               & gcap[g][None, None, :])
        alloc_eff = alloc
        if zovh is not None:
            zm_open = gzone[g][None, :] & avail.any(axis=2)
            alloc_eff = alloc - np.where(zm_open[:, :, None], zovh,
                                         np.float32(0.0)).max(axis=1)
        with_req = np.where(req[g] > 0, req[g], np.float32(1.0))
        slots = np.where(req[g][None, :] > 0,
                         np.floor(alloc_eff / with_req[None, :] + EPS),
                         np.float32(BIG)).min(axis=1)
        slots = np.minimum(np.maximum(slots, 0.0).astype(np.int32), cap_per)
        feasible = adm & (slots >= 1)[:, None, None]
        cps = np.where(feasible, price / np.maximum(slots, 1)[:, None, None]
                       .astype(np.float32), F32_MAX)
        flat = int(np.argmin(cps.reshape(-1)))
        t_star = flat // (Z * C)
        out.append((t_star, max(int(slots[t_star]), 1),
                     bool(cps.reshape(-1)[flat] < F32_MAX),
                     avail[t_star].any(axis=1), avail[t_star].any(axis=0)))
    return out


def make_case(seed: int, zone_ovh: bool):
    """A seeded catalog with duplicated types and coarse prices (many
    equal cost-per-slot values), and groups that include all-infeasible
    rows, max_per_node clamps and zero requests."""
    rng = np.random.default_rng(seed)
    T0, Z, C, R, G = 7, 3, 2, 3, 24
    alloc0 = rng.choice([2.0, 4.0, 8.0, 16.0], (T0, R)).astype(np.float32)
    price0 = rng.choice([1.0, 2.0, 4.0], (T0, Z, C)).astype(np.float32)
    price0[rng.random((T0, Z, C)) < 0.1] = np.inf
    avail0 = rng.random((T0, Z, C)) < 0.7
    dup = rng.integers(0, T0, 5)                       # duplicated types
    alloc = np.concatenate([alloc0, alloc0[dup]])
    price = np.concatenate([price0, price0[dup]])
    avail = np.concatenate([avail0, avail0[dup]])
    T = alloc.shape[0]
    req = rng.choice([0.0, 0.5, 1.0, 3.0, 20.0], (G, R)).astype(np.float32)
    compat = rng.random((G, T)) < 0.6
    compat[0] = False                                  # nothing compatible
    req[1] = np.float32(1e6)                           # nothing fits
    gzone = rng.random((G, Z)) < 0.8
    gzone[2] = False                                   # no zone allowed
    gcap = rng.random((G, C)) < 0.8
    mpn = rng.choice([0, 0, 1, 2, 5], G).astype(np.int32)
    zovh = None
    if zone_ovh:
        zovh = np.zeros((T, Z, R), np.float32)
        zovh[:, 0, 0] = np.float32(0.5)
        zovh[:, 1, 1] = rng.choice([0.25, 1.0], T).astype(np.float32)
    return alloc, price, avail, req, compat, gzone, gcap, mpn, zovh


@pytest.mark.parametrize("zone_ovh", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_offer_argmin_plain_matches_reference_formula(seed, zone_ovh):
    alloc, price, avail, req, compat, gzone, gcap, mpn, zovh = make_case(
        seed, zone_ovh)
    want = ref_step2(alloc, price, avail, req, compat, gzone, gcap, mpn, zovh)
    tt = torch.as_tensor
    got = ss.offer_argmin(
        tt(alloc), tt(price), tt(avail), tt(req), tt(compat), tt(gzone),
        tt(gcap), tt(mpn),
        tt(zovh) if zovh is not None else torch.zeros((1, 1, req.shape[1])),
        zone_ovh=zone_ovh)
    t_star, s, ok, tz, tc = (x.numpy() for x in got)
    for g, (wt, ws, wok, wz, wc) in enumerate(want):
        assert (t_star[g], s[g], ok[g]) == (wt, ws, wok), g
        np.testing.assert_array_equal(tz[g], wz)
        np.testing.assert_array_equal(tc[g], wc)
    # the rows built to be infeasible pick index 0 and are not ok
    for g in (0, 1, 2):
        assert t_star[g] == 0 and not ok[g]


def test_offer_argmin_ties_go_to_the_first_index():
    """Two identical types: every group picks the first, whichever captype
    its mask leaves."""
    alloc = np.array([[4.0, 4.0], [4.0, 4.0]], np.float32)
    price = np.full((2, 1, 2), 1.0, np.float32)
    avail = np.ones((2, 1, 2), bool)
    tt = torch.as_tensor
    got = ss.offer_argmin_plain(
        tt(alloc), tt(price), tt(avail), tt(np.ones((3, 2), np.float32)),
        tt(np.ones((3, 2), bool)), tt(np.ones((3, 1), bool)),
        tt(np.array([[True, True], [False, True], [True, True]])),
        tt(np.array([0, 0, 3], np.int32)), torch.zeros((1, 1, 2)))
    assert got[0].tolist() == [0, 0, 0]   # t_star: never the duplicate
    assert got[1].tolist() == [4, 4, 3]   # slots, clamped by max_per_node
    assert got[2].tolist() == [True, True, True]


# --- kernel B's layout ---

NODE_BUDGETS = [1, 64, 512, 513, 1024, 4096, 6144, 8192, 8193, 12_288,
                16_384, 50_000, 100_000, 150_000, 175_000, 200_000,
                262_144, 1_000_000]
SHAPES = [  # (Rk, W, Z, C, T, zone_ovh)
    (2, 0, 3, 3, 810, False),    # the main path
    (9, 4, 3, 3, 810, True),     # every column, conflicts, zone overhead
    (1, 0, 1, 1, 6, False),
    (32, 8, 6, 4, 4096, True),   # a catalog too large for shared memory
]


def _node_bytes(Rk, W):
    return 12 + 4 * Rk + 4 * W


@pytest.mark.parametrize("shape", SHAPES)
def test_scan_layout_fits_and_grows(shape):
    Rk, W, Z, C, T, zovh = shape
    prev = 0
    for n_max in NODE_BUDGETS:
        lay = ss._scan_layout(n_max, Rk, W, Z, C, T, zovh)
        assert lay.smem_bytes + ss.STATIC_SMEM <= 232_448, (n_max, lay)
        assert lay.cl in (1, 2, 4, 8, 16), (n_max, lay)
        assert lay.cl * lay.slice >= n_max
        assert lay.slab_bytes >= lay.slice * _node_bytes(Rk, W)
        assert lay.cl >= prev, (n_max, lay)
        prev = lay.cl
        if lay.nodes_smem:
            assert lay.smem_bytes >= lay.slab_bytes
        else:
            assert lay.cl == ss.CL_MAX


@pytest.mark.parametrize("shape", SHAPES)
def test_scan_layout_global_only_past_capacity(shape):
    """The slices go to global scratch exactly when 16 blocks cannot hold
    them in shared memory, and the switch happens once as n_max grows."""
    Rk, W, Z, C, T, zovh = shape
    budget = 232_448 - ss.STATIC_SMEM
    switched = False
    for n_max in NODE_BUDGETS:
        lay = ss._scan_layout(n_max, Rk, W, Z, C, T, zovh)
        base = lay.smem_bytes - (lay.slab_bytes if lay.nodes_smem else 0)
        slice16 = -(-n_max // ss.CL_MAX)
        fits16 = base + slice16 * _node_bytes(Rk, W) <= budget
        assert lay.nodes_smem == fits16, (n_max, lay)
        switched |= not lay.nodes_smem
        if switched:
            assert not lay.nodes_smem, (n_max, lay)


def test_scan_layout_main_path():
    """100k pods x 810 types: 6,144 nodes, two columns, no conflicts."""
    lay = ss._scan_layout(6144, 2, 0, 3, 3, 810)
    assert (lay.cl, lay.slice, lay.nodes_smem, lay.cat_smem) == (16, 384,
                                                                 True, True)
    assert lay.slab_bytes == 384 * 20


def test_scan_layout_refuses_a_record_too_large():
    with pytest.raises(ValueError, match="does not fit"):
        ss._scan_layout(64, 2, 0, 3, 3, 4_000_000)
