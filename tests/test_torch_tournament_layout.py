"""Kernel C's launch layout (`optimizer/tournament_k.tournament_layout`),
from sizes alone: its tier, cluster, node slices and shared memory. No
card needed; the kernel itself is held against its plain version on
every tier in tests/test_torch_kernels.py (marker `cuda`)."""

import pytest

from karpenter_tpu_torch.optimizer import tournament_k as tk

SMEM = 232_448
NODES = [1, 5, 31, 96, 382, 512, 600, 700, 1_000, 2_000, 4_165, 4_250,
         8_000, 9_000, 20_000, 50_000]
GROUPS = [0, 1, 7, 90, 600, 1_536]


def _lanes(lay, N, G):
    return tk._lane_floats(lay.slice, lay.xs, G, lay.x_smem)


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("N", NODES)
def test_layout_fits_shared_memory(N, G):
    """Each tier's shared memory (every subset a block holds, plus the
    kernel's static arrays) fits one block of an H100."""
    for Rk in (1, 2, 9, 16):
        lay = tk.tournament_layout(232, N, G, Rk)
        assert lay.smem_bytes + tk.STATIC_SMEM <= SMEM, (Rk, lay)
    lay = tk.tournament_layout(232, N, G, 2)
    # the block's rows (req, k's slice or the ring of k chunks), then each
    # subset's
    assert lay.smem_bytes == 4 * (tk._block_floats(G, 2, lay.ch, lay.k_smem)
                                  + lay.spb * _lanes(lay, N, G))
    if lay.k_smem:
        assert lay.ch == lay.slice
    else:
        assert (tk.NBUF * lay.ch * tk._round4(G) * 4 <= tk.RING_BYTES
                or lay.ch == 1)
        assert 1 <= lay.ch <= tk.CH_MAX
    if lay.x_smem:  # x itself, plus a row of a node and of a group
        assert lay.smem_bytes >= lay.spb * 4 * (lay.slice * lay.xs + 6 * G)
    # 16-byte rows whose quarter is odd: conflict-free reads of 8 rows
    assert lay.xs % 4 == 0 and (lay.xs // 4) % 2 == 1 and lay.xs >= G


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("N", NODES)
def test_slices_cover_the_nodes_once_in_order(N, G):
    lay = tk.tournament_layout(20, N, G, 2)
    spans = lay.slices(N)
    assert len(spans) == lay.cl
    covered = [n for a, b in spans for n in range(a, b)]
    assert covered == list(range(N))
    assert all(b - a <= lay.slice for a, b in spans)


@pytest.mark.parametrize("G", GROUPS)
def test_cluster_is_a_power_of_two_growing_with_n(G):
    prev = 0
    for N in NODES:
        lay = tk.tournament_layout(20, N, G, 2)
        assert lay.cl in (1, 2, 4, 8, 16), lay
        assert lay.cl >= prev, (N, lay)
        prev = lay.cl
        assert (lay.tier == "block") == (lay.cl == 1)
        assert lay.spb == 1 or lay.tier == "block"


@pytest.mark.parametrize("N", NODES)
def test_cluster_grows_only_with_the_groups(N):
    prev = 0
    for G in GROUPS:
        lay = tk.tournament_layout(20, N, G, 2)
        assert lay.cl >= prev, (G, lay)
        prev = lay.cl


def test_the_tier_changes_once_block_cluster_global():
    order = {"block": 0, "cluster": 1, "global": 2}
    for G in GROUPS:
        tiers = [order[tk.tournament_layout(20, N, G, 2).tier] for N in NODES]
        assert tiers == sorted(tiers), (G, tiers)


def test_the_operator_loops_first_search_takes_one_block():
    """S=232, N=382, G=90: x is 137,520 bytes, one block a subset."""
    lay = tk.tournament_layout(232, 382, 90, 2)
    assert (lay.tier, lay.cl, lay.slice, lay.spb) == ("block", 1, 382, 1)
    assert 382 * 90 * 4 == 137_520 <= lay.smem_bytes


def test_the_operator_loops_first_search_streams_k():
    """x and k do not both fit one block at N=382: k streams through the
    ring."""
    lay = tk.tournament_layout(232, 382, 90, 2)
    assert not lay.k_smem and lay.ch >= tk.CH_MIN
    assert 2 * 382 * 92 * 4 > SMEM


def test_the_grid_mix_search_takes_a_cluster_with_k_resident():
    """S=20, N=4,250, G=90: x is 1.53 MB. 8 blocks of 532 nodes hold x's
    slices alone; 16 blocks of 266 hold x's and k's, and take them."""
    lay = tk.tournament_layout(20, 4250, 90, 2)
    assert (lay.tier, lay.cl, lay.slice, lay.k_smem) == ("cluster", 16, 266,
                                                         True)
    assert 180_000 < lay.smem_bytes <= SMEM - tk.STATIC_SMEM
    # 8 blocks hold x's slices but not k's beside them
    x8 = tk._lane_floats(-(-4250 // 8), 92, 90, True)
    assert 4 * (x8 + tk._block_floats(90, 2, tk.CH_MIN)) <= SMEM
    assert 4 * (x8 + tk._block_floats(90, 2, 532, True)) > SMEM
    # a cluster of 4 would not hold x's slices
    assert tk._lane_floats(-(-4250 // 4), 92, 90, True) * 4 > SMEM


@pytest.mark.parametrize("S,N,G,cl", [(4, 8000, 90, 16), (4, 5000, 90, 16)])
def test_clusters_stream_k_where_it_does_not_fit_beside_x(S, N, G, cl):
    lay = tk.tournament_layout(S, N, G, 2)
    assert (lay.tier, lay.cl, lay.k_smem) == ("cluster", cl, False)


@pytest.mark.parametrize("S,N,G", [(4, 4165, 1536), (8, 600, 1536),
                                   (2, 50_000, 90)])
def test_past_sixteen_blocks_the_global_tier(S, N, G):
    """The facade mix's 4,165 nodes x 1,536 groups need 25.6 MB a subset:
    16 blocks with the slices in global scratch."""
    lay = tk.tournament_layout(S, N, G, 2)
    assert (lay.tier, lay.cl, lay.x_smem) == ("global", 16, False)
    assert lay.slice == -(-N // 16)
    # 16 blocks' shared memory could not hold x
    assert tk._lane_floats(lay.slice, lay.xs, G, True) * 4 > SMEM


def test_small_subsets_share_a_block_while_the_card_stays_full():
    lay = tk.tournament_layout(600, 40, 7, 3)
    assert (lay.tier, lay.spb) == ("block", 4)
    assert lay.blocks(600) >= tk.SMS
    assert lay.spb * 40 <= tk.NT
    # too few subsets to fill the card twice over: one a block
    assert tk.tournament_layout(256, 96, 5, 2).spb == 1
    assert tk.tournament_layout(232, 382, 90, 2).spb == 1


@pytest.mark.parametrize("S", [1, 131, 132, 264, 1_000, 10_000])
def test_blocks_hold_every_subset(S):
    for N, G in [(16, 5), (40, 7), (382, 90), (4250, 90)]:
        lay = tk.tournament_layout(S, N, G, 2)
        assert lay.blocks(S) // lay.cl * lay.spb >= S
        assert lay.spb & (lay.spb - 1) == 0 and lay.spb <= tk.SPB_MAX


def test_layout_refuses_what_it_cannot_carry():
    with pytest.raises(ValueError, match="resource columns"):
        tk.tournament_layout(4, 10, 5, 17)
    with pytest.raises(ValueError, match="do not fit"):
        tk.tournament_layout(4, 100, 20_000, 2)
