"""The subset search past kernel C's old limits, held against the JAX
reference on the CPU: a pool of 4,500 distinct pod groups over 8 requested
resource columns (past the global tier's shared-memory rows: the stream
tier), one whose pods request 20 columns (past 16: the 32-column
instantiation) and one whose pods request 40 (past 32: that
instantiation over two tiles of columns).

The same seeded inputs, made with numpy, go through both packages'
`score_subsets_host`, `score_subsets_device` and `plan_repack`: the
reference's XLA on the CPU, the port's with device="cpu" (kernel A's and
kernel C's plain versions). As in tests/test_torch_optimizer.py
(`_check_scoring`): feasibility and the ranked plans equal element for
element, savings within HOST_SAVINGS_RTOL (above 32 nodes the
reference's XLA dot adds in its own order), residuals and repl_lb within
the reference's own rtol / atol 1e-3. The kernels themselves run at these
tiers on the card (tests/test_torch_kernels.py, chip_smoke.py).

Both packages' resource axes get 32 extended resources for the module,
and their monotone unions of requested columns start empty for each case
(so Rk is the case's own, whatever ran before in the process); the axes,
the unions and the reference's signature intern table are left as found.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from karpenter_tpu.catalog import small_catalog as ref_small_catalog
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import resources as ref_res
from karpenter_tpu.models.nodeclaim import NodeClaim
from karpenter_tpu.models.pod import Pod
from karpenter_tpu.models.resources import Resources
from karpenter_tpu.ops import solver as ref_solver
from karpenter_tpu.ops.binpack import VirtualNode
from karpenter_tpu.ops.encode import encode_catalog, encode_pods
from karpenter_tpu.state.cluster import NodeView as RefNodeView

from karpenter_tpu_torch import convert
from karpenter_tpu_torch import optimizer as port_opt
from karpenter_tpu_torch.models import pod as port_pod
from karpenter_tpu_torch.models import resources as port_res
from karpenter_tpu_torch.models.nodeclaim import NodeClaim as PNodeClaim
from karpenter_tpu_torch.ops import solver as port_solver
from karpenter_tpu_torch.optimizer import tournament_k as tk
from karpenter_tpu_torch.state.cluster import NodeView

from test_torch_optimizer import HOST_SAVINGS_RTOL, _check_scoring

# the 8 columns of the small catalog's axis a pod may request (all but pods)
BUILTIN = ("cpu", "memory", "ephemeral-storage", "nvidia.com/gpu",
           "gpu.karpenter.tpu/accelerator", "google.com/tpu",
           "networking.karpenter.tpu/interface",
           "storage.karpenter.tpu/attachable-volumes")
# extended resources a long-lived operator meets: MIG profiles, pod ENIs,
# EFA, Neuron, FPGAs, device plugins
EXTENDED = ("nvidia.com/mig-1g.10gb", "nvidia.com/mig-2g.20gb",
            "nvidia.com/mig-3g.40gb", "nvidia.com/mig-7g.80gb",
            "vpc.amazonaws.com/pod-eni", "vpc.amazonaws.com/efa",
            "aws.amazon.com/neuron", "aws.amazon.com/neuroncore",
            "smarter-devices/fuse", "xilinx.com/fpga", "intel.com/qat",
            "intel.com/sriov_netdevice")
# 20 more device plugins' resources: with the 20 above, 40 columns
MORE = tuple(f"devices.example.com/p{i:02d}" for i in range(20))


@pytest.fixture(scope="module", autouse=True)
def _extended_axes():
    """Both axes get EXTENDED, in one order; afterwards the axes, the
    requested-column unions and the reference's intern table are as
    found."""
    saved = [(m, list(m._RESOURCE_AXIS), dict(m._RESOURCE_INDEX))
             for m in (ref_res, port_res)]
    unions = [(m, set(m._cols_union)) for m in (ref_solver, port_solver)]
    encode_catalog(ref_small_catalog())
    for name in ref_res.resource_axis() + EXTENDED + MORE:
        ref_res.register_resource(name)
        port_res.register_resource(name)
    assert port_res.resource_axis() == ref_res.resource_axis()
    yield
    for m, axis, index in saved:
        m._RESOURCE_AXIS[:] = axis
        m._RESOURCE_INDEX.clear()
        m._RESOURCE_INDEX.update(index)
    for m, cols in unions:
        m._cols_union.clear()
        m._cols_union.update(cols)
    ref_pod._sig_intern.clear()
    port_pod._sig_intern.clear()


@pytest.fixture(autouse=True)
def _fresh_unions():
    ref_solver._cols_union.clear()
    port_solver._cols_union.clear()


def _quantity(name, v):
    return f"{v}Gi" if name == "ephemeral-storage" else int(v)


def _wide(seed, N, n_groups, cols, p_col=0.3):
    """Seeded nodes of the small catalog's types (each type given some
    capacity of every requested column), pods of `n_groups` distinct
    (cpu, memory) pairs, each also requesting every other column of
    `cols` with probability p_col; random prices, pod counts, slack and
    exclusions. (reference inputs, port inputs, exclude)."""
    rng = np.random.default_rng(seed)
    types = copy.deepcopy(ref_small_catalog())
    for it in types:
        for name in cols[2:]:
            if name == "ephemeral-storage":
                continue  # every type has 100Gi
            it.capacity[name] = float(rng.integers(0, 9))
    cat = encode_catalog(types)
    pairs = rng.choice(3999 * 8, size=n_groups, replace=False)
    pods = []
    for i, v in enumerate(pairs):
        req = {"cpu": f"{1 + int(v) % 3999}m",
               "memory": f"{1 + int(v) // 3999}Gi"}
        for j, name in enumerate(cols[2:]):
            # pod j requests column j (every column is requested)
            if j == i or rng.random() < p_col:
                req[name] = _quantity(name, int(rng.integers(1, 3)))
        pods.append(Pod(name=f"g{i}", requests=Resources.parse(req)))
    enc = encode_pods(pods, cat)
    R = enc.requests.shape[1]
    idx = [ref_res.resource_index(n) for n in cols]
    nodes = []
    for i in range(N):
        t = int(rng.integers(0, cat.T))
        cum = np.zeros(R, np.float32)
        alloc = cat.allocatable[t]
        for c in idx:
            cum[c] = np.float32(rng.uniform(0, 0.6) * alloc[c])
        nodes.append(VirtualNode(type_idx=t,
                                 zone_mask=rng.random(cat.Z) < 0.8,
                                 cap_mask=rng.random(cat.C) < 0.8, cum=cum))
    prices = rng.uniform(0.05, 2.5, N).astype(np.float32)
    counts = (rng.random((N, enc.G)) < 3.0 / max(enc.G, 1)).astype(np.int32)
    counts *= rng.integers(1, 3, (N, enc.G)).astype(np.int32)
    slack = rng.normal(size=(N, enc.G)).astype(np.float32)
    exclude = rng.random(N) < 0.2
    views = [RefNodeView(claim=NodeClaim(name=f"n{i}", nodepool="d"),
                         node=None, pods=[], virtual=n, price=float(p))
             for i, (n, p) in enumerate(zip(nodes, prices))]
    pviews = [NodeView(claim=PNodeClaim(name=f"n{i}", nodepool="d"),
                       node=None, pods=[], virtual=v, price=float(p))
              for i, (v, p) in enumerate(zip(
                  convert.nodes_from_arrays(vars(n) for n in nodes), prices))]
    ref = (cat, enc, views, counts, slack)
    port = (convert.catalog_from_arrays(vars(cat)),
            convert.pods_from_arrays(vars(enc)), pviews, counts, slack)
    return ref, port, exclude


def _search(ref, port, exclude):
    """Both packages' scoring and plans held as _check_scoring holds them,
    at the subset batch plan_repack takes at these sizes; returns the
    search's (S, N, G, Rk) as kernel C would take it. The search ranks
    both tiers: some subsets repack free, others leave a residue."""
    cat, enc, views = ref[:3]
    N, G = len(views), enc.G
    S, (feasible, _s, residual, _r) = _check_scoring(ref, port, exclude, max_k=4,
                          max_subsets=max(16, port_opt.RELAX_BUDGET
                                          // (N * G)),
                          dev_savings_rtol=HOST_SAVINGS_RTOL)
    assert (feasible & (residual <= port_opt.RESIDUAL_EPS)).any()
    assert (residual > 1).any()
    Rk = len(port_solver._request_cols(port[1], port[0]))
    assert len(ref_solver._request_cols(enc, cat)) == Rk
    return S, N, G, Rk


def test_scoring_and_plan_past_the_shared_memory_rows():
    """4,500 groups over 8 requested columns, 24 nodes: a search kernel C
    takes on its stream tier (no earlier tier's rows fit), where it used
    to raise."""
    ref, port, exclude = _wide(3, N=24, n_groups=4_500, cols=BUILTIN)
    assert exclude.any()
    S, N, G, Rk = _search(ref, port, exclude)
    assert (N, G, Rk) == (24, 4_500, 8) and S == 74
    lay = tk.tournament_layout(S, N, G, Rk)
    assert lay.tier == "stream" and lay.gc < tk._round4(G)


def test_scoring_and_plan_at_twenty_requested_columns():
    """Pods requesting 20 resource columns (the 8 of the small catalog's
    axis and 12 extended resources), 40 nodes and 60 groups: a search
    kernel C takes in its 32-column instantiation, where it used to
    raise past 16."""
    ref, port, exclude = _wide(4, N=40, n_groups=60,
                               cols=BUILTIN + EXTENDED)
    assert exclude.any()
    S, N, G, Rk = _search(ref, port, exclude)
    assert (N, G, Rk) == (40, 60, 20) and S == 3_333
    assert tk._rkb(Rk) == 32
    tk.tournament_layout(S, N, G, Rk)  # a layout: no refusal


def test_scoring_and_plan_at_forty_requested_columns():
    """Pods requesting 40 resource columns (the 8 of the small catalog's
    axis and 32 extended resources), 40 nodes and 60 groups: a search
    kernel C takes in its 32-column instantiation over two tiles of
    columns, where it used to raise past 32."""
    ref, port, exclude = _wide(5, N=40, n_groups=60,
                               cols=BUILTIN + EXTENDED + MORE)
    assert exclude.any()
    S, N, G, Rk = _search(ref, port, exclude)
    assert (N, G, Rk) == (40, 60, 40) and S == 3_333
    assert tk._rkb(Rk) == 32 and tk._req_width(Rk) == 64
    lay = tk.tournament_layout(S, N, G, Rk)
    assert lay.smem_bytes + tk.STATIC_SMEM <= tk.SMEM_LIMIT
