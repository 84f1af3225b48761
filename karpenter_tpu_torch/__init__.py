"""karpenter_tpu_torch: the provisioning solve, the consolidation screen and
the control loop of `karpenter_tpu`, ported to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `karpenter_tpu` stays the reference. This package imports
neither `jax` nor anything of `karpenter_tpu`: the framework-free layers
it needs (models, catalog generator, encode, host bin-packing oracle) are
its own copies, with numpy semantics unchanged, so the two packages can be
held against each other on the same encoded input.

Layout mirrors the reference:

    models/      labels, resources, requirements, pod, instancetype,
                 nodepool, nodeclaim, validation
    catalog/     generate_catalog, small_catalog, CatalogProvider
    ops/         encode, binpack (host oracle), solver (solve_device),
                 consolidate (consolidation_screen), facade (Solver),
                 solve_scan and screen_k (kernel wrappers + plain
                 versions), _build (nvcc)
    csrc/        screen_k.cu, solve_scan.cu
    cloud/       the fake cloud and its wire formats
    state/       the store, node views, intent journal, rehydration
    controllers/ the engine and the reconcile controllers
    sim.py       make_sim: the whole control loop against the fake cloud
    convert.py   plain arrays -> CatalogTensors / EncodedPods / VirtualNode

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__all__ = ["models", "catalog", "ops", "cloud", "state", "controllers",
           "sim", "convert"]
