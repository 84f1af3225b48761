"""karpenter_tpu_torch: the provisioning solve and the consolidation screen
of `karpenter_tpu`, ported to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

The JAX package `karpenter_tpu` stays the reference. This package imports
neither `jax` nor anything of `karpenter_tpu`: the framework-free layers
it needs (models, catalog generator, encode, host bin-packing oracle) are
its own copies, with numpy semantics unchanged, so the two packages can be
held against each other on the same encoded input.

Layout mirrors the reference:

    models/    labels, resources, requirements, pod, instancetype
    catalog/   generate_catalog, small_catalog, GeneratorConfig
    ops/       encode, binpack (host oracle), solver (solve_device),
               consolidate (consolidation_screen), solve_scan and
               screen_k (kernel wrappers + plain versions), _build (nvcc)
    csrc/      screen_k.cu, solve_scan.cu
    convert.py plain arrays -> CatalogTensors / EncodedPods / VirtualNode

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__all__ = ["models", "catalog", "ops", "convert"]
