"""Synthetic instance-type catalog generator.

The port's own copy of `karpenter_tpu/catalog/generator.py`: the same
seeded hash-derived catalog, type for type and price for price.

Produces a deterministic EC2-scale catalog (~850 types across categories ×
families × generations × sizes, 3 zones, spot/on-demand/reserved offerings)
without copying any AWS data. This backs the fake cloud and benchmarks the
same way the reference's generated fixtures
(pkg/fake/zz_generated.describe_instance_types.go) back its test env.

Shapes follow the reference's resolver outputs
(pkg/providers/instancetype/types.go):
 - requirements: ~20 labels incl. category/family/generation/size/cpu/
   memory/gpu/accelerator/nvme/bandwidth (computeRequirements, :158-300)
 - capacity: vcpu, memory minus VM overhead, pods (ENI-style limit),
   ephemeral storage, gpus/accelerators (computeCapacity, :320-492)
 - overhead: kube-reserved + system-reserved + eviction threshold
   (:493-559)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..models import labels as L
from ..models.instancetype import InstanceType, Offering, Overhead
from ..models.requirements import Requirements
from ..models.resources import (CPU, EPHEMERAL_STORAGE, MEMORY, NVIDIA_GPU,
                                PODS, Resources, TPU_CHIP)

DEFAULT_ZONES = ("zone-a", "zone-b", "zone-c")

# (category, family base name, generations, GiB memory per vCPU, $/vCPU-hr
#  base, gpu per 8 vCPU or 0, accelerator per 8 vCPU or 0, local nvme)
_FAMILY_SPECS = [
    # category, fam,  gens,        gib/vcpu, $/vcpu,  gpus, accel, nvme
    ("c", "c", (5, 6, 7, 8), 2.0, 0.0425, 0, 0, False),  # compute
    ("m", "m", (5, 6, 7, 8), 4.0, 0.0480, 0, 0, False),  # general
    ("r", "r", (5, 6, 7, 8), 8.0, 0.0630, 0, 0, False),  # memory
    ("x", "x", (2, 4), 16.0, 0.0833, 0, 0, True),        # high-mem
    ("t", "t", (3, 4), 4.0, 0.0416, 0, 0, False),        # burstable
    ("c", "cn", (6, 7), 2.0, 0.0540, 0, 0, True),        # compute+nvme
    ("m", "mn", (6, 7), 4.0, 0.0570, 0, 0, True),
    ("r", "rn", (6, 7), 8.0, 0.0720, 0, 0, True),
    ("i", "i", (3, 4), 8.0, 0.0780, 0, 0, True),         # storage
    ("d", "d", (3,), 16.0, 0.0690, 0, 0, True),          # dense storage
    ("g", "g", (4, 5, 6), 4.0, 0.1260, 1, 0, True),      # 1 gpu / 8 vcpu
    ("p", "p", (4, 5), 8.0, 0.3830, 2, 0, True),         # 2 gpu / 8 vcpu
    ("q", "q", (1, 2), 4.0, 0.1680, 0, 4, False),        # accelerator (tpu-like)
    ("z", "z", (1,), 8.0, 0.0975, 0, 0, True),           # high-freq
    ("hpc", "hpc", (6, 7), 4.0, 0.0864, 0, 0, False),    # hpc / fast net
    # amd-cpu variants (cheaper) and network-optimized variants of c/m/r
    ("c", "ca", (6, 7), 2.0, 0.0383, 0, 0, False),
    ("m", "ma", (6, 7), 4.0, 0.0432, 0, 0, False),
    ("r", "ra", (6, 7), 8.0, 0.0567, 0, 0, False),
    ("c", "ce", (6, 7), 2.0, 0.0468, 0, 0, False),
    ("m", "me", (6, 7), 4.0, 0.0528, 0, 0, False),
    ("r", "re", (6, 7), 8.0, 0.0693, 0, 0, False),
    ("i", "in", (3, 4), 8.0, 0.0858, 0, 0, True),        # storage + fast net
    ("g", "gr", (5, 6), 4.0, 0.1134, 1, 0, True),        # gpu, arm cpu
    ("x", "xe", (1, 2), 24.0, 0.1040, 0, 0, True),       # ultra-memory
]

# size name -> vCPU count (metal = largest non-metal of the family)
_SIZES = [
    ("medium", 1), ("large", 2), ("xlarge", 4), ("2xlarge", 8),
    ("3xlarge", 12), ("4xlarge", 16), ("6xlarge", 24), ("8xlarge", 32),
    ("9xlarge", 36), ("12xlarge", 48), ("16xlarge", 64), ("18xlarge", 72),
    ("24xlarge", 96), ("32xlarge", 128), ("48xlarge", 192), ("metal", 96),
]

_GIB = float(2**30)
_MIB = float(2**20)
VM_MEMORY_OVERHEAD_PERCENT = 0.075  # reference options.go default


def _hash01(*parts) -> float:
    """Deterministic pseudo-random in [0,1) from a string key."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


def _max_pods(vcpu: int) -> int:
    # ENI-style pod density curve: small nodes ~30, mid ~110, big ~234+
    if vcpu <= 2:
        return 29
    if vcpu <= 4:
        return 58
    if vcpu <= 16:
        return 110
    if vcpu <= 64:
        return 234
    return 737


def _network_bandwidth_gbps(vcpu: int, fast: bool) -> float:
    base = min(100.0, max(1.0, vcpu * 0.78))
    return base * (4.0 if fast else 1.0)


def kube_reserved(vcpu: int, max_pods: int) -> Resources:
    """Standard kubelet reservation curve (same shape the reference's
    AL2/AL2023 families compute, types.go:493-530)."""
    # cpu: 6% of first core, 1% of next, 0.5% of next 2, 0.25% of rest
    millis = 0.0
    remaining = vcpu * 1000.0
    for frac, width in ((0.06, 1000.0), (0.01, 1000.0), (0.005, 2000.0)):
        take = min(remaining, width)
        millis += take * frac
        remaining -= take
        if remaining <= 0:
            break
    if remaining > 0:
        millis += remaining * 0.0025
    mem = (255 + 11 * max_pods) * _MIB
    return Resources({CPU: millis / 1000.0, MEMORY: mem})


@dataclass
class GeneratorConfig:
    zones: Sequence[str] = DEFAULT_ZONES
    region: str = "region-1"
    families: Optional[List[str]] = None  # limit to these family names
    max_types: Optional[int] = None
    spot_discount_range: tuple = (0.55, 0.75)  # fraction off on-demand
    reserved_families: Sequence[str] = ("p", "q")  # families with ODCRs
    seed: str = "karpenter-tpu-catalog-v1"


def generate_catalog(cfg: Optional[GeneratorConfig] = None) -> List[InstanceType]:
    cfg = cfg or GeneratorConfig()
    out: List[InstanceType] = []
    for category, fam, gens, gib_per_vcpu, per_vcpu, gpus8, accel8, nvme in _FAMILY_SPECS:
        for gen in gens:
            family = f"{fam}{gen}"
            if cfg.families and family not in cfg.families:
                continue
            # newer generations are ~5% cheaper per vCPU
            gen_rate = per_vcpu * (0.95 ** (gen - gens[0]))
            for size, vcpu in _SIZES:
                if fam == "t" and vcpu > 8:
                    continue  # burstable stays small
                if fam in ("p", "q") and vcpu < 8:
                    continue  # accelerator boxes start large
                if size == "metal" and fam in ("t", "q"):
                    continue
                name = f"{family}.{size}"
                mem_gib = vcpu * gib_per_vcpu
                gpu_count = (vcpu // 8) * gpus8 if gpus8 else 0
                accel_count = (vcpu // 8) * accel8 if accel8 else 0
                price = _price(name, gen_rate, vcpu, gpu_count, accel_count)
                out.append(_build_type(
                    cfg, name, category, family, gen, size, vcpu, mem_gib,
                    gpu_count, accel_count, nvme, fam == "hpc", price))
    if cfg.max_types:
        out = out[: cfg.max_types]
    return out


def _price(name: str, gen_rate: float, vcpu: int, gpus: int, accels: int) -> float:
    p = gen_rate * vcpu + gpus * 0.65 + accels * 0.35
    # per-type jitter so prices aren't perfectly collinear
    return round(p * (1.0 + 0.06 * (_hash01("price", name) - 0.5)), 4)


def _build_type(cfg: GeneratorConfig, name: str, category: str, family: str,
                gen: int, size: str, vcpu: int, mem_gib: float, gpus: int,
                accels: int, nvme: bool, fast_net: bool, od_price: float) -> InstanceType:
    mem_bytes = mem_gib * _GIB * (1.0 - VM_MEMORY_OVERHEAD_PERCENT)
    pods = _max_pods(vcpu)
    labels = {
        L.ARCH: "arm64" if gen >= 7 and category in ("c", "m", "r") and _hash01("arch", family) < 0.5 else "amd64",
        L.OS: "linux",
        L.INSTANCE_TYPE: name,
        L.REGION: cfg.region,
        L.INSTANCE_CATEGORY: category,
        L.INSTANCE_FAMILY: family,
        L.INSTANCE_GENERATION: str(gen),
        L.INSTANCE_SIZE: size,
        L.INSTANCE_CPU: str(vcpu),
        L.INSTANCE_CPU_MANUFACTURER: "acme",
        L.INSTANCE_MEMORY: str(int(mem_gib * 1024)),  # MiB, pre-overhead
        L.INSTANCE_HYPERVISOR: "" if size == "metal" else "vh",
        L.INSTANCE_ENCRYPTION_IN_TRANSIT: "true" if gen >= 5 else "false",
        L.INSTANCE_NETWORK_BANDWIDTH: str(int(_network_bandwidth_gbps(vcpu, fast_net) * 1000)),
        L.INSTANCE_EBS_BANDWIDTH: str(int(min(80, max(4, vcpu // 2)) * 1000)),
    }
    if nvme:
        labels[L.INSTANCE_LOCAL_NVME] = str(int(vcpu * 58.5))
    if fast_net:
        labels[L.INSTANCE_NETWORK_FAST_INTERFACE] = "true"
    if gpus:
        labels[L.INSTANCE_GPU_NAME] = f"gx{gen}00"
        labels[L.INSTANCE_GPU_MANUFACTURER] = "nvidia"
        labels[L.INSTANCE_GPU_COUNT] = str(gpus)
        labels[L.INSTANCE_GPU_MEMORY] = str(gpus * 24 * 1024)
    if accels:
        labels[L.INSTANCE_ACCELERATOR_NAME] = f"tq{gen}"
        labels[L.INSTANCE_ACCELERATOR_MANUFACTURER] = "tensorco"
        labels[L.INSTANCE_ACCELERATOR_COUNT] = str(accels)

    from ..models.volume import DEFAULT_ATTACH_LIMIT, VOLUME_ATTACH_RESOURCE
    capacity = Resources({
        CPU: float(vcpu),
        MEMORY: mem_bytes,
        PODS: float(pods),
        EPHEMERAL_STORAGE: 100.0 * _GIB,
        # per-node attachable-volume limit (the EBS CSI attach-limit
        # analog, models/volume.py): volume-bearing pods consume this
        VOLUME_ATTACH_RESOURCE: float(DEFAULT_ATTACH_LIMIT),
    })
    if gpus:
        capacity[NVIDIA_GPU] = float(gpus)
    if accels:
        capacity[TPU_CHIP] = float(accels)

    overhead = Overhead(
        kube_reserved=kube_reserved(vcpu, pods),
        system_reserved=Resources({CPU: 0.0, MEMORY: 100 * _MIB}),
        eviction_threshold=Resources({MEMORY: 100 * _MIB}),
    )

    offerings: List[Offering] = []
    for zone in cfg.zones:
        # a few (type, zone) pairs simply don't exist, like real regions
        if _hash01("exists", name, zone) < 0.06:
            continue
        offerings.append(Offering(zone=zone, capacity_type=L.CAPACITY_ON_DEMAND,
                                  price=od_price))
        lo, hi = cfg.spot_discount_range
        disc = lo + (hi - lo) * _hash01("spot", name, zone)
        if not (size == "metal" and _hash01("spotmetal", name) < 0.5):
            offerings.append(Offering(zone=zone, capacity_type=L.CAPACITY_SPOT,
                                      price=round(od_price * (1 - disc), 4)))
        fam_base = family.rstrip("0123456789")
        if fam_base in cfg.reserved_families and _hash01("odcr", name, zone) < 0.3:
            offerings.append(Offering(
                zone=zone, capacity_type=L.CAPACITY_RESERVED,
                price=od_price / 1e7,  # reference prices reserved at OD/10^7
                reservation_id=f"cr-{name}-{zone}",
                reservation_capacity=int(2 + 14 * _hash01("odcrcap", name, zone))))
        elif (accels or gpus) and _hash01("block", name, zone) < 0.25:
            # capacity blocks: prepaid time-boxed accelerator reservations
            # (reference CapacityReservationType capacity-block); the end
            # time is set by the environment (fake cloud / tests) — None
            # means not yet scheduled to end
            from ..models.instancetype import RESERVATION_CAPACITY_BLOCK
            offerings.append(Offering(
                zone=zone, capacity_type=L.CAPACITY_RESERVED,
                price=od_price / 1e7,
                reservation_id=f"cb-{name}-{zone}",
                reservation_capacity=int(1 + 7 * _hash01("blockcap", name, zone)),
                reservation_type=RESERVATION_CAPACITY_BLOCK))

    return InstanceType(
        name=name,
        requirements=Requirements.from_labels(labels),
        capacity=capacity,
        overhead=overhead,
        offerings=offerings,
    )


def small_catalog(n_families: int = 5, zones: Sequence[str] = DEFAULT_ZONES) -> List[InstanceType]:
    """~20-type catalog for the kwok-scale benchmark config #1."""
    fams = ["c5", "m5", "r5", "c6", "m6", "r6", "t3", "g5"][:n_families]
    cat = generate_catalog(GeneratorConfig(zones=zones, families=fams))
    # thin out sizes to keep ~4 per family
    keep_sizes = {"large", "xlarge", "4xlarge", "8xlarge"}
    return [t for t in cat if t.name.split(".")[1] in keep_sizes]
