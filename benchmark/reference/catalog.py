"""The instance-type catalog as plain data.

A copy of the generated EC2-scale catalog that the autoscaler's fake
cloud lists (810 types, 3 zones, on-demand, spot and reserved offerings),
written as plain dictionaries so that the reference and the program are
handed the same input: `generate()` is the one source, the harness builds
the program's instance types from its dictionaries, and the reference
reads them as they are. Deterministic: it takes no seed.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

ZONES = ("zone-a", "zone-b", "zone-c")
REGION = "region-1"
ON_DEMAND, SPOT, RESERVED = "on-demand", "spot", "reserved"
CAPACITY_TYPES = (ON_DEMAND, SPOT, RESERVED)
CAPACITY_BLOCK = "capacity-block"
SPOT_DISCOUNT = (0.55, 0.75)
RESERVED_FAMILIES = ("p", "q")
SEED = "karpenter-tpu-catalog-v1"

# label keys
G = "karpenter.tpu"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
REGION_KEY = "topology.kubernetes.io/region"
CATEGORY = f"{G}/instance-category"
FAMILY = f"{G}/instance-family"
GENERATION = f"{G}/instance-generation"
SIZE = f"{G}/instance-size"
CPU_LABEL = f"{G}/instance-cpu"
CPU_MANUFACTURER = f"{G}/instance-cpu-manufacturer"
MEMORY_LABEL = f"{G}/instance-memory"
HYPERVISOR = f"{G}/instance-hypervisor"
ENCRYPTION = f"{G}/instance-encryption-in-transit-supported"
NETWORK_BW = f"{G}/instance-network-bandwidth"
EBS_BW = f"{G}/instance-ebs-bandwidth"
LOCAL_NVME = f"{G}/instance-local-nvme"
FAST_NET = f"{G}/instance-fast-networking"
GPU_NAME = f"{G}/instance-gpu-name"
GPU_MANUFACTURER = f"{G}/instance-gpu-manufacturer"
GPU_COUNT = f"{G}/instance-gpu-count"
GPU_MEMORY = f"{G}/instance-gpu-memory"
ACCEL_NAME = f"{G}/instance-accelerator-name"
ACCEL_MANUFACTURER = f"{G}/instance-accelerator-manufacturer"
ACCEL_COUNT = f"{G}/instance-accelerator-count"

# resource names
CPU, MEMORY, PODS = "cpu", "memory", "pods"
EPHEMERAL = "ephemeral-storage"
NVIDIA_GPU = "nvidia.com/gpu"
TPU_CHIP = "google.com/tpu"
ATTACH = "storage.karpenter.tpu/attachable-volumes"
ATTACH_LIMIT = 27

GIB = float(2**30)
MIB = float(2**20)
VM_MEMORY_OVERHEAD = 0.075

FAMILIES = [
    # category, family, generations, GiB/vCPU, $/vCPU-hr, gpu/8 vCPU,
    # accelerators/8 vCPU, local nvme
    ("c", "c", (5, 6, 7, 8), 2.0, 0.0425, 0, 0, False),
    ("m", "m", (5, 6, 7, 8), 4.0, 0.0480, 0, 0, False),
    ("r", "r", (5, 6, 7, 8), 8.0, 0.0630, 0, 0, False),
    ("x", "x", (2, 4), 16.0, 0.0833, 0, 0, True),
    ("t", "t", (3, 4), 4.0, 0.0416, 0, 0, False),
    ("c", "cn", (6, 7), 2.0, 0.0540, 0, 0, True),
    ("m", "mn", (6, 7), 4.0, 0.0570, 0, 0, True),
    ("r", "rn", (6, 7), 8.0, 0.0720, 0, 0, True),
    ("i", "i", (3, 4), 8.0, 0.0780, 0, 0, True),
    ("d", "d", (3,), 16.0, 0.0690, 0, 0, True),
    ("g", "g", (4, 5, 6), 4.0, 0.1260, 1, 0, True),
    ("p", "p", (4, 5), 8.0, 0.3830, 2, 0, True),
    ("q", "q", (1, 2), 4.0, 0.1680, 0, 4, False),
    ("z", "z", (1,), 8.0, 0.0975, 0, 0, True),
    ("hpc", "hpc", (6, 7), 4.0, 0.0864, 0, 0, False),
    ("c", "ca", (6, 7), 2.0, 0.0383, 0, 0, False),
    ("m", "ma", (6, 7), 4.0, 0.0432, 0, 0, False),
    ("r", "ra", (6, 7), 8.0, 0.0567, 0, 0, False),
    ("c", "ce", (6, 7), 2.0, 0.0468, 0, 0, False),
    ("m", "me", (6, 7), 4.0, 0.0528, 0, 0, False),
    ("r", "re", (6, 7), 8.0, 0.0693, 0, 0, False),
    ("i", "in", (3, 4), 8.0, 0.0858, 0, 0, True),
    ("g", "gr", (5, 6), 4.0, 0.1134, 1, 0, True),
    ("x", "xe", (1, 2), 24.0, 0.1040, 0, 0, True),
]

SIZES = [
    ("medium", 1), ("large", 2), ("xlarge", 4), ("2xlarge", 8),
    ("3xlarge", 12), ("4xlarge", 16), ("6xlarge", 24), ("8xlarge", 32),
    ("9xlarge", 36), ("12xlarge", 48), ("16xlarge", 64), ("18xlarge", 72),
    ("24xlarge", 96), ("32xlarge", 128), ("48xlarge", 192), ("metal", 96),
]


def hash01(*parts) -> float:
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


def max_pods(vcpu: int) -> int:
    if vcpu <= 2:
        return 29
    if vcpu <= 4:
        return 58
    if vcpu <= 16:
        return 110
    if vcpu <= 64:
        return 234
    return 737


def kube_reserved(vcpu: int, pods: int) -> Dict[str, float]:
    millis, remaining = 0.0, vcpu * 1000.0
    for frac, width in ((0.06, 1000.0), (0.01, 1000.0), (0.005, 2000.0)):
        take = min(remaining, width)
        millis += take * frac
        remaining -= take
        if remaining <= 0:
            break
    if remaining > 0:
        millis += remaining * 0.0025
    return {CPU: millis / 1000.0, MEMORY: (255 + 11 * pods) * MIB}


def generate() -> List[dict]:
    """Every type as {"name", "labels", "capacity", "overhead": [kube,
    system, eviction], "offerings": [{"zone", "capacity_type", "price",
    "reservation_id", "reservation_type", "reservation_capacity"}]}."""
    out = []
    for category, fam, gens, gib_per_vcpu, per_vcpu, gpus8, accel8, nvme in \
            FAMILIES:
        for gen in gens:
            family = f"{fam}{gen}"
            rate = per_vcpu * (0.95 ** (gen - gens[0]))
            for size, vcpu in SIZES:
                if fam == "t" and vcpu > 8:
                    continue
                if fam in ("p", "q") and vcpu < 8:
                    continue
                if size == "metal" and fam in ("t", "q"):
                    continue
                name = f"{family}.{size}"
                gpus = (vcpu // 8) * gpus8 if gpus8 else 0
                accels = (vcpu // 8) * accel8 if accel8 else 0
                p = rate * vcpu + gpus * 0.65 + accels * 0.35
                price = round(p * (1.0 + 0.06 * (hash01("price", name) - 0.5)),
                              4)
                out.append(_type(name, category, family, gen, size, vcpu,
                                 vcpu * gib_per_vcpu, gpus, accels, nvme,
                                 fam == "hpc", price))
    return out


def _type(name, category, family, gen, size, vcpu, mem_gib, gpus, accels,
          nvme, fast_net, od_price) -> dict:
    pods = max_pods(vcpu)
    labels = {
        ARCH: ("arm64" if gen >= 7 and category in ("c", "m", "r")
               and hash01("arch", family) < 0.5 else "amd64"),
        OS: "linux",
        INSTANCE_TYPE: name,
        REGION_KEY: REGION,
        CATEGORY: category,
        FAMILY: family,
        GENERATION: str(gen),
        SIZE: size,
        CPU_LABEL: str(vcpu),
        CPU_MANUFACTURER: "acme",
        MEMORY_LABEL: str(int(mem_gib * 1024)),
        HYPERVISOR: "" if size == "metal" else "vh",
        ENCRYPTION: "true" if gen >= 5 else "false",
        NETWORK_BW: str(int(min(100.0, max(1.0, vcpu * 0.78))
                            * (4.0 if fast_net else 1.0) * 1000)),
        EBS_BW: str(int(min(80, max(4, vcpu // 2)) * 1000)),
    }
    if nvme:
        labels[LOCAL_NVME] = str(int(vcpu * 58.5))
    if fast_net:
        labels[FAST_NET] = "true"
    if gpus:
        labels[GPU_NAME] = f"gx{gen}00"
        labels[GPU_MANUFACTURER] = "nvidia"
        labels[GPU_COUNT] = str(gpus)
        labels[GPU_MEMORY] = str(gpus * 24 * 1024)
    if accels:
        labels[ACCEL_NAME] = f"tq{gen}"
        labels[ACCEL_MANUFACTURER] = "tensorco"
        labels[ACCEL_COUNT] = str(accels)
    capacity = {CPU: float(vcpu),
                MEMORY: mem_gib * GIB * (1.0 - VM_MEMORY_OVERHEAD),
                PODS: float(pods), EPHEMERAL: 100.0 * GIB,
                ATTACH: float(ATTACH_LIMIT)}
    if gpus:
        capacity[NVIDIA_GPU] = float(gpus)
    if accels:
        capacity[TPU_CHIP] = float(accels)
    overhead = [kube_reserved(vcpu, pods), {CPU: 0.0, MEMORY: 100 * MIB},
                {MEMORY: 100 * MIB}]
    offerings = []
    for zone in ZONES:
        if hash01("exists", name, zone) < 0.06:
            continue
        offerings.append(_offer(zone, ON_DEMAND, od_price))
        lo, hi = SPOT_DISCOUNT
        disc = lo + (hi - lo) * hash01("spot", name, zone)
        if not (size == "metal" and hash01("spotmetal", name) < 0.5):
            offerings.append(_offer(zone, SPOT,
                                    round(od_price * (1 - disc), 4)))
        base = family.rstrip("0123456789")
        if base in RESERVED_FAMILIES and hash01("odcr", name, zone) < 0.3:
            offerings.append(_offer(
                zone, RESERVED, od_price / 1e7, f"cr-{name}-{zone}",
                "default", int(2 + 14 * hash01("odcrcap", name, zone))))
        elif (accels or gpus) and hash01("block", name, zone) < 0.25:
            offerings.append(_offer(
                zone, RESERVED, od_price / 1e7, f"cb-{name}-{zone}",
                CAPACITY_BLOCK, int(1 + 7 * hash01("blockcap", name, zone))))
    return {"name": name, "labels": labels, "capacity": capacity,
            "overhead": overhead, "offerings": offerings}


def _offer(zone, captype, price, rid=None, rtype="default", rcap=0) -> dict:
    return {"zone": zone, "capacity_type": captype, "price": price,
            "reservation_id": rid, "reservation_type": rtype,
            "reservation_capacity": rcap}
