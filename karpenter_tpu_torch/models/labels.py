"""Well-known scheduling label vocabulary.

The port's own copy of `karpenter_tpu/models/labels.py`, unchanged in
semantics (the port imports nothing of the JAX package).

The framework's own label group is `karpenter.tpu/…` (the reference uses
`karpenter.k8s.aws/instance-*` — pkg/apis/v1/labels.go:34-54 defines 21 such
labels). We define the same *capability surface*: category/family/generation/
size/cpu/memory/accelerator/network labels that instance-type requirements
expose for pod nodeAffinity to match on, plus the core well-known labels
(arch, os, instance-type, zone, region, capacity-type, nodepool).
"""

from __future__ import annotations

# core well-known (kubernetes + framework core group)
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
ZONE = "topology.kubernetes.io/zone"
REGION = "topology.kubernetes.io/region"
HOSTNAME = "kubernetes.io/hostname"
CAPACITY_TYPE = "karpenter.tpu/capacity-type"
NODEPOOL = "karpenter.tpu/nodepool"
# pod annotation: the NodeClaim a pending pod is nominated to (the
# provisioner's in-flight placement marker; the store's pending-group
# index keys off its presence)
NOMINATED = "karpenter.tpu/nominated-nodeclaim"
# NoSchedule taint cordoning a node: applied at DISRUPTION DECISION time
# (before replacements boot — reference step order, disruption.md:14-27)
# and again at drain start; the provisioner never reuses a node carrying it
DISRUPTED_TAINT_KEY = "karpenter.tpu/disrupted"
NODE_INITIALIZED = "karpenter.tpu/initialized"
NODE_REGISTERED = "karpenter.tpu/registered"

# capacity types
CAPACITY_ON_DEMAND = "on-demand"
CAPACITY_SPOT = "spot"
CAPACITY_RESERVED = "reserved"
CAPACITY_TYPES = (CAPACITY_ON_DEMAND, CAPACITY_SPOT, CAPACITY_RESERVED)

# instance-* labels (framework group) — parity with the reference's 21
# karpenter.k8s.aws/instance-* labels (pkg/apis/v1/labels.go:34-54)
_G = "karpenter.tpu"
INSTANCE_CATEGORY = f"{_G}/instance-category"
INSTANCE_FAMILY = f"{_G}/instance-family"
INSTANCE_GENERATION = f"{_G}/instance-generation"
INSTANCE_SIZE = f"{_G}/instance-size"
INSTANCE_CPU = f"{_G}/instance-cpu"
INSTANCE_CPU_MANUFACTURER = f"{_G}/instance-cpu-manufacturer"
INSTANCE_CPU_SUSTAINED_CLOCK_SPEED_MHZ = f"{_G}/instance-cpu-sustained-clock-speed-mhz"
INSTANCE_MEMORY = f"{_G}/instance-memory"  # MiB
INSTANCE_EBS_BANDWIDTH = f"{_G}/instance-ebs-bandwidth"
INSTANCE_NETWORK_BANDWIDTH = f"{_G}/instance-network-bandwidth"
INSTANCE_GPU_NAME = f"{_G}/instance-gpu-name"
INSTANCE_GPU_MANUFACTURER = f"{_G}/instance-gpu-manufacturer"
INSTANCE_GPU_COUNT = f"{_G}/instance-gpu-count"
INSTANCE_GPU_MEMORY = f"{_G}/instance-gpu-memory"  # MiB
INSTANCE_ACCELERATOR_NAME = f"{_G}/instance-accelerator-name"
INSTANCE_ACCELERATOR_MANUFACTURER = f"{_G}/instance-accelerator-manufacturer"
INSTANCE_ACCELERATOR_COUNT = f"{_G}/instance-accelerator-count"
INSTANCE_HYPERVISOR = f"{_G}/instance-hypervisor"
INSTANCE_ENCRYPTION_IN_TRANSIT = f"{_G}/instance-encryption-in-transit-supported"
INSTANCE_LOCAL_NVME = f"{_G}/instance-local-nvme"  # GiB of local disk
INSTANCE_NETWORK_FAST_INTERFACE = f"{_G}/instance-fast-networking"  # EFA analog

# labels whose values are numeric and support Gt/Lt in requirements
NUMERIC_LABELS = frozenset({
    INSTANCE_CPU,
    INSTANCE_CPU_SUSTAINED_CLOCK_SPEED_MHZ,
    INSTANCE_MEMORY,
    INSTANCE_EBS_BANDWIDTH,
    INSTANCE_NETWORK_BANDWIDTH,
    INSTANCE_GPU_COUNT,
    INSTANCE_GPU_MEMORY,
    INSTANCE_ACCELERATOR_COUNT,
    INSTANCE_GENERATION,
    INSTANCE_LOCAL_NVME,
})

# labels that vary per-offering rather than per-type: handled by the solver's
# (zone, capacity-type) axes, not by the per-type label mask
OFFERING_LABELS = frozenset({ZONE, CAPACITY_TYPE})

# instance adoption tags, stamped at launch and read back by restart
# rehydration (state/rehydrate.py) — the writer (provisioner) and reader
# must share one spelling or instances silently become unadoptable
TAG_NODECLAIM = f"{_G}/nodeclaim"
TAG_NODEPOOL = NODEPOOL
TAG_NODECLASS = f"{_G}/nodeclass"
TAG_NODECLASS_HASH = f"{_G}/nodeclass-hash"
TAG_NODECLASS_HASH_VERSION = f"{_G}/nodeclass-hash-version"
TAG_NODEPOOL_HASH = f"{_G}/nodepool-hash"
TAG_NODEPOOL_HASH_VERSION = f"{_G}/nodepool-hash-version"
# launch idempotency token (state/journal.launch_token), stamped on the
# instance at launch: restart replay matches open intents to the
# instances they actually minted by this tag, and the GC sweep skips
# instances whose token still has an open intent (launch in flight)
TAG_LAUNCH_TOKEN = f"{_G}/launch-token"

# restricted: users may not set these directly on NodePool templates
RESTRICTED_LABELS = frozenset({NODEPOOL, NODE_INITIALIZED, NODE_REGISTERED, HOSTNAME})

WELL_KNOWN = frozenset({
    ARCH, OS, INSTANCE_TYPE, ZONE, REGION, CAPACITY_TYPE, NODEPOOL,
    INSTANCE_CATEGORY, INSTANCE_FAMILY, INSTANCE_GENERATION, INSTANCE_SIZE,
    INSTANCE_CPU, INSTANCE_CPU_MANUFACTURER,
    INSTANCE_CPU_SUSTAINED_CLOCK_SPEED_MHZ, INSTANCE_MEMORY,
    INSTANCE_EBS_BANDWIDTH, INSTANCE_NETWORK_BANDWIDTH, INSTANCE_GPU_NAME,
    INSTANCE_GPU_MANUFACTURER, INSTANCE_GPU_COUNT, INSTANCE_GPU_MEMORY,
    INSTANCE_ACCELERATOR_NAME, INSTANCE_ACCELERATOR_MANUFACTURER,
    INSTANCE_ACCELERATOR_COUNT, INSTANCE_HYPERVISOR,
    INSTANCE_ENCRYPTION_IN_TRANSIT, INSTANCE_LOCAL_NVME,
    INSTANCE_NETWORK_FAST_INTERFACE,
})
