"""Attachable-volume constants the catalog generator needs.

Copy of the two constants of `karpenter_tpu/models/volume.py`: every
instance type allocates DEFAULT_ATTACH_LIMIT of the attachable-volumes
resource, and volume-bearing pods request it, so the solver's ordinary
resource packing enforces the per-node attach limit.
"""

VOLUME_ATTACH_RESOURCE = "storage.karpenter.tpu/attachable-volumes"
DEFAULT_ATTACH_LIMIT = 27  # the classic EBS per-instance attach limit
