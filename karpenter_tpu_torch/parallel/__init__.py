"""Mesh + sharding: multi-device distribution of the solver."""

from .mesh import (Mesh, device_count, make_batch_mesh, make_mesh,
                   run_sharded_solve, set_virtual_devices, sharded_solve_fn,
                   virtual_devices)

__all__ = ["Mesh", "device_count", "make_batch_mesh", "make_mesh",
           "run_sharded_solve", "set_virtual_devices", "sharded_solve_fn",
           "virtual_devices"]
