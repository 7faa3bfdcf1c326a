"""Multi-device execution on ``torch.distributed`` (port of
``timewarp_tpu/parallel``): the mesh and its collectives (mesh.py) and the
launcher that starts one rank per shard (launch.py)."""

from .mesh import (AxisName, Mesh, MeshComm, ShardedDriver, axis_size,
                   check_backend, make_mesh)

__all__ = ["AxisName", "Mesh", "MeshComm", "ShardedDriver", "axis_size",
           "check_backend", "make_mesh"]
