"""Device meshes for SPMD pipelines, one process per card.

Counterpart of ``pragma_dsp_tpu/parallel/mesh.py``. The JAX package runs
one program over a ``jax.sharding.Mesh`` of local and remote devices and
shards with ``shard_map``; here every rank of a ``torch.distributed``
process group runs the same program on its own card and holds its own
block, and a mesh is a ``DeviceMesh`` over the ranks. The collectives are
NCCL (gloo on the CPU) through ``torch.distributed``: ``_comm.py``.

A mesh axis argument is one name or a tuple of names. A tuple is the
row-major joint axis over those dimensions (the JAX PartitionSpec tuple
entry): position ``host * chips + chip`` on ``("host", "chip")``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "data_mesh", "Mesh"]

Mesh = DeviceMesh


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh over the first prod(shape) ranks of the default process group,
    row-major; ``device_type`` "cpu" for a gloo group."""
    n = int(np.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group, one process per card: "
                           "call parallel.init_multihost() first")
    if dist.get_world_size() < n:
        raise ValueError(f"need {n} devices, have {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def data_mesh(n_devices: Optional[int] = None, axis: str = "x",
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over all (or the first n) ranks: the workhorse layout for
    batch/channel/time-block sharding."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n_devices,), (axis,), device_type)


def _axes(axis) -> Tuple[str, ...]:
    """Normalise a mesh-axis argument (name or tuple of names)."""
    return axis if isinstance(axis, tuple) else (axis,)


def _dims(mesh: DeviceMesh, axis) -> List[int]:
    names = tuple(mesh.mesh_dim_names or ())
    for a in _axes(axis):
        if a not in names:
            raise ValueError(f"{a!r} is not a mesh axis (available: {names})")
    return [names.index(a) for a in _axes(axis)]


def _extent(mesh: DeviceMesh, axis) -> int:
    return int(np.prod([mesh.shape[i] for i in _dims(mesh, axis)]))


def _coordinate(mesh: DeviceMesh) -> List[int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    return list(coord)


def _flat_index(mesh: DeviceMesh, axis) -> int:
    """This rank's position along the flattened joint axis (row-major over
    the tuple order, as a PartitionSpec tuple entry shards): the JAX
    ``axis_index`` chain."""
    coord = _coordinate(mesh)
    idx = 0
    for i in _dims(mesh, axis):
        idx = idx * mesh.shape[i] + coord[i]
    return idx


def _axis_ranks(mesh: DeviceMesh, axis) -> List[int]:
    """The global ranks along the joint axis through this rank, in flat
    index order."""
    dims = _dims(mesh, axis)
    coord = _coordinate(mesh)
    ranks = mesh.mesh
    rest = [i for i in range(ranks.ndim) if i not in dims]
    line = ranks.permute(rest + dims)[tuple(coord[i] for i in rest)]
    return line.reshape(-1).tolist()


# This rank's group of each joint axis, keyed on the default group, the
# mesh's rank layout and the axis' dimensions: meshes made anew over the
# same ranks share their groups, and a new default group makes its own.
_JOINT_GROUPS: Dict[tuple, Any] = {}


def _group(mesh: DeviceMesh, axis):
    """The process group of the joint axis through this rank. One mesh
    dimension is the mesh's own group. A joint axis gets one group per line
    of the mesh, made once per (default group, rank layout, axes) by every
    rank in one order: so the mesh must span the default group."""
    dims = _dims(mesh, axis)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    ranks = mesh.mesh
    key = (dist.group.WORLD, tuple(ranks.shape), tuple(ranks.reshape(-1).tolist()), tuple(dims))
    if key not in _JOINT_GROUPS:
        if ranks.numel() != dist.get_world_size():
            raise ValueError(
                f"a joint axis {_axes(axis)} needs a mesh over every rank of the "
                f"default group ({dist.get_world_size()}), got {ranks.numel()}")
        rest = [i for i in range(ranks.ndim) if i not in dims]
        lines = ranks.permute(rest + dims).reshape(-1, _extent(mesh, axis)).tolist()
        me = dist.get_rank()
        for line in lines:
            group = dist.new_group(line)
            if me in line:
                _JOINT_GROUPS[key] = group
    return _JOINT_GROUPS[key]
