"""Mesh builders: the 1-D fleet mesh over this process's cards, and the
named (pod, data, model) meshes of the LM layouts as
``torch.distributed`` ``DeviceMesh``es. Functions, not module constants:
importing this module touches no device and no process group.

A fleet mesh needs no ``torch.distributed``: a fleet bin's instances are
independent, so ``distributed.sharding.fleet_sharded`` runs each shard on
its device from this one process. The LM meshes span the current process
group (gloo on the CPU, NCCL on the cards), one rank a device. A
``MeshShape`` is a mesh's names and sizes without ranks: what the dry run
accounts over when no process group has the production mesh's ranks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

#: axis name of the fleet-execution mesh (instance axis of a job bin)
FLEET_AXIS = "fleet"


@dataclass(frozen=True)
class FleetMesh:
    """A 1-D mesh over ``devices``, in order, named ``mesh_dim_names``:
    shard ``i`` of a bin runs on ``devices[i]``. A device may appear more
    than once (several shards on one card run one after the other)."""
    devices: Tuple[torch.device, ...]
    mesh_dim_names: Tuple[str, ...] = (FLEET_AXIS,)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.devices),)


def local_devices() -> Tuple[torch.device, ...]:
    """The cards this process sees, in order: what a fleet mesh spans."""
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


_FLEET_MESHES: dict = {}


def make_fleet_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Optional[FleetMesh]:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: all
    of ``local_devices()``) for sharding a fleet bin's instance axis.
    Returns None with fewer than 2 (nothing to shard over); raises when
    ``n_devices`` exceeds the devices there are. Memoised per device
    tuple: the executor asks once per bin."""
    devs = tuple(torch.device(d) for d in
                 (local_devices() if devices is None else devices))
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"a fleet mesh of {n} devices needs {n}, there "
                         f"are {len(devs)}")
    if n < 2:
        return None
    devs = devs[:n]
    mesh = _FLEET_MESHES.get(devs)
    if mesh is None:
        mesh = _FLEET_MESHES[devs] = FleetMesh(devs)
    return mesh


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, no ranks: what ``spec_for``,
    ``placements`` and the dry run read of a ``DeviceMesh``
    (``mesh_dim_names``, ``shape``, ``size()``, ``ndim``). It stands for
    the production meshes' 256 and 512 devices, which no process group of
    one machine has; nothing can run on it."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if mesh_dim is None \
            else self.shape[mesh_dim]


def make_mesh(shape, axes, *, ranks: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ``ranks`` (default:
    the first ``prod(shape)`` ranks) of the current process group (the
    cards under NCCL, the CPU under any other backend, unless
    ``device_type`` names the device its tensors lie on). Every rank of
    the group must call it, those outside the mesh too: creating its
    subgroups is collective. Raises without a process group or with fewer
    ranks than the mesh needs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(torch.distributed.init_process_group)")
    size = math.prod(shape)
    world = dist.get_world_size()
    if size > world:
        raise ValueError(f"Number of ranks {world} must be >= the product "
                         f"of mesh_shape {shape}")
    ranks = list(range(size)) if ranks is None else list(ranks)
    if len(set(ranks)) != len(ranks) or len(ranks) != size \
            or not set(ranks) <= set(range(world)):
        raise ValueError(f"a mesh of shape {shape} needs {size} distinct "
                         f"ranks of the {world}, got {ranks}")
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl"
                                  else "cpu")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod: a
    ``DeviceMesh`` where the process group has that many ranks, else the
    ``MeshShape`` the dry run accounts over."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() >= math.prod(shape):
        return make_mesh(shape, axes)
    return MeshShape(shape, axes)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes the mesh has, in mesh order."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
