"""Production device meshes (the JAX package's `launch/mesh.py`).

JAX's shapes and axis names: one pod of 256 devices as (16, 16) over
("data", "model"); two pods add a leading "pod" axis, (2, 16, 16).  A
maker returns a `torch.distributed.device_mesh.DeviceMesh` over the process
group that is already initialized (its world size must be the mesh's
size), of the model's device type: ``cuda`` unless the caller asks for
``cpu``.  Importing this module touches no device and no process group.

The sharding rules (`models/sharding.py`) read only a mesh's axis names
and sizes, so they also take a `MeshSpec`, which needs no process group:
the tests hold the 256- and 512-device layouts against JAX's with one.

`init_fake_group(world)` starts torch's ``fake`` backend as rank 0 of
``world`` ranks: one real process that a mesh of ``world`` devices can be
built over and whose collectives move no data (the dry run's group,
`launch/ocean_dryrun.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's description: its axis names and their sizes."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} and axis names "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as JAX's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def production_spec(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def small_spec(n_data: int = 2, n_model: int = 4) -> MeshSpec:
    return MeshSpec((n_data, n_model), ("data", "model"))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `MeshSpec` or a `DeviceMesh`."""
    if isinstance(mesh, MeshSpec):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, MeshSpec):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def init_fake_group(world: int) -> None:
    """Initialise the default process group on torch's ``fake`` backend
    (`torch.testing._internal.distributed.fake_pg`) as rank 0 of ``world``;
    the caller destroys it (`torch.distributed.destroy_process_group`)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("init_fake_group: a process group is already "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """A `DeviceMesh` of ``spec`` over the initialized default process
    group, ranks laid out row-major (the last axis fastest, as JAX's device
    grid).  Raises when the group's world size is not the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialized")
    world = dist.get_world_size()
    if world != spec.size:
        raise ValueError(f"mesh {spec.sizes} {spec.axis_names} needs "
                         f"{spec.size} ranks; the process group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(spec.sizes),
                      mesh_dim_names=spec.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return make_mesh(production_spec(multi_pod=multi_pod), device_type)


def make_test_mesh(n_data: int = 2, n_model: int = 4, device_type: str = "cuda"):
    """Small mesh for tests: (n_data, n_model) over ("data", "model")."""
    return make_mesh(small_spec(n_data, n_model), device_type)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(t: torch.Tensor, mesh, placements):
    """``t`` (the same whole tensor on every rank) as a DTensor on ``mesh``
    at ``placements``, each rank keeping only its own shard, on the mesh's
    device type.  No communication; the whole tensor is not kept alive."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    t = t.to(mesh.device_type)
    d = distribute_tensor(t, mesh, placements, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        # a view of the whole tensor would keep all of it alive
        d = DTensor.from_local(local.clone(), mesh, placements,
                               run_check=False, shape=d.shape,
                               stride=d.stride())
    return d


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axis names for a mesh (pod folds into DP)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
