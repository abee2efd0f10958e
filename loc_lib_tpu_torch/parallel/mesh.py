"""Device meshes and the collectives (port of loc_lib_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the process group `multihost.init` set up, one rank per process: 1-D with
the axis "dp" (source rows), or 2-D ("dp", "mp") with the map shards on
"mp". A mesh spans the whole world, so a reduction over all of its axes
runs on the default group.

The collectives carry the names of their counterparts in jax.lax inside
shard_map: `psum` (all_reduce SUM), `pmin` (all_reduce MIN) and
`axis_index` (this rank's index along an axis). They reduce over the
named axes only; an axis of size 1 costs nothing, and a mesh of one rank
runs no collective at all. `local_rows` is what P("dp") gives a device:
the rank's contiguous block of a replicated tensor's leading rows.
"""

from __future__ import annotations

from typing import Iterable, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

Axes = Union[str, Iterable[str]]


def _require_world(n: int) -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.init first")
    if n != dist.get_world_size():
        raise ValueError(f"a mesh spans the whole world: {n} ranks asked, world size "
                         f"{dist.get_world_size()}")


def _device_type() -> str:
    """The mesh's device type: "cuda" on an NCCL world, else "cpu" (a gloo
    world, also when its ranks compute on a card: gloo reduces in host
    memory wherever the tensors live, and the mesh's device type only
    places DTensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> DeviceMesh:
    """1-D mesh over all ranks (n_devices, when given, must equal the world
    size)."""
    n = dist.get_world_size() if n_devices is None and dist.is_initialized() else n_devices
    _require_world(n or 0)
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(dp: int, mp: int) -> DeviceMesh:
    """2-D mesh dp x mp (source rows x map shards), rank = dp_index * mp +
    mp_index."""
    _require_world(dp * mp)
    return init_device_mesh(_device_type(), (dp, mp), mesh_dim_names=("dp", "mp"))


def replicated(mesh: DeviceMesh) -> list:
    """DTensor placements of a tensor every rank holds whole."""
    return [Replicate() for _ in mesh.mesh_dim_names]


def row_sharded(mesh: DeviceMesh, axis: str = "dp") -> list:
    """DTensor placements of a tensor whose leading axis is split over
    `axis` (replicated over the others)."""
    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The mesh's extent along `axis` (1 for an axis it does not have)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along `axis` (0 for an axis the mesh does not
    have)."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def group(mesh: DeviceMesh, axes: Axes):
    """The process group reducing over `axes`, or None when those axes hold
    one rank (nothing to reduce)."""
    live = [a for a in _axes(axes) if axis_size(mesh, a) > 1]
    if not live:
        return None
    if len(live) == len(mesh.mesh_dim_names):
        return dist.group.WORLD          # the mesh spans the world
    return mesh.get_group(live[0])


def _reduce(x: torch.Tensor, mesh: DeviceMesh, axes: Axes, op) -> torch.Tensor:
    g = group(mesh, axes)
    if g is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=op, group=g)
    return out


def psum(x: torch.Tensor, mesh: DeviceMesh, axes: Axes = ("dp", "mp")) -> torch.Tensor:
    """Sum of x over the ranks along `axes`, the same bits on every one of
    them; x itself is left as it was."""
    return _reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmin(x: torch.Tensor, mesh: DeviceMesh, axes: Axes = "mp") -> torch.Tensor:
    """Elementwise minimum of x over the ranks along `axes`."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MIN)


def local_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp") -> torch.Tensor:
    """This rank's contiguous block of the leading rows of a replicated x
    (what P(axis) gives a device); the row count must divide evenly."""
    n, k = x.shape[0], axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"{n} rows do not split evenly over {k} ranks of {axis!r}")
    i = axis_index(mesh, axis)
    return x[i * (n // k):(i + 1) * (n // k)]


def gather_slots(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """(ranks along `axes`, *x.shape): every rank's x along `axes` (slots in
    row-major order of the axes), on every rank. An all_reduce SUM of a
    zero-filled buffer in which each rank fills its own slot, on int32
    views of the data, so adding the zeros is exact bit for bit (-0.0 and
    NaN included) on NCCL and gloo alike. x must have 4-byte elements."""
    if x.element_size() != 4:
        raise ValueError(f"gather_slots takes 4-byte elements, got {x.dtype}")
    slot, k = 0, 1
    for a in _axes(axes):
        slot = slot * axis_size(mesh, a) + axis_index(mesh, a)
        k *= axis_size(mesh, a)
    bits = x.contiguous().view(torch.int32)
    buf = torch.zeros((k,) + tuple(bits.shape), dtype=torch.int32, device=x.device)
    buf[slot] = bits
    return psum(buf, mesh, axes).view(x.dtype)
