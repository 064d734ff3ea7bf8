"""Device meshes: the production meshes training shards over, and where each
shard of the sharded engine lives.

The counterpart of src/repro/launch/mesh.py.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group (``torchrun``, one rank a card, or a ``fake`` process group for
the dry run): JAX's ``Mesh`` of devices becomes a mesh of ranks.  Functions,
so that importing this module touches no process group.  The rules of
launch/sharding.py need only each axis's name and size, which
``mesh_axes`` reads from a ``DeviceMesh`` or takes as a dict, as JAX's rules
take an ``AbstractMesh``.
"""
from __future__ import annotations

import math
import os
from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_mesh_shape(multi_pod: bool = False) -> dict[str, int]:
    """The production mesh's axes and sizes: (16, 16) ``("data", "model")``,
    or (2, 16, 16) ``("pod", "data", "model")``."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over the default process group, which must have
    256 (or, ``multi_pod``, 512) ranks: JAX's ``make_mesh`` raises likewise
    without the devices."""
    axes = production_mesh_shape(multi_pod)
    need = math.prod(axes.values())
    if _world_size() != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, axes.values()))} production mesh needs a process group of {need} ranks, "
            f"found world size {_world_size()} (run under torchrun with {need} processes in all)")
    return init_device_mesh(device_type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of such a dict, returned as
    it is), in mesh-dim order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch dimension."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def make_data_mesh(n_shards: int, *, device_type: str = "cuda") -> DeviceMesh:
    """A 1-axis ``("data",)`` mesh over ranks 0..n_shards-1 of the default
    process group: one pool whose stream axis is ``Shard`` on it is split
    across those ranks (``launch.sharding.pool_shardings``).  Raises when the
    group has fewer ranks; ``shard_meshes`` is the host-local form."""
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    if _world_size() < n_shards:
        raise ValueError(f"a {n_shards}-shard data mesh needs {n_shards} ranks, "
                         f"the process group has {_world_size()}")
    return DeviceMesh(device_type, torch.arange(n_shards), mesh_dim_names=("data",))


def shard_meshes(n_shards: int, devices) -> list[torch.device]:
    """One device per shard, cycling ``devices``: a device type (``"cuda"``:
    every CUDA device of the host, and it raises when there is none;
    ``"cpu"``: the CPU) or a sequence of devices.  The caller names it (the
    engine's device, or the launcher's ``--device``): nothing falls back to
    the CPU.  JAX's ``shard_meshes`` cycles the local devices the same way."""
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    if devices == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("shards on cuda, but torch.cuda.is_available() is false or no device is "
                               "visible; name the cpu to serve the plain versions")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif devices == "cpu":
        devices = [torch.device("cpu")]
    elif isinstance(devices, str):
        raise ValueError(f"shards live on cuda or cpu, not {devices!r} (or name a sequence of devices)")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no device to place the shards on")
    return [devices[i % len(devices)] for i in range(n_shards)]


def rank_shard(device_type: str, group=None) -> tuple[int, torch.device]:
    """This process's shard of a sharded engine with one shard a rank: its
    shard id is its rank in ``group`` (the default process group when None)
    and its device ``shard_meshes``' for its node-local rank (``LOCAL_RANK``,
    which ``torchrun`` sets; the group rank without it), so ranks cycle the
    host's cards as JAX's shards cycle its devices: ``cuda:(LOCAL_RANK %
    device_count)``, or the CPU for ``device_type`` ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("a shard a rank needs an initialised process group (run under torchrun, or call "
                           "torch.distributed.init_process_group first)")
    rank = dist.get_rank(group)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return rank, shard_meshes(local + 1, device_type)[local]


@dataclass(frozen=True)
class DataRows:
    """This rank's place in a pool split over a data mesh: its index
    ``rank`` of ``n`` on the ``"data"`` axis, its stream rows [lo, hi) and
    the axis's process group, whose backend (the mesh's device type) carries
    the exchanges."""

    rank: int
    n: int
    lo: int
    hi: int
    group: object


def data_rows(mesh: DeviceMesh, n_slots: int) -> DataRows:
    """The rows of an ``n_slots``-row pool that this rank holds on ``mesh``,
    a ``DeviceMesh`` with a ``"data"`` axis: rank r of n takes rows
    [r b, (r + 1) b), b = n_slots / n, as JAX's ``NamedSharding`` of the
    stream axis over ``make_data_mesh(n)`` splits it.  ``n_slots`` must
    divide the axis (``launch.sharding.pad_slots``).  Any other axis of
    size > 1 raises: JAX's ``pool_specs`` replicates the pool over it, but
    no JAX caller builds such a mesh, and serving from one is ROADMAP queue
    1 item 18."""
    axes = mesh_axes(mesh)
    if "data" not in axes:
        raise ValueError(f"a pool splits over a mesh with a 'data' axis, got axes {axes}")
    other = {name: size for name, size in axes.items() if name != "data" and size > 1}
    if other:
        raise NotImplementedError(f"one pool over a data mesh with another axis of size > 1 ({other}) is not "
                                  f"served (ROADMAP queue 1 item 18): give the engine a 1-axis data mesh "
                                  f"(make_data_mesh)")
    n = axes["data"]
    if n_slots % n:
        raise ValueError(f"KV-pool stream axis of size {n_slots} does not divide the mesh data axis ({n}): "
                         f"pad n_slots with launch.sharding.pad_slots() instead of replicating a pool shard")
    b = n_slots // n
    r = mesh.get_local_rank("data")
    return DataRows(r, n, r * b, (r + 1) * b, mesh.get_group("data"))
