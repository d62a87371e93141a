"""Device meshes over the ranks of a process group.

Counterpart of the JAX package's ``parallel/mesh.py``.  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks, one card (or
CPU process) a rank.  The fleet and the train step shard their batch axis
over the mesh's ``data`` axis: a rank's block of a batch of ``B`` is rows
``[rank * B / W, (rank + 1) * B / W)``, the layout of JAX's
``NamedSharding(mesh, P("data"))`` in device order; everything else is
replicated.

A mesh needs an initialised process group (`distributed.initialize`, or a
launcher's ``init_process_group``): `make_mesh` raises without one.  The
entry points that take ``mesh=None`` run the whole batch in the calling
process then, as on one card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def mesh_shape(n: int, n_axes: int = 1) -> tuple[int, ...]:
    """The shape JAX's ``make_mesh`` folds ``n`` devices into: ``(n,)`` for
    one axis, a near-square ``(a, n // a)`` grid for ``('data', 'model')``-
    style axes (``a`` the largest divisor of ``n`` at most ``gcd(n,
    floor(sqrt(n)))``)."""
    if n_axes == 1:
        return (n,)
    a = math.gcd(n, math.isqrt(n) or 1) or 1
    while n % a:
        a -= 1
    return (a, n // a)


def make_mesh(n_devices: int | None = None, axis_names: tuple[str, ...] = ("data",), device_type: str | None = None):
    """A mesh over the first ``n_devices`` ranks (all of them by default),
    folded as JAX folds its devices (`mesh_shape`).  ``device_type``
    defaults to ``cuda`` on an NCCL group and ``cpu`` otherwise; gloo ranks
    that hold CUDA tensors pass ``"cuda"``.  Raises RuntimeError without an
    initialised process group."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call "
                           "icp_slam_yolo_tpu_torch.parallel.distributed.initialize() first (under torchrun it reads "
                           "the launcher's variables); without a group, pass mesh=None to run in this process alone")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world or len(axis_names) > 2:
        raise ValueError(f"a mesh of {n} ranks over axes {axis_names} in a group of {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n, dtype=torch.int).reshape(mesh_shape(n, len(axis_names)))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh, axis: str = "data") -> list:
    """Axis 0 sharded over ``axis``, replicated over the others: the
    placements of JAX's ``NamedSharding(mesh, P(axis))``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh) -> list:
    """Every mesh axis replicated: JAX's ``NamedSharding(mesh, P())``."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def rank_block(n: int, mesh, axis: str = "data") -> slice:
    """This rank's rows of a batch axis of ``n`` sharded over ``axis``:
    ``[rank * n / W, (rank + 1) * n / W)``.  Raises ValueError when ``n``
    does not divide by ``W``, as JAX's sharding does."""
    w = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % w:
        raise ValueError(f"a batch of {n} does not divide over the {w} ranks of mesh axis {axis!r}")
    r = mesh.get_local_rank(axis)
    return slice(r * n // w, (r + 1) * n // w)


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh: its current card for a ``cuda``
    mesh, the CPU for a ``cpu`` one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
