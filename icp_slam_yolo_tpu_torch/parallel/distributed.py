"""Several processes: process start, the fleet's mesh over every rank, and
the collectives the port calls.

Counterpart of the JAX package's ``parallel/distributed.py``.  JAX runs one
process a host and one global mesh whose devices span the hosts; XLA then
inserts every collective from the sharding annotations.  Here the layout is
``torch.distributed``'s: one process a card (``torchrun --nproc-per-node
N``), NCCL between cards, gloo between CPU processes, and every collective
is written out.  The functions below are the only place the port calls one:

* `all_sum_`: a sum over the ranks (``all_reduce``), JAX's ``psum``;
* `all_concat`: a concatenation along axis 0 in rank order, JAX's tiled
  ``all_gather``;
* `global_sum`: `all_sum_` inside the autograd graph (its gradient is the
  sum over the ranks of the gradients), for the data-parallel train step's
  batch statistics and loss normalisers (`data_parallel`).

gloo takes tensors in host memory.  A CUDA tensor given to a gloo group
crosses through host memory here, explicitly: it is copied to the host
(which waits for the card), reduced or gathered there, and copied back to
its card, where the compute stays.  NCCL takes it where it is, on the
current stream.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch
import torch.distributed as dist

from icp_slam_yolo_tpu_torch.device import resolve_device


def initialize(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None,
               backend: str | None = None, device=None) -> torch.device | None:
    """Join the process group when one is configured; a no-op otherwise.

    Reads torchrun's variables where an argument is not given:
    ``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator ``host:port``; a
    ``tcp://`` or ``file://`` URL is taken as it is), ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK``.  Without a coordinator it does nothing and
    returns None, as JAX's does on a single host.

    ``device`` is this rank's device; None means its card: ``cuda:
    LOCAL_RANK`` (or the process id modulo the host's cards), made the
    current device, so that later ``device=None`` calls land on it.  The
    backend is NCCL for a CUDA device and gloo for the CPU; ``backend=``
    overrides it (two gloo ranks may share one card, which NCCL refuses).
    The backend is never changed on the caller's behalf: when NCCL fails to
    start, the run fails.  Returns this rank's device."""
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if not coordinator:
        return None
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    if device is None:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), init_method=url,
                            world_size=world, rank=rank)
    return device


def global_fleet_mesh(axis_name: str = "data"):
    """A 1-D mesh over every rank of the job (all hosts): the fleet's batch
    axis shards over it, each rank taking its block (`mesh.rank_block`)."""
    from icp_slam_yolo_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axis_names=(axis_name,))


def process_count() -> int:
    """The number of ranks: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_local_batch_size(global_batch: int) -> int:
    """This rank's share of a global batch (the same on every rank)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def _via_host(t: torch.Tensor, group) -> bool:
    """gloo reduces and gathers in host memory: a CUDA tensor crosses there."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place; returns ``t``.
    Every rank gets the same bits."""
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


def all_concat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated along axis 0
    in rank order: JAX's ``all_gather(..., tiled=True)``."""
    if _via_host(t, group):
        return all_concat(t.cpu(), group).to(t.device)
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


# ------------------------------------------------------------ data parallel

_DATA_PARALLEL = contextvars.ContextVar("data_parallel_group", default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Inside, train-mode BatchNorm (`models.yolo.batch_norm_train`) and the
    losses (`models.losses`) take their batch statistics and normalisers
    over the global batch of ``group``'s ranks; ``group=None`` leaves them
    per process, as outside."""
    token = _DATA_PARALLEL.set(group)
    try:
        yield
    finally:
        _DATA_PARALLEL.reset(token)


def data_parallel_group():
    """The group of the enclosing `data_parallel`, or None."""
    return _DATA_PARALLEL.get()


class _SumOverRanks(torch.autograd.Function):
    """`all_sum_` in the autograd graph: the gradient of a sum over the
    ranks is the sum over the ranks of the gradients.  (Not
    ``torch.distributed.nn.functional.all_reduce``: for a CUDA tensor on a
    gloo group it would run on a host tensor, an autograd node of the CPU
    thread, whose order against the other ranks' would follow the card's
    timing; a node on the card's tensors keeps the backward's collectives
    in one order on every rank.)"""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_sum_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_sum_(grad.clone(), ctx.group), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the enclosing `data_parallel` group,
    with its gradient; ``t`` itself outside one."""
    group = _DATA_PARALLEL.get()
    return t if group is None else _SumOverRanks.apply(t, group)
