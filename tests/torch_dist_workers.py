"""Ranks for the port's multi-process tests: spawned CPU processes in one
gloo group, and the work they run.

This module imports only torch, numpy and the port (never JAX, never a test
module), since every rank imports it anew.  pytest does not collect it (its
name does not start with ``test_``).  Rules the tests keep:

* ranks start with the ``spawn`` method and join their group through a
  ``FileStore`` in the test's temporary directory (``file://``), never a
  fixed TCP port: several test files run in parallel;
* each rank runs on one thread (``torch.set_num_threads(1)``);
* every wait has a timeout; a rank that does not answer in time has the
  ranks killed, so a hang fails one test and not the suite (an error that
  every rank reports is raised in the test and leaves the ranks running).
"""

from __future__ import annotations

import hashlib
import multiprocessing
import queue
import time
import traceback

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.parallel import distributed, mesh as pmesh


class Ranks:
    """``world`` spawned processes in one gloo group (`distributed.
    initialize` on the CPU), each serving tasks: `run` calls one function
    of this module on every rank and returns the results in rank order
    (`submit`, then `collect`)."""

    def __init__(self, world: int, store_dir, timeout: float = 120.0):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, world, f"file://{store_dir}/store", self.tasks[r],
                                                       self.results), daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        self.submit(fn, *args)
        return self.collect(fn)

    def submit(self, fn, *args) -> None:
        """Start ``fn(*args)`` on every rank; `collect` waits for it (the
        test may compute its references meanwhile)."""
        for q in self.tasks:
            q.put((fn.__name__, args))

    def collect(self, fn) -> list:
        """The results of the task `submit` started, in rank order."""
        deadline = time.monotonic() + self.timeout
        got, failed = {}, {}
        while len(got) + len(failed) < self.world:
            try:
                rank, ok, value = self.results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                self.close()  # a rank waits in a collective that will not complete
                missing = sorted(set(range(self.world)) - set(got) - set(failed))
                raise TimeoutError(f"{fn.__name__}: ranks {missing} did not answer; failed: {failed}")
            if ok:
                got[rank] = value
            else:
                failed[rank] = value
                deadline = min(deadline, time.monotonic() + 15.0)  # the others answer soon or hang
        if failed:  # every rank answered: the group is still usable
            raise RuntimeError(f"{fn.__name__} failed on ranks {sorted(failed)}:\n" + "\n".join(failed.values()))
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _serve(rank: int, world: int, url: str, tasks, results) -> None:
    torch.set_num_threads(1)
    distributed.initialize(url, world, rank, device="cpu")
    try:
        while (task := tasks.get()) is not None:
            name, args = task
            try:
                results.put((rank, True, globals()[name](*args)))
            except Exception:  # reported to the test, which kills the ranks
                results.put((rank, False, traceback.format_exc()))
    finally:
        torch.distributed.destroy_process_group()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def digest(*tensors: torch.Tensor) -> str:
    """The bytes of ``tensors``, hashed: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(_np(t).tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ tasks

def collectives() -> dict:
    """The helpers on this rank: a sum and a concatenation of the rank ids,
    the per-process batch, the mesh's shapes, placements and blocks."""
    rank = torch.distributed.get_rank()
    total = distributed.all_sum_(torch.tensor([float(rank), 1.0]))
    ids = distributed.all_concat(torch.tensor([[rank, 10 * rank]], dtype=torch.int32))
    try:
        distributed.process_local_batch_size(10)
        refused = False
    except ValueError:
        refused = True
    one, two = pmesh.make_mesh(), pmesh.make_mesh(axis_names=("data", "model"))
    with distributed.data_parallel(one.get_group("data")):
        x = torch.tensor([float(rank + 1)], requires_grad=True)
        y = distributed.global_sum(x * x)
        (y / torch.distributed.get_world_size()).backward()  # this rank's share of the sum
    return {"rank": rank, "sum": total.tolist(), "ids": ids.tolist(), "batch16": distributed.process_local_batch_size(16),
            "batch10_refused": refused, "shape1": tuple(one.mesh.shape), "shape2": tuple(two.mesh.shape),
            "dims2": two.mesh_dim_names, "block8": pmesh.rank_block(8, one), "sharding": str(pmesh.batch_sharding(two)),
            "replicated": str(pmesh.replicated(two)), "grad": float(x.grad), "global": float(y.detach())}


def fleet(stack: np.ndarray, cfg, n_stat_steps: int) -> dict:
    """`fleet_run_sharded` over a mesh of every rank, then ``n_stat_steps``
    steps of `make_fleet_step(cfg, mesh)` on the rank's block: its outputs
    and the global statistics."""
    from icp_slam_yolo_tpu_torch.parallel import fleet as pfleet

    mesh = pmesh.make_mesh()
    states, outs = pfleet.fleet_run_sharded(stack, cfg, mesh=mesh)
    block = torch.from_numpy(stack[pmesh.rank_block(stack.shape[0], mesh)])
    step = pfleet.make_fleet_step(cfg, mesh)
    st = pfleet.fleet_init(block[:, 0], cfg)
    stats = []
    for t in range(1, n_stat_steps + 1):
        st, _, s = step(st, block[:, t], t - 1)
        stats.append({k: float(v) for k, v in s.items()})
    return {"states": {k: _np(v) for k, v in states._asdict().items()},
            "outs": {k: _np(v) for k, v in outs._asdict().items()}, "stats": stats}


def shared(stack: np.ndarray, cfg, entry_point: bool) -> dict:
    """The shared map over a mesh of every rank, step by step as
    `shared_fleet_run` runs it, with a digest of the replicated map and
    grid after the seed and after every step; then, with ``entry_point``,
    `shared_fleet_run` itself, which must give the same."""
    from icp_slam_yolo_tpu_torch.parallel import shared as pshared

    mesh = pmesh.make_mesh()
    block = torch.from_numpy(stack[pmesh.rank_block(stack.shape[0], mesh)])
    step = pshared.make_shared_step(cfg, mesh)
    state = pshared.shared_init(block[:, 0], cfg, mesh)
    digests = [digest(state.map_xy, state.map_valid, state.occ)]
    outs = []
    for t in range(1, block.shape[1]):
        state, out = step(state, block[:, t], t - 1)
        digests.append(digest(state.map_xy, state.map_valid, state.occ))
        outs.append(out)
    pose, rmse, acc = (torch.stack(f, dim=1) for f in zip(*outs))
    same = None
    if entry_point:
        run = pshared.shared_fleet_run(stack, cfg, device="cpu", mesh=mesh)
        same = all(torch.equal(a, b) for a, b in zip((state.map_xy, state.map_valid, state.occ, state.pose, pose, rmse,
                                                      acc), (*run[:4], *run[4])))
    return {"digests": digests, "entry_point_same": same, "map_xy": _np(state.map_xy),
            "map_valid": _np(state.map_valid), "occ": _np(state.occ), "poses": _np(state.pose),
            "pose": _np(pose), "rmse": _np(rmse), "accepted": _np(acc)}


def train_step(family: str, task: str, state_dict: dict, batch: dict, steps: int) -> dict:
    """``steps`` data-parallel float64 train steps over a mesh of every
    rank, from ``state_dict``, each rank on its block of ``batch``: the
    metrics of each step and the parameters and buffers after each."""
    from icp_slam_yolo_tpu_torch.models import train as ttrain
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    mesh = pmesh.make_mesh()
    model = YOLO(num_classes=1, family=family, task=task, compute_dtype=torch.float64)
    model.load_state_dict(state_dict)
    model.double()
    state = ttrain.TrainState(model, ttrain.make_optimizer(model, total_steps=steps))
    step = ttrain.make_train_step(model, state.optimizer, batch["images"].shape[1], mesh=mesh)
    rows = pmesh.rank_block(batch["images"].shape[0], mesh)
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    metrics, states = [], []
    for _ in range(steps):
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append({k: _np(v).copy() for k, v in model.state_dict().items()})
    return {"metrics": metrics, "states": states}


def dryrun(n: int) -> dict:
    from icp_slam_yolo_tpu_torch.models.train import dryrun_train_step

    return dryrun_train_step(n, device="cpu")
