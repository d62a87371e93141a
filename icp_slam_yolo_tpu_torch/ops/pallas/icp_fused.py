"""K1: the whole gated point-to-point ICP loop in one kernel, for ``B``
independent registrations (the fleet's robot axis) in one launch.

Counterpart of the JAX package's ``icp_fused_pallas`` and its batched core
``_fused_batched`` (``ops/pallas/icp_fused.py``).  The CUDA kernel is
``csrc/icp.cu``: one launch in which each registration has its own blocks
(`icp_plan` says how many and how they meet), its targets held in their shared
memory for the whole launch, one barrier among them an iteration, and its own
end at its convergence (`layouts` lists those that fit); its source says what
bounds it and how it is laid out.  A registration's result does not depend on the plan or on the others in
its launch: the kernel gives the same bits for it alone.

Both versions work per registration in the frame recentred on the
valid-target centroid (the moments are accumulated uncentred in f32, so this
keeps them well conditioned; the centroid is summed in float64) and carry the
rotation as (cos, sin).  The kernel recentres, and maps its result back,
inside its one launch; the plain version takes the problem recentred by
`_prepare` and returns ``(B, 8)`` rows ``[tx, ty, cos, sin, rmse,
n_inliers, n_iters, 0]`` (rmse ``1e30`` when no inlier survives) for
`_finish`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib
from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin_plain

_BIG = 1e30
MIN_TARGETS = 64  # valid targets a block keeps at least, so a slice is worth its barrier arrival
ROWS_A_PASS = 128  # live rows a block sweeps at once (csrc/icp.cu kRowsPass)
MAX_ROW_GROUPS = 4
MAX_CLUSTER = 16  # blocks of a thread-block cluster (16 is the card's non-portable size)
CLUSTER_FROM = 16  # registrations from which each gets one cluster in place of a share of the grid
CLUSTER = ((2, 8), (2, 4), (1, 4), (1, 2))  # (row runs, target runs) of a cluster, the first that fits
KEY_BUFFERS = 3  # csrc/icp.cu rotates the per-row keys over three buffers
BAR_WORDS = 32  # barrier words per registration in csrc/icp.cu


class Card(NamedTuple):
    """What the plan needs to know of a card for K1."""
    sms: int
    blocks_per_sm: Callable[[int], int]  # K1 blocks a multiprocessor holds with this much dynamic shared memory
    clusters: Callable[[int, int], int]  # clusters of this many such blocks the card runs at once


class IcpPlan(NamedTuple):
    row_groups: int  # a registration's live rows split into this many runs
    slices: int  # its valid targets split into this many runs
    cluster: bool  # its row_groups x slices blocks are one thread-block cluster
    smem: int  # dynamic shared memory a block takes (bytes)


def smem_bytes(s: int, t: int, slices: int) -> int:
    """Dynamic shared memory of a K1 block (``csrc/icp.cu`` `smem_bytes`):
    the sources and live-row list (12 bytes a row) and the block's share of
    the targets with their indices (12 bytes a target)."""
    return 12 * (s + max(1, -(-t // slices)))


def plan_fits(b: int, s: int, t: int, card: Card, row_groups: int, slices: int, cluster: bool) -> bool:
    """Whether the layout launches: in the grid layout every block of the
    ``b`` registrations must be resident at once (the barriers need it); in
    the cluster layout one registration's blocks must fit as a cluster."""
    smem = smem_bytes(s, t, slices)
    if cluster:
        return row_groups * slices <= MAX_CLUSTER and card.clusters(row_groups * slices, smem) > 0
    per_sm = card.blocks_per_sm(smem)
    return per_sm > 0 and b * row_groups * slices <= card.sms * per_sm


def layouts(b: int, s: int, t: int, card: Card) -> tuple[IcpPlan, ...]:
    """The layouts of ``b`` registrations of ``s`` source and ``t`` target
    slots that fit on ``card`` (`plan_fits`), as `icp_plan` prefers them:
    the cluster layouts (`CLUSTER`), taking the card in turn as
    registrations finish; then the grid layouts, about two blocks a
    multiprocessor shared out (one, for a single registration: more only add
    barrier arrivals and key atomics), then fewer, each registration's live
    rows in runs of at most `ROWS_A_PASS` where its blocks allow (one sweep
    pass a block), its targets in runs of at least `MIN_TARGETS`."""
    most_slices = max(1, -(-t // MIN_TARGETS))
    plans = [(rg, min(sl, most_slices), True) for rg, sl in CLUSTER]
    goal = max(1, min(card.sms, 2 * card.sms // b))
    for bpr in range(goal, 0, -1):
        most_groups = max(1, min(bpr, MAX_ROW_GROUPS, -(-s // ROWS_A_PASS)))
        plans += [(rg, min(bpr // rg, most_slices), False) for rg in (4, 2, 1) if rg <= most_groups]
    return tuple(IcpPlan(rg, sl, cl, smem_bytes(s, t, sl)) for rg, sl, cl in dict.fromkeys(plans)
                 if plan_fits(b, s, t, card, rg, sl, cl))


def icp_plan(b: int, s: int, t: int, card: Card) -> IcpPlan:
    """How ``b`` registrations share the card: the first of `layouts` from
    `CLUSTER_FROM` on, else the first grid layout; raises if none fits."""
    plan = next((p for p in layouts(b, s, t, card) if b >= CLUSTER_FROM or not p.cluster), None)
    if plan is None:
        raise ValueError(f"icp_plan: {b} registrations of {t} targets do not fit in the card's shared memory "
                         "(each needs at least one resident block)")
    return plan


@functools.lru_cache(maxsize=None)
def _card_blocks_per_sm(smem: int) -> int:
    out = ctypes.c_int(0)
    _lib.check(_lib.lib().slam_icp_blocks_per_sm(smem, ctypes.byref(out)), "icp_fused occupancy")
    return out.value


@functools.lru_cache(maxsize=None)
def _card_clusters(blocks: int, smem: int) -> int:
    out = ctypes.c_int(0)
    _lib.check(_lib.lib().slam_icp_clusters(blocks, smem, ctypes.byref(out)), "icp_fused cluster occupancy")
    return out.value


def card(dev) -> Card:
    """The card a CUDA tensor is on, as the plan sees it (the CUDA occupancy
    calculator)."""
    return Card(_lib.sm_count(dev), _card_blocks_per_sm, _card_clusters)


@functools.lru_cache(maxsize=None)
def card_plan(b: int, s: int, t: int, dev) -> IcpPlan:
    """`icp_plan` on the card of ``dev`` (cached: a step asks the same each
    time)."""
    return icp_plan(b, s, t, card(dev))


def _prepare(tgt_xy, tgt_valid, init_pose):
    """Recentre each registration on its valid-target centroid: ``(params
    (B, 4) [x, y, cos, sin], recentred targets (B, T, 2), centroids (B, 2))``
    (the kernel does the same inside its launch)."""
    # summed in float64: the rounded centroid, and with it the whole
    # registration, must not depend on how the reduction is split, which
    # changes with the number of registrations in the call
    tvf = tgt_valid.to(torch.float64)
    n_valid = torch.clamp(tvf.sum(-1, keepdim=True), min=1.0)
    c = ((tgt_xy * tvf[..., None]).sum(-2) / n_valid).to(torch.float32)
    params = torch.stack([
        init_pose[..., 0] - c[..., 0], init_pose[..., 1] - c[..., 1],
        torch.cos(init_pose[..., 2]), torch.sin(init_pose[..., 2]),
    ], dim=-1).contiguous()
    return params, (tgt_xy - c[..., None, :]).contiguous(), c


def _finish(out, c):
    theta = torch.atan2(out[..., 3], out[..., 2])
    pose = torch.stack([out[..., 0] + c[..., 0], out[..., 1] + c[..., 1], theta], dim=-1)
    rmse = torch.where(out[..., 4] >= _BIG, torch.full_like(out[..., 4], float("inf")), out[..., 4])
    return pose, rmse, out[..., 5].to(torch.int32), out[..., 6].to(torch.int32)


def icp_fused_plain(src_xy, src_valid, tgt_xy, tgt_valid, params, *, iters: int,
                    thr2: float, tolerance: float, anderson: bool) -> torch.Tensor:
    """Plain version of the kernel's loop on recentred problems: ``(B, S, 2),
    (B, S), (B, T, 2), (B, T), (B, 4) -> (B, 8)``.

    Freezes each registration's pose once it has converged (the kernel
    stops there instead; the results are the same).  On the card it runs all
    ``iters`` iterations over every target slot, so no step needs a host
    read.  On the CPU, where a read costs nothing, it first packs the valid
    targets to the front in their order (the nearest valid target, first on
    ties, is the same point) and stops once every registration has
    converged; both give the same bits (`tests/test_torch_ops.py`).
    """
    on_cpu = tgt_valid.device.type == "cpu"
    if on_cpu:
        n_live = max(int(tgt_valid.sum(-1).max()), 1)
        order = torch.sort((~tgt_valid).to(torch.int8), dim=-1, stable=True).indices[:, :n_live]
        tgt_xy = torch.gather(tgt_xy, 1, order[..., None].expand(-1, -1, 2))
        tgt_valid = torch.gather(tgt_valid, 1, order)
    return _plain_loop(src_xy, src_valid, tgt_xy, tgt_valid, params, iters=iters, thr2=thr2,
                       tolerance=tolerance, anderson=anderson, stop_when_done=on_cpu)


def _plain_loop(src_xy, src_valid, tgt_xy, tgt_valid, params, *, iters: int, thr2: float,
                tolerance: float, anderson: bool, stop_when_done: bool) -> torch.Tensor:
    """`icp_fused_plain`'s loop on the targets as given; ``stop_when_done``
    ends it (one host read an iteration) once every registration has
    converged."""
    sx, sy = src_xy[..., 0], src_xy[..., 1]
    tx, ty = tgt_xy[..., 0], tgt_xy[..., 1]

    def correspond(cth, sth, ptx, pty):
        px = cth[:, None] * sx - sth[:, None] * sy + ptx[:, None]
        py = sth[:, None] * sx + cth[:, None] * sy + pty[:, None]
        d2, idx = nn_argmin_plain(torch.stack([px, py], -1), tgt_xy, tgt_valid)
        w = src_valid & (d2 < thr2)
        return px, py, w, d2, torch.gather(tx, 1, idx.long()), torch.gather(ty, 1, idx.long())

    def wsum(w, v):
        return torch.where(w, v, torch.zeros_like(v)).sum(-1)

    ptx, pty, cth, sth = params.unbind(-1)
    zero = torch.zeros_like(ptx)
    prev_err = zero + _BIG
    done = torch.zeros_like(ptx, dtype=torch.bool)
    n_iters = zero
    pf = [zero] * 4
    pg = [ptx, pty, cth, sth]
    have_prev = done
    for _ in range(iters):
        px, py, w, d2, mx, my = correspond(cth, sth, ptx, pty)
        pxm, pym, mxm, mym = px * 1e-3, py * 1e-3, mx * 1e-3, my * 1e-3
        m = [
            wsum(w, torch.ones_like(px)), wsum(w, pxm), wsum(w, pym), wsum(w, mxm), wsum(w, mym),
            wsum(w, pxm * mxm + pym * mym), wsum(w, pxm * mym - pym * mxm), wsum(w, torch.sqrt(d2)),
        ]
        sw = m[0]
        safe = torch.clamp(sw, min=1e-9)
        cax, cay, cbx, cby = m[1] / safe, m[2] / safe, m[3] / safe, m[4] / safe
        sxx = m[5] - (m[1] * m[3] + m[2] * m[4]) / safe
        sxy = m[6] - (m[1] * m[4] - m[2] * m[3]) / safe
        degenerate = (sw < 1e-6) | (sxx * sxx + sxy * sxy < 1e-30)
        r = torch.sqrt(sxx * sxx + sxy * sxy)
        safe_r = torch.clamp(r, min=1e-30)
        c2 = torch.where(degenerate, zero + 1.0, sxx / safe_r)
        s2 = torch.where(degenerate, zero, sxy / safe_r)
        dtx = torch.where(degenerate, zero, (cbx - (c2 * cax - s2 * cay)) * 1e3)
        dty = torch.where(degenerate, zero, (cby - (s2 * cax + c2 * cay)) * 1e3)
        nc = c2 * cth - s2 * sth
        ns = s2 * cth + c2 * sth
        rn = 1.0 / torch.sqrt(nc * nc + ns * ns)
        nc, ns = nc * rn, ns * rn
        ntx = c2 * ptx - s2 * pty + dtx
        nty = s2 * ptx + c2 * pty + dty
        err = m[7] / torch.clamp(sw, min=1.0)
        converged = torch.abs(prev_err - err) < tolerance
        new_done = done | converged
        if anderson:
            # Anderson(1) on the pose fixed point, as in the kernel
            f = [ntx - ptx, nty - pty, 1000.0 * (nc - cth), 1000.0 * (ns - sth)]
            d = [fi - pfi for fi, pfi in zip(f, pf)]
            den = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3]
            num = f[0] * d[0] + f[1] * d[1] + f[2] * d[2] + f[3] * d[3]
            gamma = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), zero)
            gamma = torch.clamp(gamma, -9.0, 0.0)
            fn = f[0] * f[0] + f[1] * f[1] + f[2] * f[2] + f[3] * f[3]
            pfn = pf[0] * pf[0] + pf[1] * pf[1] + pf[2] * pf[2] + pf[3] * pf[3]
            gamma = torch.where(have_prev & (fn <= pfn), gamma, zero)
            plain = [ntx, nty, nc, ns]
            acc = [p - gamma * (p - q) for p, q in zip(plain, pg)]
            arn = 1.0 / torch.sqrt(torch.clamp(acc[2] * acc[2] + acc[3] * acc[3], min=1e-12))
            acc[2], acc[3] = acc[2] * arn, acc[3] * arn
            pf = [torch.where(done, a, b) for a, b in zip(pf, f)]
            pg = [torch.where(done, a, b) for a, b in zip(pg, plain)]
            have_prev = have_prev | ~done
            ntx, nty, nc, ns = acc
        cth = torch.where(done, cth, nc)
        sth = torch.where(done, sth, ns)
        ptx = torch.where(done, ptx, ntx)
        pty = torch.where(done, pty, nty)
        n_iters = n_iters + torch.where(done, zero, zero + 1.0)
        prev_err, done = err, new_done
        if stop_when_done and bool(done.all()):
            break

    _, _, w, d2, _, _ = correspond(cth, sth, ptx, pty)
    n_in = wsum(w, torch.ones_like(d2))
    rmse = torch.where(n_in > 0, torch.sqrt(wsum(w, d2) / torch.clamp(n_in, min=1.0)), zero + _BIG)
    return torch.stack([ptx, pty, cth, sth, rmse, n_in, n_iters, zero], dim=-1)


def icp_fused(src_xy, src_valid, tgt_xy, tgt_valid, init_pose, *, iters: int = 50,
              threshold_mm: float = 200.0, tolerance: float = 1e-5, anderson: bool = False,
              plan: IcpPlan | None = None):
    """Gated point-to-point ICP of ``src`` onto ``tgt`` from ``init_pose``.

    ``(B, S, 2) f32, (B, S) bool, (B, T, 2) f32, (B, T) bool, (B, 3) f32`` ->
    ``(pose (B, 3), rmse (B,), n_inliers (B,) int32, n_iters (B,) int32)``,
    rmse ``inf`` with no inlier; ``B`` registrations in ONE launch, each
    ending at its own convergence.  Degenerate inputs (too few points) are
    the caller's job.
    Launches the CUDA kernel for CUDA tensors, in ``plan`` (one that
    `plan_fits` on the card, as every one of `layouts` does; ``None``:
    `icp_plan`'s); the plain version runs only for CPU tensors.
    """
    dev = src_xy.device
    b, s, t = src_xy.shape[0], src_xy.shape[1], tgt_xy.shape[-2]
    pallas.check_tensor(src_xy, "src_xy", torch.float32, (b, s, 2), dev)
    pallas.check_tensor(src_valid, "src_valid", torch.bool, (b, s), dev)
    pallas.check_tensor(tgt_xy, "tgt_xy", torch.float32, (b, t, 2), dev)
    pallas.check_tensor(tgt_valid, "tgt_valid", torch.bool, (b, t), dev)
    pallas.check_tensor(init_pose, "init_pose", torch.float32, (b, 3), dev)
    thr2 = float(threshold_mm) ** 2
    if dev.type == "cpu":
        params, tgt_c, c = _prepare(tgt_xy, tgt_valid, init_pose)
        out = icp_fused_plain(src_xy, src_valid, tgt_c, tgt_valid, params, iters=int(iters),
                              thr2=thr2, tolerance=float(tolerance), anderson=bool(anderson))
        return _finish(out, c)
    if dev.type != "cuda":
        raise ValueError(f"icp_fused: unsupported device {dev}")
    if plan is None:
        plan = card_plan(b, s, t, dev)
    elif not plan_fits(b, s, t, card(dev), plan.row_groups, plan.slices, plan.cluster):
        raise ValueError(f"icp_fused: {b} registrations x {plan.row_groups} x {plan.slices} blocks (cluster "
                         f"{plan.cluster}) do not fit on the card")
    keys = torch.empty((KEY_BUFFERS, b, s), dtype=torch.int64, device=dev)
    bar = torch.empty((b, BAR_WORDS), dtype=torch.int32, device=dev)
    centre = torch.empty((b, 4), dtype=torch.float32, device=dev)
    pose = torch.empty((b, 3), dtype=torch.float32, device=dev)
    rmse = torch.empty(b, dtype=torch.float32, device=dev)
    n_in = torch.empty(b, dtype=torch.int32, device=dev)
    n_iters = torch.empty(b, dtype=torch.int32, device=dev)
    err = _lib.lib().slam_icp_fused(
        src_xy.data_ptr(), src_valid.data_ptr(), b, s, tgt_xy.data_ptr(), tgt_valid.data_ptr(), t,
        init_pose.data_ptr(), int(iters), thr2, float(tolerance), int(bool(anderson)),
        plan.row_groups, plan.slices, int(plan.cluster), keys.data_ptr(), bar.data_ptr(), centre.data_ptr(),
        pose.data_ptr(), rmse.data_ptr(), n_in.data_ptr(), n_iters.data_ptr(), _lib.stream_ptr(dev),
    )
    _lib.check(err, "icp_fused")
    pallas.LAUNCHES["icp_fused"] += 1
    return pose, rmse, n_in, n_iters
