"""K1: the whole gated point-to-point ICP loop in one kernel, for ``B``
independent registrations (the fleet's robot axis) in one launch.

Counterpart of the JAX package's ``icp_fused_pallas`` and its batched core
``_fused_batched`` (``ops/pallas/icp_fused.py``).  The CUDA kernel is
``csrc/icp.cu``: one cooperative launch whose blocks are shared out among the
registrations, share each iteration's nearest-neighbour sweep, and end each
registration on the device at its own convergence; its source says what
bounds it and how it is laid out.  A registration's result does not depend on
the others in its launch: the kernel gives the same bits for it alone.

Both versions work per registration in the frame recentred on the
valid-target centroid (the moments are accumulated uncentred in f32, so this
keeps them well conditioned) and carry the rotation as (cos, sin).  Output of
both, before `_finish`: ``(B, 8)`` rows ``[tx, ty, cos, sin, rmse, n_inliers,
n_iters, 0]`` with rmse ``1e30`` when no inlier survives.
"""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib
from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin_plain

_BIG = 1e30
_TILE = 256  # targets per work item in csrc/icp.cu (partials are per tile)


def _prepare(tgt_xy, tgt_valid, init_pose):
    """Recentre each registration on its valid-target centroid: ``(params
    (B, 4) [x, y, cos, sin], recentred targets (B, T, 2), centroids (B, 2))``."""
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

    Runs all ``iters`` iterations and freezes each registration's pose once
    it has converged (the kernel stops there instead; the results are the
    same), so no step needs a host read.
    """
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

    _, _, w, d2, _, _ = correspond(cth, sth, ptx, pty)
    n_in = wsum(w, torch.ones_like(d2))
    rmse = torch.where(n_in > 0, torch.sqrt(wsum(w, d2) / torch.clamp(n_in, min=1.0)), zero + _BIG)
    return torch.stack([ptx, pty, cth, sth, rmse, n_in, n_iters, zero], dim=-1)


def icp_fused(src_xy, src_valid, tgt_xy, tgt_valid, init_pose, *, iters: int = 50,
              threshold_mm: float = 200.0, tolerance: float = 1e-5, anderson: bool = False):
    """Gated point-to-point ICP of ``src`` onto ``tgt`` from ``init_pose``.

    ``(B, S, 2) f32, (B, S) bool, (B, T, 2) f32, (B, T) bool, (B, 3) f32`` ->
    ``(pose (B, 3), rmse (B,), n_inliers (B,) int32, n_iters (B,) int32)``,
    rmse ``inf`` with no inlier; ``B`` registrations in ONE launch, each
    ending at its own convergence.  Degenerate inputs (too few points) are
    the caller's job.
    Launches the CUDA kernel for CUDA tensors (and raises when ``B`` exceeds
    the blocks the card holds resident); the plain version runs only for CPU
    tensors.
    """
    dev = src_xy.device
    b, s, t = src_xy.shape[0], src_xy.shape[1], tgt_xy.shape[-2]
    pallas.check_tensor(src_xy, "src_xy", torch.float32, (b, s, 2), dev)
    pallas.check_tensor(src_valid, "src_valid", torch.bool, (b, s), dev)
    pallas.check_tensor(tgt_xy, "tgt_xy", torch.float32, (b, t, 2), dev)
    pallas.check_tensor(tgt_valid, "tgt_valid", torch.bool, (b, t), dev)
    pallas.check_tensor(init_pose, "init_pose", torch.float32, (b, 3), dev)
    params, tgt_c, c = _prepare(tgt_xy, tgt_valid, init_pose)
    thr2 = float(threshold_mm) ** 2
    if dev.type == "cpu":
        out = icp_fused_plain(src_xy, src_valid, tgt_c, tgt_valid, params, iters=int(iters),
                              thr2=thr2, tolerance=float(tolerance), anderson=bool(anderson))
        return _finish(out, c)
    if dev.type != "cuda":
        raise ValueError(f"icp_fused: unsupported device {dev}")
    n_slices = -(-t // _TILE)
    part_d2 = torch.empty((b, n_slices, s), dtype=torch.float32, device=dev)
    part_idx = torch.empty((b, n_slices, s), dtype=torch.int32, device=dev)
    row_m = torch.empty((b, s, 8), dtype=torch.float32, device=dev)
    finishing = torch.empty(b, dtype=torch.int32, device=dev)
    out = torch.empty((b, 8), dtype=torch.float32, device=dev)
    err = _lib.lib().slam_icp_fused(
        src_xy.data_ptr(), src_valid.data_ptr(), b, s, tgt_c.data_ptr(), tgt_valid.data_ptr(), t,
        params.data_ptr(), int(iters), thr2, float(tolerance), int(bool(anderson)),
        part_d2.data_ptr(), part_idx.data_ptr(), row_m.data_ptr(), finishing.data_ptr(), out.data_ptr(), _lib.stream_ptr(dev),
    )
    _lib.check(err, "icp_fused")
    pallas.LAUNCHES["icp_fused"] += 1
    return _finish(out, c)
