"""The port's shared-map fleet (`parallel/shared.py`) against the JAX
package's, which runs one robot a device on a CPU mesh (`tests/conftest.py`
gives 8 host devices), its ICP and raster on their fused Pallas paths in
interpret mode (the kernels the port's K1 and K4 stand for).

Tolerances: the occupancy merge within 1e-6 (a ``psum`` may add in another
order than a sum over the robot axis); the replays with equal accept flags,
poses within 0.5 mm and 2e-4 rad, live map counts within 1 % and the grid
within 1e-4 on at least 99.9 % of its cells, except where a reading below
says why a case holds 99.5 %.

Why the port and JAX part by tenths of a millimetre: point-to-point ICP on
these scans has several exact fixed points a few hundredths of a millimetre
apart (correspondence sets that reproduce themselves), and which one a
registration ends in is decided by rounding along its path: the Pallas
kernel picks neighbours in Gram form and sums its moments in blocks of 64
rows, the port in difference form over the whole row, with a float64
centroid.  Fed the same inputs, the step-2 registration of the interleave
below ends 0.042 mm from JAX's in the port, and the port's loop started
from JAX's end stays there (both are fixed points).  The maps inherit the
split, so it grows over the steps, and a ray stops at its first blocked
cell, so a pose a few tenths of a millimetre off moves whole rays.  JAX's
own XLA path parts from its Pallas path the same way, by more.  Readings
(this module run as a script, see the end; CPU): the 2-robot interleave
over 11 steps, port against Pallas 0.33 mm and 0.9988 of the grid, Pallas
against XLA 4.2 mm and 0.9919; its first 5 steps (the
``local_map_capacity`` case), 0.17 mm and 0.9998 against 0.45 mm and
0.9966; the 4 depot robots over 4 steps, 0.32 mm and 0.9953 against 9.1
mm and 0.9935, and over 9 steps 12.0 mm against 29.3 mm.  So the
interleave holds 99.5 % of the grid over its 11 steps (its first 5 steps
hold 99.9 % in the ``local_map_capacity`` case) and the depot replay is
compared over its first 4 steps at 99.5 %: past them no two of these
engines stay within 0.5 mm.  The 4-robot and the ``local_map_capacity``
cases are in `test_torch_shared_depot.py`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import chip_smoke
from icp_slam_yolo_tpu import config as jcfg
from icp_slam_yolo_tpu.parallel.mesh import make_mesh
from icp_slam_yolo_tpu.parallel.shared import _merge_occupancy
from icp_slam_yolo_tpu.parallel.shared import shared_fleet_run as jax_shared_fleet_run
from icp_slam_yolo_tpu_torch import config as tcfg
from icp_slam_yolo_tpu_torch.parallel.shared import merge_occupancy, shared_fleet_run

torch.set_num_threads(2)


def _jax_merge(base: np.ndarray, per_robot: np.ndarray) -> np.ndarray:
    mesh = make_mesh(per_robot.shape[0])
    return np.asarray(shard_map(
        lambda b, pr: _merge_occupancy(b, pr[0], "data"),
        mesh=mesh, in_specs=(P(), P("data")), out_specs=P(), check_vma=False,
    )(jnp.asarray(base), jnp.asarray(per_robot)))


def _merge_cases():
    base = np.full((4, 8), 0.5, np.float32)
    disjoint = np.tile(base[None], (2, 1, 1))
    disjoint[0, 0, 0] = 0.45  # robot 0: free decay on (0, 0)
    disjoint[1, 1, 1] = 0.7   # robot 1: an endpoint hit on (1, 1)
    overlap = np.full((2, 2, 2), 0.5, np.float32)
    overlap[:, 0, 0] = 0.45   # both robots decay one cell by 0.9
    rng = np.random.default_rng(3)
    rbase = rng.uniform(0.0, 1.0, (33, 47)).astype(np.float32)
    rbase[0, :5] = 0.0  # below the clip
    rrob = np.clip(rbase[None] * rng.uniform(0.6, 1.4, (4, 33, 47)), 0.0, 1.0).astype(np.float32)
    return [("disjoint", base, disjoint), ("overlap", np.full((2, 2), 0.5, np.float32), overlap),
            ("random-4", rbase, rrob), ("random-2", rbase, rrob[:2])]


@pytest.mark.parametrize("case", range(4), ids=[c[0] for c in _merge_cases()])
def test_merge_occupancy_matches_jax(case):
    name, base, per_robot = _merge_cases()[case]
    ours = merge_occupancy(torch.from_numpy(base), torch.from_numpy(per_robot)).numpy()
    np.testing.assert_allclose(ours, _jax_merge(base, per_robot), atol=1e-6, rtol=0)
    if name == "disjoint":
        assert abs(ours[0, 0] - 0.45) < 1e-5 and abs(ours[1, 1] - 0.7) < 1e-5 and abs(ours[2, 2] - 0.5) < 1e-6
    if name == "overlap":
        assert abs(ours[0, 0] - 0.5 * 0.9 * 0.9) < 1e-5


def _interleaved(n_scans: int):
    """One seeded stream interleaved over two robots (even and odd scans)."""
    scans, _ = chip_smoke.padded_sequence(n_scans, 0, 512)
    a, b = scans[0::2], scans[1::2]
    t = min(len(a), len(b))
    return np.stack([a[:t], b[:t]])


def _fused(cfg):
    return cfg.replace(icp=dataclasses.replace(cfg.icp, backend="fused"),
                       occupancy=dataclasses.replace(cfg.occupancy, backend="fused"))


def _runs(stack: np.ndarray, jcfg_, tcfg_, backends=("fused",)) -> dict:
    """The port's run on the CPU and JAX's on a mesh of R devices, one for
    each ICP and raster backend named: name -> (map_xy, map_valid, occ,
    poses, SharedOutputs)."""
    out = {"port": shared_fleet_run(stack, tcfg_, device="cpu")}
    for backend in backends:
        cfg = jcfg_.replace(icp=dataclasses.replace(jcfg_.icp, backend=backend),
                            occupancy=dataclasses.replace(jcfg_.occupancy, backend=backend))
        out[backend] = jax_shared_fleet_run(jnp.asarray(stack), cfg, mesh=make_mesh(stack.shape[0]))
    return out


def _compare(stack: np.ndarray, jcfg_, tcfg_, grid_share: float = 0.999) -> None:
    runs = _runs(stack, jcfg_, tcfg_)
    check_against_jax(runs["port"], runs["fused"], stack, tcfg_, grid_share)


def check_against_jax(port, jax_run, stack: np.ndarray, tcfg_, grid_share: float) -> None:
    """The module's tolerances between a port run and JAX's, each ``(map_xy,
    map_valid, occ, poses, SharedOutputs)``."""
    m_xy, m_valid, occ, poses, outs = port
    jm_xy, jm_valid, jocc, jposes, jouts = jax_run

    jacc = np.asarray(jouts.accepted)
    assert outs.accepted.shape == jacc.shape == (stack.shape[0], stack.shape[1] - 1)
    assert jacc[:, 2:].mean() > 0.8  # the replay tracks: the comparison is not of two failures
    np.testing.assert_array_equal(outs.accepted.numpy(), jacc)
    d = np.abs(outs.pose.numpy() - np.asarray(jouts.pose))
    assert d[..., :2].max() <= 0.5 and d[..., 2].max() <= 2e-4, (d[..., :2].max(), d[..., 2].max())
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=0.5)
    fin = np.isfinite(np.asarray(jouts.rmse))
    np.testing.assert_array_equal(np.isfinite(outs.rmse.numpy()), fin)
    np.testing.assert_allclose(outs.rmse.numpy()[fin], np.asarray(jouts.rmse)[fin], atol=0.05)
    n, jn = int(m_valid.sum()), int(np.asarray(jm_valid).sum())
    assert abs(n - jn) <= 0.01 * jn, (n, jn)
    assert m_xy.shape == (tcfg_.map_capacity, 2)
    assert occ.shape == (tcfg_.map.height_px, tcfg_.map.width_px)
    close = np.abs(occ.numpy() - np.asarray(jocc)) <= 1e-4
    assert close.mean() >= grid_share, close.mean()
    o = occ.numpy()
    assert o.min() > 0.0 and o.max() <= 1.0 and (o < 0.3).any() and (o > 0.6).any()


def test_two_robots_interleaved_match_jax():
    """R = 2 on a 2-device mesh: one stream's even and odd scans (23), each
    robot relying on the map its peer built; `REALTIME_CONFIG` (GICP rescue
    on) with 4096 map slots; the maintenance (a prune around the fleet's
    mean position, the downsample) runs at step 10.  The grid on 99.5 % of
    its cells: the module's readings."""
    kw = dict(map_capacity=4096)
    _compare(_interleaved(24), jcfg.REALTIME_CONFIG.replace(**kw), tcfg.REALTIME_CONFIG.replace(**kw),
             grid_share=0.995)


def test_shared_run_takes_any_robot_count_and_refuses_one_scan():
    """The one-card layout has no mesh: R = 3 runs; a stream of one scan
    (nothing to process) is refused."""
    stack, _ = chip_smoke.depot_streams(3, 3, 512)
    cfg = tcfg.FLEET_CONFIG.replace(map_capacity=2048)
    out = shared_fleet_run(stack, cfg, device="cpu")
    assert out[4].pose.shape == (3, 2, 3) and out[3].shape == (3, 3)
    with pytest.raises(ValueError, match="T >= 2"):
        shared_fleet_run(stack[:, :1], cfg, device="cpu")


def _readings(name: str, stack: np.ndarray, jcfg_, tcfg_) -> dict:
    """Per step, the largest position (mm) and heading (rad) gap over the
    robots between the port, JAX's Pallas path and JAX's XLA path, with the
    share of grid cells within 1e-4 at the end."""
    runs = _runs(stack, jcfg_, tcfg_, backends=("fused", "xla"))
    row = {"case": name, "robots": stack.shape[0], "steps": stack.shape[1] - 1}
    for a, b in (("port", "fused"), ("port", "xla"), ("fused", "xla")):
        d = np.abs(np.asarray(runs[a][4].pose) - np.asarray(runs[b][4].pose))
        row[f"{a}-{b}"] = {
            "flags_equal": bool((np.asarray(runs[a][4].accepted) == np.asarray(runs[b][4].accepted)).all()),
            "pos_mm": [float(f"{v:.4g}") for v in d[..., :2].max(axis=(0, 2))],
            "rad": [float(f"{v:.3g}") for v in d[..., 2].max(axis=0)],
            "grid_share": float(f"{(np.abs(np.asarray(runs[a][2]) - np.asarray(runs[b][2])) <= 1e-4).mean():.5f}"),
        }
    return row


def _fixed_points() -> dict:
    """The interleave's step-2 registration of robot 0, from the port's
    state after step 1: the port's K1 (plain) and JAX's Pallas kernel on the
    same inputs, and the port's K1 started from where JAX's ended."""
    from icp_slam_yolo_tpu.ops.pallas.icp_fused import icp_fused_pallas
    from icp_slam_yolo_tpu_torch.ops import geometry as geo
    from icp_slam_yolo_tpu_torch.ops.outliers import statistical_outlier_mask
    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import icp_fused
    from icp_slam_yolo_tpu_torch.ops.voxel import voxel_downsample
    from icp_slam_yolo_tpu_torch.parallel.shared import make_shared_step, shared_init

    cfg = tcfg.REALTIME_CONFIG.replace(map_capacity=4096)
    scans = torch.from_numpy(_interleaved(24))
    state, _ = make_shared_step(cfg)(shared_init(scans[:, 0], cfg), scans[:, 1], 0)
    xy, valid = geo.polar_to_cartesian(scans[:1, 2], cfg.gate)
    valid = statistical_outlier_mask(xy, valid, cfg.outlier_nb_neighbors, cfg.outlier_std_ratio)
    src, src_valid = voxel_downsample(xy, valid, cfg.icp.voxel_size_mm)
    d2 = ((state.map_xy - state.pose[0, :2]) ** 2).sum(-1)
    local = state.map_valid & (d2 < float(np.float32(cfg.local_map_radius_mm) ** 2))
    tgt_valid = local if int(local.sum()) >= cfg.min_local_map_points else state.map_valid
    init = geo.se2_extrapolate(state.pose, state.prev_pose)[:1]
    args = (src, src_valid, state.map_xy[None].contiguous(), tgt_valid[None].contiguous())
    kw = dict(iters=cfg.icp.max_iterations, threshold_mm=cfg.icp.threshold_mm, tolerance=cfg.icp.tolerance)
    port = icp_fused(*args, init, **kw)[0][0].numpy()
    jax_end = np.array(icp_fused_pallas(*(jnp.asarray(a[0].numpy()) for a in (*args, init)), interpret=True,
                                          early_exit=True, **kw)[0])
    again = icp_fused(*args, torch.from_numpy(jax_end)[None], **kw)[0][0].numpy()
    return {"case": "fixed points", "port_mm_rad": port.tolist(), "jax_pallas_mm_rad": jax_end.tolist(),
            "port_from_jax_end_mm_rad": again.tolist(),
            "port_vs_jax_mm": float(np.abs(port[:2] - jax_end[:2]).max()),
            "port_from_jax_end_vs_jax_mm": float(np.abs(again[:2] - jax_end[:2]).max())}


if __name__ == "__main__":
    # PYTHONPATH=. XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    #     python tests/test_torch_shared.py
    # prints one JSON line a case (~2.5 min on 8 CPU cores)
    import json

    cap = dict(map_capacity=4096)
    local = dict(map_capacity=4096, local_map_capacity=512)
    depot = dict(map_capacity=6144)
    for name, stack, jc, tc in (
        ("interleave", _interleaved(24), jcfg.REALTIME_CONFIG.replace(**cap), tcfg.REALTIME_CONFIG.replace(**cap)),
        ("local_map_capacity", _interleaved(13), jcfg.REALTIME_CONFIG.replace(**local),
         tcfg.REALTIME_CONFIG.replace(**local)),
        ("depot-4", chip_smoke.depot_streams(4, 5, 512)[0], jcfg.FLEET_CONFIG.replace(**depot),
         tcfg.FLEET_CONFIG.replace(**depot)),
        ("depot-4", chip_smoke.depot_streams(4, 10, 512)[0], jcfg.FLEET_CONFIG.replace(**depot),
         tcfg.FLEET_CONFIG.replace(**depot)),
    ):
        print(json.dumps(_readings(name, stack, jc, tc)), flush=True)
    print(json.dumps(_fixed_points()), flush=True)
