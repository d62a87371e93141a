"""The shared map over two ranks (`parallel/shared.py` with a mesh): the
port's spawned gloo ranks (`torch_dist_workers.Ranks`) against the JAX
package's ``shared_fleet_run`` on a mesh of R CPU devices, and against the
port's one-process run, in two layouts: R = 2 (one robot a rank, JAX's
layout) and R = 4 (two a rank).

Against JAX: the cases, step counts and tolerances of
`test_torch_shared.py` (R = 2, the interleave, 11 steps) and
`test_torch_shared_depot.py` (R = 4, the depot, 4 steps), for the reasons
given there.  Against the port's one process: the ranks add the robots'
log-ratio deltas and the anchor's positions in another order (each rank
its own robots, then the ranks), which is the only new rounding; with R =
2 each rank holds one robot and the sums are the same additions, so the
runs are bit-equal; with R = 4 the grid's last bits may differ, and the
readings are held equal for the accept flags and within 1e-3 mm / 1e-6 rad
for the poses, 1e-6 for the grid, with the map's live counts equal
(measured over its 4 steps: poses and map bit-equal, 13 grid cells apart
by at most 2.2e-8).  On
every rank the replicated map and grid are bit-identical after the seed
and after every step (digests of their bytes), and in the R = 4 case
`shared_fleet_run` with the mesh gives the step loop's results."""

import numpy as np
import pytest
import torch

import chip_smoke
from icp_slam_yolo_tpu import config as jcfg
from icp_slam_yolo_tpu.parallel.mesh import make_mesh
from icp_slam_yolo_tpu.parallel.shared import shared_fleet_run as jax_shared_fleet_run
from icp_slam_yolo_tpu_torch import config as tcfg
from icp_slam_yolo_tpu_torch.parallel.shared import SharedOutputs, shared_fleet_run
from test_torch_shared import _fused, _interleaved, check_against_jax
import torch_dist_workers as workers

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    ranks = workers.Ranks(2, tmp_path_factory.mktemp("store"), timeout=300.0)
    yield ranks
    ranks.close()


def _gathered(got: list):
    """The ranks' results as one run: the replicated map and grid (rank
    0's, after checking every rank's bits), the robots' rows concatenated."""
    for g in got[1:]:
        assert g["digests"] == got[0]["digests"], "the ranks' maps or grids differ"
        for name in ("map_xy", "map_valid", "occ"):
            np.testing.assert_array_equal(g[name], got[0][name])
    assert all(g["entry_point_same"] is not False for g in got), "shared_fleet_run(mesh=...) differs from the loop"
    cat = [torch.from_numpy(np.concatenate([g[k] for g in got])) for k in ("poses", "pose", "rmse", "accepted")]
    return (*(torch.from_numpy(got[0][k]) for k in ("map_xy", "map_valid", "occ")), cat[0], SharedOutputs(*cat[1:]))


@pytest.mark.parametrize("layout", ["R2", "R4"])
def test_shared_map_over_two_ranks(ranks2, layout):
    if layout == "R2":  # test_torch_shared.py's interleave
        stack, kw, grid_share = _interleaved(24), dict(map_capacity=4096), 0.995
        jc, tc = jcfg.REALTIME_CONFIG.replace(**kw), tcfg.REALTIME_CONFIG.replace(**kw)
    else:  # test_torch_shared_depot.py's four depot robots
        stack, kw, grid_share = chip_smoke.depot_streams(4, 5, 512)[0], dict(map_capacity=6144), 0.995
        jc, tc = jcfg.FLEET_CONFIG.replace(**kw), tcfg.FLEET_CONFIG.replace(**kw)
    ranks2.submit(workers.shared, stack, tc, layout == "R4")
    one = shared_fleet_run(stack, tc, device="cpu")
    jax_run = jax_shared_fleet_run(stack, _fused(jc), mesh=make_mesh(stack.shape[0]))
    got = ranks2.collect(workers.shared)
    assert (got[0]["entry_point_same"] is None) == (layout == "R2")
    assert len(got[0]["digests"]) == stack.shape[1]
    ranks = _gathered(got)

    np.testing.assert_array_equal(ranks[4].accepted.numpy(), one[4].accepted.numpy())
    np.testing.assert_array_equal(ranks[1].numpy(), one[1].numpy())
    if layout == "R2":
        for a, b in zip((*ranks[:4], *ranks[4]), (*one[:4], *one[4])):
            assert torch.equal(a, b)
    else:
        d = (ranks[4].pose - one[4].pose).abs()
        assert d[..., :2].max() <= 1e-3 and d[..., 2].max() <= 1e-6, d.amax(dim=(0, 1))
        assert (ranks[2] - one[2]).abs().max() <= 1e-6

    check_against_jax(ranks, jax_run, stack, tc, grid_share)
