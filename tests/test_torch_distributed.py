"""The port's multi-process layer (`parallel/{distributed,mesh}.py`) and the
fleet sharded over ranks, against the JAX package's helpers and its
``fleet_run_sharded`` on a 2-device mesh of the CPU devices
(`tests/conftest.py`).  The port's ranks are spawned CPU processes in one
gloo group (`torch_dist_workers.Ranks`).

Tolerances: the sharded fleet's outputs and states bit-equal to the port's
one-process replay of the whole fleet (each robot's lane is computed alone
in the batched step, whichever process holds it); against JAX, those of
`test_torch_fleet.py`'s replay at the preset's stopping rule (the cut is
that file's `_cut_fleet`); the fleet's global statistics equal to the
one-process statistics of the whole fleet within 1e-6 relative for the mean
RMSE (a sum over two ranks adds in another order than a sum over the four
robots) and exactly for the accept rate."""

import numpy as np
import pytest
import torch

import icp_slam_yolo_tpu as jpkg
import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu import config as jc
from icp_slam_yolo_tpu.parallel import distributed as jdist
from icp_slam_yolo_tpu.parallel import fleet as jfleet
from icp_slam_yolo_tpu.parallel import mesh as jmesh
from icp_slam_yolo_tpu_torch import config as tc
from icp_slam_yolo_tpu_torch.parallel import distributed, fleet as tfleet, mesh as tmesh
from test_torch_fleet import _cut_fleet, _streams
import torch_dist_workers as workers

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    ranks = workers.Ranks(2, tmp_path_factory.mktemp("store2"))
    yield ranks
    ranks.close()


def test_exports_cover_the_jax_package():
    """Every name of the JAX package's ``__all__`` is in the port's."""
    assert set(jpkg.__all__) <= set(port.__all__)
    assert port.__version__ == jpkg.__version__ and port.RegistrationResult._fields == jpkg.RegistrationResult._fields


def test_one_process_helpers_match_jax(monkeypatch):
    """Without a group: one process, `initialize()` without arguments or
    torchrun's variables does nothing, `make_mesh` asks for a group."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is None and not torch.distributed.is_initialized()
    assert distributed.process_local_batch_size(16) == jdist.process_local_batch_size(16) == 16
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_mesh()


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
def test_mesh_shapes_match_jax(n, axes):
    assert tmesh.mesh_shape(n, len(axes)) == jmesh.make_mesh(n, axes).devices.shape


def test_collectives_over_four_ranks(tmp_path):
    """Four ranks: the sum and the concatenation of the rank ids in rank
    order, the per-process batch (16 -> 4, 10 refused), the meshes' shapes
    (JAX's for n = 4), placements and blocks, and a sum over the ranks that
    carries its gradient: each rank back-propagates its share ``y / 4`` of
    ``y = sum over ranks of x_r^2``, and gets ``dy / dx_r = 2 x_r``."""
    ranks = workers.Ranks(4, tmp_path)
    try:
        got = ranks.run(workers.collectives)
    finally:
        ranks.close()
    for r, g in enumerate(got):
        assert g["rank"] == r and g["sum"] == [6.0, 4.0]
        assert g["ids"] == [[k, 10 * k] for k in range(4)]
        assert g["batch16"] == 4 and g["batch10_refused"]
        assert g["shape1"] == jmesh.make_mesh(4).devices.shape
        assert g["shape2"] == jmesh.make_mesh(4, ("data", "model")).devices.shape and g["dims2"] == ("data", "model")
        assert g["block8"] == slice(2 * r, 2 * r + 2)
        assert g["sharding"] == "[Shard(dim=0), Replicate()]" and g["replicated"] == "[Replicate(), Replicate()]"
        assert g["global"] == 1 + 4 + 9 + 16 and g["grad"] == 2.0 * (r + 1)


def test_fleet_sharded_over_two_ranks(ranks2):
    """2 ranks x 2 robots of the cut ``fleet`` preset, 14 scans: the ranks'
    blocks, concatenated, bit-equal to the port's one-process replay of the
    4 robots; within `test_torch_fleet`'s preset-tolerance bounds of JAX's
    ``fleet_run_sharded`` on a 2-device mesh; and `make_fleet_step(cfg,
    mesh)`'s statistics the whole fleet's."""
    stack = _streams(14, seeds=(7, 11, 3, 5))
    tcfg = _cut_fleet(tc)
    ranks2.submit(workers.fleet, stack, tcfg, 4)
    whole_states, whole_outs = tfleet.fleet_run_sequence(stack, tcfg, device="cpu")
    jstates, jouts = jfleet.fleet_run_sharded(stack, _cut_fleet(jc), mesh=jmesh.make_mesh(2))
    got = ranks2.collect(workers.fleet)
    for name, want in whole_outs._asdict().items():
        np.testing.assert_array_equal(np.concatenate([g["outs"][name] for g in got]), want.numpy(), err_msg=name)
    for name, want in whole_states._asdict().items():
        np.testing.assert_array_equal(np.concatenate([g["states"][name] for g in got]), want.numpy(), err_msg=name)

    assert len(jouts.pose.sharding.device_set) == 2  # JAX's outputs stay sharded on the batch axis
    np.testing.assert_array_equal(whole_outs.accepted.numpy(), np.asarray(jouts.accepted))
    np.testing.assert_array_equal(whole_outs.n_points.numpy(), np.asarray(jouts.n_points))
    assert whole_outs.accepted.numpy().mean() > 0.9
    dp = np.abs(whole_outs.pose.numpy() - np.asarray(jouts.pose))
    assert dp[..., :2].max() <= 8.0 and dp[..., 2].max() <= 8e-3 and dp[:, -1, :2].max() <= 3.0, dp.max(axis=(0, 1))
    dmap = np.abs(whole_states.map_valid.sum(1).numpy() - np.asarray(jstates.map_valid).sum(1)).max()
    same_cells = (np.abs(whole_states.occ.numpy() - np.asarray(jstates.occ)) <= 1e-5).mean()
    assert dmap <= 25 and same_cells >= 0.98, (dmap, same_cells)

    step = tfleet.make_fleet_step(tcfg)
    st = tfleet.fleet_init(torch.from_numpy(stack[:, 0]), tcfg)
    for t in range(1, 5):
        st, _, stats = step(st, torch.from_numpy(stack[:, t]), t - 1)
        for g in got:
            np.testing.assert_allclose(g["stats"][t - 1]["mean_rmse"], float(stats["mean_rmse"]), rtol=1e-6)
            assert g["stats"][t - 1]["accept_rate"] == float(stats["accept_rate"])


def test_fleet_sharded_refuses_an_uneven_fleet(ranks2):
    """3 robots over 2 ranks: the ValueError of JAX's sharding, on every rank."""
    with pytest.raises(RuntimeError, match="does not divide over the 2 ranks"):
        ranks2.run(workers.fleet, _streams(3, seeds=(7, 11, 3)), _cut_fleet(tc), 1)
    with pytest.raises(ValueError):
        jfleet.fleet_run_sharded(_streams(3, seeds=(7, 11, 3)), _cut_fleet(jc), mesh=jmesh.make_mesh(2))
