"""The port's shared-map fleet against the JAX package's: four depot robots
on a 4-device CPU mesh, and a ``local_map_capacity`` below the map's (the
comparison and its tolerances: `test_torch_shared.py`)."""

import numpy as np

import chip_smoke
from icp_slam_yolo_tpu import config as jcfg
from icp_slam_yolo_tpu_torch import config as tcfg
from test_torch_shared import _compare, _interleaved


def test_four_depot_robots_match_jax():
    """R = 4 on a 4-device mesh: four robots leaving one depot at their own
    speeds (`chip_smoke.depot_streams`, as phase 14 runs them), on the
    ``fleet`` preset with 6144 map slots (4202 fill after the 4 steps), over
    4 steps, the grid on 99.5 % of its cells: past step 4, and on more of
    the grid, JAX's own Pallas and XLA paths part (`test_torch_shared.py`'s
    readings)."""
    stack, _ = chip_smoke.depot_streams(4, 5, 512)
    kw = dict(map_capacity=6144)
    _compare(stack, jcfg.FLEET_CONFIG.replace(**kw), tcfg.FLEET_CONFIG.replace(**kw), grid_share=0.995)


def test_local_map_capacity_is_ignored_as_in_jax():
    """JAX's shared step registers against the whole map under its radius
    mask; a ``local_map_capacity`` below ``map_capacity`` (which the
    single-map pipeline compacts the targets to) must give JAX's result."""
    kw = dict(map_capacity=4096, local_map_capacity=512)
    stack = _interleaved(13)
    assert np.asarray(stack).shape[:2] == (2, 6)
    _compare(stack, jcfg.REALTIME_CONFIG.replace(**kw), tcfg.REALTIME_CONFIG.replace(**kw))
