"""The per-script realtime presets (``realtime_b``, ``realtime_1``,
``realtime_2``) replayed against the JAX package on the CPU, each with its
own map geometry and gates: the port's ``run_sequence`` against JAX's on the
same seeded synthetic warehouse scans.

Only the map buffer is cut (2048 slots, from 24576: the plain ICP on the CPU
pays for every slot).  The JAX side runs ICP and the raster on their fused
Pallas paths in interpret mode.  Parity is `_compare` of
``test_torch_slam.py``: equal accept flags, poses within 2 mm / 2e-3 rad,
map counts within 1 %, and 99.5 % of the occupancy cells within 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu import config as jc
from icp_slam_yolo_tpu.slam import pipeline as jpipe
from icp_slam_yolo_tpu_torch import config as tc
from test_torch_slam import _compare, _scans

torch.set_num_threads(2)


def _preset(m, name, backend):
    base = m.PRESETS[name]
    return base.replace(
        map_capacity=2048, local_map_capacity=2048,
        icp=dataclasses.replace(base.icp, backend=backend),
        occupancy=dataclasses.replace(base.occupancy, backend=backend),
    )


@pytest.mark.parametrize("name", ["realtime_b", "realtime_1", "realtime_2"])
def test_preset_replay_matches_jax(name):
    """12 scans through each preset on both sides."""
    padded, _ = _scans(12, seed=7)
    jcfg, tcfg = _preset(jc, name, "fused"), _preset(tc, name, "auto")
    jstate, jouts = jpipe.run_sequence(jnp.asarray(padded), jcfg)
    tstate, touts = port.run_sequence(padded, tcfg, device="cpu")
    _compare(jstate, jouts, tstate, touts)
    assert tstate.occ.shape == (tcfg.map.height_px, tcfg.map.width_px)
    assert touts.accepted.numpy().mean() >= 0.9
