"""The benchmark's scan generator against the program's
`io/synthetic.py`: the same walls and poses, the same ranges without
noise, and the stated noise, dropouts and qualities."""

import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu_torch.io import synthetic
from portbench import scans

HALL = {"half_x": 10000.0, "half_y": 6000.0, "path_half_x": 7000.0, "path_half_y": 1800.0, "radius": 1800.0}


def test_walls():
    ours, theirs = scans.warehouse_segments(10000.0, 6000.0), synthetic.warehouse_segments(10000.0, 6000.0)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("step,start", [(150.0, 0), (115.0, 0), (150.05, 37)])
def test_poses(step, start):
    ours = scans.loop_path(300, 7000.0, 1800.0, 1800.0, step, start)
    theirs = synthetic.loop_path(300 + start, 7000.0, 1800.0, 1800.0, step)[start:]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def test_ranges_without_noise():
    poses = synthetic.loop_path(40, 7000.0, 1800.0, 1800.0, 150.0)
    segs = synthetic.warehouse_segments(10000.0, 6000.0)
    angles = np.arange(360) * 1.0
    ours = scans.raycast(torch.as_tensor(poses), torch.as_tensor(segs), torch.as_tensor(angles)).numpy()
    theirs = np.stack([synthetic.raycast(p, segs, angles) for p in poses])
    assert np.array_equal(np.isfinite(ours), np.isfinite(theirs))
    np.testing.assert_allclose(ours[np.isfinite(ours)], theirs[np.isfinite(theirs)], rtol=1e-12, atol=1e-9)


def test_noise_dropout_and_quality():
    traffic = {"robots": 4, "scans_a_lap": [30, 40], "start": "spread", "hall": HALL, "beams": 360,
               "noise_mm": 10.0, "dropout": 0.05, "max_range_mm": 10000.0}
    got, laps, gt = scans.fleet_streams(traffic, 2**31 + 7, 512, "cpu")
    assert got.shape == (4, 40, 512, 3) and sorted(laps) == [30, 33, 37, 40]
    assert not got[:, :, 360:].any()
    walls = torch.as_tensor(scans.warehouse_segments(10000.0, 6000.0))
    clean = scans.raycast(torch.as_tensor(gt.reshape(-1, 3)), walls, torch.arange(360, dtype=torch.float64))
    clean = clean.reshape(4, 40, 360)
    live = torch.isfinite(clean) & (clean < 9900.0)
    hit = got[..., :360, 2] > 0
    resid = (got[..., :360, 2].double() - clean)[hit & live]
    assert abs(float(resid.std()) - 10.0) < 0.5 and abs(float(resid.mean())) < 0.5
    assert abs(1.0 - float(hit[live].float().mean()) - 0.05) < 0.01
    q = got[..., :360, 0][hit]
    assert float(q.min()) == 15.0 and float(q.max()) == 54.0
    again, _, _ = scans.fleet_streams(traffic, 2**31 + 7, 512, "cpu")
    assert torch.equal(got, again)


def test_feed_wraps_each_lap():
    s = torch.arange(2 * 5 * 3 * 3, dtype=torch.float32).reshape(2, 5, 3, 3)
    feed = scans.Feed(s, np.array([5, 3]), 100)
    assert torch.equal(feed(7), torch.stack([s[0, 2], s[1, 1]]))


def test_noise_seed_gives_every_seed_the_same_streams():
    """With ``noise_seed`` two run seeds get the same streams, noise
    included, run by other robots; without it the noise is the run seed's."""
    traffic = {"robots": 6, "scans_a_lap": [30, 40], "start": "depot", "hall": HALL, "beams": 360,
               "noise_mm": 10.0, "dropout": 0.05, "max_range_mm": 10000.0, "noise_seed": 5}
    a, laps_a, _ = scans.fleet_streams(traffic, 2**31 + 1, 512, "cpu")
    b, laps_b, _ = scans.fleet_streams(traffic, 2**33 + 2, 512, "cpu")
    assert not np.array_equal(laps_a, laps_b)
    by_lap = lambda s, laps: {int(lap): s[i, :lap] for i, lap in enumerate(laps)}  # noqa: E731
    sa, sb = by_lap(a, laps_a), by_lap(b, laps_b)
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    c, laps_c, _ = scans.fleet_streams({k: v for k, v in traffic.items() if k != "noise_seed"}, 2**31 + 1, 512, "cpu")
    assert np.array_equal(laps_a, laps_c) and not torch.equal(a, c)
