"""The traffic repeats per seed; the seed changes the sensor's draws only."""
import json
import os

import numpy as np
import torch

from benchmark import room
from benchmark.tests.tiny import REPO

CAM = {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5, "cy": 11.5,
       "crop_edge": 1}


def _load(name):
    with open(os.path.join(REPO, "benchmark", name)) as f:
        return json.load(f)


def _frames(seed, traffic, sensor, idx=(0, 7, 40)):
    r = room.Room(CAM, sensor, traffic, seed, torch.device("cpu"))
    return [r.render(i) for i in idx]


def test_same_seed_same_frames():
    sensor = _load("configs/pointslam-scannet.json")["synthetic"]
    traffic = _load("traffic/explore.json")
    a = _frames(2 ** 31 + 7, traffic, sensor)
    b = _frames(2 ** 31 + 7, traffic, sensor)
    for (ca, da, pa), (cb, db, pb) in zip(a, b):
        assert np.array_equal(ca, cb) and np.array_equal(da, db)
        assert np.array_equal(pa, pb)


def test_seed_moves_noise_not_motion():
    sensor = _load("configs/pointslam-scannet.json")["synthetic"]
    traffic = _load("traffic/explore.json")
    a = _frames(1, traffic, sensor)
    b = _frames(2, traffic, sensor)
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(a, b))
    assert not np.array_equal(a[0][1], b[0][1])
    # noise-free frames do not depend on the seed at all
    c = _frames(1, traffic, {})
    d = _frames(2, traffic, {})
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(c, d))


def test_explore_motion_scale():
    """The orbit's mean step is the cited scan's: freiburg1_desk's 0.413
    m/s and 23.327 deg/s at 30 Hz."""
    p = room.poses(_load("traffic/explore.json"))
    step = np.linalg.norm(p[1:, :3, 3] - p[:-1, :3, 3], axis=1)
    assert np.isclose(step.mean(), 0.413 / 30, rtol=2e-3)
    yaw = np.unwrap(np.arctan2(p[:, 0, 2], p[:, 0, 0]))
    assert np.isclose(np.degrees(np.abs(np.diff(yaw))).mean(),
                      23.327 / 30, rtol=2e-3)


def test_every_mix_cites_its_source():
    folder = os.path.join(REPO, "benchmark", "traffic")
    for name in sorted(os.listdir(folder)):
        mix = _load(os.path.join("traffic", name))
        assert mix.get("source"), name
        assert len(room.poses(mix)) == mix["frames"]
