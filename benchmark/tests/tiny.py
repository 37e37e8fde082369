"""A cell cut to a size the CPU runs in seconds, for the harness's tests."""
from __future__ import annotations

import json
import os
import types

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny(cfg: dict) -> dict:
    """The configuration at 44x60 pixels, a few pixels, rays and
    iterations, a 4096-point store."""
    cfg = json.loads(json.dumps(cfg))
    cfg["cam"].update(H=48, W=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5,
                      crop_edge=2)
    cfg["tracking"].update(pixels=64, iters=8, ignore_edge_W=4,
                           ignore_edge_H=4)
    cfg["mapping"].update(pixels=128, iters=10, iters_first=10,
                          geo_iter_first=3, mapping_window_size=4,
                          pixels_adding=300, keyframe_every=2)
    cfg["pointcloud"]["initial_capacity"] = 4096
    return cfg


def run_tiny(workload="scannet.explore", seed=12345678901, **kw):
    """run_cell on the CPU at the tiny size, from the repository root."""
    import torch
    from benchmark import harness
    from benchmark.registry import Registry
    torch.set_num_threads(2)
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.0,
                                 trace=0)
    reg = Registry(os.path.join(REPO, "BENCHMARK.json"))
    return harness.run_cell(args, "cpu", reg, config_override=tiny, **kw)
