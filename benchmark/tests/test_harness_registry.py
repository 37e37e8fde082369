"""A configuration, a traffic mix and a metric are added as files and
entries; the harness finds and runs them with no file of it edited."""
import json
import os
import shutil

from benchmark.registry import Registry
from benchmark.tests import tiny as T


def test_added_config_mix_and_metric_run(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(os.path.join(T.REPO, "benchmark"), root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(T.REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    # new files only
    cfg = json.loads((root / "configs/pointslam-scannet.json").read_text())
    cfg["name"] = "pointslam-scannet-copy"
    (root / "configs/pointslam-scannet-copy.json").write_text(
        json.dumps(cfg))
    (root / "limits/pointslam-scannet-copy.json").write_text(
        (root / "limits/pointslam-scannet.json").read_text())
    mix = json.loads((root / "traffic/explore.json").read_text())
    mix["sway_m"] = 0.05
    (root / "traffic/sway5.json").write_text(json.dumps(mix))
    (root / "metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.frames)\n")
    # new entries only
    spec["configs"].append(dict(spec["configs"][0],
                                name="pointslam-scannet-copy",
                                file="benchmark/configs/"
                                     "pointslam-scannet-copy.json"))
    spec["workloads"].append({"name": "copy.sway5",
                              "config": "pointslam-scannet-copy",
                              "traffic": "sway5", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["copy.sway5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(str(tmp_path / "BENCHMARK.json"), str(root))
    assert reg.traffic("sway5")["sway_m"] == 0.05
    assert [m["name"] for m in reg.metrics("copy.sway5", "end_to_end")] \
        == ["frame_ms", "map_ms", "setup_s", "frames_seen"]
    assert [m["name"] for m in reg.metrics("replica.explore", "end_to_end")] \
        == ["frame_ms", "track_ms", "map_ms", "setup_s"]
    assert "frames_seen" not in [m["name"] for m in reg.metrics(
        "scannet.explore", "end_to_end")]

    import types

    from benchmark import harness
    args = types.SimpleNamespace(workload="copy.sway5", seed=5, seconds=0.0,
                                 trace=0)
    r = harness.run_cell(args, "cpu", reg, config_override=T.tiny)
    assert r["metrics"]["frames_seen"]["value"] == 4
    assert r["metrics"]["frame_ms"]["value"] > 0
    assert r["correct"] is True
    assert list(r)[-1] == "checks"
