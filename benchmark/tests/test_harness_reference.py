"""The reference against the program at a tiny size on the CPU, and the
control (the reference with TF32 products in the program's place)."""
import pytest

from benchmark import calibrate, check
from benchmark.registry import Registry
from benchmark.tests import tiny as T


@pytest.mark.parametrize("workload", ["scannet.explore", "replica.explore"])
def test_program_agrees_with_reference(workload):
    r = T.run_tiny(workload)
    assert r["correct"] is True, r["checks"]
    nums = {k: v["value"] for k, v in r["checks"].items()}
    # the same plain operations on the CPU: tracking and insertion exact
    assert nums["track_loss_gap"] == 0.0
    assert nums["track_pose_gap_m"] == 0.0
    assert nums["map_insert_gap"] == 0.0
    assert nums["map_loss_gap"] < 1e-6
    assert nums.get("map_state_gap", 0.0) < 1e-6
    assert nums.get("map_feature_gap", 0.0) < 1e-6
    # frame 0, from the benchmark's own state
    assert nums["map0_insert_gap"] == 0.0
    assert nums["map0_loss_gap"] < 1e-6


@pytest.mark.parametrize("workload", ["scannet.explore", "replica.explore"])
def test_control_reads_above_the_program(workload):
    r = T.run_tiny(workload, after_check=calibrate.control_and_faults)
    prog = {k: v["value"] for k, v in r["checks"].items()}
    ctl = r["calibration"]["control"]
    assert ctl["track_loss_gap"] > 10 * max(prog["track_loss_gap"], 1e-9)
    assert ctl["track_pose_gap_m"] > 10 * max(prog["track_pose_gap_m"],
                                              1e-9)
    unchanged = r["calibration"]["fault_unchanged"]
    assert unchanged["map_insert_gap"] > 0
    assert unchanged["track_loss_gap"] > 0.01
    reg = Registry(T.REPO + "/BENCHMARK.json")
    limits = reg.limits(reg.workload(workload)["config"])
    assert check.judge(unchanged, limits)[0] is False
    altered = {k: 0.0 for k in limits} | r["calibration"]["fault_altered"]
    assert check.judge(altered, limits)[0] is False
