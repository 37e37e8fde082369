"""On the card, at a cell's own size: the program passes its limits, and
the control (the reference with TF32 products in the program's place)
and the faults fail them.  Skips without a CUDA device."""
import os
import types

import pytest

from benchmark import calibrate, check, harness
from benchmark.registry import Registry
from benchmark.tests.tiny import REPO


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["scannet.explore", "replica.explore"])
def test_control_fails_at_cell_size(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.set_cache_dirs(REPO)
    reg = Registry(os.path.join(REPO, "BENCHMARK.json"))
    limits = reg.limits(reg.workload(workload)["config"])
    args = types.SimpleNamespace(workload=workload, seed=987654321,
                                 seconds=0.0, trace=0)
    r = harness.run_cell(args, "cuda", reg,
                         after_check=calibrate.control_and_faults)
    assert r["correct"] is True, r["checks"]
    cal = r["calibration"]
    assert check.judge(cal["control"], limits)[0] is False
    assert check.judge(cal["fault_unchanged"], limits)[0] is False
    prog = {k: v["value"] for k, v in r["checks"].items()}
    for fault in ("fault_fine_unchanged", "fault_writeback_skipped"):
        if fault in cal:
            assert check.judge(prog | cal[fault], limits)[0] is False
