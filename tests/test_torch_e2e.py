"""The port's SLAM loop end to end on the CPU, at the tiny budget of
tests/test_e2e.py (48x64 frames, 7 frames, <= 12 iterations), through the
port's own entry point.  ATE below 0.5 m as test_e2e.py requires; the
slow companion runs both packages on the same config and compares ATE."""
import copy
import os

import numpy as np
import pytest
import torch
import yaml

from tests.test_e2e import tiny_cfg


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads per test: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_cfg(tmp_path, cfg) -> str:
    path = tmp_path / "tiny.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _run_port(tmp_path, fused_paths: bool = False):
    from hpslam_tpu_torch import run as R
    torch.manual_seed(0)
    cfg = tiny_cfg(tmp_path)
    if fused_paths:
        # the fused tracker render and the union mapping path on the fused
        # trunks (no mapping-loss kernel)
        cfg["tracking"]["fused_loss"] = True
        cfg["model"]["fused_composite"] = False
    path = _write_cfg(tmp_path, cfg)
    out = str(tmp_path / "port_out")
    results, summary = R.run([path, "--output", out, "--device", "cpu"])
    return results, summary, out


def test_port_runs_tiny_synthetic_on_cpu(tmp_path):
    results, summary, out = _run_port(tmp_path)
    rmse = results["absolute_translational_error.rmse"]
    assert np.isfinite(rmse) and rmse < 0.5, rmse
    assert summary["n_frames"] == 7 and summary["map_ms_mean"] > 0
    assert os.path.exists(os.path.join(out, "final_point_cloud.ply"))
    assert any(f.endswith(".ckpt")
               for f in os.listdir(os.path.join(out, "ckpts")))
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    state = load_checkpoint(latest_checkpoint(out))
    assert state["levels"]["fine"]["count"] > 0
    assert state["decoder_params"]["col_fine"]["core"]["out"]["w"].shape \
        == (128, 3)


def test_port_runs_tiny_synthetic_fused_paths_on_cpu(tmp_path, monkeypatch):
    """tracking.fused_loss on and model.fused_composite off: every tracker
    step goes through nicer_fused_trackloss and every mapping step through
    the fused trunks, never the mapping loss."""
    from hpslam_tpu_torch.ops import fused_mlp as FM
    calls = {"trackloss": 0, "color": 0, "geo": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(FM, "nicer_fused_trackloss",
                        counted("trackloss", FM.nicer_fused_trackloss))
    monkeypatch.setattr(FM, "nicer_fused_color",
                        counted("color", FM.nicer_fused_color))
    monkeypatch.setattr(FM, "nicer_fused_geo",
                        counted("geo", FM.nicer_fused_geo))

    def no_maploss(*args, **kwargs):
        raise AssertionError("the mapping-loss path was taken")

    monkeypatch.setattr(FM, "nicer_fused_maploss", no_maploss)
    results, summary, _out = _run_port(tmp_path, fused_paths=True)
    rmse = results["absolute_translational_error.rmse"]
    assert np.isfinite(rmse) and rmse < 0.5, rmse
    assert summary["n_frames"] == 7
    assert min(calls.values()) > 0, calls


@pytest.mark.slow
def test_port_and_reference_ate_agree(tmp_path):
    from hpslam_tpu.slam import PointSLAM
    cfg = tiny_cfg(tmp_path)
    cfg["data"]["output"] = str(tmp_path / "ref_out")
    ref, _ = PointSLAM(copy.deepcopy(cfg)).run()
    port, _, _ = _run_port(tmp_path)
    a = port["absolute_translational_error.rmse"]
    b = ref["absolute_translational_error.rmse"]
    # the tiny budget is noise-dominated (different random streams);
    # the port must stay within the reference's scale
    assert a < max(2.0 * b, b + 0.05), (a, b)


@pytest.mark.slow
def test_port_mesh_dp2_matches_single_device(tmp_path):
    """The counterpart of tests/test_e2e.py::test_pointslam_run_mesh_dp8:
    the tiny run with mesh dp2 on two gloo ranks (spawned processes, a
    FileStore rendezvous) against the single-device run; the trajectory
    within the reference's 0.15 m drift bound of it (the fixture's
    neighbour-set noise, carried through each frame's Adam steps)."""
    from hpslam_tpu_torch import run as R
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    from tests.test_torch_parallel import run_ranks
    res1, _, out1 = _run_port(tmp_path)
    cfg = tiny_cfg(tmp_path)
    cfg["mesh"] = "dp2"
    path = str(tmp_path / "tiny_dp2.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out2 = str(tmp_path / "port_dp2")
    outs = run_ranks(tmp_path, 2, R.run,
                     [path, "--output", out2, "--device", "cpu"])
    rmse = [r[0]["absolute_translational_error.rmse"] for r in outs]
    assert rmse[0] == rmse[1] and np.isfinite(rmse[0]) and rmse[0] < 0.5
    traj1 = load_checkpoint(latest_checkpoint(out1))["estimate_c2w_list"]
    traj2 = load_checkpoint(latest_checkpoint(out2))["estimate_c2w_list"]
    dt = np.linalg.norm(traj2[:, :3, 3] - traj1[:, :3, 3], axis=1)
    assert float(dt.max()) < 0.15, f"mesh-vs-single drift {dt.max():.3f} m"
