"""Checkpoint -> live resume of the PyTorch port (CPU), at the tiny budget
of tests/test_e2e.py.

tests/test_resume.py's round trip (slow there) runs here at 48x64; a run
resumed from a mid-run checkpoint ends bit for bit where the uninterrupted
run ends; and a checkpoint written by hpslam_tpu's Logger is restored by
the port, whose render_img then agrees with hpslam_tpu's on the same state
(rtol 1e-4 / atol 1e-5, f32 sums ordered differently).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_e2e import tiny_cfg


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, cfg, out, *flags):
    from hpslam_tpu_torch import run as R
    path = str(tmp_path / f"cfg_{os.path.basename(out)}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return R.run([path, "--output", out, "--device", "cpu", *flags])


def _cfg(tmp_path, n_frames, ckpt_freq):
    cfg = tiny_cfg(tmp_path)
    cfg["synthetic"]["n_frames"] = n_frames
    cfg["mapping"]["ckpt_freq"] = ckpt_freq
    cfg["mapping"]["every_frame"] = 3
    return cfg


def test_resume_roundtrip(tmp_path):
    from hpslam_tpu_torch.slam import PointSLAM
    out = str(tmp_path / "run")
    cfg1 = _cfg(tmp_path, 6, 4)
    cfg1["data"]["output"] = out
    slam1 = PointSLAM(cfg1, device="cpu")
    slam1.run()
    pts1 = slam1.npc.pts_num()
    kfs1 = list(slam1.mapper.keyframe_list)
    assert pts1["fine"] > 0 and len(kfs1) > 0

    cfg2 = _cfg(tmp_path, 9, 100)
    cfg2["data"]["output"] = out
    cfg2["resume"] = True
    slam2 = PointSLAM(cfg2, device="cpu")
    results, _summary = slam2.run()
    assert slam2.mapper.keyframe_list[:len(kfs1)] == kfs1
    assert all(slam2.npc.pts_num()[k] >= pts1[k] for k in pts1)
    np.testing.assert_array_equal(slam2.estimate_c2w_list[:6],
                                  slam1.estimate_c2w_list[:6])
    assert np.abs(slam2.estimate_c2w_list[6:9]).sum() > 0
    assert np.isfinite(results["absolute_translational_error.rmse"])


def test_resume_continues_bitwise(tmp_path):
    """Resume from the uninterrupted run's frame-3 checkpoint: the same
    trajectory, ATE, point levels and keyframes, bit for bit (the
    checkpoint holds each level's capacity, the mapper's last pose and the
    random streams' states)."""
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    cfg = _cfg(tmp_path, 7, 3)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ra, _ = _run(tmp_path, cfg, a)
    os.makedirs(os.path.join(b, "ckpts"))
    shutil.copy(os.path.join(a, "ckpts", "00003.ckpt"),
                os.path.join(b, "ckpts"))
    rb, _ = _run(tmp_path, cfg, b, "--resume")
    sa = load_checkpoint(latest_checkpoint(a))
    sb = load_checkpoint(latest_checkpoint(b))
    assert sa["idx"] == sb["idx"] == 6
    np.testing.assert_array_equal(sa["estimate_c2w_list"],
                                  sb["estimate_c2w_list"])
    assert ra["absolute_translational_error.rmse"] \
        == rb["absolute_translational_error.rmse"]
    assert sa["keyframe_list"] == sb["keyframe_list"]
    for name in sa["levels"]:
        for k in ("pos", "geo", "col", "count", "capacity"):
            np.testing.assert_array_equal(sa["levels"][name][k],
                                          sb["levels"][name][k])


def _reference_checkpoint(tmp_path, cfg, rng):
    """A checkpoint written by hpslam_tpu's Logger: frame 3 of 7, two
    corner-cloud levels, the reference decoders at cfg's widths."""
    from hpslam_tpu.models import decoder as jDec
    from hpslam_tpu.state import NeuralPointCloud as jNPC
    from hpslam_tpu.utils.logger import Logger as jLogger
    from tests.test_torch_visualizer import scene
    c_dim = cfg["model"]["c_dim"]
    npc = jNPC(cfg)
    levels = {}
    for name in npc.levels:
        (pos, count, geo, col), _d, _rq, _c2w = scene(rng, c_dim=c_dim)
        levels[name] = (pos[:count], geo[:count], col[:count])
        npc.restore_level(name, pos[:count], np.zeros((count, 2), np.float32),
                          geo[:count], col[:count])
    npc.restore_input(rng.normal(size=(50, 3)),
                      rng.uniform(0, 255, (50, 3)), np.zeros((50, 2)))
    params = jDec.init_nicer(jax.random.PRNGKey(5),
                             jDec.ModelConfig.from_cfg(cfg))
    est = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    est[:4, :3, 3] = rng.normal(0, 0.05, (4, 3))

    class _Slam:
        ckptsdir = str(tmp_path / "jax_run" / "ckpts")
        _key_counter = 11

    os.makedirs(_Slam.ckptsdir)
    kf = {"idx": 0, "gt_c2w": np.eye(4, dtype=np.float32),
          "est_c2w": est[0], "exposure_feat": np.zeros(8, np.float32),
          "pool_len": 10}
    expo = rng.normal(0, 0.01, 8).astype(np.float32)
    path = jLogger(dict(cfg, verbose=False), _Slam()).log(
        3, npc, params, expo, [0], [kf], {0: [{"idx": 0}]}, est, est)
    return path, params, levels, expo, est


def test_restore_reference_checkpoint_and_render(tmp_path, rng, capsys):
    """hpslam_tpu's checkpoint restored by the port; both packages'
    render_img on the restored state agree."""
    from hpslam_tpu import renderer as jR
    from hpslam_tpu.models import decoder as jDec
    from hpslam_tpu.utils import visualizer as jV
    from hpslam_tpu_torch.slam import PointSLAM
    from tests.test_torch_visualizer import corner_depth
    cfg = tiny_cfg(tmp_path)
    path, params, levels, expo, est = _reference_checkpoint(tmp_path, cfg,
                                                            rng)
    cfg["data"]["output"] = str(tmp_path / "port_run")
    slam = PointSLAM(cfg, device="cpu")
    assert slam.restore_from(path) == 3
    assert "no random-stream states" in capsys.readouterr().out
    np.testing.assert_array_equal(slam.estimate_c2w_list, est)
    np.testing.assert_array_equal(slam.exposure_feat, expo)
    assert slam.mapper.keyframe_list == [0]
    kf = slam.mapper.keyframe_dict[0]
    assert kf["color_t"].shape == (48, 64, 3) and kf["pool_len"] > 0
    np.testing.assert_array_equal(slam.mapper.prev_c2w, est[3])
    for name, (pos, geo, col) in levels.items():
        lv = slam.npc.levels[name]
        assert lv.count == pos.shape[0]
        assert lv.capacity >= pos.shape[0] + slam.npc.GROWTH_HEADROOM
        np.testing.assert_array_equal(lv.geo[:lv.count].numpy(), geo)
    assert len(slam.npc.input_pos()) == 50
    w = slam.params["col_fine"]["core"]["out"]["w"]
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(params["col_fine"]["core"]["out"]["w"]))

    H, W = slam.H, slam.W
    jj, ii = np.mgrid[0:H, 0:W]
    depth = corner_depth(np.stack([(ii - slam.cx) / slam.fx,
                                   -(jj - slam.cy) / slam.fy,
                                   -np.ones_like(ii, float)], -1)
                         ).astype(np.float32)
    depth[:6, :10] = 0.0
    rq = np.full((H, W), 0.4, np.float32)
    c2w = est[3]
    d_t, u_t, c_t = slam.mapper_vis.vis_value_only(c2w, depth, slam.npc,
                                                   slam.params, rq)
    mcfg_j = jDec.ModelConfig.from_cfg(cfg)
    rcfg_j = jR.RenderConfig(**dataclasses.asdict(slam.mapper.rcfg))
    pos, geo, col = levels["fine"]
    outs_j = jV.render_img(params, mcfg_j, rcfg_j, c2w, H, W, slam.fx,
                           slam.fy, slam.cx, slam.cy,
                           (jnp.asarray(np.pad(pos, ((0, 848), (0, 0)))),
                            jnp.int32(pos.shape[0]),
                            jnp.asarray(np.pad(geo, ((0, 848), (0, 0)))),
                            jnp.asarray(np.pad(col, ((0, 848), (0, 0))))),
                           rq, gt_depth=depth, stage="color_fine")
    for name, a, b in zip(("depth", "unc", "color"), (d_t, u_t, c_t),
                          outs_j):
        np.testing.assert_allclose(a.astype(np.float64),
                                   np.asarray(b, np.float64), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if slam.mapper.rcfg.sample_near_pcl:
        assert (d_t[:6, :10] > 0.3).all()
    else:
        assert (d_t[:6, :10] == 0).all()


def test_port_continues_a_reference_run(tmp_path):
    """hpslam_tpu runs the tiny synth_quick config for 6 frames on the CPU
    and writes its checkpoints; the port resumes the last one (--resume,
    --device cpu) to frame 9 through its CLI.  tests/test_resume.py's
    checks: the keyframes carried over, no fewer points, the restored
    poses equal, the later poses filled, the ATE finite."""
    from hpslam_tpu.slam import PointSLAM as jPointSLAM
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    out = str(tmp_path / "run")
    cfg1 = _cfg(tmp_path, 6, 4)
    cfg1["data"]["output"] = out
    ref = jPointSLAM(cfg1)
    ref.run()
    pts1 = ref.npc.pts_num()
    kfs1 = [int(k) for k in ref.mapper.keyframe_list]
    est1 = np.asarray(ref.estimate_c2w_list)
    assert pts1["fine"] > 0 and kfs1
    cfg2 = _cfg(tmp_path, 9, 100)
    results, _summary = _run(tmp_path, cfg2, out, "--resume")
    state = load_checkpoint(latest_checkpoint(out))
    assert int(state["idx"]) == 8
    assert [int(k) for k in state["keyframe_list"][:len(kfs1)]] == kfs1
    assert all(state["pts_num"][k] >= pts1[k] for k in pts1)
    est2 = np.asarray(state["estimate_c2w_list"])
    np.testing.assert_array_equal(est2[:6], est1[:6])
    assert np.abs(est2[6:9]).sum() > 0 and np.isfinite(est2).all()
    assert np.isfinite(results["absolute_translational_error.rmse"])
