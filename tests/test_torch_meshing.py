"""Meshing, culling, reconstruction metrics and end correction of the
PyTorch port (CPU): tests/test_tools.py's tests of these tools on the
port's copies, the tools against hpslam_tpu's on the same files (equal:
the same numpy code on the same native runtime), and one tiny run of the
port's CLI through panels, end correction and TSDF meshing.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from hpslam_tpu.tools import cull_mesh as jCull
from hpslam_tpu.tools import eval_recon as jEval
from hpslam_tpu.tools import make_synth_gt_mesh as jGT
from hpslam_tpu.utils import ply as jPly
from hpslam_tpu_torch.tools import cull_mesh as tCull
from hpslam_tpu_torch.tools import eval_recon as tEval
from hpslam_tpu_torch.tools import make_synth_gt_mesh as tGT
from hpslam_tpu_torch.utils import ply as tPly


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- tests/test_tools.py on the port's copies -----------------------------

def test_cull_mesh(rng):
    verts = np.array([[0, 0, -2], [0.1, 0, -2], [0, 0.1, -2],
                      [0, 0, 2], [0.1, 0, 2], [0, 0.1, 2]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    kept = tCull.cull(verts, faces, [np.eye(4)], H=100, W=100, fx=50, fy=50,
                      cx=50, cy=50)
    assert kept.shape[0] == 1 and list(kept[0]) == [0, 1, 2]


def test_ply_roundtrip(tmp_path, rng):
    v = rng.normal(size=(10, 3)).astype(np.float32)
    c = rng.uniform(size=(10, 3)).astype(np.float32)
    f = rng.integers(0, 10, size=(5, 3)).astype(np.int32)
    p = str(tmp_path / "m.ply")
    tPly.write_ply_mesh(p, v, f, c)
    v2, c2, f2 = tPly.read_ply(p)
    np.testing.assert_allclose(v2, v, atol=1e-6)
    np.testing.assert_array_equal(f2, f)
    np.testing.assert_allclose(c2, c, atol=1 / 255.0)
    p2 = str(tmp_path / "p.ply")
    tPly.write_ply_points(p2, v, c)
    v3, _c3, f3 = tPly.read_ply(p2)
    np.testing.assert_allclose(v3, v, atol=1e-6)
    assert f3 is None
    # the two packages' files are byte for byte the same
    pj = str(tmp_path / "mj.ply")
    jPly.write_ply_mesh(pj, v, f, c)
    with open(p, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()


def test_end_correction_decay(rng):
    from hpslam_tpu_torch.tools.end_correction import voxel_downsample
    pts = rng.uniform(0, 1, (5000, 3)).astype(np.float32)
    ds = voxel_downsample(pts, 0.2)
    assert ds.shape[0] <= 6 ** 3
    assert ds.shape[0] > 50


def _drifted_room(rng):
    pts = []
    for axis in range(3):
        for side in (0.0, 1.0):
            p = rng.uniform(0, 1, (3000, 3))
            p[:, axis] = side
            pts.append(p)
    cloud = (np.concatenate(pts) * np.array([4.0, 3.0, 4.0])).astype(
        np.float32)
    rng.shuffle(cloud)
    drift = np.array([0.15, -0.4, 0.1], np.float32)
    drifted = cloud.copy()
    drifted[int(cloud.shape[0] * 0.78):] += drift
    return drifted, drift


def _fake_slam(cloud, n_img, gates):
    est = [np.eye(4, dtype=np.float32) for _ in range(n_img)]
    for c2w in est:
        c2w[:3, 3] = [2.0, 1.5, 2.0]

    class _NPC:
        def input_pos(self):
            return cloud

    class _Slam:
        cfg = {"mapping": gates}
        npc = _NPC()
        estimate_c2w_list = est

    s = _Slam()
    s.n_img = n_img
    return s


def test_apply_end_correction_recovers_rigid_tail_drift(rng):
    """A rigidly displaced trajectory tail is registered back onto the
    earlier map and the decayed translation applied to the pose list;
    gates lowered to the fixture's scale."""
    from hpslam_tpu_torch.tools.end_correction import apply_end_correction
    drifted, drift = _drifted_room(rng)
    n_img = 60
    s = _fake_slam(drifted, n_img, {"end_corr_min_pts": 1000,
                                    "end_corr_min_fitness": 0.3})
    est = s.estimate_c2w_list
    est[-1][:3, 3] += drift
    before_tail = est[-1][:3, 3].copy()
    before_head = est[0][:3, 3].copy()
    out = apply_end_correction(s)
    assert out["applied"] and out["fitness"] > 0.3
    corr = est[-1][:3, 3] - before_tail
    np.testing.assert_allclose(out["translation"], corr, atol=1e-6)
    assert np.linalg.norm(corr + drift) < 0.25 * np.linalg.norm(drift)
    np.testing.assert_allclose(est[0][:3, 3], before_head, atol=1e-7)
    mid = n_img - 1 - int(0.2 * n_img)
    mid_corr = est[mid][:3, 3] - before_head
    assert 0.1 < np.linalg.norm(mid_corr) / np.linalg.norm(corr) < 0.95


@pytest.mark.parametrize("gates,applied", [
    ({"end_corr_min_pts": 1000, "end_corr_min_fitness": 0.3}, True),
    ({"end_corr_min_pts": 50_000}, False),
    ({"end_corr_min_pts": 1000, "end_corr_min_fitness": 0.999}, False)])
def test_end_correction_matches_reference(rng, gates, applied):
    """The same poses as hpslam_tpu's end correction, bit for bit, applied
    or rejected by a gate alike."""
    from hpslam_tpu.tools.end_correction import apply_end_correction as jA
    from hpslam_tpu_torch.tools.end_correction import apply_end_correction
    drifted, drift = _drifted_room(rng)
    s_t = _fake_slam(drifted, 30, gates)
    s_j = _fake_slam(drifted, 30, gates)
    for s in (s_t, s_j):
        s.estimate_c2w_list[-1][:3, 3] += drift
    assert jA(s_j) == applied
    assert apply_end_correction(s_t)["applied"] == applied
    np.testing.assert_array_equal(np.stack(s_t.estimate_c2w_list),
                                  np.stack(s_j.estimate_c2w_list))


def test_synth_gt_mesh_matches_reference(tmp_path):
    vt, ft = tGT.box_mesh(2.5, 12)
    vj, fj = jGT.box_mesh(2.5, 12)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    a, b = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    assert tGT.main([a, "--res", "12"]) == 0
    assert jGT.main([b, "--res", "12"]) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _rec_and_gt(tmp_path, rng):
    """A noisy, shifted copy of a coarse synthetic box (the
    'reconstruction') and the box (GT), as files."""
    v, f = jGT.box_mesh(2.5, 16)
    rec = (v + rng.normal(0, 0.01, v.shape) + [0.02, 0.0, -0.01]).astype(
        np.float32)
    rp, gp = str(tmp_path / "rec.ply"), str(tmp_path / "gt.ply")
    jPly.write_ply_mesh(rp, rec, f, None)
    jPly.write_ply_mesh(gp, v, f, None)
    return rp, gp, rec, f


def test_cull_and_eval_recon_match_reference(tmp_path, rng):
    rp, gp, rec, f = _rec_and_gt(tmp_path, rng)
    poses = []
    for ang in (0.0, 1.2, 2.4):
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]]
        poses.append(c2w)
    args = (rec, f, poses, 60, 80, 50.0, 50.0, 39.5, 29.5)
    kept = tCull.cull(*args)
    np.testing.assert_array_equal(kept, jCull.cull(*args))
    assert 0 < kept.shape[0] < f.shape[0]
    for align in (True, False):
        mt = tEval.eval_recon_3d(rp, gp, n_samples=20000, align=align)
        mj = jEval.eval_recon_3d(rp, gp, n_samples=20000, align=align)
        assert mt == mj
        # 20000 samples over the box's 150 m^2 lie ~9 cm apart, so the
        # distances are those of the sampling more than of the noise
        assert 0.5 < mt["accuracy_cm"] < 10.0 and 0 < mt["fscore"] <= 1
    bound = [[-1.5, 1.5], [-1.0, 1.0], [-1.5, 1.5]]
    dt = tEval.eval_depth_l1(rp, gp, bound, n_views=4, H=24, W=32, fx=20.0)
    dj = jEval.eval_depth_l1(rp, gp, bound, n_views=4, H=24, W=32, fx=20.0)
    assert dt == dj and dt["views"] == 4 and dt["depth_l1_cm"] < 5.0


def test_port_cli_panels_end_correction_and_mesh(tmp_path):
    """The port's CLI on the CPU at tiny budgets: the panels fire on exactly
    the reference's frames (tracked frames past 1 that are multiples of
    tracking.vis_freq; mapped frames that are multiples of mapping.vis_freq,
    frame 0 left out by no_vis_on_first_frame), the fine level's rendered
    image is written, end correction runs with synth_loop.yaml's fitness
    gate (its point gate lowered to the tiny run's cloud) and logs its
    event, and get_mesh_tsdf_fusion on the run's checkpoint writes a mesh
    with faces."""
    from hpslam_tpu_torch import run as R
    from hpslam_tpu_torch.tools import get_mesh_tsdf_fusion as M
    from hpslam_tpu_torch.utils import image_io as IO
    from tests.test_e2e import tiny_cfg
    cfg = tiny_cfg(tmp_path)
    cfg["tracking"]["vis_freq"] = 3
    cfg["mapping"].update(vis_freq=3, save_rendered_image=True,
                          end_correction=True, end_corr_min_pts=1000,
                          end_corr_min_fitness=0.15)
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = str(tmp_path / "out")
    results, _summary = R.run([path, "--output", out, "--device", "cpu"])
    assert np.isfinite(results["absolute_translational_error.rmse"])
    n, every = 7, cfg["mapping"]["every_frame"]
    mapped = sorted({i for i in range(n) if i % every == 0} | {n - 1})
    want_track = [i for i in range(2, n) if i % 3 == 0]
    want_map = [i for i in mapped if i % 3 == 0 and i != 0]
    for sub, frames in (("tracking_vis", want_track),
                        ("mapping_vis", want_map)):
        files = sorted(os.listdir(os.path.join(out, sub)))
        assert [int(f[:5]) for f in files] == sorted(
            [i for i in frames for _ in ("fine", "mid")]), (sub, files)
        assert all(f.endswith(("_fine.png", "_mid.png")) for f in files)
        grid = IO.read_png(os.path.join(out, sub, files[0]))
        assert grid.shape == (2 * 48, 3 * 64, 3)
    assert os.listdir(os.path.join(out, "rendered_image")) == [
        f"frame_{i:05d}.png" for i in want_map]
    events = [json.loads(line) for line in open(
        os.path.join(out, "metrics.jsonl"))]
    vis = [e for e in events if e["event"] == "vis"]
    assert len(vis) == 2 * (len(want_track) + len(want_map))
    assert all(e["depth_l1_m"] >= 0 and e["render_ms"] > 0 for e in vis)
    ec = [e for e in events if e["event"] == "end_correction"]
    assert len(ec) == 1 and ec[0]["input_pts"] > 1000
    assert ec[0]["fitness"] > 0 and isinstance(ec[0]["applied"], bool)
    assert M.main([path, "--output", out, "--device", "cpu", "-s",
                   "--render_every", "3", "--voxel_size", "0.05"]) == 0
    verts, _cols, faces = tPly.read_ply(os.path.join(out, "mesh",
                                                     "final_mesh.ply"))
    assert faces.shape[0] > 100 and verts.shape[0] > 100
    with open(os.path.join(out, "mesh", "final_mesh.json")) as f:
        stats = json.load(f)
    assert stats["frames"] == 3 and stats["faces"] == faces.shape[0]
