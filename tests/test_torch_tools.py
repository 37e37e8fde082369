"""The port's tools against hpslam_tpu's.

convert_pretrained (tests/test_tools.py builds the fake checkpoint): the
same .npz, array for array and bit for bit, read by the port's
load_pretrain into both geometry decoders; a file that needs arbitrary
unpickling is refused (weights_only).

preflight: tests/test_preflight.py's six tests on the port's readers, the
reference's checks at the same levels (each of its messages' level and
subject among the port's), and a ScanNet tree with JPEG colour that the
port writes."""
import os
import types

import numpy as np
import pytest
import torch

from hpslam_tpu.tools.convert_pretrained import convert as j_convert
from hpslam_tpu.tools.preflight import preflight as j_preflight
from hpslam_tpu_torch.models import decoder as tDec
from hpslam_tpu_torch.slam import PointSLAM
from hpslam_tpu_torch.tools import convert_pretrained as tCP
from hpslam_tpu_torch.tools import preflight as tPF
from tests import test_preflight as jPF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fake_checkpoint(path, with_B=False):
    """tests/test_tools.py's fake ConvONet checkpoint: a 'coarse' decoder
    of 5 blocks (embed 110 -> 32 wide) and a 'fine' key to be skipped."""
    g = torch.Generator().manual_seed(0)
    state = {}
    dims = [(110, 32)] + [(32, 32)] * 4
    pre = "model.decoder.coarse."
    for i, (din, dout) in enumerate(dims):
        state[f"{pre}pts_linears.{i}.weight"] = torch.randn((dout, din),
                                                            generator=g)
        state[f"{pre}pts_linears.{i}.bias"] = torch.randn((dout,),
                                                          generator=g)
        state[f"{pre}fc_c.{i}.weight"] = torch.randn((dout, 32), generator=g)
        state[f"{pre}fc_c.{i}.bias"] = torch.randn((dout,), generator=g)
    state[f"{pre}output_linear.weight"] = torch.randn((1, 32), generator=g)
    state[f"{pre}output_linear.bias"] = torch.randn((1,), generator=g)
    if with_B:
        state[f"{pre}embedder._B"] = torch.randn((3, 55), generator=g)
    state["model.decoder.fine.pts_linears.0.weight"] = torch.zeros((2, 2))
    torch.save({"model": state}, path)
    return state


@pytest.mark.parametrize("with_B", [False, True], ids=["no-B", "B"])
def test_convert_pretrained_matches_reference(tmp_path, with_B):
    pt = str(tmp_path / "middle_fine.pt")
    state = fake_checkpoint(pt, with_B)
    ref = j_convert(pt, str(tmp_path / "ref.npz"))
    assert tCP.main([pt, str(tmp_path / "port.npz")]) == 0
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(ref)
    assert ("embedder.B" in a.files) == with_B
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # load_pretrain puts the coarse decoder into both geometry decoders
    mcfg = tDec.ModelConfig(geo_embed=110)
    slam = types.SimpleNamespace(
        cfg={"pretrained_decoders": {"middle_fine": str(tmp_path /
                                                        "port.npz")}},
        params=tDec.init_nicer(torch.Generator().manual_seed(0), mcfg,
                               "cpu"),
        device=torch.device("cpu"))
    PointSLAM.load_pretrain(slam)
    for level in ("geo_mid", "geo_fine"):
        core = slam.params[level]["core"]
        for i in range(5):
            np.testing.assert_array_equal(
                core["layers"][i]["w"].numpy(),
                state[f"model.decoder.coarse.pts_linears.{i}.weight"]
                .numpy().T)
            np.testing.assert_array_equal(
                core["fc_c"][i]["b"].numpy(),
                state[f"model.decoder.coarse.fc_c.{i}.bias"].numpy())
        np.testing.assert_array_equal(
            core["out"]["w"].numpy(),
            state["model.decoder.coarse.output_linear.weight"].numpy().T)
        if with_B:
            np.testing.assert_array_equal(
                slam.params[level]["B"].numpy(),
                state["model.decoder.coarse.embedder._B"].numpy())


class _Unsafe:
    """Not a tensor: loading it needs arbitrary unpickling."""


def test_convert_pretrained_refuses_pickled_objects(tmp_path):
    pt = str(tmp_path / "bad.pt")
    torch.save({"model": {"model.decoder.coarse.x.weight": _Unsafe()}}, pt)
    with pytest.raises(Exception):
        tCP.convert(pt, str(tmp_path / "out.npz"))
    assert not os.path.exists(tmp_path / "out.npz")


def test_convert_pretrained_needs_coarse_keys(tmp_path):
    pt = str(tmp_path / "none.pt")
    torch.save({"model": {"model.decoder.fine.a.weight": torch.zeros(2)}},
               pt)
    with pytest.raises(ValueError, match="coarse"):
        tCP.convert(pt, str(tmp_path / "out.npz"))


# --- preflight: tests/test_preflight.py's six tests on the port ----------

def _levels(msgs):
    """Each message's level and its subject (the text before its first
    colon), without the runtime estimate, whose text differs by design."""
    return [(lv, m.split(":")[0]) for lv, m in msgs
            if not m.startswith("estimated runtime")]


def _n_fails(msgs):
    return sum(level == "FAIL" for level, _ in msgs)


def test_preflight_ok_tree(tmp_path):
    jPF.write_scene(str(tmp_path))
    msgs = tPF.preflight(jPF.scannet_cfg(), input_folder=str(tmp_path))
    assert _n_fails(msgs) == 0, msgs
    assert any("estimated runtime" in m and "H100" in m for _, m in msgs)
    assert not any("TPU" in m for _, m in msgs)
    assert any("first color file decodes: 64x48" in m for _, m in msgs)
    # every check of the reference's, at the same level
    ref = j_preflight(jPF.scannet_cfg(), input_folder=str(tmp_path))
    assert set(_levels(ref)) <= set(_levels(msgs)), (ref, msgs)


def test_preflight_catches_count_mismatch(tmp_path):
    jPF.write_scene(str(tmp_path), skip_depth=True)
    msgs = tPF.preflight(jPF.scannet_cfg(), input_folder=str(tmp_path))
    assert any(lv == "FAIL" and "mismatch" in m for lv, m in msgs)


def test_preflight_catches_bad_depth_scale(tmp_path):
    jPF.write_scene(str(tmp_path))
    cfg = jPF.scannet_cfg()
    cfg["cam"]["png_depth_scale"] = 1.0  # forgot the mm->m divide
    msgs = tPF.preflight(cfg, input_folder=str(tmp_path))
    assert any(lv == "FAIL" and "png_depth_scale" in m for lv, m in msgs)


def test_preflight_catches_nonfinite_poses(tmp_path):
    jPF.write_scene(str(tmp_path), pose_val=np.full((4, 4), np.nan))
    msgs = tPF.preflight(jPF.scannet_cfg(), input_folder=str(tmp_path))
    assert any(lv == "FAIL" and "non-finite" in m for lv, m in msgs)


def test_preflight_catches_empty_tree(tmp_path):
    msgs = tPF.preflight(jPF.scannet_cfg(), input_folder=str(tmp_path))
    assert _n_fails(msgs) >= 1


def test_preflight_cli_exit_codes(tmp_path, capsys):
    rc = tPF.main([os.path.join(REPO, "configs/Synthetic/synth_quick.yaml")])
    out = capsys.readouterr().out
    assert rc == 0 and "preflight: OK" in out
    rc = tPF.main([os.path.join(REPO, "configs/ScanNet/scene0059.yaml"),
                   "--input_folder", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1 and "preflight: FAIL" in out


def test_preflight_scannet_jpeg_tree(tmp_path):
    """A ScanNet tree that the port writes (write_scannet_tree: the
    synthetic room at scene0059.yaml's intrinsics halved, JPEG colour)
    passes with no failure and a consistent reprojection on the port and
    on the reference alike; the same tree with its colour rewritten as
    progressive JPEG fails the colour decode."""
    import cv2
    from hpslam_tpu_torch.utils import datasets as D
    cfg = jPF.scannet_cfg()
    # large enough for the reprojection grid (12-pixel steps)
    cfg["cam"].update(H=240, W=320, fx=288.8, fy=289.4, cx=159.5, cy=121.3,
                      crop_edge=5)
    cam = dict(cfg["cam"], crop_edge=0)
    syn = D.Synthetic({"dataset": "synthetic", "seed": 1219, "data": {},
                       "synthetic": {"n_frames": 6, "radius": 1.2},
                       "cam": cam})
    D.write_scannet_tree(str(tmp_path), [syn[i] for i in range(6)],
                         png_depth_scale=cam["png_depth_scale"])
    msgs = tPF.preflight(cfg, input_folder=str(tmp_path))
    assert _n_fails(msgs) == 0, msgs
    assert any(lv == "ok" and "reprojection consistent" in m
               for lv, m in msgs), msgs
    ref = j_preflight(cfg, input_folder=str(tmp_path))
    assert _n_fails(ref) == 0
    assert set(_levels(ref)) <= set(_levels(msgs)), (ref, msgs)
    img = cv2.imread(str(tmp_path / "color" / "0.jpg"))
    cv2.imwrite(str(tmp_path / "color" / "0.jpg"), img,
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    msgs = tPF.preflight(cfg, input_folder=str(tmp_path))
    assert any(lv == "FAIL" and "SOF2" in m for lv, m in msgs), msgs
