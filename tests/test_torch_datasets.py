"""The port's file-backed readers (hpslam_tpu_torch/utils/datasets.py)
against the reference's (hpslam_tpu/utils/datasets.py) on tiny trees the
tests write themselves: Replica, ScanNet (with crop_edge, and with
crop_size), Azure, CoFusion (EXR depth through the port's own EXR codec)
and TUM RGB-D (with tum_rgbd.yaml's distortion).

Poses and depth must equal the reference's bit for bit.  Colour: bit for
bit where no resampling runs (JPEG goes through cv2 in both); through the
undistortion at least 99.9 % of the pixels bitwise and none more than
1/255 off (the port's numpy remap against cv2's); through a crop_size
resize within 1e-4 (cv2 rounds its linear coefficients in float32).
"""
import cv2
import numpy as np
import pytest

from hpslam_tpu.utils import datasets as jD
from hpslam_tpu.utils import exr as jexr
from hpslam_tpu_torch.utils import datasets as tD
from hpslam_tpu_torch.utils import exr as texr

H, W = 24, 32


def _cfg(name, folder, depth_scale=1000.0, crop_edge=0, **cam):
    return {"dataset": name, "data": {"input_folder": str(folder)},
            "cam": {"H": H, "W": W, "fx": 26.0, "fy": 26.0, "cx": 15.7,
                    "cy": 12.2, "png_depth_scale": depth_scale,
                    "crop_edge": crop_edge, **cam}}


def _color(rng, i):
    """Smooth gradients (they survive JPEG) with a little noise."""
    jj, ii = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([jj / H * 200 + 20, ii / W * 180 + 30,
                    np.full_like(jj, 40.0 + 10 * i)], -1)
    return np.clip(img + rng.integers(0, 8, (H, W, 3)), 0, 255).astype(
        np.uint8)


def _depth(rng):
    return rng.integers(100, 5000, (H, W)).astype(np.uint16)


def _pose(rng):
    a = float(rng.uniform(-1, 1))
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    m[:3, 3] = rng.uniform(-1, 1, 3)
    return m


def _rows(m):
    return "\n".join(" ".join(f"{v:.17g}" for v in row) for row in m)


def _compare(cfg, n, colour="bitwise"):
    ref = jD.get_dataset(cfg)
    port = tD.get_dataset(cfg)
    assert len(port) == len(ref) == n
    for i in range(n):
        a, b = port[i], ref[i]
        np.testing.assert_array_equal(a.c2w, b.c2w)
        np.testing.assert_array_equal(a.depth, b.depth)
        assert a.color.dtype == np.float32 and a.color.shape == b.color.shape
        if colour == "bitwise":
            np.testing.assert_array_equal(a.color, b.color)
        elif colour == "undistorted":
            diff = np.abs(a.color - b.color).max(-1)
            assert (diff == 0).mean() >= 0.999 and diff.max() <= 1.0 / 255 \
                + 1e-7, ((diff == 0).mean(), diff.max())
        else:
            np.testing.assert_allclose(a.color, b.color, rtol=0, atol=1e-4)
    return port


def test_replica_reader_matches_reference(tmp_path, rng):
    root = tmp_path / "replica"
    (root / "results").mkdir(parents=True)
    lines = []
    for i in range(3):
        cv2.imwrite(str(root / "results" / f"frame{i:06d}.jpg"),
                    _color(rng, i), [cv2.IMWRITE_JPEG_QUALITY, 95])
        cv2.imwrite(str(root / "results" / f"depth{i:06d}.png"), _depth(rng))
        lines.append(" ".join(f"{v:.17g}" for v in _pose(rng).reshape(-1)))
    (root / "traj.txt").write_text("\n".join(lines) + "\n")
    _compare(_cfg("replica", root), 3)


@pytest.mark.parametrize("crop", [dict(crop_edge=2),
                                  dict(crop_size=[18, 22], crop_edge=1)])
def test_scannet_reader_matches_reference(tmp_path, rng, crop):
    root = tmp_path / "scannet"
    for sub in ("color", "depth", "pose"):
        (root / sub).mkdir(parents=True)
    for i in range(11):            # "10" sorts after "9": numeric order
        cv2.imwrite(str(root / "color" / f"{i}.jpg"), _color(rng, i))
        cv2.imwrite(str(root / "depth" / f"{i}.png"), _depth(rng))
        (root / "pose" / f"{i}.txt").write_text(_rows(_pose(rng)))
    port = _compare(_cfg("scannet", root, **crop), 11,
                    "bitwise" if "crop_size" not in crop else "resized")
    if "crop_size" in crop:
        assert port[0].depth.shape == (16, 20)


def test_azure_reader_matches_reference(tmp_path, rng):
    root = tmp_path / "azure"
    for sub in ("color", "depth", "scene"):
        (root / sub).mkdir(parents=True)
    log = []
    for i in range(2):
        cv2.imwrite(str(root / "color" / f"{i:05d}.jpg"), _color(rng, i))
        cv2.imwrite(str(root / "depth" / f"{i:05d}.png"), _depth(rng))
        log += [f"{i} {i} {i + 1}", _rows(_pose(rng))]
    (root / "scene" / "trajectory.log").write_text("\n".join(log) + "\n")
    _compare(_cfg("azure", root), 2)


def test_cofusion_reader_matches_reference(tmp_path, rng):
    root = tmp_path / "cofusion"
    (root / "colour").mkdir(parents=True)
    (root / "depth_noise").mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(root / "colour" / f"Color{i:04d}.png"),
                    _color(rng, i))
        texr.write_exr(str(root / "depth_noise" / f"Depth{i:04d}.exr"),
                       {"Y": rng.uniform(0.5, 4.0, (H, W)).astype(
                           np.float32)}, compression="zip")
    _compare(_cfg("cofusion", root, depth_scale=1.0), 2)
    # the port's EXR codec is the reference's
    p = str(root / "depth_noise" / "Depth0000.exr")
    np.testing.assert_array_equal(texr.read_exr_depth(p),
                                  jexr.read_exr_depth(p))


def test_tum_reader_matches_reference(tmp_path, rng):
    from scipy.spatial.transform import Rotation
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir(parents=True)
    rgb, dep, gt = [], [], ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(6):
        # 1/40 s apart: the 1/32 s frame-rate pick keeps every other frame
        t = 1305031102.175304 + i / 40.0
        cv2.imwrite(str(root / "rgb" / f"{t:.6f}.png"), _color(rng, i),
                    [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
        cv2.imwrite(str(root / "depth" / f"{t:.6f}.png"), _depth(rng))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + 0.012:.6f} depth/{t:.6f}.png")
        pose = _pose(rng)
        q = Rotation.from_matrix(pose[:3, :3]).as_quat()
        gt.append(f"{t - 0.004:.6f} " + " ".join(
            f"{v:.4f}" for v in list(pose[:3, 3]) + list(q)))
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(dep) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    s = W / 640.0
    cfg = _cfg("tumrgbd", root, depth_scale=5000.0, crop_edge=1,
               fx=517.306408 * s, fy=516.469215 * s, cx=318.643040 * s,
               cy=255.313989 * s,
               distortion=[0.262383, -0.953104, -0.005358, 0.002628,
                           1.163314])
    port = _compare(cfg, 3, "undistorted")
    # the first pose re-based to the identity, then y and z flipped
    np.testing.assert_array_equal(port[0].c2w,
                                  np.diag([1, -1, -1, 1]).astype(np.float32))


def test_every_dataset_of_the_reference_is_registered():
    assert set(tD.dataset_registry) == set(jD.dataset_registry)


def test_write_tum_rgbd_round_trips_through_the_readers(tmp_path):
    """The TUM writer (used by the chip smoke and the CPU run): frames come
    back through both packages' TUM readers up to the PNG quantisation
    (colour to 1/255, depth to 1/5000 m), poses re-based to the first."""
    syn = tD.Synthetic({"dataset": "synthetic", "seed": 5,
                        "synthetic": {"n_frames": 4}, "data": {},
                        "cam": {"H": H, "W": W, "fx": 20.0, "fy": 20.0,
                                "cx": 15.5, "cy": 11.5, "crop_edge": 0}})
    frames = [syn[i] for i in range(4)]
    tD.write_tum_rgbd(str(tmp_path), frames)
    cfg = _cfg("tumrgbd", tmp_path, depth_scale=5000.0)
    port = _compare(cfg, 4)
    inv0 = np.linalg.inv(frames[0].c2w.astype(np.float64))
    for fr, back in zip(frames, (port[i] for i in range(4))):
        assert np.abs(back.color - fr.color).max() <= 0.5 / 255 + 1e-6
        assert np.abs(back.depth - fr.depth).max() <= 0.5 / 5000 + 1e-6
        # the file holds c2w_i diag(1, -1, -1, 1); re-based and flipped
        # back that is diag(1, -1, -1, 1) c2w_0^-1 c2w_i
        want = np.diag([1.0, -1.0, -1.0, 1.0]) @ inv0 @ fr.c2w
        np.testing.assert_allclose(back.c2w, want, atol=1e-6)
