"""The port's baseline JPEG codec (hpslam_tpu_torch/native/jpeg.cpp through
utils/image_io.read_color / write_jpeg) against cv2, which the reference
reads colour frames with (hpslam_tpu/utils/datasets.py).

read_color must equal cv2.imread (BGR flipped to RGB) bit for bit on
files that cv2 writes: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and grey, with and
without restart markers, optimised (custom) Huffman tables, qualities
from 5 to 100, odd sizes (37x53, 17x5, 1x1, 2x3) and a ScanNet colour
frame's 968x1296.  write_jpeg's files decode to the same bits in cv2 and
in the port, near the image written; a progressive file is refused with
its name and its marker.  The ScanNet reader reads a tree that
datasets.write_scannet_tree writes as it reads cv2's own."""
import os

import cv2
import numpy as np
import pytest

from hpslam_tpu_torch.utils import datasets as D
from hpslam_tpu_torch.utils import image_io as IO

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def textured(rng, h, w, noise=20.0):
    """Smooth colour waves plus noise: both flat runs and busy blocks."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0),
                    128 + 90 * np.cos(x / 5.0 - y / 13.0),
                    128 + 80 * np.sin((x + y) / 9.0)], -1)
    img = img + rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_file(tmp_path, img, params, name="f.jpg"):
    path = str(tmp_path / name)
    assert cv2.imwrite(path, img, params)
    return path


def assert_as_cv2(path):
    ref = cv2.imread(path)
    got = IO.read_color(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref[..., ::-1]), (
        int(np.abs(got.astype(int) - ref[..., ::-1]).max()),
        int((got != ref[..., ::-1]).any(-1).sum()))


@pytest.mark.parametrize("size", [(37, 53), (968, 1296)],
                         ids=["37x53", "968x1296"])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
@pytest.mark.parametrize("restart", [0, 3], ids=["no-rst", "rst"])
def test_read_color_equals_cv2(rng, tmp_path, size, sampling, restart):
    img = textured(rng, *size)
    params = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_QUALITY, 90]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    path = cv2_file(tmp_path, img, params)
    with open(path, "rb") as fh:
        data = fh.read()
    assert (b"\xff\xdd" in data) == bool(restart)     # DRI segment
    assert_as_cv2(path)


@pytest.mark.parametrize("size", [(37, 53), (17, 5), (1, 1), (2, 3),
                                  (968, 1296)],
                         ids=["37x53", "17x5", "1x1", "2x3", "968x1296"])
def test_read_color_equals_cv2_grey_and_tiny(rng, tmp_path, size):
    """Grey files (replicated to three channels), and colour 4:2:0 at
    sizes where a chroma plane is 1 or 2 samples wide (box upsampling)."""
    img = textured(rng, *size)
    grey = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    assert_as_cv2(cv2_file(tmp_path, grey, [], "g.jpg"))
    assert_as_cv2(cv2_file(tmp_path, img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
                           "c.jpg"))


@pytest.mark.parametrize("quality", [5, 50, 100])
def test_read_color_equals_cv2_tables(rng, tmp_path, quality):
    """Quantisation tables from quality 5 to 100 and optimised (custom)
    Huffman tables."""
    img = textured(rng, 61, 83, noise=40.0)
    for opt in (0, 1):
        assert_as_cv2(cv2_file(tmp_path, img, [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_OPTIMIZE, opt], f"q{opt}.jpg"))


@pytest.mark.parametrize("subsampling", ["420", "444"])
def test_write_jpeg_reads_in_cv2_and_the_port(rng, tmp_path, subsampling):
    img = textured(rng, 37, 53, noise=3.0)
    path = str(tmp_path / "w.jpg")
    IO.write_jpeg(path, img, 95, subsampling)
    ref = cv2.imread(path)
    assert ref is not None and ref.shape == img.shape
    assert_as_cv2(path)
    err = np.abs(ref[..., ::-1].astype(int) - img).mean()
    assert err < (4.0 if subsampling == "420" else 2.5), err
    grey = img[..., 1]
    IO.write_jpeg(str(tmp_path / "g.jpg"), grey, 95)
    assert_as_cv2(str(tmp_path / "g.jpg"))
    assert np.abs(IO.read_color(str(tmp_path / "g.jpg"))[..., 0].astype(int)
                  - grey).mean() < 2.5


def test_progressive_and_bad_files_refused(rng, tmp_path):
    img = textured(rng, 37, 53)
    path = cv2_file(tmp_path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                    "prog.jpg")
    with pytest.raises(ValueError, match=r"prog\.jpg.*SOF2.*progressive"):
        IO.read_color(path)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(ValueError, match=r"bad\.jpg"):
        IO.read_color(str(bad))
    with open(cv2_file(tmp_path, img, [], "t.jpg"), "rb") as fh:
        data = fh.read()
    (tmp_path / "trunc.jpg").write_bytes(data[:200])
    with pytest.raises(ValueError, match=r"trunc\.jpg"):
        IO.read_color(str(tmp_path / "trunc.jpg"))


def test_scannet_tree_round_trip(rng, tmp_path):
    """write_scannet_tree's tree through the ScanNet reader: colour as cv2
    decodes the same JPEG files (then /255, cropped), depth and poses back
    exactly."""
    cfg = {"dataset": "scannet", "data": {},
           "cam": {"H": 48, "W": 64, "fx": 57.8, "fy": 57.9, "cx": 31.9,
                   "cy": 24.3, "png_depth_scale": 1000.0, "crop_edge": 2}}
    frames = []
    for i in range(3):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.1 * i, 0.0, 0.05 * i]
        frames.append(D.Frame(i, textured(rng, 48, 64, 5.0) / 255.0,
                              np.full((48, 64), 2.0 + 0.001 * i, np.float32),
                              c2w))
    D.write_scannet_tree(str(tmp_path), frames)
    ds = D.get_dataset(cfg, input_folder=str(tmp_path))
    assert len(ds) == 3
    for i in range(3):
        fr = ds[i]
        ref = cv2.imread(os.path.join(str(tmp_path), "color", f"{i}.jpg"))
        col = (ref[..., ::-1].astype(np.float32) / 255.0)[2:-2, 2:-2]
        assert np.array_equal(fr.color, col)
        np.testing.assert_allclose(fr.depth, frames[i].depth[2:-2, 2:-2],
                                   atol=0.5e-3)
        np.testing.assert_allclose(fr.c2w, frames[i].c2w, atol=1e-7)
