"""The port's image codec and resampling (hpslam_tpu_torch/utils/image_io.py)
against cv2, which the reference's readers call.

PNG decode: bit for bit cv2.imread(..., IMREAD_UNCHANGED) (channel order
aside) on files cv2 writes (8-bit RGB with each filter and libpng's
adaptive choice, 16-bit grey, RGBA) and on files the port's writer writes
(every colour type and depth, every filter type; its adaptive choice is
libpng's, row for row).  undistort: cv2.undistort with
tum_rgbd.yaml's coefficients, on which at least 99.9 % of the pixels are
bitwise equal and none is more than 1 level of 255 off.  resize: cv2.resize
of float images, linear within 1e-4 absolute (cv2 rounds its coefficients
in float32), nearest bit for bit.
"""
import cv2
import numpy as np
import pytest

from hpslam_tpu_torch.utils import image_io as IO

K_TUM = np.array([[517.306408, 0.0, 318.643040],
                  [0.0, 516.469215, 255.313989], [0.0, 0.0, 1.0]])
DIST_TUM = np.array([0.262383, -0.953104, -0.005358, 0.002628, 1.163314])


def _photo(rng, H, W):
    """Smooth gradients plus noise: libpng's adaptive filter choice then
    mixes every filter type."""
    jj, ii = np.mgrid[0:H, 0:W]
    img = np.stack([ii * 0.7 + jj * 0.3, 120 + 90 * np.sin(ii / 9.0),
                    (ii * jj) % 251], -1) + rng.integers(0, 6, (H, W, 3))
    return (img % 256).astype(np.uint8)


def _unchanged_rgb(path):
    """cv2.imread(IMREAD_UNCHANGED) in the file's channel order."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = img[..., [2, 1, 0] + ([3] if img.shape[2] == 4 else [])]
    return img


@pytest.mark.parametrize("flt", ["NONE", "SUB", "UP", "AVG", "PAETH",
                                 "ALL_FILTERS"])
def test_png_decode_equals_cv2_rgb8(tmp_path, rng, flt):
    img = _photo(rng, 37, 53)
    p = str(tmp_path / "c.png")
    cv2.imwrite(p, img, [cv2.IMWRITE_PNG_FILTER,
                         getattr(cv2, f"IMWRITE_PNG_{flt}"
                                 if flt == "ALL_FILTERS"
                                 else f"IMWRITE_PNG_FILTER_{flt}")])
    out = IO.read_png(p)
    assert out.dtype == np.uint8 and out.shape == (37, 53, 3)
    np.testing.assert_array_equal(out, _unchanged_rgb(p))
    np.testing.assert_array_equal(IO.read_color(p), img[..., ::-1])


def test_png_decode_equals_cv2_grey16_and_rgba(tmp_path, rng):
    depth = rng.integers(0, 65535, (29, 41)).astype(np.uint16)
    depth[:5] = np.arange(41) * 1000                 # smooth rows
    p = str(tmp_path / "d.png")
    cv2.imwrite(p, depth, [cv2.IMWRITE_PNG_FILTER,
                           cv2.IMWRITE_PNG_ALL_FILTERS])
    out = IO.read_png(p)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, cv2.imread(p, cv2.IMREAD_UNCHANGED))
    rgba = np.concatenate([_photo(rng, 29, 41),
                           rng.integers(0, 256, (29, 41, 1), np.uint8)], -1)
    q = str(tmp_path / "a.png")
    cv2.imwrite(q, rgba, [cv2.IMWRITE_PNG_FILTER,
                          cv2.IMWRITE_PNG_FILTER_PAETH])
    np.testing.assert_array_equal(IO.read_png(q), _unchanged_rgb(q))
    # cv2.imread's default: 3 channels, alpha dropped
    np.testing.assert_array_equal(IO.read_color(q),
                                  cv2.imread(q)[..., ::-1])


@pytest.mark.parametrize("shape,dtype", [((23, 31), np.uint8),
                                         ((23, 31), np.uint16),
                                         ((23, 31, 2), np.uint8),
                                         ((23, 31, 3), np.uint8),
                                         ((23, 31, 3), np.uint16),
                                         ((23, 31, 4), np.uint8)])
def test_png_writer_round_trips(tmp_path, rng, shape, dtype):
    top = np.iinfo(dtype).max
    img = rng.integers(0, top, shape, endpoint=True).astype(dtype)
    p = str(tmp_path / "w.png")
    IO.write_png(p, img)
    np.testing.assert_array_equal(IO.read_png(p), img)
    if len(shape) == 2 or shape[2] != 2:   # cv2 reads grey + alpha as BGRA
        np.testing.assert_array_equal(_unchanged_rgb(p), img)


def _row_filters(path):
    """The filter type of each row of a PNG file."""
    import struct
    import zlib
    with open(path, "rb") as fh:
        buf = fh.read()
    H = struct.unpack_from(">I", buf, 20)[0]           # IHDR's height
    idat, off = b"", 8
    while off < len(buf):
        n, kind = struct.unpack_from(">I4s", buf, off)
        if kind == b"IDAT":
            idat += buf[off + 8:off + 8 + n]
        off += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, -1)[:, 0]


@pytest.mark.parametrize("filt", ["none", "sub", "up", "average", "paeth",
                                  "adaptive"])
def test_png_writer_filters(tmp_path, rng, filt):
    """The port writer's rows under each filter decode to the image through
    read_png and through cv2; 'adaptive' picks the filter type that libpng
    picks for each row (cv2's file of the same image)."""
    jj, ii = np.mgrid[0:29, 0:41]
    depth = (5000 * (1.5 + 0.5 * np.sin(ii / 5.0) * np.cos(jj / 4.0))
             ).astype(np.uint16)
    for img in (_photo(rng, 37, 53), depth):
        p = str(tmp_path / "f.png")
        IO.write_png(p, img, filt)
        np.testing.assert_array_equal(IO.read_png(p), img)
        np.testing.assert_array_equal(_unchanged_rgb(p), img)
        if filt == "adaptive":
            q = str(tmp_path / "cv.png")
            cv2.imwrite(q, img if img.ndim == 2 else img[..., ::-1],
                        [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
            np.testing.assert_array_equal(_row_filters(p), _row_filters(q))
            assert (_row_filters(p) >= 3).any()


def test_png_rejects_what_it_does_not_decode(tmp_path, rng):
    p = str(tmp_path / "i.png")
    img = _photo(rng, 8, 8)
    cv2.imwrite(p, img)
    with open(p, "rb") as fh:
        buf = bytearray(fh.read())
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as fh:
        fh.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        IO.read_png(bad)
    # flip the interlace byte of IHDR (and fix its CRC): refused
    import struct
    import zlib
    buf[8 + 8 + 12] = 1
    buf[29:33] = struct.pack(">I", zlib.crc32(bytes(buf[12:29])))
    with open(bad, "wb") as fh:
        fh.write(bytes(buf))
    with pytest.raises(ValueError, match="interlaced"):
        IO.read_png(bad)


def test_jpeg_needs_cv2_and_names_the_file(tmp_path, rng, monkeypatch):
    """JPEG no longer needs cv2 (the port decodes it itself): with cv2's
    import refused, read_color still returns cv2.imread's pixels; a file
    it cannot decode raises ValueError naming the file."""
    import builtins
    p = str(tmp_path / "f.jpg")
    img = _photo(rng, 16, 24)
    cv2.imwrite(p, img)
    ref = cv2.imread(p)[..., ::-1]
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    np.testing.assert_array_equal(IO.read_color(p), ref)
    with open(p, "r+b") as fh:
        fh.truncate(100)
    with pytest.raises(ValueError, match="f.jpg"):
        IO.read_color(p)


def test_undistort_matches_cv2_on_tum_coefficients(rng):
    img = _photo(rng, 480, 640)
    out = IO.undistort(img, K_TUM, DIST_TUM)
    ref = cv2.undistort(img, K_TUM, DIST_TUM)
    bitwise = float(np.all(out == ref, axis=-1).mean())
    worst = int(np.abs(out.astype(np.int64) - ref).max())
    assert bitwise >= 0.999 and worst <= 1, (bitwise, worst)
    # zero distortion is the identity, bit for bit
    np.testing.assert_array_equal(IO.undistort(img, K_TUM, np.zeros(5)), img)
    with pytest.raises(TypeError):
        IO.undistort(img.astype(np.float32), K_TUM, DIST_TUM)


@pytest.mark.parametrize("size", [(32, 24), (64, 48), (57, 41), (90, 70)])
def test_resize_matches_cv2(rng, size):
    img = rng.random((48, 64, 3)).astype(np.float32)
    lin = IO.resize(img, size, "linear")
    ref = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    assert lin.shape == ref.shape and lin.dtype == np.float32
    np.testing.assert_allclose(lin, ref, rtol=0, atol=1e-4)
    depth = rng.random((48, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        IO.resize(depth, size, "nearest"),
        cv2.resize(depth, size, interpolation=cv2.INTER_NEAREST))
