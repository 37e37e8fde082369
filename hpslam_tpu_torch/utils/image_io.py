"""Image decode and resampling for the RGB-D readers, in numpy and the
standard library's ``zlib`` (the port's own stand-in for the reference's
cv2 calls, hpslam_tpu/utils/datasets.py):

* ``read_png``: non-interlaced PNG, 8- and 16-bit, grey, grey + alpha,
  RGB and RGBA, every filter type (0-4); what
  ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns, but in the file's
  channel order (RGB, not BGR).  ``write_png`` writes such files, its
  rows filtered by libpng's adaptive choice or by one given type.
* ``read_color``: ``cv2.imread(path)`` (3 channels, 8 bits) in RGB order;
  JPEG files through the port's own baseline decoder (``native.jpeg_decode``,
  C++ on the host, cv2's pixels bit for bit).  ``write_jpeg`` writes
  baseline JPEG files (``native.jpeg_encode``).
* ``undistort``: ``cv2.undistort(img, K, dist)`` (newCameraMatrix = K) of
  an 8-bit image, with cv2's fixed-point bilinear remap.
* ``resize``: ``cv2.resize`` of a float image, INTER_LINEAR or
  INTER_NEAREST, with cv2's pixel-centre convention.
"""
from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # colour type -> samples per pixel


def _chunks(buf: bytes, path: str):
    off = len(_SIG)
    while off + 8 <= len(buf):
        n, kind = struct.unpack_from(">I4s", buf, off)
        data = buf[off + 8:off + 8 + n]
        crc = struct.unpack_from(">I", buf, off + 8 + n)[0]
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        yield kind, data
        off += 12 + n


_FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of data (H, n) uint8 (n bytes a row,
    bpp bytes a pixel).  Rows of types 0-2 depend on at most the row above,
    so they go row by row; Average and Paeth also depend on the pixel to
    the left, so an image with such rows goes by anti-diagonals of pixels,
    on each of which every pixel's left, upper and upper-left neighbours
    are already reconstructed.  The image is sheared once so that each
    anti-diagonal d (pixels (r, d - r)) is one contiguous row of ``sk``:
    sk[d + 2, r + 1] holds pixel (r, d - r), and its left, upper and
    upper-left neighbours are sk[d + 1, r + 1], sk[d + 1, r] and
    sk[d, r]; the cells outside the image stay zero, PNG's border."""
    H, n = data.shape
    if ftype.max(initial=0) <= 2:
        out = np.empty_like(data)
        prev = np.zeros(n, np.uint8)
        for r in range(H):
            if ftype[r] == 0:
                prev = data[r]
            elif ftype[r] == 1:
                prev = np.cumsum(data[r].reshape(-1, bpp), axis=0,
                                 dtype=np.uint8).reshape(-1)
            else:
                prev = data[r] + prev
            out[r] = prev
        return out
    Wp = n // bpp
    nd = H + Wp - 1
    r = np.arange(H)[:, None]
    x = np.arange(Wp)[None, :]
    f = np.zeros((nd, H, bpp), np.int16)
    f[r + x, r] = data.reshape(H, Wp, bpp)
    sk = np.zeros((nd + 2, H + 1, bpp), np.int16)
    # the prediction of types 0-3 is (ka * a + kb * b) >> 1
    t = ftype.astype(np.int64)
    ka = np.array([0, 2, 0, 1, 0], np.int16)[t][:, None]
    kb = np.array([0, 0, 2, 1, 0], np.int16)[t][:, None]
    paeth = (t == 4)[:, None]
    for d in range(nd):
        lo, hi = max(0, d - Wp + 1), min(H, d + 1)
        a = sk[d + 1, lo + 1:hi + 1]
        b = sk[d + 1, lo:hi]
        pred = (ka[lo:hi] * a + kb[lo:hi] * b) >> 1
        if paeth[lo:hi].any():
            pred = np.where(paeth[lo:hi], _paeth(a, b, sk[d, lo:hi]), pred)
        sk[d + 2, lo + 1:hi + 1] = (f[d, lo:hi] + pred) & 255
    return sk[r + x + 2, r + 1].astype(np.uint8).reshape(H, n)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file: (H, W) for grey, else (H, W, C) in the file's
    channel order; uint8 or uint16."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if not buf.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _comp, _filt, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not supported")
    if depth not in (8, 16) or ctype not in _CHANNELS:
        raise ValueError(f"{path}: bit depth {depth} / colour type {ctype} "
                         "is not supported (8 or 16 bits; grey, grey + "
                         "alpha, RGB, RGBA)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: image data has {raw.size} bytes, "
                         f"expected {H * (1 + W * bpp)}")
    rows = raw.reshape(H, 1 + W * bpp)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG filter type")
    px = _unfilter(np.ascontiguousarray(rows[:, 1:]), rows[:, 0], bpp)
    if depth == 16:
        px = px.reshape(H, W * ch, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    img = px.reshape(H, W, ch)
    return img[..., 0] if ch == 1 else img


def _filtered_rows(rows: np.ndarray, bpp: int, filt: str) -> np.ndarray:
    """The rows (H, n) uint8 as PNG image data (H, 1 + n): each row
    prefixed by its filter type.  filt names one type for every row, or
    is 'adaptive': per row the type whose bytes, read as signed, have the
    least sum of magnitudes (libpng's choice; ties to the lower type)."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = [0, a, b, (a + b) >> 1, _paeth(a, b, c)]
    if filt == "adaptive":
        res = np.stack([(x - p) & 255 for p in preds])       # (5, H, n)
        cost = np.minimum(res, 256 - res).sum(axis=2)         # (5, H)
        t = np.argmin(cost, axis=0)
        out = res[t, np.arange(rows.shape[0])]
    elif filt in _FILTERS:
        t = np.full(rows.shape[0], _FILTERS[filt])
        out = (x - preds[_FILTERS[filt]]) & 255
    else:
        raise ValueError(f"write_png: unknown filter {filt!r}")
    return np.concatenate([t[:, None], out], 1).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filt: str = "adaptive") -> None:
    """Write img ((H, W) grey or (H, W, 1|2|3|4), uint8 or uint16) as a PNG
    file, its rows filtered by filt: 'none', 'sub', 'up', 'average',
    'paeth' or 'adaptive' (see ``_filtered_rows``)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png: uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2" if depth == 16 else np.uint8).view(
        np.uint8).reshape(H, -1)
    raw = _filtered_rows(rows, ch * depth // 8, filt)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as fh:
        fh.write(_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                                   ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                 + chunk(b"IEND", b""))


def write_jpeg(path: str, img: np.ndarray, quality: int = 95,
               subsampling: str = "420") -> None:
    """Write img ((H, W) grey or (H, W, 3) RGB, uint8) as a baseline JPEG
    file: the standard (Annex K) tables scaled to ``quality`` as libjpeg
    scales them, chroma '420' or '444'."""
    from ..native import jpeg_encode
    data = jpeg_encode(img, quality, subsampling)
    with open(path, "wb") as fh:
        fh.write(data)


def read_color(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB, as ``cv2.imread(path)`` (grey
    replicated, alpha dropped, 16 bits cut to their high byte) reads it in
    BGR.  JPEG goes through the port's baseline decoder: any other JPEG
    process raises ValueError naming the file and the marker."""
    if path.lower().endswith((".jpg", ".jpeg")):
        from ..native import jpeg_decode
        with open(path, "rb") as fh:
            data = fh.read()
        try:
            return jpeg_decode(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):                  # grey (+ alpha)
        img = img[..., :1]
        return np.ascontiguousarray(np.repeat(img, 3, axis=2))
    return np.ascontiguousarray(img[..., :3])


@functools.lru_cache(maxsize=4)
def _undistort_taps(H: int, W: int, fx: float, fy: float, cx: float,
                    cy: float, k1: float, k2: float, p1: float, p2: float,
                    k3: float):
    """The bilinear taps of ``undistort``'s map, which a reader's frames
    share: flat source pixel ids (4, H*W) and weights (4, H*W) in
    1/32768, zero for taps outside the image."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    x, y = (u - cx) / fx, (v - cy) / fy
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    mu = fx * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + cx
    mv = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + cy
    iu = np.rint(mu * 32).astype(np.int64)
    iv = np.rint(mv * 32).astype(np.int64)
    sx, ax = iu >> 5, iu & 31
    sy, ay = iv >> 5, iv & 31
    ids, ws = [], []
    for dy, wy in ((0, 32 - ay), (1, ay)):
        for dx, wx in ((0, 32 - ax), (1, ax)):
            yy, xx = sy + dy, sx + dx
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            ids.append(np.clip(yy, 0, H - 1) * W + np.clip(xx, 0, W - 1))
            ws.append(np.where(inside, wy * wx * 32, 0))
    return (np.stack(ids).reshape(4, -1).astype(np.int32),
            np.stack(ws).reshape(4, -1).astype(np.int32))


def undistort(img: np.ndarray, K: np.ndarray, dist) -> np.ndarray:
    """``cv2.undistort(img, K, dist)`` with newCameraMatrix = K, for an
    8-bit (H, W) or (H, W, C) image: each pixel maps through the
    5-coefficient model (k1, k2, p1, p2, k3) to a source position, rounded
    to 1/32 pixel, and is sampled bilinearly with weights in 1/32768 and a
    zero border, as cv2's fixed-point remap does."""
    if img.dtype != np.uint8:
        raise TypeError(f"undistort: uint8 images only, not {img.dtype}")
    H, W = img.shape[:2]
    coef = (list(np.asarray(dist, np.float64).reshape(-1)) + [0.0] * 5)[:5]
    ids, ws = _undistort_taps(H, W, float(K[0, 0]), float(K[1, 1]),
                              float(K[0, 2]), float(K[1, 2]),
                              *(float(c) for c in coef))
    src = img.reshape(H * W, -1).astype(np.int32)
    acc = sum(ws[t][:, None] * src[ids[t]] for t in range(4))
    out = ((acc + (1 << 14)) >> 15).astype(np.uint8)
    return out.reshape(img.shape)


def _linear_taps(n_src: int, n_dst: int):
    """cv2's INTER_LINEAR source taps and weights along one axis."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s
    lo = s < 0
    f[lo], s[lo] = 0.0, 0
    hi = s >= n_src - 1
    f[hi], s[hi] = 0.0, n_src - 1
    return s, np.minimum(s + 1, n_src - 1), (1.0 - f).astype(np.float32), f


def resize(img: np.ndarray, size, interpolation: str = "linear"):
    """``cv2.resize(img, (w, h), interpolation=...)`` with size = (w, h),
    as cv2 takes it: 'nearest' (INTER_NEAREST, source index floor(dst *
    src / dst_size)) for any dtype, 'linear' (INTER_LINEAR, pixel centres
    aligned, edge taps clamped) for float images."""
    w, h = size
    H, W = img.shape[:2]
    if interpolation == "nearest":
        ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))), H - 1)
        xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))), W - 1)
        return np.ascontiguousarray(img[ys.astype(np.int64)][
            :, xs.astype(np.int64)])
    if interpolation != "linear":
        raise ValueError(f"resize: unknown interpolation {interpolation!r}")
    if not np.issubdtype(img.dtype, np.floating):
        raise TypeError("resize: linear resampling of float images only")
    x0, x1, wx0, wx1 = _linear_taps(W, w)
    y0, y1, wy0, wy1 = _linear_taps(H, h)
    src = img.reshape(H, W, -1)
    rows = src[:, x0] * wx0[None, :, None] + src[:, x1] * wx1[None, :, None]
    out = rows[y0] * wy0[:, None, None] + rows[y1] * wy1[:, None, None]
    return out.reshape((h, w) + img.shape[2:]).astype(img.dtype)
