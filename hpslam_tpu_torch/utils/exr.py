"""Minimal OpenEXR scanline codec (a copy of hpslam_tpu/utils/exr.py; the
port imports nothing of the reference package).

The CoFusion dataset ships depth as ``.exr`` files, which the original
Point-SLAM decodes with the third-party OpenEXR package (its
``readEXR_onlydepth`` reads the ``Y`` channel as float32).  Neither that
package nor cv2 (whose builds mostly lack the EXR codec) is needed: this
module implements the subset of the format those files need:

* reading: version-2 scanline files, ``NONE`` / ``RLE`` / ``ZIPS`` /
  ``ZIP`` compression, ``HALF`` / ``FLOAT`` / ``UINT`` channels,
  increasing-y line order;
* writing (used by tests): ``NONE`` or ``ZIP`` compressed FLOAT channels.

Format reference: the public OpenEXR file-layout documentation
(openexr.com: "Reading and Writing Image Files" / ImfZip predictor).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_COMP_LINES = {0: 1, 1: 1, 2: 1, 3: 16}  # NONE, RLE, ZIPS, ZIP


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_chlist(data: bytes):
    """-> [(name, numpy dtype)] in file (alphabetical) order."""
    chans = []
    off = 0
    while data[off] != 0:
        name, off = _read_cstr(data, off)
        ptype = struct.unpack_from("<i", data, off)[0]
        # pLinear (1B) + reserved (3B) + xSampling/ySampling (2 x int32)
        off += 16
        chans.append((name, _PIXEL_DTYPE[ptype]))
    return chans


def _unpredict(d: np.ndarray) -> np.ndarray:
    """Inverse of the ImfZip byte predictor + two-half interleave.

    Predictor: t[0] = raw[0]; t[i] = t[i-1] + raw[i] - 128 (mod 256)
    == cumsum(raw - 128) + 128, taken mod 256 like the C uint8 loop.
    """
    d = (np.cumsum(d.astype(np.int64) - 128) + 128).astype(np.uint8)
    n = d.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out


def _rle_decode(data: bytes, out_len: int) -> np.ndarray:
    out = np.empty(out_len, np.uint8)
    i = o = 0
    mv = memoryview(data)
    while i < len(data) and o < out_len:
        n = struct.unpack_from("<b", mv, i)[0]
        i += 1
        if n < 0:  # -n literal bytes
            cnt = -n
            out[o:o + cnt] = np.frombuffer(mv[i:i + cnt], np.uint8)
            i += cnt
        else:  # n+1 copies of the next byte
            cnt = n + 1
            out[o:o + cnt] = data[i]
            i += 1
        o += cnt
    if o != out_len:
        raise ValueError(f"EXR RLE underrun ({o} != {out_len})")
    return out


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Decode a scanline EXR file -> {channel: (H, W) float32/uint32}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:  # tiled bit
        raise ValueError(f"{path}: tiled EXR unsupported")

    off = 8
    chans = None
    comp = 0
    dw = None
    while buf[off] != 0:  # header ends with an empty attribute name
        name, off = _read_cstr(buf, off)
        _atype, off = _read_cstr(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        data = buf[off:off + size]
        off += size
        if name == "channels":
            chans = _parse_chlist(data)
        elif name == "compression":
            comp = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", data)
    off += 1  # header terminator
    if chans is None or dw is None:
        raise ValueError(f"{path}: missing channels/dataWindow")
    if comp not in _COMP_LINES:
        raise ValueError(f"{path}: unsupported EXR compression {comp} "
                         "(supported: NONE, RLE, ZIPS, ZIP)")
    xmin, ymin, xmax, ymax = dw
    W, H = xmax - xmin + 1, ymax - ymin + 1
    lines_per_blk = _COMP_LINES[comp]
    n_blocks = -(-H // lines_per_blk)
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)

    line_bytes = sum(W * np.dtype(dt).itemsize for _, dt in chans)
    out = {name: np.empty((H, W), dt) for name, dt in chans}
    for b, boff in enumerate(offsets):
        y, size = struct.unpack_from("<ii", buf, boff)
        raw = buf[boff + 8: boff + 8 + size]
        y0 = y - ymin
        n_lines = min(lines_per_blk, H - y0)
        want = line_bytes * n_lines
        if comp == 0 or size == want:  # NONE, or stored-raw fallback
            blk = np.frombuffer(raw, np.uint8)
        elif comp == 1:
            blk = _unpredict(_rle_decode(raw, want))
        else:  # ZIPS / ZIP
            blk = _unpredict(np.frombuffer(zlib.decompress(raw), np.uint8))
        pos = 0
        for li in range(n_lines):
            for name, dt in chans:
                nb = W * np.dtype(dt).itemsize
                out[name][y0 + li] = np.frombuffer(
                    blk[pos:pos + nb].tobytes(), dt)
                pos += nb
    return {k: (v.astype(np.float32) if v.dtype == np.float16 else v)
            for k, v in out.items()}


def read_exr_depth(path: str) -> Optional[np.ndarray]:
    """Depth buffer as float32 — the reference's ``readEXR_onlydepth``
    semantics (channel ``Y``; ``src/utils/datasets.py:42-44``), extended to
    fall back to ``Z`` / ``R`` / the only channel for robustness."""
    chans = read_exr(path)
    for name in ("Y", "Z", "R"):
        if name in chans:
            return chans[name].astype(np.float32)
    if len(chans) == 1:
        return next(iter(chans.values())).astype(np.float32)
    return None


def _predict(d: np.ndarray) -> bytes:
    """Forward ImfZip reorder: de-interleave halves, then byte delta."""
    n = d.size
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = d[0::2]
    t[half:] = d[1::2]
    ti = t.astype(np.int16)
    ti[1:] = (ti[1:] - ti[:-1] + 128) & 0xFF
    return ti.astype(np.uint8).tobytes()


def write_exr(path: str, channels: Dict[str, np.ndarray],
              compression: str = "zip") -> None:
    """Write FLOAT channels as a scanline EXR (tests' fixture writer)."""
    names = sorted(channels)
    H, W = channels[names[0]].shape
    comp = {"none": 0, "zips": 2, "zip": 3}[compression]
    lines_per_blk = _COMP_LINES[comp]

    chl = b""
    for n in names:
        chl += n.encode("latin-1") + b"\x00"
        chl += struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    chl += b"\x00"

    def attr(name: str, atype: str, data: bytes) -> bytes:
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(data)) + data)

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (struct.pack("<ii", _MAGIC, 2)
              + attr("channels", "chlist", chl)
              + attr("compression", "compression", bytes([comp]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\x00")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\x00")

    n_blocks = -(-H // lines_per_blk)
    blocks = []
    for b in range(n_blocks):
        y0 = b * lines_per_blk
        n_lines = min(lines_per_blk, H - y0)
        raw = b"".join(
            channels[n][y0 + li].astype("<f4").tobytes()
            for li in range(n_lines) for n in names)
        if comp == 0:
            data = raw
        else:
            z = zlib.compress(_predict(np.frombuffer(raw, np.uint8)))
            data = z if len(z) < len(raw) else raw
        blocks.append((y0, data))

    with open(path, "wb") as f:
        f.write(header)
        pos = len(header) + 8 * n_blocks
        for y0, data in blocks:
            f.write(struct.pack("<q", pos))
            pos += 8 + len(data)
        for y0, data in blocks:
            f.write(struct.pack("<ii", y0, len(data)) + data)
