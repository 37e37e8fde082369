"""Visualiser panels without matplotlib (the card's machine has none).

The port's stand-in for the reference's matplotlib figure
(hpslam_tpu/utils/visualizer.py): a 2x3 grid of H x W panels, input /
generated / residual depth in the top row and input / generated / residual
RGB in the bottom one, written as one PNG through ``image_io.write_png``.
Depth panels are coloured as ``imshow(a, cmap="plasma", vmin=0,
vmax=max(gt depth))`` colours them (``PLASMA_U8`` is matplotlib's 256-entry
``plasma`` table as ``imshow`` writes it to bytes); RGB panels as
``imshow`` writes a float RGB image in [0, 1] to bytes.  Residuals are zero
where the input depth is 0.

Deliberate deviations from the reference's figure: no titles and no axes
(there is no font), no margins, and the file is a PNG, not a JPEG.
"""
from __future__ import annotations

import numpy as np

# matplotlib's 'plasma' colormap, 256 entries, as (lut * 255).astype(uint8)
PLASMA_U8 = np.frombuffer(bytes.fromhex(
    "0c078610078713068915068a18068b1b068c1d068d1f058e21058f230590250591270592"
    "2905932b05942d04942f04953104963304973404983604983804993a049a3b039a3d039b"
    "3f039c40039c42039d44039e45039e47029f49029f4a02a04c02a14e02a14f02a25101a2"
    "5201a35401a35601a35701a45901a45a00a55c00a55e00a55f00a66100a66200a66400a7"
    "6500a76700a76800a76a00a76c00a86d00a86f00a87000a87200a87300a87500a87601a8"
    "7801a87901a87b02a87c02a77e03a77f03a78104a78204a78405a68506a68607a68807a5"
    "8908a58b09a48c0aa48e0ca48f0da3900ea3920fa29310a19511a19612a09713a099149f"
    "9a159e9b179e9d189d9e199c9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296"
    "a92395aa2494ac2593ad2692ae2791af2890b02a8fb12b8fb22c8eb42d8db52e8cb62f8b"
    "b7308ab83289b93388ba3487bb3586bc3685bd3784be3883bf3982c03b81c13c80c23d80"
    "c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678cb4777cc4876cd4975ce4a75"
    "cf4b74d04d73d14e72d14f71d25070d3516fd4526ed5536dd6556dd7566cd7576bd8586a"
    "d95969da5a68db5b67dc5d66dc5e66dd5f65de6064df6163df6262e06461e16560e26660"
    "e3675fe3685ee46a5de56b5ce56c5be66d5ae76e5ae87059e87158e97257ea7356ea7455"
    "eb7654ec7754ec7853ed7952ed7b51ee7c50ef7d4fef7e4ef0804df0814df1824cf2844b"
    "f2854af38649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f79241f79341"
    "f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba337fba436"
    "fca635fca735fca934fcaa33fcac32fcad31fdaf31fdb030fdb22ffdb32efdb52dfdb62d"
    "fdb82cfdb92bfdbb2bfdbc2afdbe29fdc029fdc128fdc328fdc427fdc626fcc726fcc926"
    "fccb25fccc25fcce25fbd024fbd124fbd324fad524fad624fad824f9d924f9db24f8dd24"
    "f8df24f7e024f7e225f6e425f6e525f5e726f5e926f4ea26f3ec26f3ee26f2f026f2f126"
    "f1f326f0f525f0f623eff821"), np.uint8).reshape(256, 3)


def normalize(a: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """(a - vmin) / (vmax - vmin) in a's float type, each step rounded to
    it, as matplotlib's Normalize computes it."""
    a = np.asarray(a)
    if a.dtype.kind != "f":
        a = a.astype(np.float64)
    vmin, vmax = np.float64(vmin), np.float64(vmax)
    if vmin == vmax:
        return np.zeros_like(a)
    out = (a - vmin).astype(a.dtype)
    return (out / (vmax - vmin)).astype(a.dtype)


def colormap(x: np.ndarray, lut: np.ndarray = PLASMA_U8) -> np.ndarray:
    """Normalised values -> (..., 3) uint8 colours: index trunc(x * N), x
    == 1 on the last entry, below 0 on the first, above 1 on the last,
    NaN black."""
    n = lut.shape[0]
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over | bad] = n - 1
    out = lut[idx]
    out[bad] = 0
    return out


def scalar_panel(a: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """imshow(a, cmap='plasma', vmin, vmax) as uint8 RGB."""
    return colormap(normalize(a, vmin, vmax))


def rgb_panel(a: np.ndarray) -> np.ndarray:
    """imshow of a float RGB image in [0, 1] as uint8 RGB (truncated)."""
    a = np.asarray(a)
    return (a * 255).astype(np.uint8)


def panel_grid(gt_depth, depth, gt_color, color) -> np.ndarray:
    """The reference's 2x3 figure as one (2H, 3W, 3) uint8 image (host
    arrays: depths (H, W), colours (H, W, 3))."""
    gt_d = np.asarray(gt_depth)
    gt_c = np.asarray(gt_color)
    depth = np.asarray(depth)
    color = np.asarray(color)
    res_d = np.abs(gt_d - depth)
    res_d[gt_d == 0] = 0
    res_c = np.abs(gt_c - np.clip(color, 0, 1))
    res_c[gt_d == 0] = 0
    dmax = float(np.max(gt_d)) if gt_d.max() > 0 else 1.0
    top = [scalar_panel(a, 0.0, dmax) for a in (gt_d, depth, res_d)]
    bottom = [rgb_panel(np.clip(a, 0, 1)) for a in (gt_c, color, res_c)]
    return np.concatenate([np.concatenate(top, 1),
                           np.concatenate(bottom, 1)], 0)


def write_panels(path: str, gt_depth, depth, gt_color, color) -> None:
    from .image_io import write_png
    write_png(path, panel_grid(gt_depth, depth, gt_color, color))
