"""Run observability: JSONL metrics, an end-of-run summary plot and optional
wandb (port of hpslam_tpu/utils/telemetry.py).

Every record of a run lands in ``metrics.jsonl`` (``slam.PointSLAM``
writes it); with ``wandb: True`` in the config ``Telemetry`` mirrors the
records to wandb where that package imports, and prints one line saying
that ``metrics.jsonl`` alone holds them where it does not.  A failure
inside wandb once it is running is printed once, and the run goes on.

``summarize_run`` draws the reference's four panels from ``metrics.jsonl``
into ``plots/summary.png`` without matplotlib (the card's machine has
none): a 2x2 grid of the tracking best loss per frame, the camera position
error per frame, the mapping geometry and colour losses per mapped frame
and the fine and mid point counts per mapped frame.  Each series is a
polyline mapped linearly onto its panel's pixel box from the panel's data
minimum and maximum (both series of a panel share the box's scale), in
matplotlib's ``tab:`` colours in its order (blue, then orange; the
position error red, as the reference draws it), with a grey frame around
each box, on a white uint8 canvas written by ``image_io.write_png``.
Deliberate deviation from the reference's figure: no titles, ticks, axis
labels, grid or legends (there is no font).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

# the reference's figure: figsize (11, 7) at 110 dpi
CANVAS_HW = (770, 1210)
MARGIN = 40                      # pixels between a panel's cell and box
TAB_BLUE = (31, 119, 180)        # matplotlib's tab:blue (C0)
TAB_ORANGE = (255, 127, 14)      # tab:orange (C1)
TAB_RED = (214, 39, 40)          # tab:red
FRAME = (128, 128, 128)


class Telemetry:
    """Mirrors the run's records to wandb where ``cfg['wandb']`` asks for
    it and the package imports; otherwise does nothing."""

    def __init__(self, cfg: dict, output: str):
        self._wb = None
        self._wandb = None
        self._failed = False
        if not cfg.get("wandb", False):
            return
        try:
            import wandb  # optional; the card's machine has none
        except ImportError as e:
            print(f"wandb unavailable ({e}); metrics.jsonl only", flush=True)
            return
        try:
            self._wb = wandb.init(project=cfg.get("project_name",
                                                  "hpslam_tpu"),
                                  dir=output, config=cfg)
            self._wandb = wandb
        except Exception as e:  # noqa: BLE001 -- wandb's own failures
            print(f"wandb.init failed ({type(e).__name__}: {e}); "
                  "metrics.jsonl only", flush=True)
            self._wb = None

    def _mirror(self, fn):
        if self._wb is None:
            return
        try:
            fn()
        except Exception as e:  # noqa: BLE001 -- the run goes on
            if not self._failed:
                print(f"wandb logging failed ({type(e).__name__}: {e}); "
                      "metrics.jsonl still holds every record", flush=True)
                self._failed = True

    def log(self, record: dict, step: Optional[int] = None):
        flat = {k: v for k, v in record.items()
                if isinstance(v, (int, float, str))}
        self._mirror(lambda: self._wb.log(flat, step=step))

    def log_image(self, name: str, path: str, step: Optional[int] = None):
        self._mirror(lambda: self._wb.log(
            {name: self._wandb.Image(path)}, step=step))

    def finish(self):
        self._mirror(lambda: self._wb.finish())


def read_series(path: str) -> dict:
    """The summary's series from a metrics.jsonl: track_idx, track_loss,
    pos_err per tracked frame; map_idx, geo_loss, col_loss, pts_fine,
    pts_mid per mapped frame (missing values as 0, as the reference)."""
    out = {k: [] for k in ("track_idx", "track_loss", "pos_err", "map_idx",
                           "geo_loss", "col_loss", "pts_fine", "pts_mid")}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("event") == "track":
                out["track_idx"].append(r["idx"])
                out["track_loss"].append(r.get("loss") or 0.0)
                out["pos_err"].append(r.get("pos_err") or 0.0)
            elif r.get("event") == "map":
                out["map_idx"].append(r["idx"])
                out["geo_loss"].append(r.get("geo_loss") or 0.0)
                out["col_loss"].append(r.get("color_loss") or 0.0)
                p = r.get("pts") or {}
                out["pts_fine"].append(p.get("fine", 0))
                out["pts_mid"].append(p.get("mid", 0))
    return out


def panel_box(k: int) -> tuple:
    """Pixel box (x0, y0, x1, y1), inclusive, of panel k (0: top left, 1:
    top right, 2: bottom left, 3: bottom right)."""
    H, W = CANVAS_HW
    r, c = divmod(k, 2)
    return (c * W // 2 + MARGIN, r * H // 2 + MARGIN,
            (c + 1) * W // 2 - MARGIN, (r + 1) * H // 2 - MARGIN)


def project(xs, ys, box, xlim, ylim):
    """Data points onto the box's pixels: x from xlim onto [x0, x1], y from
    ylim onto [y1, y0] (up is up); a degenerate range maps to the middle.
    Returns integer (px, py)."""
    x0, y0, x1, y1 = box

    def lin(v, lo, hi, a, b):
        v = np.asarray(v, np.float64)
        if hi > lo:
            return a + (v - lo) / (hi - lo) * (b - a)
        return np.full(v.shape, 0.5 * (a + b))
    return (np.rint(lin(xs, xlim[0], xlim[1], x0, x1)).astype(np.int64),
            np.rint(lin(ys, ylim[0], ylim[1], y1, y0)).astype(np.int64))


def _draw_polyline(img, px, py, color):
    if len(px) == 1:
        img[py[0], px[0]] = color
    for a in range(len(px) - 1):
        n = int(max(abs(px[a + 1] - px[a]), abs(py[a + 1] - py[a]))) + 1
        t = np.linspace(0.0, 1.0, n)
        xs = np.rint(px[a] + t * (px[a + 1] - px[a])).astype(np.int64)
        ys = np.rint(py[a] + t * (py[a + 1] - py[a])).astype(np.int64)
        img[ys, xs] = color


def _draw_frame(img, box):
    x0, y0, x1, y1 = box
    img[y0, x0:x1 + 1] = FRAME
    img[y1, x0:x1 + 1] = FRAME
    img[y0:y1 + 1, x0] = FRAME
    img[y0:y1 + 1, x1] = FRAME


def panels(series: dict) -> list:
    """The four panels: [(x values, [(y values, colour), ...]), ...]."""
    t, m = series["track_idx"], series["map_idx"]
    return [(t, [(series["track_loss"], TAB_BLUE)]),
            (t, [(series["pos_err"], TAB_RED)]),
            (m, [(series["geo_loss"], TAB_BLUE),
                 (series["col_loss"], TAB_ORANGE)]),
            (m, [(series["pts_fine"], TAB_BLUE),
                 (series["pts_mid"], TAB_ORANGE)])]


def limits(xs, lines) -> tuple:
    """A panel's data ranges: (xlim, ylim) over the finite values of all
    its series."""
    ys = np.concatenate([np.asarray(y, np.float64) for y, _ in lines])
    ys = ys[np.isfinite(ys)]
    ylim = (float(ys.min()), float(ys.max())) if ys.size else (0.0, 0.0)
    return (float(np.min(xs)), float(np.max(xs))), ylim


def summarize_run(output: str) -> Optional[str]:
    """Render metrics.jsonl into plots/summary.png.  Returns its path, or
    None when the file is missing or holds no track or map record."""
    from .image_io import write_png
    path = os.path.join(output, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    series = read_series(path)
    if not series["track_idx"] and not series["map_idx"]:
        return None
    img = np.full(CANVAS_HW + (3,), 255, np.uint8)
    for k, (xs, lines) in enumerate(panels(series)):
        box = panel_box(k)
        _draw_frame(img, box)
        if not len(xs):
            continue
        xlim, ylim = limits(xs, lines)
        for ys, color in lines:
            ok = np.isfinite(np.asarray(ys, np.float64))
            if ok.any():
                px, py = project(np.asarray(xs)[ok], np.asarray(ys)[ok], box,
                                 xlim, ylim)
                _draw_polyline(img, px, py, color)
    out_dir = os.path.join(output, "plots")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "summary.png")
    write_png(out, img)
    return out
