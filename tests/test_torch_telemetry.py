"""The port's telemetry (hpslam_tpu_torch/utils/telemetry.py) against the
reference's tests (tests/test_telemetry.py): Telemetry degrades to
metrics.jsonl alone without wandb, summarize_run renders the run into
plots/summary.png (here without matplotlib: the port's own PNG, read back
by its decoder) and returns None for a missing or empty file.  Beyond
those: the polylines' pixels lie where the data put them, and a failure
inside wandb once it runs is printed once."""
import json
import os
import sys
import types

import numpy as np

from hpslam_tpu_torch.utils import image_io as IO
from hpslam_tpu_torch.utils import telemetry as T


def _write_metrics(out, n=10):
    with open(os.path.join(out, "metrics.jsonl"), "w") as f:
        for i in range(n):
            f.write(json.dumps({"event": "track", "idx": i,
                                "loss": 100.0 - i, "pos_err": 0.01 * i})
                    + "\n")
            if i % 5 == 0:
                f.write(json.dumps({"event": "map", "idx": i,
                                    "geo_loss": 50.0 - i, "color_loss": 70.0,
                                    "pts": {"fine": 100 * i, "mid": 60 * i}})
                        + "\n")


def test_telemetry_degrades_without_wandb(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    t = T.Telemetry({"wandb": True}, str(tmp_path))
    t.log({"event": "track", "idx": 1, "loss": 2.0})  # must not raise
    t.log_image("run_summary", str(tmp_path / "x.png"))
    t.finish()
    out = capsys.readouterr().out
    assert out.count("metrics.jsonl only") == 1


def test_summarize_run_renders_plots(tmp_path):
    out = str(tmp_path)
    _write_metrics(out)
    p = T.summarize_run(out)
    assert p == os.path.join(out, "plots", "summary.png")
    img = IO.read_png(p)
    assert img.shape == T.CANVAS_HW + (3,) and img.dtype == np.uint8
    for k in range(4):
        x0, y0, x1, y1 = T.panel_box(k)
        box = img[y0 + 1:y1, x0 + 1:x1]
        # line pixels (neither white background nor frame grey) in every
        # panel
        assert (np.abs(box.astype(int) - 255).sum(-1) > 0).any(), k


def test_summarize_run_empty(tmp_path):
    assert T.summarize_run(str(tmp_path)) is None
    open(tmp_path / "metrics.jsonl", "w").close()
    assert T.summarize_run(str(tmp_path)) is None


def test_polyline_pixels_where_the_data_put_them(tmp_path):
    """Each data point of a known series sits at its linear map onto the
    panel's box (x from the frame range, y from the panel's value range,
    up is up) in its series' colour; a panel with two series shares one
    scale; the segments between points are drawn."""
    out = str(tmp_path)
    _write_metrics(out)
    img = IO.read_png(T.summarize_run(out))
    s = T.read_series(os.path.join(out, "metrics.jsonl"))
    x0, y0, x1, y1 = T.panel_box(0)
    # track loss 100 - i over frames 0..9: a straight falling line from
    # the box's top left to its bottom right
    px, py = T.project(s["track_idx"], s["track_loss"], T.panel_box(0),
                       (0, 9), (91, 100))
    assert (px[0], py[0]) == (x0, y0) and (px[-1], py[-1]) == (x1, y1)
    for a, b in zip(px, py):
        assert tuple(img[b, a]) == T.TAB_BLUE
    xm = (x0 + x1) // 2
    col = np.nonzero((img[y0 + 1:y1, xm] == T.TAB_BLUE).all(-1))[0]
    assert col.size >= 1
    mid = y0 + 1 + col.mean()
    assert abs(mid - (y0 + (y1 - y0) * (xm - x0) / (x1 - x0))) <= 1.5
    # position error in red, rising
    px, py = T.project(s["track_idx"], s["pos_err"], T.panel_box(1),
                       (0, 9), (0.0, 0.09))
    for a, b in zip(px, py):
        assert tuple(img[b, a]) == T.TAB_RED
    # mapping losses: geo (blue) and colour (orange) on one scale from 45
    # to 70; colour's flat line lies on the box's top edge
    xlim, ylim = T.limits(s["map_idx"], [(s["geo_loss"], None),
                                         (s["col_loss"], None)])
    assert xlim == (0.0, 5.0) and ylim == (45.0, 70.0)
    gx, gy = T.project(s["map_idx"], s["geo_loss"], T.panel_box(2), xlim,
                       ylim)
    cx, cy = T.project(s["map_idx"], s["col_loss"], T.panel_box(2), xlim,
                       ylim)
    assert set(cy) == {T.panel_box(2)[1]}
    assert tuple(img[gy[-1], gx[-1]]) == T.TAB_BLUE
    assert tuple(img[cy[0], (cx[0] + cx[-1]) // 2]) == T.TAB_ORANGE


def test_wandb_failure_printed_once(tmp_path, monkeypatch, capsys):
    """A wandb that initialises but then fails: the failure is printed
    once, the run goes on, and records still reach wandb's log until it
    fails."""
    calls = []

    class Run:
        def log(self, rec, step=None):
            calls.append((rec, step))
            if len(calls) > 1:
                raise RuntimeError("network down")

        def finish(self):
            raise RuntimeError("network down")

    fake = types.SimpleNamespace(init=lambda **kw: Run(),
                                 Image=lambda p: ("image", p))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    t = T.Telemetry({"wandb": True}, str(tmp_path))
    t.log({"event": "track", "idx": 0, "loss": 1.0, "pts": {"fine": 1}})
    assert calls == [({"event": "track", "idx": 0, "loss": 1.0}, None)]
    t.log({"event": "track", "idx": 1, "loss": 2.0}, step=1)
    t.log_image("run_summary", "x.png")
    t.finish()
    out = capsys.readouterr().out
    assert out.count("wandb logging failed") == 1
    assert "network down" in out


def test_slam_run_writes_summary(tmp_path, monkeypatch, capsys):
    """A tiny CPU run through the CLI (tests/test_e2e.py's budget) with
    wandb: True on a machine without wandb: one line says so, and the run
    ends with plots/summary.png, line pixels in every panel."""
    import torch
    import yaml
    from hpslam_tpu_torch import run as R
    from tests.test_e2e import tiny_cfg
    monkeypatch.setitem(sys.modules, "wandb", None)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = tiny_cfg(tmp_path)
        cfg["wandb"] = True
        path = str(tmp_path / "tiny.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        out = str(tmp_path / "out")
        R.run([path, "--output", out, "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert capsys.readouterr().out.count("metrics.jsonl only") == 1
    img = IO.read_png(os.path.join(out, "plots", "summary.png"))
    assert img.shape == T.CANVAS_HW + (3,)
    for k in range(4):
        x0, y0, x1, y1 = T.panel_box(k)
        box = img[y0 + 1:y1, x0 + 1:x1].astype(int)
        assert (np.abs(box - 255).sum(-1) > 0).any(), k
