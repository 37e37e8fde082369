"""The metrics' arithmetic on made-up windows and hand-worked shapes."""
import json
import os

import pytest

from benchmark import harness, work
from benchmark.registry import Registry
from benchmark.tests.tiny import REPO


def _cfg():
    with open(os.path.join(REPO, "benchmark/configs/pointslam-scannet.json")) \
            as f:
        return json.load(f)


def _ctx(frames, window_s, trace=None, topk=()):
    window = {"window_s": window_s, "frames": frames}
    return harness.Context(_cfg(), {"name": "x"}, window, 12.5, trace,
                           list(topk), harness.Spans())


def _read(name, ctx):
    return Registry(os.path.join(REPO, "BENCHMARK.json")).reader(name)(ctx)


def test_frame_ms_amortises_mapping():
    # frames 2-5 tracked (1 s each), frame 5 also mapped (10 s); 1 s of
    # orchestration outside the spans: window 15 s
    frames = {i: {"tracked": True, "track_s": 1.0} for i in (2, 3, 4, 5)}
    frames[5].update(map_s=10.0, map_iters=750, points_added=480)
    ctx = _ctx(frames, 15.0)
    # (15 - 10) / 4 + 10 / 1 / 5 = 1.25 + 2 s
    assert _read("frame_ms", ctx) == pytest.approx(3250.0)
    assert _read("track_ms", ctx) == pytest.approx(1000.0)
    assert _read("map_ms", ctx) == pytest.approx(10000.0)
    assert _read("host_other_ms", ctx) == pytest.approx(250.0)
    assert _read("track_iter_ms", ctx) == pytest.approx(10.0)
    assert _read("track_frame_ms", ctx) == pytest.approx(1000.0)
    assert _read("map_iter_ms", ctx) == pytest.approx(10000.0 / 750)
    assert _read("map_iters", ctx) == 750
    assert _read("points_added", ctx) == 480
    assert _read("setup_s", ctx) == 12.5


def test_no_mapped_frame_reads_nothing():
    frames = {2: {"tracked": True, "track_s": 1.0}}
    ctx = _ctx(frames, 1.2)
    assert _read("frame_ms", ctx) is None
    assert _read("map_ms", ctx) is None
    assert _read("device_idle_pct", ctx) is None
    assert _read("roofline_pct.topk_rows", ctx) is None


def test_topk_work_by_hand():
    # 4096 rows of 1536 columns with payload, k = 8: 4096*1536*8 bytes in,
    # 4096*8*8 out; 4096*1536 comparisons
    nbytes, ops = work.topk_work(4096, 1536, 8, True)
    assert nbytes == 4096 * 1536 * 8 + 4096 * 8 * 8
    assert ops == 4096 * 1536
    assert work.bound_s(nbytes, ops) == pytest.approx(nbytes / 3.35e12)


def test_trunk_and_maploss_counts_by_hand():
    w = work.widths(_cfg())
    # geometry trunk: inputs 93, 32, 32, 32+93, 32 into hidden 32; five
    # feature injections 32x32; output 32x1
    fwd, cot = work.trunk_flops(w, 93, 32, 1, False)
    assert fwd == 2 * ((93 + 32 + 32 + 125 + 32) * 32 + 5 * 32 * 32 + 32)
    assert cot == 2 * (32 + 4 * 32 * 32 + 5 * 32 * 32)
    nb, fl = work.maploss_work(w, 10000, 5, 8, False, True)
    per = fwd + cot + 2 * 2 * 8 * 32
    assert fl == per * 10000 * 5
    assert nb == 4 * (10000 * (5 * 5 + 7 + 40 + 8 + 8 * 32 + 1 + 12)
                      + work.weight_numel(w, 93, 32, 1)) \
        + 4 * 10000 * (8 * 32 + 12)


def test_stage_counts_follow_the_schedule():
    cfg = _cfg()
    # 600 iterations: mid 0..300, geometry through int(300 * 0.3) = 90;
    # fine 301..599, geometry through int(300 + 300 * 0.3) = 390
    assert work.stage_counts(cfg, 600, False) == (91 + 90, 210 + 209)
    assert sum(work.stage_counts(cfg, 1200, False)) == 1200


def test_mfu_by_hand():
    cfg = _cfg()
    frames = {i: {"tracked": True, "track_s": 1.0} for i in (2, 3, 4, 5)}
    frames[5].update(map_s=10.0, map_iters=600)
    ctx = _ctx(frames, 20.0)
    flops = 4 * work.track_frame_flops(cfg) + work.map_frame_flops(
        cfg, 600, False)
    assert _read("mfu_pct", ctx) == pytest.approx(
        100 * flops / (20.0 * 67e12))
    # one tracking iteration: 5000 rays x 5 samples through both trunks
    w = work.widths(cfg)
    assert work.track_frame_flops(cfg) == 100 * work.trackloss_work(
        w, 5000, 5, 8, True)[1]


class _Trace:
    def __init__(self, kernels, t0, t1):
        from benchmark.devtrace import DeviceTrace
        self._t = DeviceTrace(None)
        self._t.kernels, self._t.t0, self._t.t1 = kernels, t0, t1

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_idle_share_is_a_union_and_roofline_from_shapes():
    # two overlapping kernels cover [1, 4); a third [6, 7): busy 4 of 10 s
    k = [("topk_rows_lists<8,4>", 1.0, 2.0), ("ml_bwd_tiles", 2.0, 2.0),
         ("elementwise", 6.0, 1.0)]
    tr = _Trace(k, 0.0, 10.0)
    assert tr.busy_s() == pytest.approx(4.0)
    frames = {i: {"tracked": True, "track_s": 1.0} for i in (2, 3, 4, 5)}
    ctx = _ctx(frames, 10.0, trace=tr, topk=[(4096, 1536, 8, True)])
    assert _read("device_idle_pct", ctx) == pytest.approx(60.0)
    least = work.bound_s(*work.topk_work(4096, 1536, 8, True))
    assert _read("roofline_pct.topk_rows", ctx) == pytest.approx(
        100 * least / 2.0)
    gaps = tr.idle_gaps(lambda t: "other", 10)
    assert [g for _, g in gaps] == pytest.approx([3.0, 2.0, 1.0])
