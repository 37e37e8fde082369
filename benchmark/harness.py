"""One run of one cell: set-up, the measured window, the check, the line.

The window drives ``hpslam_tpu_torch.slam.PointSLAM`` frame by frame
through its per-frame step (``_step``): tracking on every frame, mapping
on every ``mapping.every_frame``-th, keyframe registration.  The loop is
closed: the next frame is handed over as soon as the program is done with
the last.

Set-up (``setup_s``, from process start): loading the program and its
kernels, rendering the cell's frames, building ``PointSLAM`` with the
benchmark's decoders, frame 0 (mapped at ``iters_first``) and frame 1
(which the program takes at its ground-truth pose), and one tracking call
on frame 1's data whose random draws are put back, so that no shape of the
window meets the device first inside it.  The window starts at frame 2;
no frame starts after ``--seconds``, the frame in flight finishes and
counts, and the window runs at least through the first mapped frame.

Spans around the tracker's and the mapper's calls (wrappers set on the
instance, each call ended by a device synchronise) time the layers.  With
``--trace 1`` the device is traced over the window's first mapping period
(frames 2 to the first mapped frame) and the row top-k's call shapes are
recorded there.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from .registry import Registry


def process_age_s() -> float:
    """Seconds since this process started (from /proc; falls back to the
    interpreter's own clock)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def set_cache_dirs(root: str):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(root, "build")
    os.environ["HPSLAM_TORCH_BUILD"] = os.path.join(build, "hpslam_tpu_torch")
    os.environ["HPSLAM_NATIVE_BUILD"] = os.path.join(build, "native")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def make_cfg(config: dict, output: str) -> dict:
    """The program's configuration: the file's, with the run's output
    folder.  Its own random streams keep the configuration's seed, so a
    run's seed changes the frames' sensor noise and the decoders, not the
    program's draws."""
    cfg = json.loads(json.dumps(config))
    cfg["data"] = dict(cfg.get("data", {}), output=output)
    return cfg


class Spans:
    """Host spans of the window: (kind, frame, start, end)."""

    def __init__(self):
        self.rows = []

    def label_at(self, t: float) -> str:
        for kind, idx, s, e in self.rows:
            if s <= t <= e:
                return f"{kind}:frame{idx}"
        return "other"


class TopkShapes:
    """Records the row top-k's call shapes (rows, columns, k, payload)
    while on: the problem's shapes of kernel #1's work."""

    def __init__(self, knn_module):
        self.mod = knn_module
        self.orig = getattr(knn_module, "topk_rows", None)
        self.calls = []
        self.on = False

    def install(self):
        if self.orig is None:
            return

        def topk_rows(x, payload, k):
            if self.on:
                self.calls.append((int(x.shape[0]), int(x.shape[1]), int(k),
                                   payload is not None))
            return self.orig(x, payload, k)
        self.mod.topk_rows = topk_rows

    def remove(self):
        if self.orig is not None:
            self.mod.topk_rows = self.orig


def run_cell(args, device_kind: str = "cuda", registry=None,
             config_override=None, after_check=None) -> dict:
    """Run one cell once; returns the result dict (the line's object).
    ``config_override`` (a function of the config dict) and
    ``after_check`` (a function of (cfg, capture, refs, device) whose dict
    the result keeps under "calibration") serve the tests and the
    calibration."""
    import torch

    reg = registry or Registry()
    wl = reg.workload(args.workload)
    config = reg.config(wl["config"])
    if config_override is not None:
        config = config_override(config)
    traffic = reg.traffic(wl["traffic"])
    limits = reg.limits(wl["config"])
    e2e = reg.metrics(args.workload, "end_to_end")
    per_layer = reg.metrics(args.workload, "per_layer")

    from hpslam_tpu_torch import slam as S
    from hpslam_tpu_torch.ops import knn as program_knn
    from hpslam_tpu_torch.utils.datasets import Frame

    from . import check, room, weights
    from .devtrace import DeviceTrace

    dev = torch.device(device_kind)
    seed = int(args.seed)
    out_dir = tempfile.mkdtemp(prefix="hpslam_bench_",
                               dir=os.environ.get("TMPDIR"))
    try:
        stages = {"start_s": process_age_s()}
        t_stage = time.perf_counter()
        cfg = make_cfg(config, out_dir)
        sensor = cfg.get("synthetic", {})
        rm = room.Room(cfg["cam"], sensor, traffic, seed, dev)
        n_frames = rm.n
        frames = []
        for i in range(n_frames):
            c, d, pose = rm.render(i)
            frames.append(Frame(i, c, d, pose))
        cfg["synthetic"] = dict(sensor, n_frames=n_frames)
        stages["render_s"] = time.perf_counter() - t_stage
        t_stage = time.perf_counter()
        slam = S.PointSLAM(cfg, device=device_kind)
        slam.params = weights.make_params(cfg, seed, dev)
        stages["build_s"] = time.perf_counter() - t_stage
        every = int(cfg["mapping"]["every_frame"])
        first_map = every
        rng = np.random.default_rng(seed)
        # frame 0's mapping is checked from the benchmark's own state: its
        # decoders, and the exposure latent as the configuration states it
        own = {"params": check._clone_tree(slam.params),
               "exposure_feat": 0.01 * np.random.default_rng(
                   int(cfg.get("seed", 1219))).standard_normal(
                       int(cfg["model"]["exposure_dim"])).astype(np.float32)}
        capture = check.Capture(track_idx=int(rng.integers(2, first_map)),
                                map_idx=first_map, own=own)
        spans = Spans()
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)
        frame_log = {}
        orig_track, orig_map = slam.tracker.track, slam.mapper.map

        def track(idx, frame, npc, params, exposure_feat, est, gt_c2w):
            capture.before_track(slam, idx, frame, npc, params,
                                 exposure_feat, est, gt_c2w)
            t0 = time.perf_counter()
            out = orig_track(idx, frame, npc, params, exposure_feat, est,
                             gt_c2w)
            sync()
            t1 = time.perf_counter()
            spans.rows.append(("tracking", idx, t0, t1))
            rec = frame_log.setdefault(idx, {})
            rec["track_s"] = t1 - t0
            rec["tracked"] = not out[1].get("skipped", False)
            curve = out[1].get("loss_curve") or []
            rec["loss_ok"] = bool(np.all(np.isfinite(curve))) and bool(
                np.all(np.isfinite(out[0])))
            capture.after_track(idx, out)
            return out

        def map_(idx, frame, npc, params, exposure_feat, c2w,
                 color_refine=False):
            capture.before_map(slam, idx, frame, npc, params, exposure_feat,
                               c2w)
            t0 = time.perf_counter()
            out = orig_map(idx, frame, npc, params, exposure_feat, c2w,
                           color_refine=color_refine)
            sync()
            t1 = time.perf_counter()
            spans.rows.append(("mapping", idx, t0, t1))
            rec = frame_log.setdefault(idx, {})
            rec["map_s"] = t1 - t0
            rec["map_iters"] = int(out[2]["n_joint_iters"])
            rec["points_added"] = int(out[2]["frame_pts_add"])
            capture.after_map(idx, npc, out)
            return out

        slam.tracker.track = track
        slam.mapper.map = map_
        n = slam.n_img
        track_times, map_times = [], []
        mf = open(slam.metrics_path, "a")
        try:
            t_stage = time.perf_counter()
            for idx in (0, 1):
                slam._step(mf, idx, frames[idx], n, track_times, map_times)
            sync()
            stages["frames01_s"] = time.perf_counter() - t_stage
            t_stage = time.perf_counter()
            # warm the tracker's shapes on frame 1's data; its random
            # draws are put back, so the window's calls are unchanged
            st = slam.tracker.gen.get_state()
            est = slam.estimate_c2w_list.copy()
            est[1] = slam.estimate_c2w_list[0]
            orig_track(2, frames[1], slam.npc, slam.params,
                       slam.exposure_feat, est, frames[1].c2w)
            slam.tracker.gen.set_state(st)
            sync()
            stages["warm_s"] = time.perf_counter() - t_stage
            frame_log.clear()
            spans.rows.clear()
            setup_s = process_age_s()
            host_before = host_state()

            trace = DeviceTrace(dev) if args.trace else None
            shapes = TopkShapes(program_knn)
            if trace is not None:
                shapes.install()
            # the profiler's own start and read-back are left out of the
            # window's time
            tracing_s = 0.0
            t_start = time.perf_counter()
            idx = 2
            last = min(n - 2, n_frames - 1)
            while idx <= last:
                if (time.perf_counter() - t_start - tracing_s
                        >= args.seconds and idx > first_map):
                    break
                if trace is not None and idx == 2:
                    t0 = time.perf_counter()
                    trace.start()
                    shapes.on = True
                    tracing_s += time.perf_counter() - t0
                slam._step(mf, idx, frames[idx], n, track_times, map_times)
                if trace is not None and idx == first_map:
                    t0 = time.perf_counter()
                    shapes.on = False
                    trace.stop()
                    tracing_s += time.perf_counter() - t0
                idx += 1
            sync()
            t_end = time.perf_counter()
            host = host_report(host_before, host_state())
        finally:
            mf.close()
            if trace is not None:
                shapes.remove()
        window = {"window_s": t_end - t_start - tracing_s,
                  "frames": frame_log}
        memory_peak = (int(torch.cuda.max_memory_allocated(dev))
                       if dev.type == "cuda" else 0)
        store = {lv: int(L.count) for lv, L in slam.npc.levels.items()}
        n_keyframes = len(slam.mapper.keyframe_dict)
        ate = ate_cm(slam, idx - 1)
        ctx = Context(cfg, wl, window, setup_s, trace, shapes.calls,
                      spans)
        kind = per_layer if args.trace else e2e
        metrics = {}
        for m in kind:
            v = reg.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = None
        if trace is not None and trace.kernels:
            breakdown = {"device_ops": trace.top_ops(10),
                         "idle_gaps": trace.idle_gaps(spans.label_at, 10)}
        del slam, orig_track, orig_map, track, map_
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        refs = {}
        numbers = check.run_check(cfg, capture, dev, list(limits), refs)
        correct, table = check.judge(numbers, limits)
        check_s = time.perf_counter() - t_check
        extra = (after_check(cfg, capture, refs, dev)
                 if after_check is not None else None)
        attempted = len(frame_log)
        failed = sum(1 for r in frame_log.values()
                     if r.get("tracked") and not r.get("loss_ok", True))
        result = {"correct": bool(correct and failed == 0),
                  "attempted": attempted, "failed": failed,
                  "metrics": metrics,
                  "device": device_info(dev, memory_peak, trace)}
        if breakdown is not None:
            result["breakdown"] = breakdown
        if extra is not None:
            result["calibration"] = extra
        result["check_s"] = check_s
        result["checks"] = table
        mapped = [(i, r["map_iters"], r["points_added"], round(r["map_s"], 4))
                  for i, r in sorted(frame_log.items()) if "map_s" in r]
        print("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     stages.items()), file=sys.stderr)
        print(f"window: frames 2-{idx - 1} in {window['window_s']:.4f} s; "
              f"mapped (frame, iterations, points added, s): {mapped}; "
              f"check {check_s:.2f} s", file=sys.stderr)
        print(f"map at the window's end: points {store}, keyframes "
              f"{n_keyframes}", file=sys.stderr)
        print("host over the window: " + ", ".join(
            f"{k} {v}" for k, v in host.items()), file=sys.stderr)
        print(f"ate_cm over frames 0-{idx - 1}: {ate}", file=sys.stderr)
        return result
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _probe_ms() -> float:
    """Milliseconds a fixed piece of pure Python work takes: the host
    core's speed as this process sees it."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i * i % 7
    return 1e3 * (time.perf_counter() - t0)


def host_state() -> dict:
    """The host's side of a window: the probe's time and the machine's CPU
    jiffies (/proc/stat's first line, where readable)."""
    cpu = None
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        pass
    return {"probe_ms": _probe_ms(), "cpu": cpu}


def host_report(a: dict, b: dict) -> dict:
    """What the host did over a window, for the record (standard error):
    the probe before and after, and the share of the machine's CPU time
    the hypervisor took (steal)."""
    out = {"probe_ms": [round(a["probe_ms"], 2), round(b["probe_ms"], 2)]}
    if a["cpu"] and b["cpu"] and len(a["cpu"]) >= 8:
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
        out["steal_pct"] = round(100.0 * d[7] / max(1, sum(d[:8])), 3)
    return out


def ate_cm(slam, last: int):
    """The aligned ATE RMSE (cm) over frames 0..last, for the record."""
    from hpslam_tpu_torch.tools.eval_ate import evaluate_trajectory
    try:
        r = evaluate_trajectory(slam.gt_c2w_list, slam.estimate_c2w_list,
                                last, slam.scale, plot=None,
                                use_alignment=True)
        return 100.0 * float(r["absolute_translational_error.rmse"])
    except (KeyError, ValueError, np.linalg.LinAlgError) as e:
        return f"not computed ({type(e).__name__})"


def device_info(dev, memory_peak: int, trace) -> dict:
    import torch
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": memory_peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info


class Context:
    """What a metric reader reads: the configuration, the window's frames
    and spans, set-up time, the device trace and the top-k call shapes."""

    def __init__(self, cfg, workload, window, setup_s, trace, topk_calls,
                 spans):
        self.cfg = cfg
        self.workload = workload
        self.window = window
        self.setup_s = setup_s
        self.trace = trace
        self.topk_calls = topk_calls
        self.spans = spans

    @property
    def frames(self) -> dict:
        return self.window["frames"]

    def totals(self) -> dict:
        """Sums over the window's frames: times (s), counts, iterations."""
        fr = self.frames.values()
        return {
            "window_s": self.window["window_s"],
            "n_tracked": sum(1 for r in fr if r.get("tracked")),
            "track_s": sum(r["track_s"] for r in fr if r.get("tracked")),
            "track_s_all": sum(r.get("track_s", 0.0) for r in fr),
            "n_mapped": sum(1 for r in fr if "map_s" in r),
            "map_s": sum(r.get("map_s", 0.0) for r in fr),
            "map_iters": sum(r.get("map_iters", 0) for r in fr),
            "points_added": sum(r.get("points_added", 0) for r in fr)}

    def traced_frames(self) -> list:
        if self.trace is None:
            return []
        first_map = int(self.cfg["mapping"]["every_frame"])
        return [i for i in range(2, first_map + 1) if i in self.frames]
