"""The device trace of a traced run: kernel intervals from torch.profiler.

Adapted from ``chip_smoke.py``'s ``profile_run``, with the busy time taken
as the union of the device's operation intervals (kernels, copies, sets)
rather than their sum, so overlapping operations count once.  Only device
activity is recorded (no host operator events), and the events are read
from the profiler's raw results, so a trace of a few hundred thousand
kernels reads back in seconds.

Host and device clocks are aligned by a marker: right after the profiler
starts and the device is idle, one small operation is launched at a known
host time; the first device event is that marker.
"""
from __future__ import annotations

import time

import torch


def _raw_events(prof):
    """[(name, start_ns, dur_ns)] of every device-side event."""
    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = 1000 * e.start_us(), 1000 * e.duration_us()
            out.append((e.name(), int(s), int(d)))
        return out
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        out.append((e.name, int(1000 * e.time_range.start),
                    int(1000 * (e.time_range.end - e.time_range.start))))
    return out


class DeviceTrace:
    """Start / stop around a stretch of the run; then ``kernels`` holds
    (name, start_s, dur_s) on the host's perf_counter clock."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.kernels = []
        self.t0 = self.t1 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_marker = time.perf_counter()
        torch.ones((1,), device=self.device).mul_(2.0)
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        raw = sorted(_raw_events(self.prof), key=lambda e: e[1])
        self.prof = None
        if not raw:
            return
        origin = raw[0][1] * 1e-9 - self.t_marker
        self.kernels = [(n, s * 1e-9 - origin, d * 1e-9) for n, s, d in raw
                        if s * 1e-9 - origin >= self.t0 - 1e-4]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        """The union of the device's operation intervals, clipped to the
        traced window: [(start, end)]."""
        out = []
        for _n, s, d in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.t0), min(s + d, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_time(self, match) -> float:
        """Seconds of device time of the events whose name ``match``
        accepts."""
        return sum(d for n, _s, d in self.kernels if match(n))

    def top_ops(self, n: int = 10):
        acc: dict = {}
        for name, _s, d in self.kernels:
            acc[name[:120]] = acc.get(name[:120], 0.0) + d
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, label_at, n: int = 10):
        """The n longest idle stretches of the device, each named by
        ``label_at(host time)`` at its middle."""
        gaps = []
        prev = self.t0
        for s, e in self.busy_intervals() + [[self.t1, self.t1]]:
            if s > prev:
                gaps.append((s - prev, label_at(0.5 * (s + prev))))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[0])
        return [[lab, g] for g, lab in gaps[:n]]
