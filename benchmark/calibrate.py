"""Readings that the check's limits are set from (not part of a run).

    python3 -m benchmark.calibrate --workload <name> --seeds <n> ... \
        [--out <jsonl>]

For each seed one process-internal run with the shortest window (through
the first mapped frame), printing one JSON line: the program's numbers
against the reference (the lower readings), the control's (the reference
computed with TF32 products put in the program's place, against the
float32 reference: an upper reading), and faults put in the program's
place (its outputs replaced): a call that returns its state unchanged (the
initial pose and a flat loss curve; a mapped frame that inserts nothing
and never moves its loss), an answer altered where it is produced (the
pose moved by 1 cm), and, where the whole mapping call is compared, the
fine level's features or both levels' (the write-back) left as they were
after insertion.  There it also reads the reference against itself with
its starting features moved by one ulp (``nudge``): how far free running
parts two float32 runs, and the five largest per-leaf gaps of the
program, the control and the nudge.  ``--extras K`` reads the control,
the faults and the nudge on the first K seeds only.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np


def _info_of(losses, n_joint, frame_pts_add):
    """A mapping call's logged info built from a reference's losses."""
    step = max(1, n_joint // 120)
    k = (len(losses) - 1) // step + 1
    return {"frame_pts_add": frame_pts_add, "n_joint_iters": n_joint,
            "geo_loss_curve": [round(float(losses[j * step, 0]), 3)
                               for j in range(k)],
            "color_loss_curve": [round(float(losses[j * step, 1]), 3)
                                 for j in range(k)]}


def _as_program(cap, ref):
    """The snapshot ``cap`` with the program's outputs replaced by those
    of a reference run ``ref`` (the control's, a nudged reference's)."""
    out = dict(cap, out_levels=ref["levels"], out_info=_info_of(
        ref["losses"], ref["n_joint"], ref["frame_pts_add"]))
    if "state" in ref:
        out.update(out_state=ref["state"],
                   out_params={k: v for k, v in ref["params"].items()
                               if k.startswith("col_")},
                   out_expo=ref["expo"])
    return out


def _flat(ref):
    """A mapping call's log that never moves its loss."""
    info = _info_of(ref["losses"], ref["n_joint"], ref["frame_pts_add"])
    info["geo_loss_curve"] = [info["geo_loss_curve"][0]] * len(
        info["geo_loss_curve"])
    info["color_loss_curve"] = [0.0] * len(info["color_loss_curve"])
    return info


def _top(gaps, n=5):
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]


def _nudged(cap):
    """The snapshot with every starting feature moved by one ulp."""
    import torch

    def up(t):
        return torch.nextafter(t, torch.full_like(t, float("inf")))
    lv = {k: (p, up(g), up(c), n) for k, (p, g, c, n) in cap["levels"].items()}
    return dict(cap, levels=lv)


def control_and_faults(cfg, capture, refs, dev):
    """Readings of the control, of the faults and of the nudged reference
    (see the module docstring), each over the same numbers as the run's
    check."""
    from . import check
    from .reference import decoder as RDec
    from .reference import tracking as RTrack
    out = {}
    full = "state" in refs["map"]
    t0 = time.perf_counter()
    token = RDec.PRECISION.set("tf32")
    try:
        ctl_track = check.reference_track(cfg, capture.track, dev)
        ctl_map = check.reference_map(cfg, capture.map, dev, full=full)
        ctl_map0 = (check.reference_map(cfg, capture.map0, dev,
                                        entries=check.MAP_ENTRIES)
                    if "map0" in refs else None)
    finally:
        RDec.PRECISION.reset(token)
    out["control_s"] = time.perf_counter() - t0
    pose_f, losses_f = refs["track"]
    ref_map = refs["map"]
    as_prog = dict(capture.track, out_c2w=ctl_track[0],
                   out_curve=np.round(ctl_track[1], 3))
    ctl = check.track_numbers(as_prog, pose_f, losses_f)
    ctl_cap = _as_program(capture.map, ctl_map)
    ctl.update(check.map_numbers(cfg, ctl_cap, ref_map))
    if ctl_map0 is not None:
        ctl.update(check.map0_numbers(_as_program(capture.map0, ctl_map0),
                                      refs["map0"]))
    out["control"] = ctl
    # a call that returns its state unchanged
    cap = capture.track
    init = RTrack.initial_pose(cap["idx"], cap["est_prev"], cap["est_prev2"],
                               cfg["tracking"]["const_speed_assumption"])
    same = dict(cap, out_c2w=init, out_curve=np.full(
        len(losses_f), np.round(float(losses_f[0]), 3)))
    unchanged = check.track_numbers(same, pose_f, losses_f)
    before = {lv: (c, p[:c].clone())
              for lv, (p, _g, _c, c) in capture.map["levels"].items()}
    same = dict(capture.map, out_levels=before, out_info=_flat(ref_map))
    if full:
        same.update(out_state=ref_map["init_state"],
                    out_params={k: v for k, v in capture.map["params"].items()
                                if k.startswith("col_")},
                    out_expo=capture.map["exposure_feat"])
    unchanged.update(check.map_numbers(cfg, same, ref_map))
    if "map0" in refs:
        empty = {lv: (0, p[:0].clone())
                 for lv, (p, _g, _c, _n) in capture.map0["levels"].items()}
        unchanged.update(check.map0_numbers(
            dict(capture.map0, out_levels=empty,
                 out_info=_flat(refs["map0"])), refs["map0"]))
    out["fault_unchanged"] = unchanged
    moved = dict(cap, out_c2w=cap["out_c2w"] + np.pad(
        np.array([[0.0, 0.0, 0.0, 0.01]]), ((0, 3), (0, 0))))
    out["fault_altered"] = check.track_numbers(moved, pose_f, losses_f)
    out["map_curve_prog"] = check.curve_gaps(capture.map["out_info"],
                                             ref_map["losses"])
    if not full:
        return out
    # the program's own outputs with the fine level's features, or both
    # levels' (the write-back), left as they were after insertion
    init = ref_map["init_state"]
    prog = capture.map
    fine = dict(prog, out_state=dict(prog["out_state"], fine=init["fine"]))
    out["fault_fine_unchanged"] = check.map_numbers(cfg, fine, ref_map)
    skipped = dict(prog, out_state=init)
    out["fault_writeback_skipped"] = check.map_numbers(cfg, skipped, ref_map)
    # the look at free running: the reference against itself, its starting
    # features moved by one ulp
    t0 = time.perf_counter()
    nud = check.reference_map(cfg, _nudged(capture.map), dev, full=True)
    out["nudge_s"] = time.perf_counter() - t0
    nud_cap = _as_program(capture.map, nud)
    out["nudge"] = check.map_numbers(cfg, nud_cap, ref_map)
    out["leaves"] = {"program": _top(check.state_gaps(prog, ref_map)),
                     "control": _top(check.state_gaps(ctl_cap, ref_map)),
                     "nudge": _top(check.state_gaps(nud_cap, ref_map))}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    p.add_argument("--extras", type=int, default=None,
                   help="read the control, faults and nudge on the first "
                   "this many seeds only (default: all)")
    args = p.parse_args(argv)
    from . import harness
    harness.set_cache_dirs(os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for i, seed in enumerate(args.seeds):
        a = types.SimpleNamespace(workload=args.workload, seed=seed,
                                  seconds=args.seconds, trace=0)
        t0 = time.perf_counter()
        extras = args.extras is None or i < args.extras
        r = harness.run_cell(a, "cuda", after_check=(
            control_and_faults if extras else None))
        torch.cuda.reset_peak_memory_stats()
        line = {"workload": args.workload, "seed": seed,
                "run_s": time.perf_counter() - t0,
                "numbers": {k: v["value"] for k, v in r["checks"].items()},
                "metrics": r["metrics"], "check_s": r["check_s"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                **r.get("calibration", {})}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
