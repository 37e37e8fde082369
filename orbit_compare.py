#!/usr/bin/env python
"""The two packages' ATE on the CPU, seed by seed: the port
(``hpslam_tpu_torch``) beside the JAX reference (``hpslam_tpu``).

    python orbit_compare.py --out DIR [--scenario orbit] [--seeds 0 1 2] \
        [--impl port reference] [--jobs 3] [--route {plain,fused}]
    python orbit_compare.py --summary DIR_OR_FILE [...]

Scenarios (``--scenario``):

* ``orbit`` (the default): ``configs/ScanNet/scene0059.yaml`` on an orbit
  of 23 cm a frame (below).
* ``synth_tpu``: ``configs/Synthetic/synth_tpu.yaml`` (the synthetic room,
  tracking 2000 px x 60 iterations, mapping 4000 px x 150) with
  ``synthetic.n_frames`` 15 for 30.  The synthetic orbit spans a quarter
  turn whatever the frame count, so this is the same orbit in 15 frames,
  about 12.6 cm a frame for 6.3; nothing else is cut.
* ``synth_quality``: ``configs/Synthetic/synth_quality.yaml`` uncut (120
  frames).  It differs from ``synth_tpu.yaml`` only in its frame count, so
  no frame count gives a cut of it: at 15 frames it is ``synth_tpu``.

The synthetic scenarios read no files: both readers render the room.  The
cut is applied to both implementations alike.  ``--route plain`` (or
``--plain``) sets ``model.fused_mlp`` and ``model.fused_composite`` off for
both: the route the reference's 'auto' takes on the CPU, where the port's
'auto' takes its fused route (on the CPU the kernels' plain versions),
which, as the reference's fused route, keeps the colour decoder's Fourier
matrix fixed while the plain route trains it.  ``--route fused`` sets both
on for both: the reference then runs its Pallas kernels in interpret mode
(about 0.5 s a mapping iteration and 10 s a tracked frame on the CPU).
Without ``--route`` each takes its 'auto'.

Each run's record is also appended, with its scenario and route, to
``runs.jsonl`` in ``--out``, so that seeds may be gathered over several
invocations.  ``--summary`` reads such files (or every ``.jsonl`` file
under the directories named, as ``orbit_runs/``, which keeps the
records of the repo's comparisons) and, for each scenario and route,
compares the two implementations' ATEs at the seeds both have
(``compare``): the difference of means, port - reference, with a 95 %
bootstrap interval (10,000 resamples, a fixed seed), and a two-sided
Mann-Whitney U p-value.  The verdict: ``closed`` where the interval's
upper end lies below +0.35 cm; ``fault`` where the interval lies wholly
above 0 and p < 0.05; ``open`` otherwise, with the seeds a side that
would put the interval's half-width under the distance from the
difference to the nearer of those two verdicts, at the same spread.
It also reads ``band_run`` lines of ``chip_smoke.py`` (``slam_fused``
against ``slam``) and reports each implementation's fused route against
its plain one the same way.

The port's side also runs on the card: ``chip_smoke.py --phases
device,build,orbit --scenario synth_tpu --route fused plain --seeds ...``
runs the port's CLI on the configs that ``write_config`` writes and
prints one record a run (with ``"device": "cuda"``), which ``--summary``
reads from the smoke's log or from its ``--out``
(``orbit/runs.jsonl``).  A record's side is its implementation, followed
by ``@device`` where it ran on another device than the CPU (records
without ``device`` are CPU records): ``port`` and ``port@cuda`` are kept
apart, and ``--summary`` compares ``port@cuda`` with ``reference`` and
with ``port`` (a finding within the port: a fault there is one of the
card path) as it compares ``port`` with ``reference``.

It is a comparison of the two implementations, as the tests are, and not
an entry point of either: the reference runs on the CPU only, and the
port's runs here are CPU runs too, asked for with ``--device cpu``
(``--impl reference`` leaves them to the card's ``orbit`` phase).

For ``orbit`` it writes one 8-frame ScanNet tree of the synthetic room (a
quarter orbit of radius 1.2 m in 8 frames: 23.6 cm and 11.25 degrees a
frame; colour as baseline JPEG, 16-bit PNG depth) at 120x160, with
scene0059.yaml's
intrinsics scaled by 1/4.  For each seed it writes a config that inherits
scene0059.yaml and cuts it as chip_smoke.py's ``slam_scannet`` cuts it
(tracking 100 -> 30 iterations, mapping 600 -> 60, first 500 -> 150,
``geo_iter_first`` 200 -> 40) and to the smaller image (crop edge 10 -> 2,
tracking's ignored edges 20 -> 5 px).  Each implementation's CLI runs on
it in a subprocess of its own: the port as ``python -m
hpslam_tpu_torch.run --device cpu``, the reference through ``run.py``
with ``JAX_PLATFORMS=cpu`` (it reads the JPEGs with cv2, which must be
installed for it).  This script imports no JAX.  Each run prints one JSON
line with its ATE RMSE (the ``ate`` record of its ``metrics.jsonl``, after
end correction as both implementations order it); a last line gives each
implementation's ATEs by seed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import yaml

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = "configs/ScanNet/scene0059.yaml"
FRAMES = 8
RADIUS = 1.2
SCALE = 4
CUTS = {"tracking": {"iters": 30, "ignore_edge_W": 5, "ignore_edge_H": 5},
        "mapping": {"iters": 60, "iters_first": 150, "geo_iter_first": 40}}
# the synthetic scenarios: (config, cuts), the frame count cut only
SYNTHETIC = {
    "synth_tpu": ("configs/Synthetic/synth_tpu.yaml",
                  {"synthetic": {"n_frames": 15}}),
    "synth_quality": ("configs/Synthetic/synth_quality.yaml", {}),
}
ROUTES = {"plain": False, "fused": True}
# --summary's pairs: (side, the side it is held against); a side is an
# implementation, with "@device" for a record of another device than the
# CPU
PAIRS = (("port", "reference"), ("port@cuda", "reference"),
         ("port@cuda", "port"), ("slam_fused", "slam"))
# the rule (--summary): closed below this upper end of the interval, in cm
CLOSE_CM = 0.35
BOOT_RESAMPLES, BOOT_SEED = 10_000, 0
_LOG_LOCK = threading.Lock()


def write_tree(folder: str) -> dict:
    """The 8-frame tree at scene0059.yaml's intrinsics / SCALE; returns the
    cam block the configs use."""
    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch.utils import datasets as D
    cam = dict(C.load_config(os.path.join(ROOT, CONFIG),
                             C.default_config_path())["cam"])
    cam.update(H=cam["H"] // SCALE, W=cam["W"] // SCALE,
               fx=cam["fx"] / SCALE, fy=cam["fy"] / SCALE,
               cx=cam["cx"] / SCALE, cy=cam["cy"] / SCALE)
    syn = D.Synthetic({"dataset": "synthetic", "seed": 1219, "data": {},
                       "synthetic": {"n_frames": FRAMES, "radius": RADIUS},
                       "cam": dict(cam, crop_edge=0)})
    D.write_scannet_tree(folder, [syn[i] for i in range(FRAMES)],
                         png_depth_scale=cam["png_depth_scale"])
    return dict(cam, crop_edge=cam["crop_edge"] // SCALE)


def write_config(path: str, scenario: str, seed: int, output: str,
                 cam=None, tree=None, route=None):
    if scenario == "orbit":
        cfg = {"inherit_from": CONFIG, "seed": int(seed), "cam": cam,
               "data": {"input_folder": tree, "output": output}, **CUTS}
    else:
        base, cuts = SYNTHETIC[scenario]
        cfg = {"inherit_from": base, "seed": int(seed),
               "data": {"output": output}, **cuts}
    if route is not None:
        on = ROUTES[route]
        cfg["model"] = {"fused_mlp": on, "fused_composite": on}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def command(impl: str, cfg_path: str) -> tuple:
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "2"))
    if impl == "port":
        return ([sys.executable, "-m", "hpslam_tpu_torch.run", cfg_path,
                 "--device", "cpu"], env)
    env["JAX_PLATFORMS"] = "cpu"
    return [sys.executable, os.path.join(ROOT, "run.py"), cfg_path], env


def ate_of(output: str):
    ate = None
    with open(os.path.join(output, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r.get("event") == "ate":
                ate = r["absolute_translational_error.rmse"]
    return ate


def run_one(impl: str, seed: int, out: str, scenario: str, cam=None,
            tree=None, route=None) -> dict:
    output = os.path.join(out, f"{impl}_s{seed}")
    os.makedirs(output, exist_ok=True)
    cfg_path = os.path.join(out, f"{impl}_s{seed}.yaml")
    write_config(cfg_path, scenario, seed, output, cam, tree, route)
    cmd, env = command(impl, cfg_path)
    t0 = time.perf_counter()
    with open(os.path.join(output, "log.txt"), "w") as log:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    rec = {"impl": impl, "seed": seed, "rc": rc,
           "seconds": time.perf_counter() - t0,
           "ate_rmse_m": ate_of(output) if rc == 0 else None}
    print(json.dumps(rec), flush=True)
    with _LOG_LOCK, open(os.path.join(out, "runs.jsonl"), "a") as f:
        f.write(json.dumps(dict(rec, scenario=scenario, route=route)) + "\n")
    return rec


def compare(a, b) -> dict:
    """ATEs ``a`` against ``b`` (cm, the same seeds): the difference of
    means a - b with its 95 % bootstrap interval (each side resampled
    apart, BOOT_RESAMPLES times from BOOT_SEED), the two-sided Mann-Whitney
    U p-value and the rule's verdict."""
    import numpy as np
    from scipy.stats import mannwhitneyu
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    g = np.random.default_rng(BOOT_SEED)
    boot = (a[g.integers(0, len(a), (BOOT_RESAMPLES, len(a)))].mean(1)
            - b[g.integers(0, len(b), (BOOT_RESAMPLES, len(b)))].mean(1))
    lo, hi = (float(x) for x in np.percentile(boot, [2.5, 97.5]))
    diff = float(a.mean() - b.mean())
    p = float(mannwhitneyu(a, b, alternative="two-sided").pvalue)
    if hi < CLOSE_CM:
        verdict, seeds = "closed", None
    elif lo > 0 and p < 0.05:
        verdict, seeds = "fault", None
    else:
        # seeds a side that would bring the half-width under the distance
        # from the difference to the verdict it is nearer to reaching
        # (below CLOSE_CM, or wholly above 0), at this spread; the
        # half-width falls as one over the root of the count
        margin = max(m for m in (CLOSE_CM - diff, diff, 1e-3) if m > 0)
        verdict = "open"
        seeds = int(np.ceil(len(a) * ((hi - lo) / 2 / margin) ** 2))
    return {"n": [len(a), len(b)], "mean": [float(a.mean()),
                                            float(b.mean())],
            "sd": [float(a.std(ddof=1)), float(b.std(ddof=1))],
            "diff_cm": diff, "ci95_cm": [lo, hi], "mannwhitney_p": p,
            "verdict": verdict, "seeds_a_side_to_decide": seeds}


def side(record: dict) -> str:
    """The side a record belongs to: its implementation, with "@device"
    where it names a device other than the CPU."""
    dev = record.get("device")
    return record["impl"] + ("" if dev in (None, "cpu") else f"@{dev}")


def read_runs(paths) -> list:
    """(scenario, route, side, seed, ate cm) from orbit_compare records
    and chip_smoke orbit records (files such as the smoke's log, or
    directories, whose .jsonl files at any depth are read) and chip_smoke
    band_run lines (side the smoke's path, route None)."""
    files = []
    for p in paths:
        if os.path.isdir(p):
            files += sorted(os.path.join(d, n) for d, _, ns in os.walk(p)
                            for n in ns if n.endswith(".jsonl"))
        else:
            files.append(p)
    rows = []
    for p in files:
        with open(p) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(r, dict):
                    continue
                if "band_run" in r:
                    b = r["band_run"]
                    rows.append(("band:" + b["config"], None, b["path"],
                                 b["seed"], b["ate_cm"]))
                elif "impl" in r and r.get("ate_rmse_m") is not None:
                    rows.append((r.get("scenario"), r.get("route"),
                                 side(r), r["seed"],
                                 100 * r["ate_rmse_m"]))
    return rows


def summary(paths) -> list:
    """For each scenario and route, each of PAIRS compared at their common
    seeds (port - reference, port@cuda - reference, port@cuda - port,
    slam_fused - slam); for each scenario and side its fused route against
    its plain one.  A seed run twice keeps its last record."""
    runs = {}
    for scen, route, impl, seed, ate in read_runs(paths):
        runs.setdefault((scen, route, impl), {})[seed] = ate
    out = []

    def add(kind, key, a, b, names):
        seeds = sorted(set(a) & set(b))
        if len(seeds) >= 2:
            out.append(dict({"compare": kind, "scenario": key[0],
                             "route_or_impl": key[1], "a_minus_b": names,
                             "seeds": seeds},
                            **compare([a[s] for s in seeds],
                                      [b[s] for s in seeds])))

    for (scen, route, impl), a in sorted(runs.items(), key=str):
        for other in (b for s, b in PAIRS if s == impl):
            if (scen, route, other) in runs:
                add("packages", (scen, route), a,
                    runs[(scen, route, other)], [impl, other])
        if route == "fused" and (scen, "plain", impl) in runs:
            add("routes", (scen, impl), a, runs[(scen, "plain", impl)],
                ["fused", "plain"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out")
    p.add_argument("--summary", nargs="+", metavar="PATH",
                   help="compare the runs recorded in these files or "
                        "directories by the rule and exit")
    p.add_argument("--scenario", default="orbit",
                   choices=["orbit"] + sorted(SYNTHETIC))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--impl", nargs="+", default=["port", "reference"],
                   choices=["port", "reference"])
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--route", choices=sorted(ROUTES),
                   help="model.fused_mlp and fused_composite off (plain) "
                        "or on (fused) for both; default each one's auto")
    p.add_argument("--plain", action="store_true",
                   help="the same as --route plain")
    args = p.parse_args(argv)
    if args.summary:
        for line in summary(args.summary):
            print(json.dumps(line))
        return 0
    if not args.out:
        p.error("--out is required")
    route = "plain" if args.plain else args.route
    out = os.path.abspath(args.out)
    cam = tree = None
    if args.scenario == "orbit":
        tree = os.path.join(out, "tree")
        cam = write_tree(tree)
    jobs = [(i, s) for i in args.impl for s in args.seeds]
    with ThreadPoolExecutor(args.jobs) as ex:
        recs = list(ex.map(lambda j: run_one(j[0], j[1], out,
                                             args.scenario, cam, tree,
                                             route), jobs))
    print(json.dumps({impl: {r["seed"]: r["ate_rmse_m"] for r in recs
                             if r["impl"] == impl} for impl in args.impl}))
    return 0 if all(r["rc"] == 0 for r in recs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
