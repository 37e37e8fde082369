#!/usr/bin/env python
"""The two packages' ATE on the CPU, seed by seed: the port
(``hpslam_tpu_torch``) beside the JAX reference (``hpslam_tpu``).

    python orbit_compare.py --out DIR [--scenario orbit] [--seeds 0 1 2] \
        [--impl port reference] [--jobs 3]

Scenarios (``--scenario``):

* ``orbit`` (the default): ``configs/ScanNet/scene0059.yaml`` on an orbit
  of 23 cm a frame (below).
* ``synth_tpu``: ``configs/Synthetic/synth_tpu.yaml`` (the synthetic room,
  tracking 2000 px x 60 iterations, mapping 4000 px x 150) with
  ``synthetic.n_frames`` 15 for 30.  The synthetic orbit spans a quarter
  turn whatever the frame count, so this is the same orbit in 15 frames,
  about 12.6 cm a frame for 6.3; nothing else is cut.  (``synth_quality.yaml``
  differs from ``synth_tpu.yaml`` only in its frame count, so no frame
  count gives a cut of it: at 15 frames it is this scenario.)

The synthetic scenario reads no files: both readers render the room.  The
cut is applied to both implementations alike.  ``--plain`` sets
``model.fused_mlp`` and ``model.fused_composite`` off for both: the route
the reference's 'auto' takes on the CPU, where the port's 'auto' takes its
fused route (on the CPU the kernels' plain versions), which, as the
reference's fused route, keeps the colour decoder's Fourier matrix fixed
while the plain route trains it.

It is a comparison of the two implementations, as the tests are, and not
an entry point of either: the reference runs on the CPU only, so the port
runs there too, asked for with ``--device cpu``.

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
# the synthetic scenario: (config, cuts), the frame count cut only
SYNTHETIC = {
    "synth_tpu": ("configs/Synthetic/synth_tpu.yaml",
                  {"synthetic": {"n_frames": 15}}),
}


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
                 cam=None, tree=None, plain: bool = False):
    if scenario == "orbit":
        cfg = {"inherit_from": CONFIG, "seed": int(seed), "cam": cam,
               "data": {"input_folder": tree, "output": output}, **CUTS}
    else:
        base, cuts = SYNTHETIC[scenario]
        cfg = {"inherit_from": base, "seed": int(seed),
               "data": {"output": output}, **cuts}
    if plain:
        cfg["model"] = {"fused_mlp": False, "fused_composite": False}
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
            tree=None, plain: bool = False) -> dict:
    output = os.path.join(out, f"{impl}_s{seed}")
    os.makedirs(output, exist_ok=True)
    cfg_path = os.path.join(out, f"{impl}_s{seed}.yaml")
    write_config(cfg_path, scenario, seed, output, cam, tree, plain)
    cmd, env = command(impl, cfg_path)
    t0 = time.perf_counter()
    with open(os.path.join(output, "log.txt"), "w") as log:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    rec = {"impl": impl, "seed": seed, "rc": rc,
           "seconds": time.perf_counter() - t0,
           "ate_rmse_m": ate_of(output) if rc == 0 else None}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--scenario", default="orbit",
                   choices=["orbit"] + sorted(SYNTHETIC))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--impl", nargs="+", default=["port", "reference"],
                   choices=["port", "reference"])
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--plain", action="store_true",
                   help="model.fused_mlp and fused_composite off for both")
    args = p.parse_args(argv)
    out = os.path.abspath(args.out)
    cam = tree = None
    if args.scenario == "orbit":
        tree = os.path.join(out, "tree")
        cam = write_tree(tree)
    jobs = [(i, s) for i in args.impl for s in args.seeds]
    with ThreadPoolExecutor(args.jobs) as ex:
        recs = list(ex.map(lambda j: run_one(j[0], j[1], out,
                                             args.scenario, cam, tree,
                                             args.plain), jobs))
    print(json.dumps({impl: {r["seed"]: r["ate_rmse_m"] for r in recs
                             if r["impl"] == impl} for impl in args.impl}))
    return 0 if all(r["rc"] == 0 for r in recs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
