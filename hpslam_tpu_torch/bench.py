"""The repository's benchmark workload (``bench.py``) on the port: the
ScanNet operating point at full state size.

    python -m hpslam_tpu_torch.bench                    # one CUDA card
    python -m hpslam_tpu_torch.bench --reps 5 --fused_track
    python -m hpslam_tpu_torch.bench --device cpu --H 24 --W 32 \
        --n_mid 1000 --n_fine 3000 --cap_mid 2048 --cap_fine 4096 \
        --pixels 64 --track_iters 8 --rays 32 --map_iters 16 --window 3 \
        --P 64 --reps 1                                  # tiny, on the CPU

Workload (the same sizes as ``bench.py``, whose constants are copied here):
  * scene state: 300,000 fine and 60,000 mid points in capacities of 2^19
    and 2^17 (4096 and 1024 tiles of 128), c_dim 32, from numpy draws of
    seed 1219 in ``bench.py``'s order (``build_state``, then the frame);
  * tracking: 100 iterations x 5000 pixels (50 mid, 50 fine, 4 sub-stages
    each, probe 12), pose and exposure, the plain trunks (``bench.py``
    turns ``fused_mlp`` off for the tracker); ``--fused_track`` takes the
    fused tracker render (kernels #8-9);
  * mapping: 600 iterations x 10,000 rays over a 20-frame window, per
    level the union cache (2000 pixels a frame, 5 samples, k 8, union of
    8), ``count_unique``, ``unique_bucket``, ``compact_scene``,
    ``pack_union_cache`` and ``map_scan`` through the mapping-loss kernel
    (#3 under autograd), the features scattered back and the colour
    decoder written back, amortised over every 5th frame.

Kernels on the path: #1 (``ops.knn.topk_rows``: every ``knn_tiles`` search
and the union ranking) and #3 (``ops.fused_mlp.nicer_fused_maploss``).
Timing as ``bench.py``'s: the tile-index build (after one warm-up build) is
added to the mapping time; one warm-up pass each; then tracking ``--reps``
times and mapping max(1, reps - 2) times, each clock read after
``torch.cuda.synchronize()``; per frame = track + map / 5.  One JSON line
with ``bench.py``'s keys.  Unlike ``bench.py`` there is no fallback: a
failure of the mapping-loss path raises.  ``count_unique`` brings each
level's count to the host (one synchronisation per level, which
``bench.py`` overlaps with an asynchronous copy).

Decoder weights come from the port's ``init_nicer`` with a seeded
``torch.Generator`` (``jax.random`` cannot be reproduced in torch), and
pixel and ray draws from ``torch.Generator``s seeded as ``bench.py``'s keys
are numbered.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import mapper as M
from .device import resolve_device
from .models import decoder as Dec
from .ops import knn as Knn
from .ops import optim as Opt
from .renderer import RenderConfig
from .tracker import track_frame

# bench.py's constants
REF_ESTIMATE_MS = 10_000.0
METRIC = "per_frame_tracking+mapping_ms_scannet"
SEED = 1219
FX, FY, CX, CY = 577.59, 578.73, 308.9, 232.68     # ScanNet post-crop
EVERY = 5
LEVELS = ("mid", "fine")
# bench.py's mapping schedule: 4 stages, per-stage LRs
LR_CFG = {"stage": {s: {"decoders_lr": 0.005 if "color" in s else 0.001,
                        "geometry_mid_lr": 0.03 if "geometry" in s else 0.005,
                        "geometry_fine_lr": 0.03 if "geometry" in s else 0.005,
                        "color_lr": 0.0 if "geometry" in s else 0.005}
                    for s in ("geometry_mid", "color_mid", "geometry_fine",
                              "color_fine")},
          "init": {}}


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The workload's sizes; the defaults are bench.py's."""
    H: int = 460
    W: int = 620
    n_mid: int = 60_000
    n_fine: int = 300_000
    cap_mid: int = 1 << 17
    cap_fine: int = 1 << 19
    pixels: int = 5000          # tracking pixels per iteration
    track_iters: int = 100
    rays: int = 10_000          # mapping rays per iteration
    map_iters: int = 600
    window: int = 20
    P: int = 2000               # cached pixels per window frame


def model_config() -> Dec.ModelConfig:
    """bench.py's ScanNet model: exposure, no rel-pos colour, the fused
    trunks and the whole-iteration mapping loss, named explicitly (not
    'auto', which differs between the packages)."""
    return Dec.ModelConfig(encode_exposure=True, encode_rel_pos_in_col=False,
                           fused_mlp=True, fused_composite=True)


def render_config() -> RenderConfig:
    return RenderConfig(near_end_surface=0.96, far_end_surface=1.04,
                        sample_near_pcl=False)


def build_state(rng: np.random.Generator, c_dim: int, n_mid: int,
                n_fine: int, cap_mid: int, cap_fine: int, device):
    """bench.py's scene state, the same numpy draws in the same order (mid,
    then fine; per level the points uniform(-3, 3) with z uniform(-3, -1),
    then geo and col normal(0, 0.1) over the whole capacity): ((pos,
    count, geo, col) mid, the same fine), tensors on ``device``."""
    def level(n, cap):
        pos = np.zeros((cap, 3), np.float32)
        pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        pts[:, 2] = rng.uniform(-3, -1, n)      # rough wall band
        pos[:n] = pts
        geo = rng.normal(0, 0.1, (cap, c_dim)).astype(np.float32)
        col = rng.normal(0, 0.1, (cap, c_dim)).astype(np.float32)
        return (torch.from_numpy(pos).to(device), int(n),
                torch.from_numpy(geo).to(device),
                torch.from_numpy(col).to(device))

    return level(n_mid, cap_mid), level(n_fine, cap_fine)


def draw_frame(rng: np.random.Generator, H: int, W: int):
    """The frame's depth (H, W) and colour (H, W, 3), drawn right after
    ``build_state`` from the same generator, as bench.py draws them."""
    depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return depth, color


@dataclasses.dataclass
class Workload:
    """The state one run of the workload carries: the decoders and the
    scene (mapping writes both back, as bench.py does), the tile indexes,
    the frame and the window stacks."""
    sizes: Sizes
    device: torch.device
    mcfg: Dec.ModelConfig
    rcfg: RenderConfig
    params: dict
    levels: dict        # level -> (pos, count, geo, col)
    frame: dict
    window: dict
    schedules: dict     # level -> (stage ids, LR table)
    fused_track: bool = False
    indexes: dict = dataclasses.field(default_factory=dict)


def make_workload(sizes: Sizes = Sizes(), device="cuda",
                  fused_track: bool = False, params=None) -> Workload:
    """The workload at ``sizes`` on ``device``; ``params``: decoder
    weights to use in place of ``init_nicer``'s (seed 0)."""
    dev = torch.device(device)
    s = sizes
    rng = np.random.default_rng(SEED)
    mcfg = model_config()
    if params is None:
        params = Dec.init_nicer(torch.Generator(device=dev).manual_seed(0),
                                mcfg, dev)
    mid, fine = build_state(rng, mcfg.c_dim, s.n_mid, s.n_fine, s.cap_mid,
                            s.cap_fine, dev)
    depth, color = draw_frame(rng, s.H, s.W)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    F, HW = s.window, s.H * s.W
    frame = {"color": T(color), "depth": T(depth),
             "rq": {"mid": torch.full((s.H, s.W), 0.5, device=dev),
                    "fine": torch.full((s.H, s.W), 0.1, device=dev)},
             "pool": torch.arange(HW, device=dev),
             "expo": torch.zeros((8,), device=dev),
             "cam": torch.tensor([1, 0, 0, 0, 0.1, 0.05, 0.2], device=dev)}
    # the window stacks stay on the device, as the product keeps them
    window = {"colors": frame["color"].expand(F, -1, -1, -1).contiguous(),
              "depths": frame["depth"].expand(F, -1, -1).contiguous(),
              "c2ws": torch.eye(4, device=dev).expand(F, 4, 4).contiguous(),
              "pools": frame["pool"].expand(F, -1).contiguous(),
              "pool_lens": torch.full((F,), HW, device=dev),
              "expo": torch.zeros((F, 8), device=dev),
              "rq": {lv: frame["rq"][lv].expand(F, -1, -1).contiguous()
                     for lv in LEVELS}}
    schedules = M.build_schedule(s.map_iters, 0.5, 0.3, False, 200, LR_CFG)
    return Workload(s, dev, mcfg, render_config(), params,
                    {"mid": mid, "fine": fine}, frame, window, schedules,
                    fused_track)


def build_indexes(w: Workload) -> None:
    """Both levels' tile indexes (the product rebuilds them after each
    mapped frame's insertions)."""
    for lv in LEVELS:
        pos, count, _geo, _col = w.levels[lv]
        w.indexes[lv] = Knn.build_tiles(pos, count)


def run_track(w: Workload, gen: torch.Generator):
    """One tracked frame with bench.py's arguments: (best_cam, best_loss,
    losses, opt_params) of ``track_frame``."""
    s = w.sizes
    f = w.frame
    mcfg_tr = dataclasses.replace(w.mcfg, fused_mlp=False)
    return track_frame(
        w.params, mcfg_tr, w.rcfg, f["cam"], gen, f["color"], f["depth"],
        f["rq"]["mid"], f["rq"]["fine"], f["pool"], f["pool"].numel(),
        w.levels["mid"], w.indexes["mid"], w.levels["fine"],
        w.indexes["fine"], f["expo"], pixels=s.pixels,
        iters_mid=s.track_iters // 2,
        iters_fine=s.track_iters - s.track_iters // 2, W=s.W, fx=FX, fy=FY,
        cx=CX, cy=CY, cam_lr=5e-4, separate_lr=False, use_exposure=True,
        w_color=0.5, use_color=True, handle_dynamic=True, resample_stages=4,
        knn_probe=12, fused_track=w.fused_track)


class StageClock:
    """Wall time per stage into ``times`` (name -> seconds, summed), each
    stage ended by a device synchronisation; with ``times`` None it does
    nothing (bench's own timing does not synchronise between stages)."""

    def __init__(self, device: torch.device, times: Optional[dict]):
        self.device, self.times = device, times
        self.mark()

    def mark(self) -> None:
        if self.times is not None:
            _sync(self.device)
            self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.times is not None:
            t0 = self.t
            self.mark()
            self.times[name] = self.times.get(name, 0.0) + self.t - t0


def build_cache(w: Workload, lv: str, gen: torch.Generator):
    """The level's union cache over the window (bench.py's arguments):
    (cache_pix, uids, Wm, pmask, const) of ``build_pixel_union_cache``."""
    s = w.sizes
    win = w.window
    return M.build_pixel_union_cache(
        gen, win["depths"], win["c2ws"], win["pools"], win["pool_lens"],
        win["rq"][lv], w.indexes[lv], w.levels[lv][0].shape[0], P=s.P, S=5,
        k=8, u_max=8, H=s.H, W=s.W, fx=FX, fy=FY, cx=CX, cy=CY,
        near_surface=0.96, far_surface=1.04, min_nn=w.mcfg.min_nn_num,
        weighting=w.mcfg.weighting, colors=win["colors"], knn_probe=12)


def map_level(w: Workload, lv: str, built, gen: torch.Generator,
              times: Optional[dict] = None) -> dict:
    """One level phase on its union cache ``built``: count_unique (the
    host reads the count), unique_bucket, compact_scene,
    pack_union_cache, map_scan, then the compacted feature rows scattered
    back (padding ids dropped; in place, where bench.py builds new
    arrays) and the trained colour decoder written back.  ``times``: per
    stage seconds ({lv}_count, _compact_pack, _map_scan, _scatter_back).
    Returns {"losses" (n_iters, 2) [geo, colour], "uniq" (U,) the
    compacted rows' ids}."""
    s = w.sizes
    clock = StageClock(w.device, times)
    pos, _count, geo, col = w.levels[lv]
    cache_pix, uids, Wm, pmask, const = built
    n_unique = M.count_unique(uids)
    clock(f"{lv}_count")
    U = M.unique_bucket(n_unique, pos.shape[0])
    uniq, uids_c, _pos_c, geo_c, col_c = M.compact_scene(uids, pos, geo,
                                                         col, U)
    packed = M.pack_union_cache(const, Wm, pmask, uids_c)
    clock(f"{lv}_compact_pack")
    stage_ids, lr_table = w.schedules[lv]
    name = f"col_{lv}"
    op = {"feat": torch.cat([geo_c, col_c], 1),
          "dec": {name: Opt.tree_map(torch.clone, w.params[name])},
          "expo_feat": w.frame["expo"].clone()}
    op, _ost, losses = M.map_scan(
        w.params, w.mcfg, w.rcfg, op, Opt.init(op), gen,
        w.window["depths"], cache_pix, packed, uids.shape[-1],
        w.window["expo"], lr_table, s.window, level=lv, n_rays=s.rays,
        geo_iters=int(np.sum(stage_ids == 0)), use_exposure=True,
        opt_color_dec=True, w_color=0.1)
    clock(f"{lv}_map_scan")
    C = w.mcfg.c_dim
    keep = uniq < pos.shape[0]
    rows = uniq[keep]
    geo.index_copy_(0, rows, op["feat"][keep, :C])
    col.index_copy_(0, rows, op["feat"][keep, C:])
    w.params[name] = op["dec"][name]
    clock(f"{lv}_scatter_back")
    return {"losses": losses, "uniq": uniq}


def run_map(w: Workload, gen: torch.Generator,
            times: Optional[dict] = None) -> dict:
    """One mapped frame as bench.py maps it: both levels' union caches
    first, then each level's phase (``map_level``).  ``times``: per stage
    seconds, {lv}_cache and map_level's.  Returns {level: map_level's
    result}."""
    clock = StageClock(w.device, times)
    built = {}
    for lv in LEVELS:
        built[lv] = build_cache(w, lv, gen)
        clock(f"{lv}_cache")
    return {lv: map_level(w, lv, built.pop(lv), gen, times) for lv in LEVELS}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gen(w: Workload, key: int) -> torch.Generator:
    return torch.Generator(device=w.device).manual_seed(key)


def run_bench(w: Workload, reps: int = 3) -> dict:
    """bench.py's measurement on ``w``: the result line as a dict."""
    dev = w.device
    # the tile-index build, timed after a warm-up build, counts as mapping
    build_indexes(w)
    _sync(dev)
    t0 = time.perf_counter()
    build_indexes(w)
    _sync(dev)
    index_ms = (time.perf_counter() - t0) * 1e3
    # warm-up, with bench.py's key numbers as generator seeds
    run_track(w, _gen(w, 0))
    run_map(w, _gen(w, 1))
    _sync(dev)
    t0 = time.perf_counter()
    for r in range(reps):
        run_track(w, _gen(w, 2 + r % 4))
    _sync(dev)
    track_ms = (time.perf_counter() - t0) / reps * 1e3
    n_map = max(1, reps - 2)
    t0 = time.perf_counter()
    for r in range(n_map):
        run_map(w, _gen(w, 3 + r % 4))
    _sync(dev)
    map_ms = (time.perf_counter() - t0) / n_map * 1e3 + index_ms
    per_frame_ms = track_ms + map_ms / EVERY
    return {"metric": METRIC, "value": per_frame_ms, "unit": "ms",
            "vs_baseline": REF_ESTIMATE_MS / per_frame_ms,
            "detail": {"track_ms": track_ms, "map_ms": map_ms,
                       "index_build_ms": index_ms,
                       "platform": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu")}}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="bench.py's ScanNet workload on the PyTorch port")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card only "
                         "--device cpu runs")
    ap.add_argument("--reps", type=int, default=3,
                    help="tracking repetitions (bench.py's BENCH_REPS); "
                         "mapping runs max(1, reps - 2) times")
    ap.add_argument("--fused_track", action="store_true",
                    help="the fused tracker render, kernels #8-9 "
                         "(bench.py's HPSLAM_BENCH_FUSED_TRACK=1)")
    for f in dataclasses.fields(Sizes):
        ap.add_argument(f"--{f.name}", type=int, default=f.default)
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    sizes = Sizes(**{f.name: getattr(args, f.name)
                     for f in dataclasses.fields(Sizes)})
    w = make_workload(sizes, dev, args.fused_track)
    print(json.dumps(run_bench(w, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
