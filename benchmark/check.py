"""Whether what the timed path produced is correct.

Inside the window the run snapshots, for one tracked frame (drawn from the
seed among those before the first mapped frame) and the first mapped frame,
what the call started from (the point store, the decoders, the exposure
latent, the pose estimates, the keyframe registry, the random streams'
states) and what it returned; those two calls start from state the
program made.  Frame 0's mapping call, in set-up, is snapshot too, from
the benchmark's own state.  After the window, with the program's state
freed, the plain reference (``benchmark/reference``) runs the same calls
from those snapshots, on the same random draws:

- ``track_loss_gap``: the tracking call whole; the largest relative gap
  of the program's logged loss curve (every iteration, logged to 3
  decimals) to the reference's;
- ``track_pose_gap_m``: the largest gap of the returned camera's position
  to the reference's (m);
- ``map_insert_gap``: the mapping call's point insertion: 0 when both
  levels hold exactly the reference's inserted points and the iteration
  count (set by the points added) is the reference's; else the count gaps
  (+1) or the largest position gap (m);
- ``map_loss_gap``: the mid level's first three logged losses
  (iterations 0, s and 2s, s the log's stride): the loss over the cache
  (kernel #3 on the union path), its gradient and the Adam step of the
  features, twice;
- ``map_follow_gap``: the mid level's logged losses through its first
  colour-stage entry and one more (about 0.3 of the level): the geometry
  stage and the first colour iterations (colour decoder, exposure);
- ``map_state_gap`` (where a configuration's limits name it): the whole
  mapping call, both levels, every iteration and the write-back: per
  leaf of what it changes (each level's feature tables, the colour
  decoders' leaves, the exposure latent), the gap between the program's
  and the reference's norm of the change, over the larger of the
  reference's and the median leaf's;
- ``map_feature_gap``: the same over the four feature tables alone
  (geometry and colour, mid and fine level), as written back: it follows
  the fine level and the write-back, where the decoders' small leaves
  swing most;
- ``map0_insert_gap``, ``map0_loss_gap``: frame 0's mapping call (in
  set-up, at ``iters_first``), from state the benchmark made: an empty
  store, the decoders drawn from the seed (``weights.py``), the exposure
  latent worked out from the configuration's seed, the rendered frame at
  its ground-truth pose; insertion and the first three logged losses, as
  above.

On the union path free running parts the program from the reference
over a whole call (a one-ulp nudge of the starting features parts the
reference from itself as far: PERF.md), so the union path's whole call
is held by the per-leaf change gaps, whose limits lie between that spread
and a state left unchanged; the per-sample path agrees whole.

Each number has a limit of its own (``limits/<config>.json``, which also
says which numbers a configuration compares); a run is correct when
every number is at or under its limit.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from .reference import geometry as RG
from .reference import knn as RKnn
from .reference import mapping as RMap
from .reference import tracking as RTrack

# the logged entries map_loss_gap compares (iterations 0, s, 2s)
MAP_ENTRIES = 3


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_clone_tree(v) for v in t)
    return t.detach().clone()


def effective_cam(cfg: dict) -> dict:
    """The camera the program runs at: intrinsics after the crop edge."""
    cam = cfg["cam"]
    e = int(cam.get("crop_edge", 0) or 0)
    return {"fx": float(cam["fx"]), "fy": float(cam["fy"]),
            "cx": float(cam["cx"]) - e, "cy": float(cam["cy"]) - e}


class Capture:
    """Snapshots of the checked calls, taken by the run's wrappers of the
    tracker's and mapper's calls."""

    def __init__(self, track_idx: int, map_idx: int, own=None):
        """``own``: the benchmark's own starting state of frame 0's
        mapping call ({"params", "exposure_feat"}), or None to leave frame
        0 unchecked."""
        self.track_idx = track_idx
        self.map_idx = map_idx
        self.own = own
        self.track = None
        self.map = None
        self.map0 = None

    def before_track(self, slam, idx, frame, npc, params, exposure_feat,
                     estimate_c2w_list, gt_c2w):
        if idx != self.track_idx:
            return
        self.track = {
            "idx": idx, "color": frame.color, "depth": frame.depth,
            "gen": slam.tracker.gen.get_state(),
            "levels": {lv: (L.pos.clone(), int(L.count), L.geo.clone(),
                            L.col.clone()) for lv, L in npc.levels.items()},
            "params": _clone_tree(params),
            "exposure_feat": np.array(exposure_feat, np.float32),
            "est_prev": np.array(estimate_c2w_list[idx - 1]),
            "est_prev2": np.array(estimate_c2w_list[idx - 2]),
            "gt_c2w": np.array(gt_c2w)}

    def after_track(self, idx, out):
        if idx != self.track_idx or self.track is None:
            return
        c2w, tinfo, _op = out
        self.track["out_c2w"] = np.array(c2w)
        self.track["out_curve"] = np.asarray(tinfo.get("loss_curve", []),
                                             np.float64)

    def before_map(self, slam, idx, frame, npc, params, exposure_feat, c2w):
        if idx == self.map_idx:
            self.map = self._map_start(slam, idx, frame, npc, params,
                                       exposure_feat, c2w)
        elif idx == 0 and self.own is not None:
            # from the benchmark's own state: an empty store of the same
            # shapes, its decoders and exposure latent
            cap = self._map_start(slam, idx, frame, npc, self.own["params"],
                                  self.own["exposure_feat"], c2w)
            cap["levels"] = {lv: (torch.zeros_like(p), torch.zeros_like(g),
                                  torch.zeros_like(c), 0)
                             for lv, (p, g, c, _n) in cap["levels"].items()}
            self.map0 = cap

    @staticmethod
    def _map_start(slam, idx, frame, npc, params, exposure_feat, c2w):
        m = slam.mapper
        return {
            "idx": idx, "color": frame.color, "depth": frame.depth,
            "c2w": np.array(c2w),
            "mapper_gen": m.gen.get_state(),
            "mapper_rng": copy.deepcopy(m.rng.bit_generator.state),
            "store_gen": npc.gen.get_state(),
            "levels": {lv: (L.pos.clone(), L.geo.clone(), L.col.clone(),
                            int(L.count)) for lv, L in npc.levels.items()},
            "params": _clone_tree(params),
            "exposure_feat": np.array(exposure_feat, np.float32),
            "keyframes": [{"est_c2w": np.array(kf["est_c2w"]),
                           "color": kf["color"], "depth": kf["depth"],
                           "r_query_mid": kf["r_query_mid"],
                           "r_query_fine": kf["r_query_fine"],
                           "exposure_feat": np.array(kf["exposure_feat"])}
                          for kf in m.keyframe_dict],
            "prev_c2w": (None if m.prev_c2w is None
                         else np.array(m.prev_c2w)),
            "n_img": int(slam.n_img)}

    def after_map(self, idx, npc, out):
        params, expo, info = out
        cap = (self.map if idx == self.map_idx
               else self.map0 if idx == 0 else None)
        if cap is None:
            return
        cap["out_levels"] = {lv: (int(L.count), L.pos[:int(L.count)].clone())
                             for lv, L in npc.levels.items()}
        cap["out_info"] = {k: info[k] for k in (
            "frame_pts_add", "n_joint_iters", "geo_loss_curve",
            "color_loss_curve")}
        if idx != self.map_idx:
            return
        cap["out_state"] = {lv: (L.geo.clone(), L.col.clone())
                            for lv, L in npc.levels.items()}
        cap["out_params"] = _clone_tree(
            {k: v for k, v in params.items() if k.startswith("col_")})
        cap["out_expo"] = np.array(expo, np.float32)


# the program logs its loss curves rounded to 3 decimals: two values that
# agree can read one unit of the last decimal apart
QUANTUM = 1e-3 * (1 + 1e-6)


def _rel(a: float, b: float) -> float:
    """Relative gap of logged value a to reference b (b rounded as the
    log rounds), less the log's rounding unit."""
    b = round(float(b), 3)
    return max(0.0, abs(float(a) - b) - QUANTUM) / max(abs(b), 1e-6)


def _pose(cam7) -> np.ndarray:
    out = np.eye(4)
    out[:3, :] = RG.get_camera_from_tensor_np(np.asarray(cam7, np.float32))
    return out


def reference_track(cfg: dict, cap: dict, device):
    """The reference's tracking call: (pose 4x4, losses (iters,))."""
    cam = effective_cam(cfg)
    gen = torch.Generator(device=device)
    gen.set_state(cap["gen"])
    levels = {lv: (pos, count, geo, col)
              for lv, (pos, count, geo, col) in cap["levels"].items()}
    indices = {lv: RKnn.build_tiles(pos, count, tile=max(
        128, pos.shape[0] // RMap.TILE_COUNT_CAP))
        for lv, (pos, count, _g, _c) in levels.items()}
    cam7, losses = RTrack.track(
        cfg, cam, cap["color"], cap["depth"], cap["idx"], cap["est_prev"],
        cap["est_prev2"], cap["gt_c2w"], levels, indices, cap["params"],
        cap["exposure_feat"], gen, device)
    return _pose(cam7), losses


def follow_entries(cfg: dict, n_joint: int) -> int:
    """Logged entries of the mid level through its first colour-stage
    entry and one more (the log keeps every s-th iteration, s = n_joint //
    120; the mid level's geometry stage ends at iteration A)."""
    m = cfg["mapping"]
    step = max(1, n_joint // 120)
    num_mid = int(n_joint * float(m["mid_iter_ratio"]))
    A = int(num_mid * float(m["geo_iter_ratio"]))
    return min(A // step + 3, num_mid // step + 1)


def follow_count(cfg: dict, n_joint: int) -> int:
    """Iterations of the mid level that reach ``follow_entries``."""
    return (follow_entries(cfg, n_joint) - 1) * max(1, n_joint // 120) + 1


def reference_map(cfg: dict, cap: dict, device, full: bool = False,
                  entries=None):
    """The reference's mapping call: whole (``full``), or followed through
    the mid level's first ``entries`` logged entries (by default
    ``follow_count`` iterations) (map_call's dict)."""
    cam = effective_cam(cfg)
    if full:
        n_follow = None
    else:
        pre = RMap.map_call(cfg, cam, cap, cap["color"], cap["depth"],
                            cap["idx"], cap["c2w"], device, n_follow=0)
        n_follow = (follow_count(cfg, pre["n_joint"]) if entries is None
                    else (entries - 1) * max(1, pre["n_joint"] // 120) + 1)
    return RMap.map_call(cfg, cam, cap, cap["color"], cap["depth"],
                         cap["idx"], cap["c2w"], device, n_follow=n_follow)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def state_gaps(cap: dict, ref: dict) -> dict:
    """Per leaf of what a whole mapping call changes (each level's
    geometry and colour feature tables, the colour decoders' leaves, the
    exposure latent): the gap between the program's and the reference's
    norm of the change from the state after insertion, over the larger of
    the reference's norm and the median leaf's.  Leaves the reference
    moves by under a thousandth of the median leaf are left out."""
    pairs = []
    for lv, (g0, c0) in ref["init_state"].items():
        pg, pc = cap["out_state"][lv]
        rg, rc = ref["state"][lv]
        pairs.append((f"feat_geo_{lv}", pg - g0, rg - g0))
        pairs.append((f"feat_col_{lv}", pc - c0, rc - c0))
    for name in sorted(cap["out_params"]):
        init = _leaves(cap["params"][name])
        for i, (p0, pp, rp) in enumerate(zip(
                init, _leaves(cap["out_params"][name]),
                _leaves(ref["params"][name]))):
            pairs.append((f"{name}.{i}", pp - p0, rp - p0))
    e0 = torch.as_tensor(np.asarray(cap["exposure_feat"]))
    pairs.append(("expo", torch.as_tensor(cap["out_expo"]) - e0,
                  torch.as_tensor(np.asarray(ref["expo"])) - e0))
    norms = [(n, float(torch.linalg.norm(a.double().cpu())),
              float(torch.linalg.norm(b.double().cpu())))
             for n, a, b in pairs]
    med = float(np.median([r for _n, _p, r in norms]))
    return {n: abs(p - r) / max(r, med) for n, p, r in norms
            if r >= 1e-3 * med}


def track_numbers(cap: dict, ref_pose, ref_losses) -> dict:
    curve = cap["out_curve"]
    ref = np.asarray(ref_losses, np.float64)
    if len(curve) == 0 or len(curve) != len(ref):
        gap = float("inf")
    else:
        gap = max(_rel(curve[i], ref[i]) for i in range(len(ref)))
    return {"track_loss_gap": float(gap),
            "track_pose_gap_m": float(np.max(np.abs(
                cap["out_c2w"][:3, 3] - ref_pose[:3, 3])))}


def curve_gaps(info: dict, losses, entries=None) -> list:
    """[(iteration, relative gap)] of the logged loss entries (geometry,
    and colour where either side is non-zero) that the reference's losses
    reach, the first ``entries`` of them or all."""
    step = max(1, int(info["n_joint_iters"]) // 120)
    out = []
    n = len(info["geo_loss_curve"])
    for j in range(n if entries is None else min(n, entries)):
        it = j * step
        if it >= len(losses):
            break
        out.append((it, _rel(info["geo_loss_curve"][j], losses[it, 0])))
        c = info["color_loss_curve"][j]
        if c != 0.0 or round(float(losses[it, 1]), 3) != 0.0:
            out.append((it, _rel(c, losses[it, 1])))
    return out


def insert_gap(cap: dict, ref: dict) -> float:
    """0 when every level holds the reference's inserted points exactly
    and the iteration count is the reference's; else the count gaps (+1)
    or the largest position gap (m)."""
    gap = float(abs(int(cap["out_info"]["n_joint_iters"]) - ref["n_joint"]))
    for lv, (cnt, pos) in cap["out_levels"].items():
        rc, rpos = ref["levels"][lv]
        if rc != cnt:
            gap += abs(rc - cnt) + 1.0
        elif cnt:
            gap = max(gap, float(torch.max(torch.abs(
                pos.to(rpos.device) - rpos))))
    return gap


def map_numbers(cfg: dict, cap: dict, ref: dict) -> dict:
    info = cap["out_info"]

    def worst(entries):
        gaps = curve_gaps(info, ref["losses"], entries)
        return float(max(g for _i, g in gaps)) if gaps else float("inf")
    out = {"map_insert_gap": insert_gap(cap, ref),
           "map_loss_gap": worst(MAP_ENTRIES),
           "map_follow_gap": worst(follow_entries(
               cfg, int(info["n_joint_iters"])))}
    if "state" in ref:
        gaps = state_gaps(cap, ref)
        out["map_state_gap"] = max(gaps.values())
        out["map_feature_gap"] = max(
            [g for n, g in gaps.items() if n.startswith("feat_")],
            default=float("inf"))
    return out


def map0_numbers(cap: dict, ref: dict) -> dict:
    gaps = curve_gaps(cap["out_info"], ref["losses"], MAP_ENTRIES)
    return {"map0_insert_gap": insert_gap(cap, ref),
            "map0_loss_gap": (float(max(g for _i, g in gaps)) if gaps
                              else float("inf"))}


def needs_full(names) -> bool:
    return "map_state_gap" in names or "map_feature_gap" in names


def run_check(cfg: dict, capture: Capture, device, names, refs=None):
    """The numbers ``names`` of the check: {name: value}.  ``refs``, where
    given, receives the reference's outputs ("track": (pose, losses),
    "map", "map0": map_call's dicts)."""
    out = {}
    refs = {} if refs is None else refs
    if capture.track is not None and "out_curve" in capture.track:
        refs["track"] = reference_track(cfg, capture.track, device)
        out.update(track_numbers(capture.track, *refs["track"]))
    if capture.map is not None and "out_info" in capture.map:
        refs["map"] = reference_map(cfg, capture.map, device,
                                    full=needs_full(names))
        out.update(map_numbers(cfg, capture.map, refs["map"]))
    if capture.map0 is not None and "out_info" in capture.map0:
        refs["map0"] = reference_map(cfg, capture.map0, device,
                                     entries=MAP_ENTRIES)
        out.update(map0_numbers(capture.map0, refs["map0"]))
    return {n: out.get(n, float("inf")) for n in names}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names."""
    table = {n: {"value": float(numbers[n]) if np.isfinite(numbers[n])
                 else 1e30, "limit": float(limits[n])} for n in limits}
    ok = all(np.isfinite(numbers[n]) and numbers[n] <= float(limits[n])
             for n in limits)
    return ok, table
