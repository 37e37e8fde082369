"""The port's tracker and mapper in lockstep with the reference's, iteration
by iteration, on the reference's own state and random draws (CPU, f32).

The reference (hpslam_tpu.slam.PointSLAM) runs once, on tests/test_e2e.py's
tiny config (48x64, 7 frames, tracking 200 px x 6 iterations, mapping 400 px
x 10 iterations), on its plain union route, which its 'auto' takes on the
CPU (tests/test_torch_lockstep_fused.py runs the same cases on the fused
route).  Wrappers on ``Tracker.track`` and ``Mapper.map`` record, at every
call, the state the engine was handed (point levels, decoders, exposure
latent, pose list, keyframe registry, the mapper's numpy stream) and what
it returned; wrappers on ``track_frame``, ``map_scan``, the union cache
and its neighbour search record the unrounded loss curves and the caches,
and one on the Adam step (``ops.optim.update``, through a debug callback
inside the jitted scans) records each iteration's parameters, moments and
gradients before and after the step.  The state is taken in the wrappers,
not from checkpoints: with the map's lag a checkpoint is not the state a
frame was tracked on.

Each tracked frame (idx >= 2) and each mapped frame is then replayed on the
port's ``PointSLAM`` (device "cpu"): the recorded state is loaded, the
port's own reader gives the frame (equal to the reference's), and the
reference's random draws are handed to the port in the order the port
makes them (``torch.randint`` / ``torch.randn``).  So are the reference's
choices among equals, each after the port's own is held against it:
  * tile selection (``ops.knn.select_tiles``): XLA's approx_min_k, exact on
    the CPU, orders tied tile bounds as an unstable sort does; the port
    takes the first tile of a tie (test_tile_selection_differs_only_on_ties);
  * the mapping cache's samples, neighbours and unions: the samples within
    CONST_ATOL (rays_d summed in another order), the neighbours within
    KNN_RTOL (XLA fuses the squared differences' sum into multiply-adds)
    and the unions up to tied scores (knn_agrees, union_cache_agrees) --
    a neighbour at the query radius falls in or out with the last bit;
  * the inserted points' features, one unit in the last place apart (XLA
    folds 0.1 * normal into the normal's last step; inserted_agrees).
Every Adam step of the port is taken from the reference's parameters and
moments of that iteration and checked against the reference's; then the
port goes on from the reference's result.  Free running, a frame parts
beyond these tolerances within a few iterations in either package: a
one-ulp nudge of the start pose parts the reference from itself as far as
the port parts from it (test_free_running_parts_as_the_reference_from_
itself).  Adam's normalised steps carry rounding-level gradient
differences into the pose at the learning rate's scale, and the robust
tracking loss (its outlier mask and clip) and the decoders' ReLUs are
discontinuous.

Tolerances.  Tracking: the loss at every iteration rtol 1e-3, the port's
own step of the pose and the best pose atol 1e-4, cam_init and the pixel
pool bit for bit.  Mapping: point counts equal, new positions bit for bit,
both losses at every iteration rtol 1e-3; the gradient at every step
within GRAD_REL_FRO_MAX of the reference's as a whole (GRAD_REL_FRO_MEDIAN
in the median) and leaf by leaf: the geometry features within
GEO_FEAT_GRAD_MAX (GEO_FEAT_GRAD_MEDIAN in the median; a ReLU at its kink
parts single steps), every other leaf (each decoder leaf, the colour
features, the exposure latent) within GRAD_LEAF_MAX; the port's own Adam
step on its own gradient, on every leaf but the geometry features, within
FEAT_RTOL / FEAT_ATOL of the reference's step where the reference's
gradient is at least OWN_STEP_GRAD_SHARE of the leaf's largest.  At most
MAX_KINK_STEPS steps a frame may find one ray at the kink of the L1 colour
loss (kink_ray: a residual within rounding of zero, whose cotangent's sign
falls either way); there that ray's feature rows and the decoder and
exposure leaves are not held, the rest is.  Both engines: the port's
Adam step on the reference's gradient within ADAM_ATOL of the
reference's.  The levels, decoders and exposure latent that map() returns
are the last step's, handed over: held at FEAT_RTOL / FEAT_ATOL, they
check the hand-back and the scatter-back into the levels, not the
optimisation.  Run with -s, each case prints one JSON line of its largest
differences.

The tracker's host helpers (initial pose, pixel pools, radii, the
quaternion sign gauge) are held bit for bit below the lockstep cases.
"""
import builtins
import contextlib
import copy
import json
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from hpslam_tpu import mapper as jM
from hpslam_tpu import state as jS
from hpslam_tpu import tracker as jT
from hpslam_tpu.ops import knn as jK
from hpslam_tpu.ops import optim as jOpt
from hpslam_tpu_torch import convert
from hpslam_tpu_torch import mapper as tM
from hpslam_tpu_torch import tracker as tT
from hpslam_tpu_torch.models import decoder as tDec
from hpslam_tpu_torch.ops import fused_mlp as tFM
from hpslam_tpu_torch.ops import knn as tK
from hpslam_tpu_torch.ops import optim as tOpt
from tests.test_e2e import tiny_cfg

N_FRAMES = 7                        # tiny_cfg's sequence
TRACKED = list(range(2, N_FRAMES))  # frames 0-1 take the GT pose
MAPPED = [0, 5, 6]                  # every 5th frame and the last
INT32_MAX = int(jnp.iinfo(jnp.int32).max)
# the lockstep's tolerances (f32 on the same inputs)
LOSS_RTOL = 1e-3
POSE_ATOL = 1e-4
FEAT_RTOL, FEAT_ATOL = 1e-3, 1e-5
GRAD_REL_FRO_MAX, GRAD_REL_FRO_MEDIAN = 5e-2, 1e-3   # the whole gradient
# the mapping gradient leaf by leaf (grad_leaf_errors): the geometry
# features' leaf (a ReLU at its kink parts single steps), every other leaf
# (decoders, colour features, exposure) at every step
GEO_FEAT_GRAD_MAX, GEO_FEAT_GRAD_MEDIAN = 5e-2, 2e-3
GRAD_LEAF_MAX = 2e-3
# the port's own mapping step is held where the reference's gradient is at
# least this share of the leaf's largest (elsewhere Adam's normalised step
# turns a rounding-level gradient into a step of the learning rate's size)
OWN_STEP_GRAD_SHARE = 1e-2
# a mapped frame's steps at which one ray sits at the L1 colour loss's kink
# (kink_ray: that ray's rows and the decoder leaves are not held there); a
# tracked frame's steps at which one pixel's colour residual does
# (kink_pixel: the pose step held with that term's sign as the reference's)
MAX_KINK_STEPS = 1
# a colour residual this near zero may take either sign in the two packages
# (their rendered colours part by rounding: FMAs, summation order)
COLOR_KINK_ATOL = 1e-5
# kink_pixel: the part of the pose gradient's difference that flipping one
# pixel's colour term leaves unexplained, relative to the difference, and
# how near the flip's size must be to 2 w_color times its draws
KINK_FIT_RTOL = 1e-2
# a mapped frame's steps at which the port's own step on a decoder leaf
# parts where the leaf's gradient is set by the Fourier projection's
# rounding (projection_witness: that leaf's step not held there)
MAX_ROUNDING_STEPS = 1
# free running, the port parts from the reference by at most this many
# times as far as a one-ulp nudge parts the reference from itself (the same
# order of magnitude)
FREE_RUN_FACTOR = 10.0
ADAM_ATOL = 1e-7                    # a unit in the last place at |p| ~ 1
KNN_RTOL = 1e-6                     # squared distances summed with FMAs
CONST_ATOL = 1e-6                   # rays_d summed in another order
# the port's functions the replay wraps, as imported
ADAM_STEP = tOpt.update
TREE_LEAVES = tOpt.tree_leaves
OPTIMISE = tM.optimise
SELECT_TILES = tK.select_tiles
UNION_CACHE = tM.build_pixel_union_cache
SAMPLES = tM.pixel_samples
KNN = tK.knn_tiles


@contextlib.contextmanager
def two_torch_threads():
    """Two torch threads inside: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _torch_threads():
    with two_torch_threads():
        yield


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _levels(npc) -> dict:
    """Every level's arrays at their whole capacity, and its count."""
    return {name: {"pos": np.array(lv.pos), "normal": np.array(lv.normal),
                   "geo": np.array(lv.geo), "col": np.array(lv.col),
                   "count": int(lv.count), "capacity": int(lv.capacity)}
            for name, lv in npc.levels.items()}


def _record(store: dict, key: str, fn, copy_args: bool = False):
    """fn, keeping each call's arguments (in store[key] from the call's
    start) and outputs; with copy_args, the arguments' arrays also copied
    to the host before the call (the jitted reference donates some of its
    buffers)."""
    def wrapped(*args, **kwargs):
        entry = {"args": args, "kwargs": kwargs}
        if copy_args:
            host = lambda a: (np.array(a, copy=True)
                              if isinstance(a, jax.Array) else a)
            entry.update(args_host=jax.tree.map(host, args),
                         kwargs_host=jax.tree.map(host, kwargs))
        store.setdefault(key, []).append(entry)
        entry["out"] = fn(*args, **kwargs)
        return entry["out"]
    return wrapped


@contextlib.contextmanager
def reference_adam_steps(*jitted):
    """Record every Adam step (hpslam_tpu.ops.optim.update) that the jitted
    reference functions take, through an ordered debug callback: yields a
    function returning the steps recorded since its last call, each
    {params, state, grads, new_params, new_state} as numpy trees.  The
    functions' jit caches are cleared so that they trace the recording
    step, and again afterwards so that nothing else runs it."""
    recorded = []
    orig = jOpt.update

    def update(grads, state, params, lr, *a, **kw):
        new_p, new_s = orig(grads, state, params, lr, *a, **kw)
        jax.debug.callback(lambda *xs: recorded.append(_np(xs)), params,
                           state, grads, new_p, new_s, ordered=True)
        return new_p, new_s

    def take():
        jax.effects_barrier()
        out = [dict(zip(("params", "state", "grads", "new_params",
                         "new_state"), s)) for s in recorded]
        recorded.clear()
        return out

    for fn in jitted:
        fn.clear_cache()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jOpt, "update", update)
            yield take
    finally:
        for fn in jitted:
            fn.clear_cache()


def overlap_scores(record):
    """``sorted`` for a mapper module's globals: hands the (keyframe,
    overlap score) pairs that keyframe_selection_overlap ranks (the only
    call there that sorts pairs by a key) to ``record`` and sorts as the
    builtin does."""
    def spy(iterable, *args, **kwargs):
        items = list(iterable)
        if (kwargs.get("key") is not None and items
                and all(isinstance(x, tuple) and len(x) == 2
                        for x in items)):
            record([(int(k), float(v)) for k, v in items])
        return builtins.sorted(items, *args, **kwargs)
    return spy


def tile_shapes(npc) -> dict:
    """Each level's tile index as (tiles, tile size): the index the next
    search of the level uses (built here where stale, as the search would
    build it)."""
    return {name: (int(npc.index(name)[0].shape[0]),
                   int(npc.index(name)[0].shape[1]) // 4)
            for name in npc.levels}


def _run_reference(cfg, nudge: bool = True):
    """PointSLAM.run with every track and map call's inputs, outputs, loss
    curves and Adam steps recorded, and the order of the calls; with
    nudge, each tracked frame also rerun from a start pose one ulp away
    (nudged_track)."""
    from hpslam_tpu.slam import PointSLAM
    tracks, maps, order = {}, {}, []
    inner: dict = {}
    orig_track, orig_map = jT.Tracker.track, jM.Mapper.map
    orig_track_frame = jT.track_frame
    orig_union = jM.build_pixel_union_cache
    orig_knn = jK.knn_tiles

    def knn(query, *index, **kwargs):
        D, I = orig_knn(query, *index, **kwargs)
        jax.debug.callback(lambda *xs: inner.setdefault("knn", []).append(
            _np(xs)), D, I, ordered=True)
        return D, I

    def union_cache(*args, **kwargs):
        if "inserted" not in inner:     # the levels after the insertion
            inner["inserted"] = _levels(inner["npc"])
        jax.effects_barrier()
        inner["knn"] = []
        out = _record(inner, "union_cache", orig_union)(*args, **kwargs)
        jax.effects_barrier()
        (inner["union_cache"][-1]["knn"],) = inner["knn"]
        return out

    def nudged_track(call) -> dict:
        """track_frame again, as compiled, on the same inputs but the start
        pose's x one unit in the last place up: its loss curve and best
        pose."""
        dev = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
        args = list(jax.tree.map(dev, call["args_host"]))
        cam = np.array(call["args_host"][3], copy=True)
        cam[4] = np.nextafter(cam[4], np.float32(np.inf))
        args[3] = jnp.asarray(cam)
        best_cam, _loss, losses, _op = orig_track_frame(
            *args, **jax.tree.map(dev, call["kwargs_host"]))
        return {"losses": np.asarray(losses), "best_cam": np.asarray(best_cam)}

    def track(self, idx, frame, npc, params, exposure_feat, key,
              estimate_c2w_list, gt_c2w):
        inner.clear()
        steps()
        rec = {"key": key, "levels": _levels(npc), "params": _np(params),
               "expo": np.array(exposure_feat, copy=True),
               "est": np.array(estimate_c2w_list, copy=True),
               "gt_c2w": np.array(gt_c2w, copy=True),
               "color": frame.color.copy(), "depth": frame.depth.copy()}
        c2w, info, op = orig_track(self, idx, frame, npc, params,
                                   exposure_feat, key, estimate_c2w_list,
                                   gt_c2w)
        if "track_frame" in inner:
            (call,) = inner["track_frame"]
            best_cam, _best_loss, losses, _op = call["out"]
            rec.update(cam_init=np.asarray(call["args"][3]),
                       pool=np.asarray(call["args"][9])[
                           :int(call["args"][10])],
                       best_cam=np.asarray(best_cam),
                       losses=np.asarray(losses), steps=steps())
            if nudge:
                rec["nudged"] = nudged_track(call)
                steps()                 # the nudged run's steps
        rec.update(c2w=c2w, info=info, tiles=tile_shapes(npc))
        tracks[idx] = rec
        order.append(("track", idx))
        return c2w, info, op

    def map_(self, idx, frame, npc, params, exposure_feat, key, c2w,
             F_max=None, color_refine=False):
        inner.clear()
        steps()
        rec = {"key": key, "levels": _levels(npc), "params": _np(params),
               "expo": np.array(exposure_feat, copy=True),
               "c2w": np.array(c2w, copy=True),
               "color": frame.color.copy(), "depth": frame.depth.copy(),
               "keyframe_list": list(self.keyframe_list),
               "keyframes": [{k: np.array(kf[k], copy=True) for k in
                              ("idx", "est_c2w", "gt_c2w", "exposure_feat")}
                             for kf in self.keyframe_dict],
               "prev_c2w": (None if self.prev_c2w is None
                            else np.array(self.prev_c2w, copy=True)),
               "rng_in": copy.deepcopy(self.rng.bit_generator.state),
               "npc_keys": int(npc._key_counter), "seed": npc._seed}
        inner["npc"] = npc
        out = orig_map(self, idx, frame, npc, params, exposure_feat, key,
                       c2w, F_max=F_max, color_refine=color_refine)
        rec.update(levels_out=_levels(npc), params_out=_np(out[0]),
                   expo_out=np.array(out[1], copy=True), info=out[2],
                   rng_out=copy.deepcopy(self.rng.bit_generator.state),
                   npc_keys_out=int(npc._key_counter), steps=steps(),
                   scans=[{"level": c["kwargs"]["level"],
                           "losses": np.asarray(c["out"][2])}
                          for c in inner.get("map_scan", [])],
                   caches=[_np(c["out"]) for c in inner.get("union_cache",
                                                            [])],
                   cache_knn=[c["knn"] for c in inner.get("union_cache", [])],
                   inserted=inner.get("inserted"),
                   overlap=inner.get("overlap"), tiles=tile_shapes(npc))
        maps[idx] = rec
        order.append(("map", idx))
        return out

    jitted = (jT.track_frame, jM.map_scan, jM.build_pixel_union_cache,
              jS.add_points)
    with reference_adam_steps(*jitted) as steps, \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jT.Tracker, "track", track)
        mp.setattr(jM.Mapper, "map", map_)
        mp.setattr(jT, "track_frame",
                   _record(inner, "track_frame", jT.track_frame,
                           copy_args=True))
        mp.setattr(jM, "map_scan", _record(inner, "map_scan", jM.map_scan))
        mp.setattr(jM, "build_pixel_union_cache", union_cache)
        mp.setattr(jK, "knn_tiles", knn)
        mp.setattr(jM, "sorted", overlap_scores(
            lambda pairs: inner.setdefault("overlap", []).append(pairs)),
            raising=False)
        slam = PointSLAM(cfg)
        slam.run()
    return tracks, maps, order, list(slam.mapper.keyframe_list)


def window_cfg(tmp_path):
    """tiny_cfg lengthened only as far as a whole run's window code needs:
    12 frames, every 2nd frame mapped and registered as a keyframe, the
    window of synth_room.yaml (5 frames: mapped frame 10 ranks keyframes
    0, 2, 4 and 6 by overlap for three slots), and a point capacity of 4096
    a level, which each level outgrows during the run."""
    cfg = tiny_cfg(tmp_path)
    cfg["synthetic"]["n_frames"] = 12
    cfg["mapping"].update(every_frame=2, keyframe_every=2,
                          mapping_window_size=5)
    cfg["pointcloud"]["initial_capacity"] = 4096
    return cfg


def recorded_reference(tmp_path_factory, fused: bool, make_cfg=tiny_cfg,
                       nudge: bool = True) -> dict:
    """The reference's run of make_cfg (tiny_cfg: the tiny 7-frame run) on
    the plain or the fused union route, recorded (_run_reference)."""
    cfg = make_cfg(tmp_path_factory.mktemp("ref"))
    cfg["model"].update(fused_mlp=fused, fused_composite=fused)
    tracks, maps, order, keyframes = _run_reference(cfg, nudge)
    return {"cfg": cfg, "tracks": tracks, "maps": maps, "order": order,
            "keyframe_list": keyframes}


def check_window_coverage(reference, tracked, mapped):
    """What a long-window run must reach, asserted on the recorded
    reference: a mapped frame whose overlap ranking finds more earlier
    keyframes than mapping_window_size - 2 and keeps that many (the
    ranking truncated); a window of mapping_window_size frames; each
    level's capacity grown beyond pointcloud.initial_capacity before a
    replayed frame.  And the replayed frames (tracked, mapped) include
    every tracked frame after the first growth and every mapped frame with
    two or more candidate keyframes."""
    cfg = reference["cfg"]
    win = cfg["mapping"]["mapping_window_size"]
    cap0 = cfg["pointcloud"]["initial_capacity"]
    maps, tracks = reference["maps"], reference["tracks"]
    truncated = [i for i, r in maps.items() if r["overlap"]
                 and sum(sc > 0 for _k, sc in r["overlap"][0]) > win - 2
                 and len(r["info"]["window"]) == win]
    assert truncated, {i: r["overlap"] for i, r in maps.items()}
    assert any(len(r["info"]["window"]) == win for r in maps.values())
    grown = lambda rec: {n for n, lv in rec["levels"].items()
                         if lv["capacity"] > cap0}
    replayed = ([tracks[i] for i in tracked]
                + [maps[i] for i in mapped])
    assert set().union(*map(grown, replayed)) == set(cfg["pointcloud"][
        "radius_hierarchy"]), "a level never grew before a replayed frame"
    after_growth = {i for i, r in tracks.items() if i >= 2 and grown(r)}
    assert after_growth <= set(tracked), sorted(after_growth - set(tracked))
    ranked = {i for i, r in maps.items() if len(r["keyframe_list"]) - 1 >= 2}
    assert ranked <= set(mapped), sorted(ranked - set(mapped))


def check_schedule(reference, tmp_path_factory):
    """The port's run loop (slam.py) on the reference's recorded engine
    outputs: the engines stubbed to return what the reference's returned
    at each frame, the port's loop must track and map the same frames in
    the same order as the reference's, hand each map the same pose, and
    register the same keyframes (each map call sees the reference's
    keyframe list at that call, the run ends with its final list)."""
    slam = port_slam(reference, tmp_path_factory)
    order = []

    def track(idx, frame, npc, params, expo, est, gt_c2w):
        order.append(("track", idx))
        rec = reference["tracks"][idx]
        return rec["c2w"], rec["info"], None

    def map_(idx, frame, npc, params, expo, c2w, color_refine=False):
        order.append(("map", idx))
        rec = reference["maps"][idx]
        assert slam.mapper.keyframe_list == rec["keyframe_list"], idx
        np.testing.assert_array_equal(c2w, rec["c2w"])
        return params, expo, rec["info"]

    slam.tracker.track = track
    slam.mapper.map = map_
    slam.run()
    assert order == reference["order"]
    assert slam.mapper.keyframe_list == reference["keyframe_list"]


def port_slam(reference, tmp_path_factory):
    """The port's PointSLAM on the reference's config, on the CPU."""
    from hpslam_tpu_torch.slam import PointSLAM
    cfg = copy.deepcopy(reference["cfg"])
    cfg["data"]["output"] = str(tmp_path_factory.mktemp("port"))
    return PointSLAM(cfg, device="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's tiny run on the plain union route: what its 'auto'
    resolves to on the CPU (test_torch_lockstep_fused.py holds the fused
    route, which freezes the colour decoder's Fourier matrix)."""
    return recorded_reference(tmp_path_factory, fused=False)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    return port_slam(reference, tmp_path_factory)


def _load_state(slam, rec):
    """The reference's recorded decoders and point levels into the port's
    PointSLAM (the levels at the reference's capacities, which set the tile
    size); returns the exposure latent."""
    slam.params = convert.params_from_numpy(rec["params"])
    for name, lv in rec["levels"].items():
        n = lv["count"]
        for k in ("pos", "normal", "geo", "col"):
            assert not lv[k][n:].any(), f"{name}.{k} beyond the count"
        slam.npc.restore_level(name, lv["pos"][:n], lv["normal"][:n],
                               lv["geo"][:n], lv["col"][:n], lv["capacity"])
    return rec["expo"].copy()


def _frame(slam, rec, idx):
    """The port reader's frame idx, which must be the reference's."""
    frame = slam.frame_reader[idx]
    np.testing.assert_array_equal(frame.color, rec["color"])
    np.testing.assert_array_equal(frame.depth, rec["depth"])
    return frame


def reference_tile_selection(lb2, probe: int):
    """The reference's tile choice (hpslam_tpu.ops.knn._select_tiles) on
    the port's tile bounds."""
    return torch.as_tensor(np.array(jK._select_tiles(
        jnp.asarray(lb2.numpy()), probe)), dtype=torch.int64)


def _to_port(template, ref):
    """The nested arrays ``ref`` as tensors shaped like the port's tree
    ``template`` (the same keys and list positions)."""
    if isinstance(template, dict):
        return {k: _to_port(template[k], ref[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_to_port(t, r) for t, r in zip(template, ref))
    if isinstance(template, int):
        return int(ref)
    return torch.as_tensor(np.array(ref, copy=True), dtype=torch.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _close(name, a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=name)


def _grad_groups(path, g):
    """A gradient leaf as (label, array) pairs: the mapper's packed feature
    table split into its geometry and colour halves."""
    g = np.asarray(g)
    if path == ("feat",):
        C = g.shape[1] // 2
        return [("feat.geo", g[:, :C]), ("feat.col", g[:, C:])]
    return [(".".join(map(str, path)), g)]


def grad_leaf_errors(grads, ref_g, kink_rows=None) -> dict:
    """||g - g_ref|| / ||g_ref|| for each gradient leaf (_grad_groups); a
    leaf whose reference gradient is zero reads 0 where the port's is zero
    too, else infinity.  Given kink_rows (a ray at a loss kink, kink_ray),
    only the feature leaves, the colour features without those rows."""
    out = {}
    for path, g in _leaves(grads):
        gr = _get(ref_g, path)
        g = np.zeros_like(gr) if g is None else g.numpy()
        for (label, a), (_, b) in zip(_grad_groups(path, g),
                                      _grad_groups(path, gr)):
            if kink_rows is not None:
                if not label.startswith("feat."):
                    continue
                if label == "feat.col":
                    keep = np.ones(len(a), bool)
                    keep[kink_rows] = False
                    a, b = a[keep], b[keep]
            num = float(np.linalg.norm((a.astype(np.float64) - b).ravel()))
            den = float(np.linalg.norm(b.astype(np.float64).ravel()))
            out[label] = (num / den if den > 0
                          else (0.0 if num == 0 else float("inf")))
    return out


class Replay:
    """Stands in, inside one engine call, for torch.randint / torch.randn
    (the reference's jax.random draws, each call's bounds and shape
    checked), for ops.knn.select_tiles (the reference's tile choice) and
    for the Adam step (ops.optim.update: the port's step from the
    reference's parameters and moments of the iteration, checked against
    the reference's, which the port then carries on from)."""

    def __init__(self, steps, nested, check, own_step):
        self.randint_rules = []     # (predicate, producer)
        self.randn_rule = None
        self.steps = steps          # the reference's Adam steps, in order
        self.nested = nested        # a reference tree, keyed as the port's
        self.check = check          # check(label, port's tree, ref's)
        # own_step(label, port's own step, ref's step, ref's gradient,
        # port's gradient): holds the port's own Adam step on its own
        # gradient
        self.own_step = own_step
        self.n_steps = 0
        self.grad_errors = []      # ||g - g_ref|| / ||g_ref|| per step

    def randint(self, low, high, size, **kwargs):
        for match, produce in self.randint_rules:
            if match(high, tuple(size)):
                return torch.as_tensor(np.array(produce(high, tuple(size))),
                                       dtype=torch.int64)
        raise AssertionError(f"unexpected torch.randint{(low, high, size)}")

    def randn(self, size, **kwargs):
        return torch.as_tensor(np.array(self.randn_rule(tuple(size))),
                               dtype=torch.float32)

    def update(self, grads, state, params, lr, *a, **kw):
        i = self.n_steps
        self.n_steps += 1
        ref = self.steps[i]
        ref_p = self.nested(ref["params"])
        ref_new = self.nested(ref["new_params"])
        ref_s = {"m": self.nested(ref["state"]["m"]),
                 "v": self.nested(ref["state"]["v"]), "t": ref["state"]["t"]}
        self.check(f"step {i} start", params, ref_p)
        ref_g = self.nested(ref["grads"])
        num = den = 0.0
        for path, g in _leaves(grads):
            gr = _get(ref_g, path)
            g = np.zeros_like(gr) if g is None else g.numpy()
            num += float(np.sum((g.astype(np.float64) - gr) ** 2))
            den += float(np.sum(gr.astype(np.float64) ** 2))
        self.grad_errors.append((num / max(den, 1e-60)) ** 0.5)
        # the port's Adam step on the reference's gradient, parameters and
        # moments gives the reference's result
        adam_p, _ = ADAM_STEP(_to_port(params, ref_g), _to_port(state, ref_s),
                              _to_port(params, ref_p), lr, *a, **kw)
        for path, t in _leaves(adam_p):
            _close(f"step {i} Adam {path}", t.numpy(), _get(ref_new, path),
                   0, ADAM_ATOL)
        new_p, _ = ADAM_STEP(grads, state, params, lr, *a, **kw)
        # the port's own step on another gradient (kink_pixel's), and the
        # parameters the gradient was taken at (projection_witness)
        self.restep = lambda g: ADAM_STEP(g, state, params, lr, *a, **kw)[0]
        self.step_params = params
        self.own_step(f"step {i}", new_p, ref_new, ref_g, grads)
        return _to_port(params, ref_new), _to_port(state, {
            "m": self.nested(ref["new_state"]["m"]),
            "v": self.nested(ref["new_state"]["v"]),
            "t": ref["new_state"]["t"]})

    def install(self, mp, adam: bool = True):
        mp.setattr(torch, "randint", self.randint)
        mp.setattr(torch, "randn", self.randn)
        mp.setattr(tK, "select_tiles", reference_tile_selection)
        if adam:
            mp.setattr(tOpt, "update", self.update)
        if hasattr(self, "union_cache"):
            mp.setattr(tM, "build_pixel_union_cache", self.union_cache)
            mp.setattr(tM, "pixel_samples", self.samples)


# --------------------------------------------------------------------------
# tracking


def search_recall(query, packed, tile_lo, tile_hi, k, probe) -> tuple:
    """Recall@k against the exact neighbours of the tile search on these
    queries with the port's tile selection and with the reference's
    (reported: they differ only where tile bounds tie)."""
    tile = packed.shape[1] // 4
    pts = packed[:, :3 * tile].reshape(-1, 3, tile).permute(0, 2, 1)
    ids = tK.unpack_ids(packed[:, 3 * tile:]).reshape(-1)
    d2 = torch.cdist(query.double(), pts.reshape(-1, 3).double()) ** 2
    exact = ids[torch.topk(d2, k, largest=False).indices].numpy()
    out = []
    for select in (SELECT_TILES, reference_tile_selection):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tK, "select_tiles", select)
            _D, I = KNN(query, packed, tile_lo, tile_hi, k=k, probe=probe)
        out.append(float(np.mean([len(set(a) & set(b)) / k for a, b in
                                  zip(I.numpy(), exact)])))
    return tuple(out)


def report(engine, idx, losses, ref_losses, replay, **extra):
    """One JSON line of the call's largest differences (shown with -s)."""
    ge = np.asarray(replay.grad_errors)
    print(json.dumps({
        "lockstep": engine, "frame": idx,
        "loss_rel_max": float(np.max(np.abs(losses - ref_losses)
                                     / np.abs(ref_losses).clip(1e-12))),
        "grad_rel_fro_max": float(ge.max()),
        "grad_rel_fro_median": float(np.median(ge)), **extra}))


def tracker_draws(key, pool_len: int, pixels: int, iters: int,
                  stages: int):
    """The reference track_frame's pixel draws in its order: per stage
    (k_mid, k_fine = split(key)) and sub-stage s with iterations,
    randint(fold_in(k, s), (pixels,), 0, pool_len)."""
    out = []
    iters_mid = int(iters * 0.5)
    for k, it in zip(jax.random.split(key), (iters_mid, iters - iters_mid)):
        for s in range(stages):
            if it // stages + (1 if s < it % stages else 0):
                out.append(np.asarray(jax.random.randint(
                    jax.random.fold_in(k, s), (pixels,), 0, pool_len)))
    return out


class ColourTerms:
    """Stands in for tracker.py's ``torch`` during a tracked frame: each
    loss evaluation's colour residuals (c_gt - colour, (n, 3)) within
    COLOR_KINK_ATOL of zero, each with its gradient on the optimised
    leaves, taken before the step's backward frees the graph (the leaves
    from ops.optim.tree_leaves, which the tracker calls on them first).
    Everything else is torch's."""

    def __init__(self, w_color: float):
        self.w_color = w_color
        self.leaves = []
        self.near = []      # [(residual, rows, gradient per leaf)]

    def __getattr__(self, name):
        return getattr(torch, name)

    def tree_leaves(self, tree):
        self.leaves = TREE_LEAVES(tree)
        return self.leaves

    def abs(self, x, *args, **kwargs):
        if x.dim() == 2 and x.shape[1] == 3 and x.requires_grad:
            self.near = []
            groups: dict = {}
            xd = x.detach()
            for p, c in torch.nonzero(xd.abs() < COLOR_KINK_ATOL):
                # a pixel drawn several times: rows with the same residual
                groups.setdefault((int(c), float(xd[p, c])), []).append(
                    int(p))
            for (c, r), rows in groups.items():
                g = torch.autograd.grad(x[rows[0], c], self.leaves,
                                        retain_graph=True, allow_unused=True)
                self.near.append((r, rows, [
                    np.zeros(tuple(t.shape)) if d is None
                    else d.numpy().astype(np.float64)
                    for t, d in zip(self.leaves, g)]))
        return torch.abs(x, *args, **kwargs)

    def kink_pixel(self, grads, ref_g):
        """The colour term (residual, rows) whose sign, taken the other way,
        explains the port's gradient's difference from the reference's:
        the difference along that term's gradient v within KINK_FIT_RTOL,
        and its size 2 w_color v times a count of the pixel's draws within
        KINK_FIT_RTOL.  Returns (residual, rows, the gradient with the
        reference's sign of the term) or None."""
        g = [np.zeros_like(np.asarray(_get(ref_g, path), np.float64))
             if t is None else t.numpy().astype(np.float64)
             for path, t in _leaves(grads)]
        d = np.concatenate([(a - np.asarray(_get(ref_g, path))).ravel()
                            for a, (path, _t) in zip(g, _leaves(grads))])
        for r, rows, v in self.near:
            vf = np.concatenate([a.ravel() for a in v])
            if not vf.any():
                continue
            alpha = float(d @ vf / (vf @ vf))
            draws = abs(alpha) / (2 * self.w_color)
            m = round(draws)
            if not (1 <= m <= len(rows)
                    and abs(draws - m) <= KINK_FIT_RTOL * m
                    and np.linalg.norm(d - alpha * vf)
                    <= KINK_FIT_RTOL * np.linalg.norm(d)):
                continue
            flip = np.sign(alpha) * 2 * self.w_color * m
            return r, rows, tOpt.tree_unflatten(
                grads, [torch.as_tensor(a - flip * b, dtype=torch.float32)
                        for a, b in zip(g, v)])
        return None


@pytest.mark.parametrize("idx", TRACKED)
def test_tracking_in_lockstep(reference, port, idx):
    check_tracking(reference, port, idx)


def check_tracking(reference, port, idx):
    """Frame idx tracked by the port from the reference's state on the
    reference's draws: cam_init and the pool bit for bit; at every
    iteration the loss within LOSS_RTOL and the stepped pose within
    POSE_ATOL of the reference's; the best pose within POSE_ATOL."""
    rec = reference["tracks"][idx]
    t = reference["cfg"]["tracking"]
    slam = port
    expo = _load_state(slam, rec)
    slam.estimate_c2w_list[:] = rec["est"]
    frame = _frame(slam, rec, idx)
    np.testing.assert_array_equal(frame.c2w, rec["gt_c2w"])
    draws = iter(tracker_draws(rec["key"], len(rec["pool"]), t["pixels"],
                               t["iters"], t["resample_stages"]))

    pose_diffs = []

    def check(label, tree, ref_tree):
        for path, a in _leaves(tree):
            pose_diffs.append(float(np.abs(a.numpy()
                                           - _get(ref_tree, path)).max()))
            _close(f"frame {idx} {label} {path}", a.numpy(),
                   _get(ref_tree, path), 0, POSE_ATOL)

    terms = ColourTerms(t["w_color_loss"])
    kinks = []

    def own_step(label, new_p, ref_new, ref_g, grads):
        """The port's own pose step; where it parts, a pixel's colour term
        at the L1 kink (kink_pixel) may explain it: then the step on the
        gradient with that term's sign as the reference's is held."""
        n = len(pose_diffs)
        try:
            check(label, new_p, ref_new)
        except AssertionError:
            kink = terms.kink_pixel(grads, ref_g)
            if kink is None:
                raise
            del pose_diffs[n:]
            kinks.append({"step": replay.n_steps - 1, "residual": kink[0],
                          "draws": len(kink[1])})
            check(f"{label} (kink pixel)", replay.restep(kink[2]), ref_new)

    replay = Replay(rec["steps"], lambda tree: tree, check, own_step)
    replay.randint_rules.append(
        (lambda high, size: high == len(rec["pool"])
         and size == (t["pixels"],), lambda high, size: next(draws)))
    got: dict = {}
    recall = []

    def knn(query, *index, k=8, probe=16, **kwargs):
        recall.append(search_recall(query, *index, k, probe))
        return KNN(query, *index, k=k, probe=probe, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        replay.install(mp)
        mp.setattr(tK, "knn_tiles", knn)
        mp.setattr(tT, "track_frame",
                   _record(got, "track_frame", tT.track_frame))
        mp.setattr(tT, "torch", terms)
        mp.setattr(tOpt, "tree_leaves", terms.tree_leaves)
        c2w, _info, _op = slam.tracker.track(
            idx, frame, slam.npc, slam.params, expo, slam.estimate_c2w_list,
            frame.c2w)
    assert len(kinks) <= MAX_KINK_STEPS, kinks
    assert next(draws, None) is None, "draws left over"
    assert replay.n_steps == len(rec["steps"]) == t["iters"]
    (call,) = got["track_frame"]
    np.testing.assert_array_equal(call["args"][3].numpy(), rec["cam_init"])
    np.testing.assert_array_equal(
        call["args"][9].numpy()[:call["args"][10]], rec["pool"])
    best_cam, _best, losses, _ = call["out"]
    _close(f"frame {idx} losses", losses.numpy(), rec["losses"], LOSS_RTOL)
    _close(f"frame {idx} best pose", best_cam.numpy(), rec["best_cam"], 0,
           POSE_ATOL)
    _close(f"frame {idx} c2w", c2w, rec["c2w"], 0, POSE_ATOL)
    assert tile_shapes(slam.npc) == rec["tiles"], \
        f"frame {idx} tile index {tile_shapes(slam.npc)} {rec['tiles']}"
    own, ref = np.mean(recall, axis=0)
    report("track", idx, losses.numpy(), rec["losses"], replay,
           pose_abs_max=max(pose_diffs), search_recall_port=own,
           search_recall_reference_tiles=ref, kink_pixels=kinks)


def test_free_running_parts_as_the_reference_from_itself(reference, port):
    """Why the lockstep follows the reference's Adam steps: each tracked
    frame tracked free running by the port (the reference's state, draws
    and tile choices, its own Adam steps) against the reference's run, and
    the reference's run with its start pose nudged one unit in the last
    place (nudged_track) against the same run.  The nudge parts the
    reference from itself beyond LOSS_RTOL and POSE_ATOL, and the port parts
    from the reference by at most FREE_RUN_FACTOR times as far (largest
    relative loss difference over the iterations, largest difference of the
    best pose, each over the frames).  Run with -s, each frame prints one
    JSON line."""
    t = reference["cfg"]["tracking"]
    slam = port
    worst = {"nudge_loss": 0.0, "nudge_pose": 0.0, "port_loss": 0.0,
             "port_pose": 0.0}
    for idx in TRACKED:
        rec = reference["tracks"][idx]
        expo = _load_state(slam, rec)
        slam.estimate_c2w_list[:] = rec["est"]
        frame = _frame(slam, rec, idx)
        draws = iter(tracker_draws(rec["key"], len(rec["pool"]), t["pixels"],
                                   t["iters"], t["resample_stages"]))
        replay = Replay([], None, None, None)
        replay.randint_rules.append(
            (lambda high, size: high == len(rec["pool"])
             and size == (t["pixels"],), lambda high, size: next(draws)))
        got: dict = {}
        with pytest.MonkeyPatch.context() as mp:
            replay.install(mp, adam=False)
            mp.setattr(tT, "track_frame",
                       _record(got, "track_frame", tT.track_frame))
            slam.tracker.track(idx, frame, slam.npc, slam.params, expo,
                               slam.estimate_c2w_list, frame.c2w)
        (call,) = got["track_frame"]
        best_cam, _best, losses, _ = call["out"]
        rel = lambda a: float(np.max(np.abs(a - rec["losses"])
                                     / np.abs(rec["losses"]).clip(1e-12)))
        line = {"nudge_loss": rel(rec["nudged"]["losses"]),
                "nudge_pose": float(np.abs(rec["nudged"]["best_cam"]
                                           - rec["best_cam"]).max()),
                "port_loss": rel(losses.numpy()),
                "port_pose": float(np.abs(best_cam.numpy()
                                          - rec["best_cam"]).max())}
        print(json.dumps({"free_running": "track", "frame": idx, **line}))
        worst = {k: max(v, line[k]) for k, v in worst.items()}
    assert worst["nudge_loss"] > LOSS_RTOL, worst
    assert worst["nudge_pose"] > POSE_ATOL, worst
    assert worst["port_loss"] <= FREE_RUN_FACTOR * worst["nudge_loss"], worst
    assert worst["port_pose"] <= FREE_RUN_FACTOR * worst["nudge_pose"], worst


# --------------------------------------------------------------------------
# mapping


def knn_agrees(D, I, ref_D, ref_I):
    """A neighbour search against the reference's on the same queries and
    tiles: the distances within KNN_RTOL (the reference's XLA fuses the
    squared differences' sum into multiply-adds), the ids before the k-th
    equal on rows without tied distances; elsewhere every id that either
    side finds nearer than the row's farthest distance, less a band of
    2 KNN_RTOL, kept by the other side too (tied neighbours may be
    ordered, or at the k-th place chosen, apart, and a neighbour within
    the band of the k-th may fall either side of it)."""
    _close("neighbour distances", D, ref_D, KNN_RTOL)
    close = np.isclose(ref_D[:, 1:], ref_D[:, :-1], rtol=KNN_RTOL, atol=0)
    tied = close.any(1)
    np.testing.assert_array_equal(I[~tied, :-1], ref_I[~tied, :-1])
    for r in np.flatnonzero(tied):
        far = ref_D[r, -1] * (1 - 2 * KNN_RTOL)
        assert set(I[r][D[r] < far]) <= set(ref_I[r]), r
        assert set(ref_I[r][ref_D[r] < far]) <= set(I[r]), r


def union_cache_agrees(own, ref):
    """The port's union cache against the reference's on the same pixel
    draws: the pixels and the samples' neighbour masks equal, the phase
    constants within CONST_ATOL (rays_d through another summation order),
    and each pixel's union the same up to ties: where its ids are the
    reference's, the weights within FEAT_ATOL; elsewhere the ids both keep
    with the same weight column (Wm[:, j] over the S samples), the slots'
    scores (column sums) the same multiset, and an id that only one keeps
    scored at the union's lowest score, a tie at the u-th slot.  Tied union
    scores (neighbours at equal distances) round apart in the two
    packages' sums, which then order them, or choose among them at the
    u-th slot, differently."""
    pix, uids, Wm, pm, const = own
    np.testing.assert_array_equal(pix.numpy(), ref[0])
    np.testing.assert_array_equal(pm.numpy(), ref[3])
    for k, v in const.items():
        _close(f"cache {k}", v.numpy(), ref[4][k], 0, CONST_ATOL)
    S, u = Wm.shape[-2:]
    ua, ub = uids.numpy().reshape(-1, u), ref[1].reshape(-1, u)
    wa = np.moveaxis(Wm.numpy().reshape(-1, S, u), 1, 2)     # (R, u, S)
    wb = np.moveaxis(ref[2].reshape(-1, S, u), 1, 2)
    same = (ua == ub).all(1)
    _close("union weights", wa[same], wb[same], 0, FEAT_ATOL)
    for r in np.flatnonzero(~same):
        cols_a = dict(zip(ua[r], wa[r]))
        cols_b = dict(zip(ub[r], wb[r]))
        for i in set(cols_a) & set(cols_b):
            _close(f"cache pixel {r} slot {i}", cols_a[i], cols_b[i], 0,
                   FEAT_ATOL)
        sums_a, sums_b = wa[r].sum(1), wb[r].sum(1)
        _close(f"cache pixel {r} union scores", np.sort(sums_a),
               np.sort(sums_b), 0, FEAT_ATOL)
        floor = min(sums_a.min(), sums_b.min())
        for i in set(cols_a) ^ set(cols_b):
            w = cols_a[i] if i in cols_a else cols_b[i]
            assert abs(w.sum() - floor) <= FEAT_ATOL, \
                f"cache pixel {r}: union slot {i} above the tie"


def inserted_agrees(npc, ref_levels):
    """The port's levels after the insertion against the reference's: the
    counts equal, the positions bit for bit, the features within FEAT_ATOL
    (the reference's 0.1 * normal is fused by XLA into the normal's last
    step, a bit apart from 0.1 times the same normal); then the
    reference's feature bits in their place, so that the optimisation
    starts from the reference's state."""
    for name, ref in ref_levels.items():
        lv = npc.levels[name]
        n = ref["count"]
        assert lv.count == n, (name, lv.count, n)
        np.testing.assert_array_equal(lv.pos[:n].numpy(), ref["pos"][:n])
        for k in ("geo", "col"):
            _close(f"inserted {name}.{k}", getattr(lv, k)[:n].numpy(),
                   ref[k][:n], 0, FEAT_ATOL)
            getattr(lv, k)[:n] = torch.as_tensor(ref[k][:n])


def projection_rounded_once(x, B):
    """The Fourier projection (2 pi x) @ B in float64, rounded once to f32:
    another rounding of the same projection."""
    return torch.matmul(x.double() * (2.0 * math.pi), B.double()).float()


def projection_witness(stage_call, params, grads, ref_g, key) -> dict:
    """Whether the Fourier projection's rounding sets the gradient leaf
    ``key`` as far as the port parts from the reference there: the step's
    gradient taken again by the port's own stage loss (stage_call, the
    last (stage_loss, fid, slot, with_color) of mapper.optimise) at the
    step's parameters with the projection rounded once
    (projection_rounded_once) instead of in the port's fixed order.  The
    projection reaches 1e3 radians (a unit in the last place there is
    6e-5 rad), and the reference's XLA rounds it as its dot rounds.  A
    witness where the rounding moves the leaf by at least 1 /
    FREE_RUN_FACTOR of the port's part from the reference."""
    stage_loss, fid, slot, with_color = stage_call
    op = tOpt.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = TREE_LEAVES(op)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tDec, "fourier_proj", projection_rounded_once)
        mp.setattr(tFM, "fourier_proj", projection_rounded_once)
        total = stage_loss(op, fid, slot, with_color)[0]
    alt = tOpt.tree_unflatten(op, torch.autograd.grad(total, leaves,
                                                      allow_unused=True))

    def leaf(tree):
        for path, g in _leaves(tree):
            if g is None:
                continue
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            for label, a in _grad_groups(path, g):
                if label == key:
                    return a.astype(np.float64)
        raise KeyError(key)

    g, g_ref, g_alt = leaf(grads), leaf(ref_g), leaf(alt)
    part = float(np.linalg.norm(g - g_ref))
    moved = float(np.linalg.norm(g_alt - g))
    return {"leaf": key, "part": part, "rounding_moves": moved,
            "witness": moved * FREE_RUN_FACTOR >= part}


def mapper_replay(rec, check, npc, own_step) -> Replay:
    """The reference Mapper.map's draws in the port's order: per level
    phase (mid = 0, fine = 1) the cache's pixel draws (split(key, 4)[2 +
    phase] split over the window's F frames, randint(k_f, (P,), 0, int32
    max)), then each iteration's ray slots (split(key, 4)[phase] split over
    the phase's iterations, randint(k_it, (n_rays,), 0, P)); and the new
    points' features (per insertion call the point cloud's next key
    fold_in(PRNGKey(seed + 1), counter), kg, kc = split(key), normal(kg |
    kc, (B * n_add, C))).  The Adam steps' trees: the reference's flat
    decoder vector unravelled into the port's {'dec': {name: tree}}."""
    keys4 = jax.random.split(rec["key"], 4)
    scans = rec["scans"]
    state = {"phase": -1, "slot_keys": None, "npc": rec["npc_keys"],
             "kc": None}

    def cache(high, size):
        state["phase"] += 1
        scan = scans[state["phase"]]
        ph = {"mid": 0, "fine": 1}[scan["level"]]
        state["slot_keys"] = iter(jax.random.split(keys4[ph],
                                                   scan["losses"].shape[0]))
        F, P = size
        return np.stack([np.asarray(jax.random.randint(k, (P,), 0,
                                                       INT32_MAX))
                         for k in jax.random.split(keys4[2 + ph], F)])

    def slot(high, size):
        state["slot"] = np.asarray(jax.random.randint(
            next(state["slot_keys"]), size, 0, high))
        return state["slot"]

    base = jax.random.PRNGKey(rec["seed"] + 1)

    def feats(size):
        B, n_add, C = size
        if state["kc"] is None:
            state["npc"] += 1
            k, state["kc"] = jax.random.split(
                jax.random.fold_in(base, state["npc"]))
        else:
            k, state["kc"] = state["kc"], None
        return np.asarray(jax.random.normal(k, (B * n_add, C))).reshape(
            B, n_add, C)

    def nested(tree):
        out = {k: v for k, v in tree.items() if k != "dec_flat"}
        if "dec_flat" in tree:
            name = f"col_{scans[state['phase']]['level']}"
            _flat, unravel = ravel_pytree({name: rec["params"][name]})
            out["dec"] = unravel(jnp.asarray(tree["dec_flat"]))
        return out

    def samples(idx, depths, c2ws, S, W, *args, **kwargs):
        """The port's cache samples within CONST_ATOL of the reference's,
        then the reference's in their place (a neighbour at the radius
        would otherwise fall in or out with the last bit of rays_d)."""
        jj, ii, d, rays_d, z, pts = SAMPLES(idx, depths, c2ws, S, W, *args,
                                            **kwargs)
        const = rec["caches"][state["phase"]][4]
        F, P = idx.shape
        ref = (const["rays_d"].reshape(F, P, 3), const["z"].reshape(F, P, S),
               const["pts"].reshape(F, P, S, 3))
        for name, a, b in zip(("rays_d", "z", "pts"), (rays_d, z, pts), ref):
            _close(f"cache samples {name}", a.numpy(), b, 0, CONST_ATOL)
        return (jj, ii, d) + tuple(torch.as_tensor(a) for a in ref)

    def knn(query, *index, **kwargs):
        """The port's search of the cache's samples against the
        reference's (knn_agrees), then the reference's neighbours in its
        place: the radius test and the union then see the same
        distances."""
        D, I = KNN(query, *index, **kwargs)
        ref_D, ref_I = rec["cache_knn"][state["phase"]]
        knn_agrees(D.numpy(), I.numpy(), ref_D, ref_I)
        return torch.as_tensor(ref_D), torch.as_tensor(ref_I,
                                                       dtype=torch.int64)

    def union_cache(*args, **kwargs):
        """The port's own cache, held against the reference's (union_
        cache_agrees), then the reference's in its place."""
        if state["phase"] < 0:          # the first level's cache
            inserted_agrees(npc, rec["inserted"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tK, "knn_tiles", knn)
            own = UNION_CACHE(*args, **kwargs)
        ref = rec["caches"][state["phase"]]
        union_cache_agrees(own, ref)
        return (torch.as_tensor(ref[0], dtype=torch.int64),
                torch.as_tensor(ref[1], dtype=torch.int64),
                torch.as_tensor(ref[2]), torch.as_tensor(ref[3]),
                {k: torch.as_tensor(v) for k, v in ref[4].items()})

    replay = Replay(rec["steps"], nested, check, own_step)
    replay.union_cache = union_cache
    replay.samples = samples
    replay.randint_rules += [
        (lambda high, size: high == 2 ** 31 - 1 and len(size) == 2, cache),
        (lambda high, size: len(size) == 1, slot)]
    replay.randn_rule = feats
    replay.state = state
    return replay


def _load_mapper(slam, rec):
    """The reference's keyframe registry, last mapped pose and numpy
    stream into the port's mapper."""
    m = slam.mapper
    m.keyframe_list = list(rec["keyframe_list"])
    m.keyframe_dict = []
    for kf in rec["keyframes"]:
        i = int(kf["idx"])
        fr = slam.frame_reader[i]
        _r_add, r_query = slam.tracker.prepare_radii(fr.color)
        m.keyframe_dict.append(m.keyframe_entry(
            i, fr, kf["est_c2w"], kf["gt_c2w"], r_query,
            kf["exposure_feat"]))
    m.prev_c2w = rec["prev_c2w"]
    m.rng.bit_generator.state = copy.deepcopy(rec["rng_in"])


@pytest.mark.parametrize("idx", MAPPED)
def test_mapping_in_lockstep(reference, port, idx):
    check_mapping(reference, port, idx)


def check_mapping(reference, port, idx):
    """Frame idx mapped by the port from the reference's state on the
    reference's draws: the numpy stream in step, the window and point
    counts equal, new positions bit for bit; at every iteration both losses
    within LOSS_RTOL, the gradient as a whole and leaf by leaf, and the
    port's own step (own_step) as the module's docstring sets out; the
    returned levels, decoders and exposure latent (the hand-back) within
    FEAT_RTOL / FEAT_ATOL of the reference's."""
    rec = reference["maps"][idx]
    slam = port
    if idx == MAPPED[0]:
        # both packages seed the mapper's numpy stream alike
        assert slam.mapper.rng.bit_generator.state == rec["rng_in"]
    expo = _load_state(slam, rec)
    _load_mapper(slam, rec)
    frame = _frame(slam, rec, idx)

    def check(label, tree, ref_tree):
        for path, a in _leaves(tree):
            _close(f"frame {idx} {label} {path}", a.numpy(),
                   _get(ref_tree, path), FEAT_RTOL, FEAT_ATOL)

    got: dict = {}
    held, leaf_errors, kinks, kink_parts = [], [], [], []
    rounding = []       # steps whose decoder step projection_witness explains

    def kink_ray(grads, ref_g):
        """The feature rows of the one ray (its union) that holds every
        row whose colour-feature gradient parts from the reference's by
        more than OWN_STEP_GRAD_SHARE of the leaf's largest, where one ray
        holds them all: a ray at the kink of the L1 colour loss, its
        residual within rounding of zero and its cotangent's sign either
        way.  None where no row parts, or they span several rays."""
        g = grads["feat"].numpy()
        gr = np.asarray(ref_g["feat"])
        C = gr.shape[1] // 2
        big = np.abs(gr[:, C:]).max()
        rows = np.flatnonzero(np.abs(g[:, C:] - gr[:, C:]).max(1)
                              > OWN_STEP_GRAD_SHARE * big)
        if not len(rows):
            return None
        args = got["map_scan"][-1]["args"]      # the running level phase
        P, packed, u_sz, F_actual = (args[7].shape[1], args[8], args[9],
                                     args[12])
        o = tFM.row_offsets(args[2].N_surface, u_sz)
        slot = replay.state["slot"]
        cache_rows = packed[torch.as_tensor(
            np.arange(len(slot)) % F_actual * P + slot)]
        uids = tK.unpack_ids(cache_rows[:, o["uids"]:o["uids"] + u_sz])
        for ray_rows in uids.numpy():
            if set(rows) <= set(ray_rows):
                return ray_rows
        return None

    def own_step(label, new_p, ref_new, ref_g, grads):
        """Per step: the gradient leaf by leaf (grad_leaf_errors, a kink
        ray's rows and the decoder and exposure leaves aside at its step),
        and the port's own Adam step on its own gradient, from the
        reference's parameters and moments: every leaf held there but the
        geometry features within FEAT_RTOL / FEAT_ATOL of the reference's
        step where the reference's gradient is at least
        OWN_STEP_GRAD_SHARE of the leaf's largest."""
        rows = kink_ray(grads, ref_g)
        kinks.append(rows is not None)
        leaf_errors.append(grad_leaf_errors(grads, ref_g, rows))
        if rows is not None:            # reported: what the kink parts
            whole = grad_leaf_errors(grads, ref_g)
            g, gr = grads["feat"].numpy()[rows], np.asarray(ref_g["feat"])[
                rows]
            kink_parts.append({
                "rows": float(np.linalg.norm(g - gr) / np.linalg.norm(gr)),
                "decoder": max(v for k, v in whole.items()
                               if k.startswith("dec."))})
        n = n_all = 0
        for path, a in _leaves(new_p):
            for (key, a), (_, b), (_, g) in zip(
                    _grad_groups(path, a.numpy()),
                    _grad_groups(path, _get(ref_new, path)),
                    _grad_groups(path, np.abs(_get(ref_g, path)))):
                if key not in leaf_errors[-1] or key == "feat.geo":
                    continue
                mask = g >= OWN_STEP_GRAD_SHARE * g.max()
                if rows is not None and key == "feat.col":
                    mask[rows] = False
                try:
                    _close(f"frame {idx} {label} own {key}", a[mask],
                           b[mask], FEAT_RTOL, FEAT_ATOL)
                except AssertionError:
                    if not key.startswith("dec."):
                        raise
                    w = projection_witness(got["stage"], replay.step_params,
                                           grads, ref_g, key)
                    if not w["witness"]:
                        raise
                    rounding.append(dict(w, step=len(held)))
                    continue
                n, n_all = n + int(mask.sum()), n_all + mask.size
        held.append(n / n_all)

    def optimise(stage_loss, *args, **kwargs):
        """mapper.optimise, keeping the last stage-loss call's arguments
        (projection_witness)."""
        def keep(op, fid, slot, with_color):
            got["stage"] = (stage_loss, fid, slot, with_color)
            return stage_loss(op, fid, slot, with_color)
        return OPTIMISE(keep, *args, **kwargs)

    replay = mapper_replay(rec, check, slam.npc, own_step)
    overlap: list = []
    with pytest.MonkeyPatch.context() as mp:
        replay.install(mp)
        mp.setattr(tM, "map_scan", _record(got, "map_scan", tM.map_scan))
        mp.setattr(tM, "optimise", optimise)
        mp.setattr(tM, "sorted", overlap_scores(overlap.append),
                   raising=False)
        params, expo_out, info = slam.mapper.map(
            idx, frame, slam.npc, slam.params, expo, rec["c2w"])
    assert slam.mapper.rng.bit_generator.state == rec["rng_out"], \
        "the mapper's numpy stream left step"
    # the keyframes' overlap scores, exactly (host float64 in both)
    assert overlap == (rec["overlap"] or []), (overlap, rec["overlap"])
    assert replay.state["npc"] == rec["npc_keys_out"], \
        "insertion calls differ in number"
    assert replay.n_steps == len(rec["steps"])
    for k in ("window", "frame_pts_add", "n_joint_iters"):
        assert info[k] == rec["info"][k], k
    for name, lv_ref in rec["levels_out"].items():
        lv = slam.npc.levels[name]
        n0, n1 = rec["levels"][name]["count"], lv_ref["count"]
        assert lv.count == n1, (name, lv.count, n1)
        assert lv.capacity == lv_ref["capacity"], \
            (name, lv.capacity, lv_ref["capacity"])
        np.testing.assert_array_equal(lv.pos[n0:n1].numpy(),
                                      lv_ref["pos"][n0:n1],
                                      err_msg=f"frame {idx} {name} new pos")
        for k in ("geo", "col"):
            _close(f"frame {idx} {name}.{k}", getattr(lv, k)[:n1].numpy(),
                   lv_ref[k][:n1], FEAT_RTOL, FEAT_ATOL)
    assert tile_shapes(slam.npc) == rec["tiles"], \
        f"frame {idx} tile index {tile_shapes(slam.npc)} {rec['tiles']}"
    scans = got["map_scan"]
    assert [c["args"][13] for c in scans] == [s["level"] for s in
                                              rec["scans"]]
    for call, ref in zip(scans, rec["scans"]):
        _close(f"frame {idx} {ref['level']} losses", call["out"][2].numpy(),
               ref["losses"], LOSS_RTOL)
    ge = np.asarray(replay.grad_errors)
    assert ge.max() <= GRAD_REL_FRO_MAX, ge.max()
    assert np.median(ge) <= GRAD_REL_FRO_MEDIAN, np.median(ge)
    for i, errs in enumerate(leaf_errors):
        for key, e in errs.items():
            limit = GEO_FEAT_GRAD_MAX if key == "feat.geo" else GRAD_LEAF_MAX
            assert e <= limit, f"frame {idx} step {i} gradient {key}: {e}"
    geo = np.median([e["feat.geo"] for e in leaf_errors])
    assert geo <= GEO_FEAT_GRAD_MEDIAN, geo
    assert sum(kinks) <= MAX_KINK_STEPS, kinks
    assert len({r["step"] for r in rounding}) <= MAX_ROUNDING_STEPS, rounding
    # the hand-back: the final step's parameters (the reference's, handed
    # over) scattered back into the levels and returned
    port_params = convert.params_to_numpy(params)
    for path, a in _leaves(rec["params_out"]):
        _close(f"frame {idx} decoder {path}", _get(port_params, path), a,
               FEAT_RTOL, FEAT_ATOL)
    _close(f"frame {idx} exposure", expo_out, rec["expo_out"], FEAT_RTOL,
           FEAT_ATOL)
    losses = np.concatenate([c["out"][2].numpy() for c in scans])
    ref_losses = np.concatenate([s["losses"] for s in rec["scans"]])
    nz = ref_losses != 0
    group = lambda key: "dec" if key.startswith("dec.") else key
    leaf_max: dict = {}
    for errs in leaf_errors:
        for key, e in errs.items():
            leaf_max[group(key)] = max(leaf_max.get(group(key), 0.0), e)
    report("map", idx, losses[nz], ref_losses[nz], replay,
           grad_leaf_max=leaf_max, feat_geo_grad_median=float(geo),
           own_step_held_min=min(held),
           kink_steps=[i for i, k in enumerate(kinks) if k],
           kink_parts=kink_parts, projection_rounding=rounding)


# --------------------------------------------------------------------------
# the tracker's host helpers, bit for bit


def _trackers(tmp_path, **tracking):
    """Both packages' Tracker on tiny_cfg with the given tracking keys."""
    cfg = tiny_cfg(tmp_path)
    cfg["tracking"].update(tracking)
    return (jT.Tracker(cfg, None),
            tT.Tracker(cfg, SimpleNamespace(device=torch.device("cpu"))))


def _frame_arrays(seed: int, H: int = 48, W: int = 64):
    """A colour image with texture and a depth map with holes and a far
    region, from a seed."""
    g = np.random.default_rng(seed)
    color = g.uniform(0, 1, (H, W, 3)).astype(np.float32)
    color[:, : W // 2] = 0.5                     # a texture-poor half
    depth = g.uniform(0.5, 6.0, (H, W)).astype(np.float32)
    depth[g.uniform(size=(H, W)) < 0.1] = 0.0
    return color, depth


def _pose(angle: float, t=(0.0, 0.0, 0.0)) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    p[:3, 3] = t
    return p


@pytest.mark.parametrize("const_speed", [True, False])
def test_initial_pose_matches_reference(tmp_path, const_speed):
    """Tracker.initial_pose (the constant-speed motion model, or the last
    pose) in both packages, bit for bit, at the first frames and later."""
    jt, tt = _trackers(tmp_path, const_speed_assumption=const_speed)
    g = np.random.default_rng(3)
    est = np.stack([_pose(a, g.uniform(-1, 1, 3))
                    for a in g.uniform(-3, 3, 6)]).astype(np.float32)
    for idx in range(1, 6):
        np.testing.assert_array_equal(tt.initial_pose(idx, est),
                                      jt.initial_pose(idx, est))


@pytest.mark.parametrize("color_grad,depth_limit", [
    (False, False), (False, True), (True, False), (True, True)])
def test_build_pool_matches_reference(tmp_path, color_grad, depth_limit):
    """Tracker.build_pool in both branches (valid_pixel_pool, and
    top_grad_index_pool under sample_with_color_grad), with and without
    the depth limit, bit for bit."""
    jt, tt = _trackers(tmp_path, sample_with_color_grad=color_grad,
                       depth_limit=depth_limit, ignore_edge_W=5,
                       ignore_edge_H=4)
    for seed in range(3):
        color, depth = _frame_arrays(seed)
        a, b = tt.build_pool(color, depth), jt.build_pool(color, depth)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_prepare_radii_matches_reference(tmp_path):
    """Tracker.prepare_radii (the per-level dynamic add and query radii
    from the colour gradient) in both packages, bit for bit."""
    jt, tt = _trackers(tmp_path)
    for seed in range(3):
        color, _depth = _frame_arrays(seed)
        (ra, qa), (rb, qb) = tt.prepare_radii(color), jt.prepare_radii(color)
        assert set(ra) == set(rb) == set(qa) == set(qb)
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k])
            np.testing.assert_array_equal(qa[k], qb[k])


class _Stop(Exception):
    pass


@pytest.mark.parametrize("gt_angle,flips", [(3.1, False), (-3.1, True),
                                            (0.3, False)],
                         ids=["same-sign", "flipped", "small"])
def test_quaternion_sign_gauge_matches_reference(tmp_path, monkeypatch,
                                                 gt_angle, flips):
    """Tracker.track's initial camera tensor, whose quaternion takes the
    ground truth's sign (flipped where their dot product is negative), in
    both packages, bit for bit: the poses turn about z by 3.1 rad, and the
    ground truth by 3.1, -3.1 (across pi, whose quaternion has the other
    sign) or 0.3 rad.  Both stop at their track_frame call."""
    from hpslam_tpu.models import decoder as jDec
    from hpslam_tpu.state import NeuralPointCloud as JCloud
    from hpslam_tpu.utils.datasets import Frame as JFrame
    from hpslam_tpu_torch.models import decoder as tDec
    from hpslam_tpu_torch.state import NeuralPointCloud as TCloud
    from hpslam_tpu_torch.utils.datasets import Frame as TFrame
    cfg = tiny_cfg(tmp_path)
    cams = {}

    def stop(name):
        def track_frame(params, mcfg, rcfg, cam_init, *args, **kwargs):
            cams[name] = np.array(cam_init)
            raise _Stop
        return track_frame

    monkeypatch.setattr(jT, "track_frame", stop("reference"))
    monkeypatch.setattr(tT, "track_frame", stop("port"))
    intr = dict(fx=40.0, fy=40.0, cx=31.5, cy=23.5)
    jt = jT.Tracker(cfg, SimpleNamespace(mcfg=jDec.ModelConfig.from_cfg(cfg),
                                         **intr))
    tt = tT.Tracker(cfg, SimpleNamespace(
        mcfg=tDec.ModelConfig.from_cfg(cfg), device=torch.device("cpu"),
        **intr))
    color, depth = _frame_arrays(0)
    est = np.stack([_pose(3.1, (0.1 * i, 0, 0)) for i in range(4)])
    gt = _pose(gt_angle, (0.3, 0, 0))
    expo = np.zeros(8, np.float32)
    with pytest.raises(_Stop):
        jt.track(3, JFrame(3, color, depth, gt), JCloud(cfg), {}, expo,
                 jax.random.PRNGKey(0), est, gt)
    with pytest.raises(_Stop):
        tt.track(3, TFrame(3, color, depth, gt), TCloud(cfg, "cpu"), {},
                 expo, est, gt)
    np.testing.assert_array_equal(cams["port"], cams["reference"])
    gt_q = jT.G.get_tensor_from_camera_np(gt)[:4]
    q0 = jT.G.get_tensor_from_camera_np(jt.initial_pose(3, est))[:4]
    assert (float(np.dot(q0, gt_q)) < 0) == flips
    assert float(np.dot(cams["port"][:4], gt_q)) >= 0


def test_tile_selection_differs_only_on_ties():
    """ops.knn.select_tiles against the reference's _select_tiles below
    NARROW_MIN_TILES tiles (where both select exactly): on bounds without
    ties the same tiles in the same order; on bounds with ties (tiles whose
    boxes share a face give equal bounds) the same multiset of bounds, the
    tiles chosen among equal bounds apart (the port takes the first of a
    tie, XLA's approx_min_k on the CPU the order of an unstable sort)."""
    g = np.random.default_rng(0)
    for T, probe in ((64, 12), (200, 16), (511, 32)):
        lb = g.uniform(0, 1, (256, T)).astype(np.float32)
        a = tK.select_tiles(torch.as_tensor(lb), probe).numpy()
        b = np.asarray(jK._select_tiles(jnp.asarray(lb), probe))
        np.testing.assert_array_equal(a, b)
        lb = g.integers(0, 6, (256, T)).astype(np.float32)
        a = tK.select_tiles(torch.as_tensor(lb), probe).numpy()
        b = np.asarray(jK._select_tiles(jnp.asarray(lb), probe))
        np.testing.assert_array_equal(
            np.sort(np.take_along_axis(lb, a, 1), 1),
            np.sort(np.take_along_axis(lb, b, 1), 1))
        for r in range(lb.shape[0]):
            assert len(set(a[r])) == probe
