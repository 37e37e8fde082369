"""The port's benchmark workload (hpslam_tpu_torch/bench.py) against the
repository's bench.py and the reference's engines, on the CPU at small
sizes.

build_state draws bench.py's arrays bit for bit.  One level of the
mapping pass (union cache, count, compaction, packing, map_scan, the
scatter-back) matches the same composition written with hpslam_tpu's
functions as bench.py writes it, on the same weights (the reference's,
carried across), cache pixels and ray slots (the reference's own draws):
the cache's pixels and union ids exactly, the losses, feature tables and
colour decoder at the mesh-equivalence tolerances of
tests/test_torch_parallel.py (all but CROSS_IMPL_FRAC of the entries);
rows outside the compacted set keep their bits.  The tracked frame
matches track_frame with bench.py's arguments at the tolerances of
test_track_frame_mm_bf16_matches_reference.  The entry point prints one
JSON line with bench.py's keys.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from hpslam_tpu import mapper as jM
from hpslam_tpu import renderer as jR
from hpslam_tpu import tracker as jT
from hpslam_tpu.models import decoder as jDec
from hpslam_tpu.ops import knn as jK
from hpslam_tpu.ops import optim as jOpt
from hpslam_tpu_torch import bench as B
from hpslam_tpu_torch import convert
from hpslam_tpu_torch.ops import optim as tOpt
from tests.test_torch_parallel import CROSS_IMPL_FRAC, _check_mesh_equivalence


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads per test: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMALL = B.Sizes(H=24, W=32, n_mid=3000, n_fine=3000, cap_mid=4096,
                cap_fine=4096, pixels=64, track_iters=8, rays=32,
                map_iters=16, window=3, P=64)
INT32_MAX = int(np.iinfo(np.int32).max)
# the trained colour decoder's step (after - before) against the
# reference's, relative Frobenius norm per leaf: 5.2e-3 at worst measured
# (the two implementations round differently and Adam carries it); the
# decoders' LR a tenth lower fails it, where the tolerances above pass
DEC_STEP_REL_FRO = 2e-2


def _ref_schedules(n_iters):
    """bench.py's mapping schedule (bench.py:155-163), from hpslam_tpu."""
    return jM.build_schedule(n_iters, 0.5, 0.3, False, 200, {
        "stage": {s: {"decoders_lr": 0.005 if "color" in s else 0.001,
                      "geometry_mid_lr": 0.03 if "geometry" in s else 0.005,
                      "geometry_fine_lr": 0.03 if "geometry" in s else 0.005,
                      "color_lr": 0.0 if "geometry" in s else 0.005}
                  for s in ("geometry_mid", "color_mid", "geometry_fine",
                            "color_fine")},
        "init": {}})


def _ref_mcfg():
    """bench.py's model config in the reference."""
    return jDec.ModelConfig(encode_exposure=True, encode_rel_pos_in_col=False,
                            fused_mlp=True, fused_composite=True)


def _workload():
    """The small workload on the reference's decoders (carried across);
    returns (workload, the reference's parameter tree)."""
    pj = jDec.init_nicer(jax.random.PRNGKey(0), _ref_mcfg())
    params = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    w = B.make_workload(SMALL, "cpu", params=params)
    B.build_indexes(w)
    return w, pj


def _feed_randint(monkeypatch, draws):
    it = iter(draws)
    monkeypatch.setattr(torch, "randint", lambda *a, **k: next(it))
    return it


def test_build_state_matches_bench(monkeypatch):
    """Seed 1219 gives bench.py's scene and frame bit for bit (its sizes
    cut small; bench.build_state reads them at call time)."""
    for name, v in (("N_MID", 700), ("N_FINE", 1500), ("CAP_MID", 1024),
                    ("CAP_FINE", 2048)):
        monkeypatch.setattr(jbench, name, v)
    H, W = 12, 16
    rng_j = np.random.default_rng(1219)
    ref = jbench.build_state(rng_j, _ref_mcfg())
    ref_depth = rng_j.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    ref_color = rng_j.uniform(0, 1, (H, W, 3)).astype(np.float32)
    rng_t = np.random.default_rng(B.SEED)
    port = B.build_state(rng_t, 32, 700, 1500, 1024, 2048, "cpu")
    depth, color = B.draw_frame(rng_t, H, W)
    for (pj, nj, gj, cj), (pt, nt, gt, ct) in zip(ref, port):
        assert int(nj) == nt
        for a, b in ((pj, pt), (gj, gt), (cj, ct)):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(depth, ref_depth)
    np.testing.assert_array_equal(color, ref_color)


def test_map_level_matches_bench_composition(monkeypatch):
    """The mid level of run_map against bench.py's composition of
    hpslam_tpu.mapper's functions (bench.py:168-228) on the same inputs:
    9 iterations (3 geometry, 6 colour) of 32 rays over 3 frames of 64
    cached pixels, capacity 4096, exposure and the colour decoder
    trained."""
    from jax.flatten_util import ravel_pytree

    w, pj = _workload()
    lv = "mid"
    pos, count, geo0, col0 = (t.clone() if torch.is_tensor(t) else t
                              for t in w.levels[lv])
    stage_ids, lr_table = _ref_schedules(SMALL.map_iters)[lv]
    n_iters = stage_ids.size
    assert n_iters == 9 and int(np.sum(stage_ids == 0)) == 3
    s = SMALL
    F, key = s.window, jax.random.PRNGKey(1)
    # the reference's draws: the cache's pixels, then each iteration's slots
    r = torch.tensor(np.stack([np.asarray(jax.random.randint(
        k, (s.P,), 0, INT32_MAX)) for k in jax.random.split(key, F)]),
        dtype=torch.int64)
    slots = [torch.tensor(np.asarray(jax.random.randint(
        k, (s.rays,), 0, s.P)), dtype=torch.int64)
        for k in jax.random.split(key, n_iters)]
    it = _feed_randint(monkeypatch, [r] + slots)
    gen = torch.Generator()
    built = B.build_cache(w, lv, gen)
    out = B.map_level(w, lv, built, gen)
    assert next(it, None) is None
    monkeypatch.undo()

    # bench.py's composition in the reference, on the same inputs
    mcfg = _ref_mcfg()
    win = {k: jnp.asarray(v.numpy()) for k, v in w.window.items()
           if torch.is_tensor(v)}
    pos_j = jnp.asarray(pos.numpy())
    index = jK.build_tiles(pos_j, jnp.int32(count))
    cache_pix, uids, Wm, pmask, cache_const = jM.build_pixel_union_cache(
        key, win["depths"], win["c2ws"], win["pools"].astype(jnp.int32),
        win["pool_lens"].astype(jnp.int32),
        jnp.asarray(w.window["rq"][lv].numpy()), index,
        jnp.int32(pos.shape[0]), P=s.P, S=5, k=8, u_max=8, H=s.H, W=s.W,
        fx=B.FX, fy=B.FY, cx=B.CX, cy=B.CY, near_surface=0.96,
        far_surface=1.04, min_nn=mcfg.min_nn_num, weighting=mcfg.weighting,
        colors=win["colors"], knn_probe=12)
    np.testing.assert_array_equal(built[0].numpy(), np.asarray(cache_pix))
    np.testing.assert_array_equal(built[1].numpy(), np.asarray(uids))
    U = jM.unique_bucket(int(jM.count_unique(uids)), pos.shape[0])
    uniq, uids, pos_c, geo_c, col_c = jM.compact_scene(
        uids, pos_j, jnp.asarray(geo0.numpy()), jnp.asarray(col0.numpy()), U)
    np.testing.assert_array_equal(out["uniq"].numpy(), np.asarray(uniq))
    packed = jM.pack_union_cache(cache_const, Wm, pmask, uids)
    dec_flat, dec_unravel = ravel_pytree({f"col_{lv}": pj[f"col_{lv}"]})
    op = {"feat": jnp.concatenate([geo_c, col_c], 1), "dec_flat": dec_flat,
          "expo_feat": jnp.zeros((8,))}
    op, _ost, losses = jM.map_scan(
        pj, mcfg, jR.RenderConfig(near_end_surface=0.96,
                                  far_end_surface=1.04,
                                  sample_near_pcl=False),
        op, jOpt.init(op), key, win["colors"], win["depths"], win["c2ws"],
        jnp.asarray(w.window["rq"][lv].numpy()), cache_pix, None, uids,
        win["expo"], pos_c, jnp.int32(U), jnp.asarray(stage_ids),
        jnp.asarray(lr_table), jnp.int32(F), level=lv, n_rays=s.rays,
        F_max=F, H=s.H, W=s.W, fx=B.FX, fy=B.FY, cx=B.CX, cy=B.CY,
        n_iters=n_iters, use_exposure=True, opt_color_dec=True,
        opt_geo_dec=False, w_color=0.1, use_union=True,
        cache_packed=packed, geo_iters=3)
    C = mcfg.c_dim
    geo_r = geo0.numpy().copy()
    col_r = col0.numpy().copy()
    keep = np.asarray(uniq) < pos.shape[0]
    feat = np.asarray(op["feat"])
    geo_r[np.asarray(uniq)[keep]] = feat[keep, :C]
    col_r[np.asarray(uniq)[keep]] = feat[keep, C:]
    dec_r = dec_unravel(op["dec_flat"])[f"col_{lv}"]
    ref = (torch.tensor(np.asarray(losses)), torch.tensor(geo_r),
           torch.tensor(col_r),
           convert.params_from_numpy(jax.tree.map(np.asarray, dec_r)))
    assert np.isfinite(ref[0].numpy()).all() and (ref[0][3:, 1] > 0).all()
    _pos, _n, geo_t, col_t = w.levels[lv]
    port = (out["losses"], geo_t, col_t, w.params[f"col_{lv}"])
    _check_mesh_equivalence(ref, port, frac=CROSS_IMPL_FRAC)
    # the decoder's step, per leaf to DEC_STEP_REL_FRO of the reference's
    dec0 = convert.params_from_numpy(jax.tree.map(np.asarray, pj[f"col_{lv}"]))
    for a, b, c in zip(tOpt.tree_leaves(ref[3]), tOpt.tree_leaves(port[3]),
                       tOpt.tree_leaves(dec0)):
        step = (a - c).numpy()
        err = np.linalg.norm((b - a).numpy())
        assert err <= DEC_STEP_REL_FRO * np.linalg.norm(step), (a.shape, err)
    # the scatter-back leaves every row outside the compacted set as it was
    outside = np.ones(pos.shape[0], bool)
    outside[np.asarray(uniq)[keep]] = False
    assert outside.sum() > 0
    np.testing.assert_array_equal(geo_t.numpy()[outside], geo0.numpy()[outside])
    np.testing.assert_array_equal(col_t.numpy()[outside], col0.numpy()[outside])
    assert not np.array_equal(geo_t.numpy()[~outside],
                              geo0.numpy()[~outside])


def test_run_track_matches_track_frame(monkeypatch):
    """run_track against the reference's track_frame with bench.py's
    arguments (4 sub-stages a level, probe 12, exposure, handle_dynamic,
    the plain trunks), on the same weights, state, frame and pixel draws
    (the reference's own), 8 iterations of 64 pixels."""
    w, pj = _workload()
    s = SMALL
    key = jax.random.PRNGKey(2)
    pool_len = s.H * s.W
    draws = [torch.tensor(np.asarray(jax.random.randint(
        jax.random.fold_in(k, sub), (s.pixels,), 0, pool_len)),
        dtype=torch.int64)
        for k in jax.random.split(key) for sub in range(4)]
    it = _feed_randint(monkeypatch, draws)
    cam_t, _best_t, loss_t, _ = B.run_track(w, torch.Generator())
    assert next(it, None) is None
    monkeypatch.undo()

    f = w.frame
    lv = {k: tuple(jnp.asarray(t.numpy()) if torch.is_tensor(t)
                   else jnp.int32(t) for t in w.levels[k])
          for k in ("mid", "fine")}
    index = {k: jK.build_tiles(lv[k][0], lv[k][1]) for k in lv}
    mcfg_tr = jDec.ModelConfig(encode_exposure=True,
                               encode_rel_pos_in_col=False, fused_mlp=False,
                               fused_composite=True)
    cam_j, _best_j, loss_j, _ = jT.track_frame(
        pj, mcfg_tr, jR.RenderConfig(near_end_surface=0.96,
                                     far_end_surface=1.04,
                                     sample_near_pcl=False),
        jnp.asarray(f["cam"].numpy()), key, jnp.asarray(f["color"].numpy()),
        jnp.asarray(f["depth"].numpy()),
        jnp.asarray(f["rq"]["mid"].numpy()),
        jnp.asarray(f["rq"]["fine"].numpy()),
        jnp.asarray(f["pool"].numpy().astype(np.int32)), jnp.int32(pool_len),
        *lv["mid"], index["mid"], *lv["fine"], index["fine"], jnp.zeros(8),
        pixels=s.pixels, iters_mid=4, iters_fine=4, W=s.W, fx=B.FX, fy=B.FY,
        cx=B.CX, cy=B.CY, cam_lr=5e-4, separate_lr=False, use_exposure=True,
        w_color=0.5, use_color=True, handle_dynamic=True, resample_stages=4,
        knn_probe=12, fused_track=False)
    loss_j = np.asarray(loss_j)
    assert np.isfinite(loss_j).all() and loss_j.shape == (8,)
    assert (loss_j > 0).all()
    np.testing.assert_allclose(loss_t.numpy(), loss_j, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(cam_t.numpy(), np.asarray(cam_j), rtol=1e-2,
                               atol=1e-3)


def test_entry_point_prints_benchs_line(capsys):
    """``python -m hpslam_tpu_torch.bench --device cpu`` at tiny sizes:
    one JSON line with bench.py's keys and finite values."""
    argv = ["--device", "cpu", "--reps", "1"] + [
        a for f in B.Sizes.__dataclass_fields__
        for a in (f"--{f}", str(getattr(SMALL, f)))]
    assert B.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert set(res["detail"]) == {"track_ms", "map_ms", "index_build_ms",
                                  "platform"}
    assert res["metric"] == "per_frame_tracking+mapping_ms_scannet"
    assert res["unit"] == "ms" and res["detail"]["platform"] == "cpu"
    for v in (res["value"], res["vs_baseline"],
              *(res["detail"][k] for k in ("track_ms", "map_ms",
                                           "index_build_ms"))):
        assert math.isfinite(v) and v > 0
    d = res["detail"]
    assert res["value"] == pytest.approx(d["track_ms"] + d["map_ms"] / 5)
