"""The reference's last public functions in the port, against hpslam_tpu on
the CPU, on inputs made from a numpy seed: ``renderer.eval_points`` (with
and without a tile index), the radius query ``find_neighbors`` (module and
cloud), the cloud's accessors, ``unflatten_core_like``.  (The records'
loss curves and ``eval_ate_aligned.png`` are checked on
tests/test_torch_e2e.py's CLI run.)

Tolerances, each stated where it is used:
- eval_points: in float64 (the reference under jax.enable_x64) occupancy
  and colour to rtol / atol 1e-9; in float32 masks equal and the tile
  path within 1e-6 of the exact one; at the wall occupancy atol / rtol
  1e-3 and colour atol 2e-4 / rtol 1e-3, the two packages' f32 roundings
  apart (test_eval_points_matches_reference says which and by how much);
  near the origin the float32 port to rtol / atol 1e-5 of the float64
  reference;
- find_neighbors: D rtol 1e-6 beside an absolute term of 8 f32 ulps of
  |q|^2 + |p|^2, the rounding of the reference's expanded form
  |q|^2 - 2 q.p + |p|^2 (the port sums squared differences); D also to
  rtol 1e-6 of the float64 distances; I equal wherever D has no tie at
  that resolution; counts equal, for scalar and per-query radii;
- positions and normals of inserted points atol 1e-6; unflatten exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu import renderer as jR
from hpslam_tpu import state as jSt
from hpslam_tpu.models import decoder as jDec
from hpslam_tpu.ops import fused_mlp as jFM
from hpslam_tpu.ops import knn as jK
from hpslam_tpu_torch import convert
from hpslam_tpu_torch import renderer as tR
from hpslam_tpu_torch import state as tSt
from hpslam_tpu_torch.models import decoder as tDec
from hpslam_tpu_torch.ops import fused_mlp as tFM
from hpslam_tpu_torch.ops import knn as tK


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads per test: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def build_wall_scene(rng, n_cap=4096, c_dim=8, scale=1.0):
    """tests/test_renderer.py's scene: a dense point wall at z = -2, its
    coordinates times ``scale``."""
    xs, ys = np.meshgrid(np.linspace(-1.5, 1.5, 60),
                         np.linspace(-1.2, 1.2, 48))
    pts = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -2.0)], -1)
    pos = np.zeros((n_cap, 3), np.float32)
    pos[:pts.shape[0]] = pts * scale
    geo = rng.normal(0, 0.1, (n_cap, c_dim)).astype(np.float32)
    col = rng.normal(0, 0.1, (n_cap, c_dim)).astype(np.float32)
    return pos, pts.shape[0], geo, col


def query_points(rng, scale=1.0):
    """200 points within 0.15 m of the wall, 60 anywhere in a box around
    it (most without a neighbour in their radius), and the two points of
    tests/test_renderer.py::test_eval_points; coordinates times
    ``scale``."""
    near = np.stack([rng.uniform(-1.4, 1.4, 200), rng.uniform(-1.1, 1.1, 200),
                     -2.0 + rng.uniform(-0.15, 0.15, 200)], -1)
    far = rng.uniform([-3, -3, -5], [3, 3, 1], (60, 3))
    fixed = np.array([[0.0, 0.0, -2.0], [0.0, 0.0, 5.0]])
    return (np.concatenate([near, far, fixed]) * scale).astype(np.float32)


def _eval_pair(rng, level, rel, expo, tiles=False, dtype=np.float32,
               ref_dtype=None, scale=1.0):
    """eval_points of both packages on one scene and weights, the port in
    ``dtype`` and the reference in ``ref_dtype`` (default the same);
    float64 runs the reference under jax.enable_x64 (the exact search
    only: the row top-k kernel and its plain version take float32), and
    ``tiles`` then gives the tile index to the port alone."""
    ref_dtype = ref_dtype or dtype
    jcfg = jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32,
                            encode_rel_pos_in_col=rel, encode_exposure=expo)
    tcfg = tDec.ModelConfig(**dataclasses.asdict(jcfg))
    pn = jax.tree.map(np.asarray,
                      jDec.init_nicer(jax.random.PRNGKey(0), jcfg))
    pos, count, geo, col = build_wall_scene(rng, scale=scale)
    p = query_points(rng, scale)
    rq = rng.uniform(0.06, 0.15, p.shape[0]) * scale
    ef = rng.normal(0, 0.1, 8) if expo else None
    with jax.enable_x64(ref_dtype == np.float64):
        def j(a):
            return (None if a is None
                    else jnp.asarray(np.asarray(a, ref_dtype)))
        out_j = jR.eval_points(
            jax.tree.map(j, pn), jcfg, j(p), j(pos), jnp.int32(count),
            j(geo), j(col), j(rq), level=level, exposure_feat=j(ef),
            tile_index=(jK.build_tiles(j(pos), jnp.int32(count))
                        if tiles and ref_dtype == np.float32 else None))
        out_j = [np.asarray(a) for a in out_j]

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a, dtype))
    outs_t = []
    for use_tiles in ((False, True) if tiles else (False,)):
        with torch.no_grad():
            outs_t.append([a.numpy() for a in tR.eval_points(
                jax.tree.map(t, pn), tcfg, t(p), t(pos), count, t(geo),
                t(col), t(rq), level=level, exposure_feat=t(ef),
                tile_index=(tK.build_tiles(t(pos), count) if use_tiles
                            else None))])
    for occ, rgb, mask in outs_t:
        assert occ.dtype == dtype and rgb.shape == (p.shape[0], 3)
        np.testing.assert_array_equal(mask, out_j[2])
        # both kinds of point are present: the test sees masked and
        # unmasked ones, tests/test_renderer.py's two among them
        assert 0 < int(mask.sum()) < p.shape[0]
        assert mask[-2] and not mask[-1]
    if tiles:
        # the tile path (kernel #1's route) finds what the exact one finds:
        # equal up to the order of neighbours at equal distance (1 ulp)
        for a, b in zip(*outs_t):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    return outs_t[-1], out_j


CASES = {"fine": dict(level="fine", rel=False, expo=False),
         "mid_relpos_exposure": dict(level="mid", rel=True, expo=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_points_matches_reference_float64(rng, case):
    """Both packages' eval_points in float64: the same function, to rtol
    1e-9 / atol 1e-9 (measured ~5e-13)."""
    (occ, rgb, _), (occ_j, rgb_j, _) = _eval_pair(rng, **CASES[case],
                                                   dtype=np.float64)
    np.testing.assert_allclose(occ, occ_j, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rgb, rgb_j, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_points_matches_reference(rng, case):
    """float32, as the port runs, with and without the tile index, at the
    wall: masks equal, the tile path the exact one's to 1e-6; occupancy
    atol / rtol 1e-3 and colour atol 2e-4 / rtol 1e-3, for two f32
    roundings that the two packages do apart (measured): at |p| to 3 m
    with geometry B entries to 55, p.B reaches ~1e2 rad, where one f32
    ulp is ~8e-6 rad, and the embeddings differ by up to 1.7e-4; the
    reference's expanded-form distances |q|^2 - 2 q.p + |p|^2 lie up to
    0.5 % from the port's within the radius, and the interpolated
    features differ by up to 7e-5 (2.2e-8 given the same D).  The
    occupancy then differs by up to 3.1e-4 and the colour by 5.5e-5 in
    the runs measured.
    The median |occupancy| is above 0.3 (asserted; 0.68-1.26 measured on
    the masked points), so 1e-3 is no more than 0.3 % of a typical
    value.  The float64 test above holds the function itself; the test
    below holds the float32 port at 1e-5 where neither rounding bites."""
    (occ, rgb, mask), (occ_j, rgb_j, _) = _eval_pair(rng, **CASES[case],
                                                      tiles=True)
    assert np.median(np.abs(occ_j)) > 0.3
    assert np.median(np.abs(occ_j[mask])) > 0.3
    np.testing.assert_allclose(occ, occ_j, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rgb, rgb_j, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_points_float32_near_origin_matches_reference(rng, case):
    """The port in float32, with and without the tile index, against the
    reference in float64, on the wall scene scaled by 1/50 (|p| under
    0.1 m, so p.B under ~3 rad): masks equal, occupancy and colour to
    rtol 1e-5 / atol 1e-5 (measured: 3.6e-6 and 7e-7).  The reference's
    own float32 run is not the yardstick here: its expanded-form
    distances are 2 % off the exact ones at this scale's neighbour
    spacing."""
    (occ, rgb, mask), (occ_j, rgb_j, _) = _eval_pair(
        rng, **CASES[case], tiles=True, ref_dtype=np.float64, scale=0.02)
    assert np.median(np.abs(occ_j[mask])) > 0.3
    np.testing.assert_allclose(occ, occ_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rgb, rgb_j, rtol=1e-5, atol=1e-5)


def _cloud(rng, n_cap=1024, count=900):
    pts = np.zeros((n_cap, 3), np.float32)
    pts[:count] = rng.uniform(-1.5, 1.5, (count, 3))
    return pts, count


def _check_neighbors(q, pts, count, k, radius, out_t, out_j):
    Dt, It, nt = (a.numpy() for a in out_t)
    Dj, Ij, nj = (np.asarray(a) for a in out_j)
    # the reference's expanded form rounds at ~ulps of |q|^2 + |p|^2
    scale = (np.sum(q.astype(np.float64) ** 2, 1)[:, None]
             + np.max(np.sum(pts[:count].astype(np.float64) ** 2, 1)))
    res = 8 * np.finfo(np.float32).eps * scale
    assert (np.abs(Dt - Dj) <= 1e-6 * np.abs(Dj) + res).all()
    exact = np.sort(np.sum((q[:, None, :].astype(np.float64)
                            - pts[None, :count]) ** 2, -1), 1)[:, :k]
    np.testing.assert_allclose(Dt, exact, rtol=1e-6)
    # ids equal wherever the distance has no tie at the reference's
    # resolution with its neighbours in the list
    gap = np.diff(exact, axis=1)
    untied = np.ones_like(Dt, bool)
    untied[:, 1:] &= gap > 2 * res
    untied[:, :-1] &= gap > 2 * res
    np.testing.assert_array_equal(It[untied], Ij[untied])
    assert untied.mean() > 0.9
    np.testing.assert_array_equal(nt, nj)
    r = np.broadcast_to(np.asarray(radius, np.float64), (q.shape[0],))
    np.testing.assert_array_equal(nt, np.sum(exact < (r ** 2)[:, None], 1))


@pytest.mark.parametrize("per_query", [False, True])
def test_find_neighbors_matches_reference(rng, per_query):
    pts, count = _cloud(rng)
    q = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    radius = (rng.uniform(0.05, 0.35, q.shape[0]).astype(np.float32)
              if per_query else np.float32(0.2))
    out_t = tK.find_neighbors(torch.tensor(q), torch.tensor(pts), count,
                              torch.tensor(radius) if per_query
                              else float(radius), k=8)
    out_j = jK.find_neighbors(jnp.asarray(q), jnp.asarray(pts),
                              jnp.int32(count), jnp.asarray(radius), k=8)
    _check_neighbors(q, pts, count, 8, radius, out_t, out_j)
    assert out_t[2].min() < 8 and out_t[2].max() > 0


def _cloud_cfg():
    return {"model": {"c_dim": 8},
            "pointcloud": {"nn_num": 8, "N_add": 3, "near_end_surface": 0.96,
                           "far_end_surface": 1.04, "radius_add": 0.04,
                           "radius_min": 0.02, "radius_query": 0.08,
                           "radius_hierarchy": {"fine": {}, "mid": {}}}}


def test_cloud_accessors_match_reference(rng):
    cfg = _cloud_cfg()
    npc_t = tSt.NeuralPointCloud(cfg, "cpu", initial_capacity=256)
    npc_j = jSt.NeuralPointCloud(cfg, initial_capacity=256)
    B = 16
    rays_o = np.zeros((B, 3), np.float32)
    rays_d = np.tile(np.array([[0, 0, -1.0]], np.float32), (B, 1))
    rays_d[:, 0] = np.linspace(-0.5, 0.5, B)
    depth = np.full((B,), 2.0, np.float32)
    depth[3] = 0.0                        # one invalid ray
    color = rng.uniform(size=(B, 3)).astype(np.float32)
    r = np.full((B,), 0.01, np.float32)
    for npc in (npc_t, npc_j):
        n1 = npc.add_neural_points(rays_o, rays_d, depth, color, "fine",
                                   dynamic_radius=r)
        assert n1 == B - 1
        n2 = npc.add_neural_points(rays_o, rays_d, depth, color, "fine",
                                   dynamic_radius=np.full((B,), 0.5,
                                                          np.float32))
        assert n2 == 0
        npc.add_neural_points(rays_o + 1.0, rays_d, depth, color, "mid",
                              dynamic_radius=r, record_input=False)
    n = (B - 1) * 3
    for level in ("fine", "mid"):
        assert npc_t.index_ntotal(level) == npc_j.index_ntotal(level) == n
        for name in ("cloud_pos", "cloud_normal"):
            a = getattr(npc_t, name)(level)
            b = np.asarray(getattr(npc_j, name)(level))
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy()[:n], b[:n], atol=1e-6)
        for name in ("get_geo_feats", "get_col_feats"):
            a = getattr(npc_t, name)(level)
            assert tuple(a.shape) == np.asarray(
                getattr(npc_j, name)(level)).shape
            assert a.dtype == torch.float32
    # as tests/test_decoder_state.py reads it: points in [0.96d, 1.04d]
    pos = np.asarray(npc_t.cloud_pos("fine"))[:n]
    t = -pos[:, 2]
    assert (t >= 0.96 * 2.0 - 1e-5).all() and (t <= 1.04 * 2.0 + 1e-5).all()
    # the input cloud: two recorded calls on the fine level, no normals
    # (no caller passes them)
    assert len(npc_t.input_pos()) == len(npc_j.input_pos()) == 2 * (B - 1)
    np.testing.assert_allclose(np.asarray(npc_t.input_pos()),
                               np.asarray(npc_j.input_pos()), atol=1e-6)
    np.testing.assert_allclose(np.asarray(npc_t.input_rgb()),
                               np.asarray(npc_j.input_rgb()), atol=1e-4)
    for name in ("input_normal", "input_normal_cartesian"):
        assert getattr(npc_t, name)() == getattr(npc_j, name)() == []
    # feature updates replace the level's table, on the cloud's device
    new = rng.normal(size=(256, 8)).astype(np.float32)
    npc_t.update_geo_feats(new, "fine")
    npc_t.update_col_feats(2 * new, "mid")
    npc_j.update_geo_feats(new, "fine")
    npc_j.update_col_feats(2 * new, "mid")
    np.testing.assert_array_equal(npc_t.get_geo_feats("fine").numpy(),
                                  np.asarray(npc_j.get_geo_feats("fine")))
    np.testing.assert_array_equal(npc_t.get_col_feats("mid").numpy(),
                                  np.asarray(npc_j.get_col_feats("mid")))
    # the keyframe dict: set, and read back as a copy
    kfs = [{"idx": 0}, {"idx": 5}]
    for npc in (npc_t, npc_j):
        assert npc.get_keyframe_dict() == []
        npc.set_keyframe_dict(kfs)
        got = npc.get_keyframe_dict()
        assert got == kfs and got is not kfs
    # the cloud's radius query
    q = np.concatenate([pos[::5] + 0.003, rng.uniform(-1, 1, (10, 3))]
                       ).astype(np.float32)
    out_t = npc_t.find_neighbors(q, "fine", 0.05)
    out_j = npc_j.find_neighbors(q, "fine", 0.05)
    pts = npc_t.cloud_pos("fine").numpy()
    _check_neighbors(q, pts, n, 8, 0.05, out_t, out_j)
    # restore_input takes a checkpoint's normals, as the reference's
    nrm = rng.uniform(-np.pi, np.pi, (2 * (B - 1), 2)).astype(np.float32)
    for npc in (npc_t, npc_j):
        npc.restore_input(npc_j.input_pos(), npc_j.input_rgb(), nrm)
    np.testing.assert_array_equal(np.asarray(npc_t.input_normal()),
                                  np.asarray(npc_j.input_normal()))
    # an hpslam_tpu checkpoint's empty normals, shape (0,)
    npc_t.restore_input(npc_j.input_pos(), npc_j.input_rgb(),
                        np.zeros((0,), np.float32))
    assert npc_t.input_normal() == []


def test_unflatten_core_like_inverts_flatten(rng):
    cfg = jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                           hidden_geo=16, hidden_col=32)
    pj = jDec.init_nicer(jax.random.PRNGKey(2), cfg)
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    for name in ("geo_mid", "col_fine"):
        core_t, core_j = pt[name]["core"], pj[name]["core"]
        flat_t = tFM.flatten_core(core_t)
        back_t = tFM.unflatten_core_like(core_t, flat_t)
        back_j = jFM.unflatten_core_like(core_j, jFM.flatten_core(core_j))
        leaves_t = jax.tree_util.tree_flatten_with_path(back_t)[0]
        leaves_j = jax.tree_util.tree_flatten_with_path(back_j)[0]
        assert [p for p, _ in leaves_t] == [p for p, _ in leaves_j]
        for (_, a), (_, b) in zip(leaves_t, leaves_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the same tensors, in place: flatten(unflatten(flat)) is flat
        assert all(a is b for a, b in zip(tFM.flatten_core(back_t), flat_t))
        scaled = [2 * a for a in flat_t]
        assert all(a is b for a, b in zip(
            tFM.flatten_core(tFM.unflatten_core_like(core_t, scaled)),
            scaled))
