"""The port's device mesh on torch.distributed, on the CPU over gloo.

parse_mesh_spec follows the reference's grammar and errors; knn_tp on a
2-rank tensor-parallel group matches single-process knn (as
tests/test_parallel.py checks the reference's); the union map_scan phase at
dp = 2 matches dp = 1, and track_frame at dp = 2 matches the single-device
program, at the reference's own mesh-equivalence tolerances
(tests/test_parallel.py): the first iteration's loss to rtol 1e-4 (the same
program up to the order of the cross-rank sums), later iterations to rtol
0.03 / atol 1e-3 and features to rtol 0.05 / atol 2e-3 (that rounding
noise carried through Adam), the selected pose to atol 0.02.  The
per-sample phase (BA, rel-pos colour) at dp = 2 matches dp = 1: its first
gradients to 1e-5 of their largest entry, its losses at the same
tolerances.  The mesh
path's map_scan (the fused composite, its plain version on the CPU) is
held against the reference's union map_scan (mesh None, fused_composite
off: the same function with the compositor outside the trunks) at the
same tolerances, all but CROSS_IMPL_FRAC of the feature and decoder
entries (Adam's eps regime; see the test).

Ranks are spawned processes (torch.multiprocessing) meeting through a
FileStore in the test's tmp_path, not a TCP port; the parent builds every
input with numpy and hands it over, so a rank imports no jax.
"""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hpslam_tpu_torch import mapper as tM
from hpslam_tpu_torch import renderer as tR
from hpslam_tpu_torch import tracker as tT
from hpslam_tpu_torch.models import decoder as tDec
from hpslam_tpu_torch.ops import knn as tK
from hpslam_tpu_torch.ops import optim as tOpt
from hpslam_tpu_torch.parallel import mesh as tMesh
from hpslam_tpu_torch.parallel.knn_tp import make_tp_knn


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads per test: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rank_main(rank, world, store, out, fn, args):
    torch.set_num_threads(1)
    # a rank that waits on a collective longer than this fails instead of
    # holding the test run
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    try:
        res = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(res, f"{out}.{rank}")


def run_ranks(tmp_path, world, fn, *args):
    """fn(*args) on ``world`` gloo ranks; returns every rank's result."""
    out = str(tmp_path / "rank_result")
    mp.start_processes(_rank_main, args=(world, str(tmp_path / "store"),
                                         out, fn, args),
                       nprocs=world, start_method="spawn")
    return [torch.load(f"{out}.{r}") for r in range(world)]


# ---------------------------------------------------------------------------
# parse_mesh_spec (one process: a world of one)

@pytest.mark.parametrize("spec", [None, "", "none", "None", 0, "0"])
def test_parse_mesh_spec_no_mesh(spec):
    assert tMesh.parse_mesh_spec(spec, "cpu") is None
    assert not dist.is_initialized()


@pytest.mark.parametrize("spec", ["1", 1, "dp1", "dp1,tp1", "tp1"])
def test_parse_mesh_spec_world_of_one(spec):
    m = tMesh.parse_mesh_spec(spec, "cpu")
    try:
        assert m.shape == {"dp": 1, "tp": 1}
        assert (m.dp_rank, m.tp_rank) == (0, 0) and m.is_main
        assert dist.get_world_size() == 1
    finally:
        m.close()
    assert not dist.is_initialized()


@pytest.mark.parametrize("spec,msg", [
    ("dp4", "needs 4 devices, have 1"), ("8", "needs 8 devices, have 1"),
    ("dp2,tp2", "needs 4 devices, have 1"), ("xp2", "bad mesh axis"),
    ("dp1,foo", "bad mesh axis")])
def test_parse_mesh_spec_errors(spec, msg):
    with pytest.raises(ValueError, match=msg):
        tMesh.parse_mesh_spec(spec, "cpu")
    assert not dist.is_initialized()


def test_shard_batch_slices_cover_the_batch():
    x = torch.arange(23 * 2).reshape(23, 2)
    assert tMesh.shard_batch(None, x) is x
    parts = [tMesh.shard_bounds(23, 4, i) for i in range(4)]
    assert parts[0][0] == 0 and parts[-1][1] == 23
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert sorted(h - lo for lo, h in parts) == [5, 6, 6, 6]


# ---------------------------------------------------------------------------
# knn_tp

def _tp_knn_rank(q, pts, count):
    m = tMesh.make_mesh(2, dp=1, tp=2, device_type="cpu")
    shard = pts.shape[0] // 2
    lo = m.tp_rank * shard
    return make_tp_knn(m, k=8)(q, pts[lo:lo + shard], count)


def test_tp_knn_matches_single_process(rng, tmp_path):
    N_cap, count, Q = 1024, 900, 100
    pts = torch.tensor(rng.uniform(-2, 2, (N_cap, 3)).astype(np.float32))
    q = torch.tensor(rng.uniform(-2, 2, (Q, 3)).astype(np.float32))
    outs = run_ranks(tmp_path, 2, _tp_knn_rank, q, pts, count)
    D_ref, I_ref = tK.knn(q, pts, count, k=8)
    for D, I in outs:
        np.testing.assert_allclose(D.numpy(), D_ref.numpy(), atol=1e-5)
        same = I.numpy() == I_ref.numpy()
        ties = np.isclose(D.numpy(), D_ref.numpy(), atol=1e-6)
        assert np.all(same | ties)
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# union map_scan: dp = 2 against dp = 1, and against the reference

# share of entries the port-vs-reference map_scan comparison lets outside
# the mesh-equivalence tolerances (test_mesh_map_scan_matches_reference)
CROSS_IMPL_FRAC = 1e-3


def small_cfg(**kw):
    return tDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32, fused_mlp=True,
                            fused_composite=True, **kw)


def _map_inputs(rng):
    """The reference's union mesh-equivalence fixture
    (tests/test_parallel.py): a wall of 1600 points 2 m in front of two
    identical 24x32 frames, P=256 cached pixels per frame, 256 rays, 12
    iterations (4 geometry, 8 colour)."""
    n_cap = 2048
    xs, ys = np.meshgrid(np.linspace(-1.5, 1.5, 40),
                         np.linspace(-1.2, 1.2, 40))
    pts = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -2.0)], -1)
    pos = np.zeros((n_cap, 3), np.float32)
    pos[:pts.shape[0]] = pts
    H, W, F = 24, 32, 2
    fx = fy = 20.0
    cx, cy = 15.5, 11.5
    jj, ii = np.mgrid[0:H, 0:W]
    dirs = np.stack([(ii - cx) / fx, -(jj - cy) / fy,
                     -np.ones_like(ii, float)], -1)
    depth = (2.0 / -dirs[..., 2]).astype(np.float32)
    color = rng.uniform(0.2, 0.8, (H, W, 3)).astype(np.float32)
    return dict(
        pos=pos, count=int(pts.shape[0]),
        geo=rng.normal(0, 0.1, (n_cap, 8)).astype(np.float32),
        col=rng.normal(0, 0.1, (n_cap, 8)).astype(np.float32),
        colors=np.broadcast_to(color, (F, H, W, 3)).copy(),
        depths=np.broadcast_to(depth, (F, H, W)).copy(),
        H=H, W=W, F=F, fx=fx, fy=fy, cx=cx, cy=cy, P=256, n_rays=256,
        n_iters=12, geo_iters=4,
        lr=np.tile(np.array([[0.005, 0.03, 0.02, 0.0]], np.float32),
                   (12, 1)))


def _map_phase(x, params, mcfg, slots=None, spec="dp1",
               decoders=("col_fine",)):
    """The mesh path's union phase, as Mapper.map runs it: the union cache
    (dp-sharded search, gathered whole), compaction, packing, then
    map_scan.  ``slots``: per-iteration slot draws to use in place of the
    generator's (the reference's draws); ``decoders``: those trained.
    Returns (losses, geo, col of the whole table after the write-back, the
    trained decoders {name: tree}) and the phase's
    inputs (packed cache, cached pixels, compacted ids, compacted table
    rows, their global ids)."""
    mesh = tMesh.parse_mesh_spec(spec, "cpu")
    try:
        T = torch.tensor
        pos = T(x["pos"])
        F, H, W = x["F"], x["H"], x["W"]
        cp, uids, Wm, pm, const = tM.build_pixel_union_cache(
            torch.Generator().manual_seed(7), T(x["depths"]),
            torch.eye(4).expand(F, 4, 4).contiguous(),
            torch.arange(H * W).expand(F, H * W).contiguous(),
            torch.full((F,), H * W), torch.full((F, H, W), 0.4),
            tK.build_tiles(pos, x["count"]), pos.shape[0], P=x["P"], S=5,
            k=8, u_max=8, H=H, W=W, fx=x["fx"], fy=x["fy"], cx=x["cx"],
            cy=x["cy"], near_surface=0.96, far_surface=1.04,
            min_nn=mcfg.min_nn_num, weighting=mcfg.weighting,
            colors=T(x["colors"]), mesh=mesh)
        U = tM.unique_bucket(tM.count_unique(uids), pos.shape[0])
        uniq, uids_c, pos_c, geo_c, col_c = tM.compact_scene(
            uids, pos, T(x["geo"]), T(x["col"]), U)
        packed = tM.pack_union_cache(const, Wm, pm, uids_c)
        feat0 = torch.cat([geo_c, col_c], 1)
        op = {"feat": feat0.clone(),
              "dec": {d: tOpt.tree_map(torch.clone, params[d])
                      for d in decoders}}
        rcfg = tR.RenderConfig(sample_near_pcl=False)
        randint = torch.randint
        if slots is not None:
            it = iter(slots)
            torch.randint = lambda *a, **k: next(it)
        try:
            op, _ost, losses = tM.map_scan(
                params, mcfg, rcfg, op, tOpt.init(op),
                torch.Generator().manual_seed(1), T(x["depths"]), cp,
                packed, 8, torch.zeros((F, 8)), x["lr"], F, "fine",
                x["n_rays"], x["geo_iters"], False, True, 0.1, mesh=mesh)
        finally:
            torch.randint = randint
        geo, col = write_back(x, uniq, op["feat"])
        return ((losses, geo, col, op["dec"]),
                dict(packed=packed, cp=cp, uids_c=uids_c, feat=feat0,
                     pos_c=pos_c, uniq=uniq, U=U))
    finally:
        if mesh is not None:
            mesh.close()


def write_back(x, uniq, feat):
    """The whole feature tables after the compacted rows' write-back (the
    engine's npc.scatter_feats; padding ids dropped)."""
    geo, col = torch.tensor(x["geo"]), torch.tensor(x["col"])
    feat = torch.tensor(np.asarray(feat))
    keep = uniq < geo.shape[0]
    geo[uniq[keep]] = feat[keep, :8]
    col[uniq[keep]] = feat[keep, 8:]
    return geo, col


def _map_rank(x, params, mcfg):
    return _map_phase(x, params, mcfg, spec="dp2")[0]


def _check_mesh_equivalence(a, b, frac=0.0):
    """The reference's mesh-equivalence tolerances (module docstring).
    ``frac``: the share of feature and decoder entries allowed outside
    them (0: none)."""
    (l1, g1, c1, d1), (l2, g2, c2, d2) = a, b
    np.testing.assert_allclose(l2[0].numpy(), l1[0].numpy(), rtol=1e-4)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=0.03, atol=1e-3)
    pairs = [("geo", g2, g1), ("col", c2, c1)] + [
        (f"dec[{i}]", u, v) for i, (u, v) in enumerate(zip(
            tOpt.tree_leaves(d2), tOpt.tree_leaves(d1)))]
    for name, u, v in pairs:
        if not frac:
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=0.05,
                                       atol=2e-3, err_msg=name)
            continue
        off = ~np.isclose(u.numpy(), v.numpy(), rtol=0.05, atol=2e-3)
        assert off.mean() <= frac, (name, int(off.sum()), off.size)


def test_union_map_scan_dp2_matches_dp1(rng, tmp_path):
    x = _map_inputs(rng)
    mcfg = small_cfg()
    params = tDec.init_nicer(torch.Generator().manual_seed(0), mcfg, "cpu")
    # dp1 in this process: the mesh opens (and closes) a world of one
    ref, _ = _map_phase(x, params, mcfg)
    assert np.isfinite(ref[0].numpy()).all() and (ref[0][4:, 1] > 0).all()
    outs = run_ranks(tmp_path, 2, _map_rank, x, params, mcfg)
    for out in outs:
        _check_mesh_equivalence(ref, out)
    # every rank holds the same state
    for a, b in zip(tOpt.tree_leaves(outs[0]), tOpt.tree_leaves(outs[1])):
        assert torch.equal(a, b)


def _persample_phase(x, params, mcfg, spec, first_only=False):
    """The per-sample phase as Mapper.map runs it under BA with rel-pos
    colour: the kNN cache (dp-sharded search, gathered whole), compaction,
    then the optimisation with the colour decoder and the second frame's
    camera trainable.  Returns (losses, geo, col, decoder, cameras); with
    ``first_only`` the first iteration alone at LR 0, and its gradients
    (Adam's first moment over 1 - beta1)."""
    mesh = tMesh.parse_mesh_spec(spec, "cpu")
    try:
        T = torch.tensor
        pos = T(x["pos"])
        F, H, W = x["F"], x["H"], x["W"]
        c2ws = torch.eye(4).expand(F, 4, 4).contiguous()
        cp, cD, cI = tM.build_pixel_knn_cache(
            torch.Generator().manual_seed(7), T(x["depths"]), c2ws,
            torch.arange(H * W).expand(F, H * W).contiguous(),
            torch.full((F,), H * W), tK.build_tiles(pos, x["count"]),
            P=x["P"], S=5, k=8, W=W, fx=x["fx"], fy=x["fy"], cx=x["cx"],
            cy=x["cy"], near_surface=0.96, far_surface=1.04, mesh=mesh)
        U = tM.unique_bucket(tM.count_unique(cI), pos.shape[0])
        uniq, cI_c, pos_c, geo_c, col_c = tM.compact_scene(
            cI, pos, T(x["geo"]), T(x["col"]), U)
        cams = torch.tensor([[1.0, 0, 0, 0, 0, 0, 0],
                             [1.0, 0, 0, 0, 0.01, 0, 0]])
        op = {"geo": geo_c, "col": col_c, "cams": cams,
              "dec": {"col_fine": tOpt.tree_map(torch.clone,
                                                params["col_fine"])}}
        loss_fn = tM.samples_stage_loss(
            params, mcfg, tR.RenderConfig(sample_near_pcl=False),
            T(x["colors"]), T(x["depths"]), c2ws, torch.full((F, H, W), 0.4),
            cp, cD, cI_c, torch.zeros((F, 8)), pos_c, F, "fine", x["fx"],
            x["fy"], x["cx"], x["cy"], False, False, 0.1, use_ba=True,
            cam_trainable=torch.tensor([False, True]))
        lr = x["lr"].copy()
        lr[:, 3] = 0.001
        geo_iters = x["geo_iters"]
        if first_only:
            lr, geo_iters = lr[:1] * 0, 0
        op, ost, losses = tM.optimise(
            loss_fn, tM.samples_lr_tree, op, tOpt.init(op),
            torch.Generator().manual_seed(1), lr, geo_iters, x["n_rays"],
            x["P"], F, mesh=mesh)
        if first_only:
            return tOpt.tree_map(lambda m: m / 0.1, ost["m"])
        geo, col = write_back(x, uniq, torch.cat([op["geo"], op["col"]], 1))
        return losses, geo, col, op["dec"], op["cams"]
    finally:
        if mesh is not None:
            mesh.close()


def _persample_rank(x, params, mcfg):
    return (_persample_phase(x, params, mcfg, "dp2", first_only=True),
            _persample_phase(x, params, mcfg, "dp2"))


def test_persample_map_phase_dp2_matches_dp1(rng, tmp_path):
    """The per-sample mapping path (BA, rel-pos colour) at dp = 2 against
    dp = 1: the first iteration's gradients (colour stage: features,
    colour decoder, cameras) to 1e-5 of each tensor's largest entry (the
    same sums in another order), the whole phase's losses at the
    mesh-equivalence tolerances.  (Its features are not held entry by
    entry: under BA the rounding of the dp sums moves the poses, and
    Adam's normalised steps carry that into features whose gradients are
    at the rounding level.)  Every rank holds the same state."""
    x = _map_inputs(rng)
    mcfg = small_cfg(encode_rel_pos_in_col=True)
    params = tDec.init_nicer(torch.Generator().manual_seed(0), mcfg, "cpu")
    g_ref = _persample_phase(x, params, mcfg, "dp1", first_only=True)
    ref = _persample_phase(x, params, mcfg, "dp1")
    assert np.isfinite(ref[0].numpy()).all() and (ref[0][4:, 1] > 0).all()
    outs = run_ranks(tmp_path, 2, _persample_rank, x, params, mcfg)
    for g, out in outs:
        for a, b in zip(tOpt.tree_leaves(g), tOpt.tree_leaves(g_ref)):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=1e-5 * max(float(b.abs().max()), 1e-30))
        assert float(g["cams"][1].abs().max()) > 0
        assert not g["cams"][0].any()                   # frozen slot
        np.testing.assert_allclose(out[0][0].numpy(), ref[0][0].numpy(),
                                   rtol=1e-4)
        np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(),
                                   rtol=0.03, atol=1e-3)
        assert torch.equal(out[4][0], ref[4][0])
    for a, b in zip(tOpt.tree_leaves(outs[0]), tOpt.tree_leaves(outs[1])):
        assert torch.equal(a, b)


def test_mesh_map_scan_matches_reference(rng):
    """The port's mesh path (dp1: the fused composite, plain on the CPU)
    against the reference's map_scan on the same packed cache, compacted
    table, weights and per-iteration ray draws (the reference's own, from
    its key), with mesh None and fused_composite off: the union render
    with the compositor outside the trunks, the same function.  Its trunks
    are the fused ones (Pallas in interpret mode), which, like the fused
    composite, hold the colour decoder's Fourier B frozen; the plain
    trunks would train B with the decoder."""
    import jax
    import jax.numpy as jnp
    from hpslam_tpu import renderer as jR
    from hpslam_tpu.mapper import map_scan as j_map_scan
    from hpslam_tpu.models import decoder as jDec
    from hpslam_tpu.ops import optim as jOpt
    from hpslam_tpu_torch import convert

    x = _map_inputs(rng)
    jcfg = jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32, fused_mlp=True,
                            fused_composite=False)
    pj = jDec.init_nicer(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    key = jax.random.PRNGKey(1)
    slots = [torch.tensor(np.asarray(jax.random.randint(
        k, (x["n_rays"],), 0, x["P"])), dtype=torch.int64)
        for k in jax.random.split(key, x["n_iters"])]
    port, ph = _map_phase(x, params, small_cfg(), slots)
    op = {"feat": jnp.asarray(ph["feat"].numpy()),
          "dec": {"col_fine": pj["col_fine"]}}
    F, H, W = x["F"], x["H"], x["W"]
    op, _ost, losses = j_map_scan(
        pj, jcfg, jR.RenderConfig(sample_near_pcl=False), op,
        jOpt.init(op), key, jnp.asarray(x["colors"]),
        jnp.asarray(x["depths"]), jnp.tile(jnp.eye(4), (F, 1, 1)),
        jnp.full((F, H, W), 0.4), jnp.asarray(ph["cp"].numpy()), None,
        jnp.asarray(ph["uids_c"].numpy()), jnp.zeros((F, 8)),
        jnp.asarray(ph["pos_c"].numpy()), jnp.int32(ph["U"]),
        jnp.asarray(np.r_[np.zeros(4, np.int32), np.ones(8, np.int32)]),
        jnp.asarray(x["lr"]), jnp.int32(F), level="fine",
        n_rays=x["n_rays"], F_max=F, H=H, W=W, fx=x["fx"], fy=x["fy"],
        cx=x["cx"], cy=x["cy"], n_iters=x["n_iters"], use_exposure=False,
        opt_color_dec=True, opt_geo_dec=False, w_color=0.1, use_union=True,
        cache_packed=jnp.asarray(ph["packed"].numpy()), geo_iters=4)
    ref = (torch.tensor(np.asarray(losses)),
           *write_back(x, ph["uniq"], op["feat"]),
           convert.params_from_numpy(jax.tree.map(np.asarray, op["dec"])))
    assert np.isfinite(ref[0].numpy()).all() and (ref[0][4:, 1] > 0).all()
    # two implementations round differently; Adam turns a gradient near
    # its eps (1e-8) into a step of up to lr whatever its rounding, so a
    # few feature entries walk apart (1 of 16384 here, by 3.5e-3)
    _check_mesh_equivalence(ref, port, frac=CROSS_IMPL_FRAC)


def test_map_scan_trains_geometry_decoders_matches_reference(rng):
    """The union map_scan with the geometry decoder trained beside the
    colour decoder (fix_geo_decoder_* off: the plain trunks, no mesh)
    against the reference's map_scan on the same packed cache, compacted
    table, weights and ray draws (its own, from its key), with
    opt_geo_dec: losses, feature tables and both decoders at the
    cross-implementation tolerances of test_mesh_map_scan_matches_reference
    (module docstring), and every leaf of the geometry decoder's trunk
    moved from its start on both sides."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from hpslam_tpu import renderer as jR
    from hpslam_tpu.mapper import map_scan as j_map_scan
    from hpslam_tpu.models import decoder as jDec
    from hpslam_tpu.ops import optim as jOpt
    from hpslam_tpu_torch import convert

    x = _map_inputs(rng)
    jcfg = jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32, fused_mlp=False,
                            fused_composite=True)
    pj = jDec.init_nicer(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    key = jax.random.PRNGKey(1)
    slots = [torch.tensor(np.asarray(jax.random.randint(
        k, (x["n_rays"],), 0, x["P"])), dtype=torch.int64)
        for k in jax.random.split(key, x["n_iters"])]
    names = ("col_fine", "geo_fine")
    port, ph = _map_phase(x, params, dataclasses.replace(
        small_cfg(), fused_mlp=False), slots, spec=None, decoders=names)
    op = {"feat": jnp.asarray(ph["feat"].numpy()),
          "dec": {d: pj[d] for d in names}}
    F, H, W = x["F"], x["H"], x["W"]
    op, _ost, losses = j_map_scan(
        pj, jcfg, jR.RenderConfig(sample_near_pcl=False), op,
        jOpt.init(op), key, jnp.asarray(x["colors"]),
        jnp.asarray(x["depths"]), jnp.tile(jnp.eye(4), (F, 1, 1)),
        jnp.full((F, H, W), 0.4), jnp.asarray(ph["cp"].numpy()), None,
        jnp.asarray(ph["uids_c"].numpy()), jnp.zeros((F, 8)),
        jnp.asarray(ph["pos_c"].numpy()), jnp.int32(ph["U"]),
        jnp.asarray(np.r_[np.zeros(4, np.int32), np.ones(8, np.int32)]),
        jnp.asarray(x["lr"]), jnp.int32(F), level="fine",
        n_rays=x["n_rays"], F_max=F, H=H, W=W, fx=x["fx"], fy=x["fy"],
        cx=x["cx"], cy=x["cy"], n_iters=x["n_iters"], use_exposure=False,
        opt_color_dec=True, opt_geo_dec=True, w_color=0.1, use_union=True,
        cache_packed=jnp.asarray(ph["packed"].numpy()), geo_iters=4)
    ref = (torch.tensor(np.asarray(losses)),
           *write_back(x, ph["uniq"], op["feat"]),
           convert.params_from_numpy(jax.tree.map(np.asarray, op["dec"])))
    assert np.isfinite(ref[0].numpy()).all() and (ref[0][4:, 1] > 0).all()
    assert sorted(port[3]) == sorted(names)
    _check_mesh_equivalence(ref, port, frac=CROSS_IMPL_FRAC)
    start = params["geo_fine"]["core"]
    for trained in (port[3]["geo_fine"]["core"], ref[3]["geo_fine"]["core"]):
        for a, b in zip(tOpt.tree_leaves(trained), tOpt.tree_leaves(start)):
            assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# track_frame: dp = 2 against no mesh

def _corner_inputs(rng):
    """The reference's mesh-equivalence fixture for track_frame
    (tests/test_parallel.py): the three-plane corner of
    tests/test_engines.py (3025 points per plane, random features), its
    true depth on a 24x32 frame, grey colour."""
    import jax
    from hpslam_tpu.models import decoder as jDec
    from hpslam_tpu_torch import convert
    from tests import test_engines as jte
    jcfg = jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32)
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, jDec.init_nicer(jax.random.PRNGKey(0), jcfg)))
    pos, count, geo, col = jte.corner_level(rng)
    H, W, fx, fy, cx, cy = 24, 32, 20.0, 20.0, 15.5, 11.5
    jj, ii = np.mgrid[0:H, 0:W]
    dirs0 = np.stack([(ii - cx) / fx, -(jj - cy) / fy,
                      -np.ones_like(ii, float)], -1).reshape(-1, 3)
    depth = jte.corner_depth(dirs0).reshape(H, W).astype(np.float32)
    level = (torch.tensor(np.asarray(pos)), int(count),
             torch.tensor(np.asarray(geo)), torch.tensor(np.asarray(col)))
    cfg = tDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                           hidden_geo=16, hidden_col=32)
    return params, cfg, level, torch.tensor(depth), (H, W, fx, fy, cx, cy)


def _track(params, cfg, level, depth, cam, handle_dynamic, mesh_spec):
    mesh = (tMesh.parse_mesh_spec(mesh_spec, "cpu") if mesh_spec
            else None)
    try:
        H, W, fx, fy, cx, cy = cam
        idx = tK.build_tiles(level[0], level[1])
        best_cam, _best, losses, _ = tT.track_frame(
            params, cfg, tR.RenderConfig(sample_near_pcl=False),
            torch.tensor([1, 0, 0, 0, 0.05, -0.03, 0.04]),
            torch.Generator().manual_seed(2), torch.full((H, W, 3), 0.5),
            depth, torch.full((H, W), 0.4), torch.full((H, W), 0.4),
            torch.arange(H * W), H * W, level, idx, level, idx,
            torch.zeros(8), pixels=192, iters_mid=8, iters_fine=8, W=W,
            fx=fx, fy=fy, cx=cx, cy=cy, cam_lr=0.01, separate_lr=False,
            use_exposure=False, w_color=0.5, use_color=True,
            handle_dynamic=handle_dynamic, mesh=mesh)
        return best_cam, losses
    finally:
        if mesh is not None:
            mesh.close()


@pytest.mark.parametrize("handle_dynamic", [True, False],
                         ids=["mean_residual", "median_residual"])
def test_track_frame_dp2_matches_single_device(rng, tmp_path,
                                               handle_dynamic):
    params, cfg, level, depth, cam = _corner_inputs(rng)
    cam1, l1 = _track(params, cfg, level, depth, cam, handle_dynamic, None)
    outs = run_ranks(tmp_path, 2, _track, params, cfg, level, depth, cam,
                     handle_dynamic, "dp2")
    assert np.isfinite(l1.numpy()).all() and l1.shape == (16,)
    for cam2, l2 in outs:
        np.testing.assert_allclose(l2[0].numpy(), l1[0].numpy(), rtol=1e-4)
        np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=0.03,
                                   atol=1e-3)
        np.testing.assert_allclose(cam2.numpy(), cam1.numpy(), atol=0.02)
        assert abs(float(l2.min()) - float(l1.min())) / float(l1.min()) \
            < 0.03
    assert torch.equal(outs[0][0], outs[1][0])
