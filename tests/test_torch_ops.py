"""L0 ops of the PyTorch port against hpslam_tpu on identical inputs (CPU).

Tolerances: float32 on both sides; where the two frameworks order a sum
differently the bound is a few ulp of the values' scale (stated per test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.ops import composite as jC
from hpslam_tpu.ops import geometry as jG
from hpslam_tpu.ops import interpolate as jIT
from hpslam_tpu.ops import optim as jOpt
from hpslam_tpu.ops import sampling as jS
from hpslam_tpu_torch.ops import composite as tC
from hpslam_tpu_torch.ops import geometry as tG
from hpslam_tpu_torch.ops import interpolate as tIT
from hpslam_tpu_torch.ops import optim as tOpt
from hpslam_tpu_torch.ops import sampling as tS


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads per test: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.tensor(np.array(a))


def test_rays_and_camera_tensor(rng):
    cam = np.concatenate([rng.normal(size=4), rng.normal(size=3)]
                         ).astype(np.float32)
    R_j = np.asarray(jG.get_camera_from_tensor(jnp.asarray(cam)))
    R_t = tG.get_camera_from_tensor(T(cam)).numpy()
    np.testing.assert_allclose(R_t, R_j, rtol=1e-6, atol=1e-6)
    i = rng.uniform(0, 63, 50).astype(np.float32)
    j = rng.uniform(0, 47, 50).astype(np.float32)
    ro_j, rd_j = jG.get_rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                                     jnp.asarray(R_j), 40.0, 41.0, 31.5, 23.5)
    ro_t, rd_t = tG.get_rays_from_uv(T(i), T(j), T(R_j), 40.0, 41.0, 31.5,
                                     23.5)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j))
    # numpy twins are the same code on both sides
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :] = R_j
    np.testing.assert_allclose(tG.get_tensor_from_camera_np(c2w),
                               jG.get_tensor_from_camera_np(c2w))


def test_quad2rotation_grad_matches(rng):
    q = rng.normal(size=(6, 4)).astype(np.float32)
    g_j = jax.grad(lambda x: jnp.sum(jnp.sin(jG.quad2rotation(x))))(
        jnp.asarray(q))
    qt = T(q).requires_grad_()
    torch.sum(torch.sin(tG.quad2rotation(qt))).backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)


def test_project_points(rng):
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.2, -3.0]
    uv_j, z_j = jG.project_points(jnp.asarray(pts), jnp.asarray(w2c), 40.0,
                                  40.0, 31.5, 23.5)
    uv_t, z_t = tG.project_points(T(pts), T(w2c), 40.0, 40.0, 31.5, 23.5)
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6)


@pytest.mark.parametrize("fix_interval", [False, True])
def test_surface_z_vals(rng, fix_interval):
    d = rng.uniform(0.5, 4.0, 30).astype(np.float32)
    zj = jS.surface_z_vals(jnp.asarray(d), 5, 0.96, 1.04, fix_interval)
    zt = tS.surface_z_vals(T(d), 5, 0.96, 1.04, fix_interval)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6,
                               atol=1e-7)


def test_sample_pdf_with_given_uniforms(rng):
    bins = np.sort(rng.uniform(0, 5, (8, 11)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, (8, 10)).astype(np.float32)
    # jax draws its own uniforms; det=True passes the same linspace to both
    zj = jS.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 16, det=True)
    u = torch.linspace(0.0, 1.0, 16).expand(8, 16)
    zt = tS.sample_pdf(T(bins), T(w), u)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5,
                               atol=1e-5)
    far_j = jS.far_bound_from_depth(jnp.asarray(w[0]))
    np.testing.assert_allclose(float(tS.far_bound_from_depth(T(w[0]))),
                               float(far_j), rtol=1e-6)


def test_raw2outputs_occupancy(rng):
    raw = rng.normal(0, 20, (64, 5, 4)).astype(np.float32)
    z = np.sort(rng.uniform(1, 3, (64, 5)), 1).astype(np.float32)
    rd = rng.normal(size=(64, 3)).astype(np.float32)
    outs_j = jC.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                            occupancy=True, coef=0.1)
    outs_t = tC.raw2outputs(T(raw), T(z), T(rd), occupancy=True, coef=0.1)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=2e-6)


def test_adam_matches_reference_over_steps(rng):
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}
    pj = jax.tree.map(jnp.asarray, p)
    pt = {"a": T(p["a"]), "b": {"c": T(p["b"]["c"])}}
    sj, st = jOpt.init(pj), tOpt.init(pt)
    for step in range(6):
        g = {"a": rng.normal(size=(5, 3)).astype(np.float32),
             "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}
        lr_j = {"a": jnp.asarray(0.01 * (step + 1)),
                "b": jax.tree.map(lambda _: jnp.asarray(0.003), pj["b"])}
        lr_t = {"a": 0.01 * (step + 1), "b": 0.003}
        pj, sj = jOpt.update(jax.tree.map(jnp.asarray, g), sj, pj, lr_j)
        pt, st = tOpt.update({"a": T(g["a"]), "b": {"c": T(g["b"]["c"])}},
                             st, pt, lr_t)
    np.testing.assert_allclose(pt["a"].numpy(), np.asarray(pj["a"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt["b"]["c"].numpy(),
                               np.asarray(pj["b"]["c"]), rtol=1e-6,
                               atol=1e-7)
    assert st["t"] == int(sj["t"])


@pytest.mark.parametrize("diff_pos", [False, True])
def test_interp_weights(rng, diff_pos):
    Q, k = 40, 8
    cloud = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    p = rng.uniform(-1, 1, (Q, 3)).astype(np.float32)
    I = rng.integers(0, 200, (Q, k))
    D = np.sum((cloud[I] - p[:, None]) ** 2, -1).astype(np.float32)
    rq = rng.uniform(0.3, 0.9, Q).astype(np.float32)
    wj, hj = jIT.interp_weights(jnp.asarray(D), jnp.asarray(I),
                                jnp.asarray(p), jnp.asarray(cloud),
                                jnp.asarray(rq), 2, "distance", diff_pos)
    wt, ht = tIT.interp_weights(T(D), T(I), T(p), T(cloud), T(rq), 2,
                                "distance", diff_pos)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)


def test_gathers_and_their_gradients(rng):
    Q, k, C, N = 30, 8, 6, 50
    feats = rng.normal(size=(N, C)).astype(np.float32)
    I = rng.integers(0, N, (Q, k))
    w = rng.uniform(size=(Q, k, 1)).astype(np.float32)
    dc = rng.normal(size=(Q, C)).astype(np.float32)

    def lj(f, ww):
        return jnp.sum(jIT._interp_gather(f, jnp.asarray(I), ww) * dc)
    gj = jax.grad(lj, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    ft, wt = T(feats).requires_grad_(), T(w).requires_grad_()
    torch.sum(tIT.interp_gather(ft, T(I), wt) * T(dc)).backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gj[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj[1]),
                               rtol=1e-5, atol=1e-5)
    # union gather
    n, S, u = 12, 5, 4
    uids = rng.integers(0, N, (n, u))
    Wm = rng.uniform(size=(n, S, u)).astype(np.float32)
    dC = rng.normal(size=(n, S, C)).astype(np.float32)

    def luj(f, W_):
        return jnp.sum(jIT.union_gather(f, jnp.asarray(uids), W_) * dC)
    gj = jax.grad(luj, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(Wm))
    ft, Wt = T(feats).requires_grad_(), T(Wm).requires_grad_()
    out = tIT.union_gather(ft, T(uids), Wt)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jIT.union_gather(jnp.asarray(feats), jnp.asarray(uids),
                                    jnp.asarray(Wm))), rtol=1e-5, atol=1e-6)
    torch.sum(out * T(dC)).backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gj[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Wt.grad.numpy(), np.asarray(gj[1]),
                               rtol=1e-5, atol=1e-5)


def test_union_slots(rng):
    R, S, k, u_max = 16, 5, 8, 8
    ids = rng.integers(0, 30, (R, S * k)).astype(np.int32)
    w = rng.uniform(size=(R, S * k)).astype(np.float32)
    w[3] = 0.0                       # all-zero row: sentinel padding
    uj, Lj = jax.vmap(lambda a, b: jIT.union_slots(a, b, u_max, 999))(
        jnp.asarray(ids), jnp.asarray(w))
    ut, Lt = tIT.union_slots(T(ids).long(), T(w), u_max, 999)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(Lt.numpy(), np.asarray(Lj))
