"""The port's tensor pose helpers and pixel samplers against hpslam_tpu's,
on the CPU, on inputs made from a numpy seed (float32 on both sides).

Tolerances: values to atol 1e-6 (masked_psnr 1e-5, in dB), gradients to
atol 1e-5; rotation2quad also against scipy at atol 1e-6, as
tests/test_geometry.py holds the reference; flat_to_ij exactly.
sample_indices draws from a torch.Generator, and jax.random cannot be
reproduced, so its test holds the semantics: every index comes from the
pool, one generator state gives one draw, and over 10^5 draws each pool
entry's count lies within 5 sigma of the uniform expectation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.ops import geometry as jG
from hpslam_tpu.ops import sampling as jS
from hpslam_tpu_torch.ops import geometry as tG
from hpslam_tpu_torch.ops import sampling as tS

ATOL = 1e-6
GRAD_ATOL = 1e-5


def random_rotation(rng):
    A = rng.normal(size=(3, 3))
    Q, R = np.linalg.qr(A)
    Q *= np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def rotations(rng, n=24):
    """Random rotations and ones that take each of Shepperd's four
    branches: the identity (trace), and half turns about x, y and z (the
    largest diagonal entry)."""
    out = [random_rotation(rng) for _ in range(n)]
    out += [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
            np.diag([-1.0, -1.0, 1.0])]
    small = 0.3
    for axis in range(3):      # near-half turns, off the exact diagonal
        a = np.pi - small
        c, s = np.cos(a), np.sin(a)
        R = np.eye(3)
        i, j = [k for k in range(3) if k != axis]
        R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
        out.append(R)
    return np.stack(out).astype(np.float32)


def test_as_intrinsics_matrix():
    intr = (577.590698, 578.729797, 318.905426, 242.683609)
    K = tG.as_intrinsics_matrix(intr)
    np.testing.assert_array_equal(K, jG.as_intrinsics_matrix(intr))
    assert K.dtype == np.float64


def test_rotation2quad_matches_reference_and_scipy(rng):
    from scipy.spatial.transform import Rotation
    Rs = rotations(rng)
    qt = tG.rotation2quad(torch.tensor(Rs)).numpy()
    qj = np.asarray(jG.rotation2quad(jnp.asarray(Rs)))
    np.testing.assert_allclose(qt, qj, atol=ATOL)
    # one at a time (the reference's unbatched use) as well
    for R in Rs[:4]:
        np.testing.assert_allclose(
            tG.rotation2quad(torch.tensor(R)).numpy(),
            np.asarray(jG.rotation2quad(jnp.asarray(R))), atol=ATOL)
    for R, q in zip(Rs, qt):
        q_ref = np.roll(Rotation.from_matrix(R.astype(np.float64)).as_quat(),
                        1)
        if q_ref[0] < 0:
            q_ref = -q_ref
        if abs(q_ref[0]) < 1e-6:     # half turn: the sign is a gauge
            q_ref = q_ref * np.sign(np.dot(q_ref, q))
        np.testing.assert_allclose(q, q_ref, atol=ATOL)
    # the round trip through the port's quad2rotation
    np.testing.assert_allclose(
        tG.quad2rotation(torch.tensor(qt)).numpy(), Rs, atol=1e-5)


def test_rotation2quad_gradient(rng):
    Rs = rotations(rng, n=6)
    w = rng.normal(size=(Rs.shape[0], 4)).astype(np.float32)
    gj = jax.grad(lambda R: jnp.sum(jG.rotation2quad(R) * w))(
        jnp.asarray(Rs))
    Rt = torch.tensor(Rs, requires_grad=True)
    (tG.rotation2quad(Rt) * torch.tensor(w)).sum().backward()
    assert np.isfinite(Rt.grad.numpy()).all()
    np.testing.assert_allclose(Rt.grad.numpy(), np.asarray(gj),
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("tquad", [False, True])
@pytest.mark.parametrize("rows", [3, 4])
def test_get_tensor_from_camera(rng, tquad, rows):
    RT = np.eye(4, dtype=np.float32)
    RT[:3, :3] = random_rotation(rng)
    RT[:3, 3] = rng.normal(size=3)
    RT = RT[:rows]
    vt = tG.get_tensor_from_camera(torch.tensor(RT), Tquad=tquad)
    vj = jG.get_tensor_from_camera(jnp.asarray(RT), Tquad=tquad)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    q = vt[3:] if tquad else vt[:4]
    t = vt[:3] if tquad else vt[4:]
    back = tG.get_camera_from_tensor(torch.cat([q, t]))
    np.testing.assert_allclose(back.numpy(), RT[:3], atol=1e-5)
    # differentiable in the pose, as the reference
    RTt = torch.tensor(RT, requires_grad=True)
    tG.get_tensor_from_camera(RTt, Tquad=tquad).sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jG.get_tensor_from_camera(
        a, Tquad=tquad)))(jnp.asarray(RT))
    np.testing.assert_allclose(RTt.grad.numpy(), np.asarray(gj),
                               atol=GRAD_ATOL)


def test_c2w_to_44_and_transform_points(rng):
    c2w = np.concatenate([random_rotation(rng), rng.normal(size=(3, 1))],
                         1).astype(np.float32)
    T44t = tG.c2w_to_44(torch.tensor(c2w))
    T44j = jG.c2w_to_44(jnp.asarray(c2w))
    np.testing.assert_array_equal(T44t.numpy(), np.asarray(T44j))
    assert T44t.dtype == torch.float32
    pts = rng.normal(size=(257, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tG.transform_points(T44t, torch.tensor(pts)).numpy(),
        np.asarray(jG.transform_points(T44j, jnp.asarray(pts))), atol=ATOL)
    ptt = torch.tensor(pts, requires_grad=True)
    Tt = T44t.clone().requires_grad_()
    tG.transform_points(Tt, ptt).square().sum().backward()
    gT, gp = jax.grad(
        lambda T, p: jnp.sum(jG.transform_points(T, p) ** 2),
        argnums=(0, 1))(T44j, jnp.asarray(pts))
    np.testing.assert_allclose(Tt.grad.numpy(), np.asarray(gT),
                               atol=GRAD_ATOL, rtol=1e-5)
    np.testing.assert_allclose(ptt.grad.numpy(), np.asarray(gp),
                               atol=GRAD_ATOL)


def test_cart2sph(rng):
    n = rng.normal(size=(300, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    # the poles and the axes (atan2's edge cases)
    n[:6] = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0],
                      [0, 1, 0], [0, -1, 0]], np.float32)
    st = tG.cart2sph(torch.tensor(n))
    np.testing.assert_allclose(st.numpy(),
                               np.asarray(jG.cart2sph(jnp.asarray(n))),
                               atol=ATOL)
    nt = torch.tensor(n[6:], requires_grad=True)
    tG.cart2sph(nt).sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jG.cart2sph(a)))(jnp.asarray(n[6:]))
    np.testing.assert_allclose(nt.grad.numpy(), np.asarray(gj),
                               atol=GRAD_ATOL, rtol=1e-5)


def test_masked_psnr(rng):
    a = rng.uniform(size=(24, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(24, 32)) > 0.3
    pt = tG.masked_psnr(torch.tensor(a), torch.tensor(b), torch.tensor(mask))
    pj = jG.masked_psnr(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    np.testing.assert_allclose(float(pt), float(pj), atol=1e-5)
    # identical images: the reference's 100 dB
    assert float(tG.masked_psnr(torch.tensor(a), torch.tensor(a),
                                torch.tensor(mask))) == 100.0
    at = torch.tensor(a, requires_grad=True)
    tG.masked_psnr(at, torch.tensor(b), torch.tensor(mask)).backward()
    gj = jax.grad(lambda x: jG.masked_psnr(x, jnp.asarray(b),
                                           jnp.asarray(mask)))(jnp.asarray(a))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(gj),
                               atol=GRAD_ATOL)


def test_flat_to_ij(rng):
    W = 37
    flat = rng.integers(0, 29 * W, size=500)
    it, jt = tS.flat_to_ij(torch.tensor(flat), W)
    ij, jj = jS.flat_to_ij(jnp.asarray(flat, jnp.int32), W)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(jt.numpy(), np.asarray(jj))


def test_sample_indices_semantics(rng):
    pool_np = np.sort(rng.choice(5000, size=40, replace=False))
    pool = torch.tensor(pool_np)
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    n = 100_000
    a = tS.sample_indices(gen, pool, n)
    assert a.shape == (n,) and a.dtype == pool.dtype
    assert np.isin(a.numpy(), pool_np).all()
    gen.set_state(state)
    b = tS.sample_indices(gen, pool, n)
    assert torch.equal(a, b)
    # the reference's draw lies in the pool too
    j = np.asarray(jS.sample_indices(jax.random.PRNGKey(0),
                                     jnp.asarray(pool_np), 1000))
    assert np.isin(j, pool_np).all()
    # uniform over the pool: each entry's count within 5 sigma
    counts = np.array([(a.numpy() == v).sum() for v in pool_np])
    p = 1.0 / len(pool_np)
    sigma = np.sqrt(n * p * (1 - p))
    assert np.abs(counts - n * p).max() < 5 * sigma, counts
