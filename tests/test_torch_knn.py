"""kNN of the PyTorch port against hpslam_tpu (CPU).

The row-top-k's plain version must equal the Pallas kernel (interpret mode)
bit for bit: both select existing floats under the same first-occurrence
tie rule.  The tile index must equal the reference's packed rows exactly.
Tile selection narrows by a different (deterministic) rule than XLA's
approx_min_k, so kNN results are judged on distances and recall against
the exact oracle, as tests/test_knn.py judges the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.ops import knn as jK
from hpslam_tpu_torch.ops import knn as tK


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads per test: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _topk_input(rng, n, C):
    x = rng.uniform(0, 1, (n, C)).astype(np.float32)
    x[::7, 10] = x[::7, 3]          # exact ties across columns
    x[5] = jK.BIG                   # fully-masked row
    x[6, C // 5:] = jK.BIG          # partially-masked row
    x[8] = 3e12                     # above BIG: masked picks win again
    x[9, :4] = 0.25                 # tie at the minimum
    return x


@pytest.mark.parametrize("n,C,k", [(100, 256, 8), (37, 40, 8),
                                   (64, 512, 1), (29, 32, 12)])
def test_plain_topk_matches_pallas_kernel(rng, n, C, k):
    x = _topk_input(rng, n, C)
    ids = rng.integers(0, 1 << 22, (n, C)).astype(np.int32)
    Dp, sp = jK._pl_topk(jnp.asarray(x), None, k, interpret=True)
    Dt, st = tK.topk_rows(torch.tensor(x), None, k)
    np.testing.assert_array_equal(Dt.numpy(), np.asarray(Dp))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sp))
    Dp2, vp = jK._pl_topk(jnp.asarray(x), jK.pack_ids(jnp.asarray(ids)), k,
                          interpret=True)
    Dt2, vt = tK.topk_rows(torch.tensor(x),
                           tK.pack_ids(torch.tensor(ids)), k)
    np.testing.assert_array_equal(Dt2.numpy(), np.asarray(Dp2))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vp))
    # and the XLA-path argmin passes (topk_extract)
    De, Ie = jK.topk_extract(jnp.asarray(x), k)
    Dt3, It3 = tK.topk_extract(torch.tensor(x), k)
    np.testing.assert_array_equal(Dt3.numpy(), np.asarray(De))
    np.testing.assert_array_equal(It3.numpy(), np.asarray(Ie))


def _wall_cloud(rng, n_cap, n):
    xs = rng.uniform(-1.5, 1.5, n)
    ys = rng.uniform(-1.2, 1.2, n)
    zs = -2.0 + 0.02 * rng.normal(size=n)
    pts = np.zeros((n_cap, 3), np.float32)
    pts[:n] = np.stack([xs, ys, zs], -1)
    return pts


@pytest.mark.parametrize("n_cap,count,tile", [(4096, 3000, 128),
                                              (2048, 2048, 128),
                                              (8192, 5000, 256)])
def test_build_tiles_matches_reference(rng, n_cap, count, tile):
    pts = _wall_cloud(rng, n_cap, count)
    pj, loj, hij = jK.build_tiles(jnp.asarray(pts), jnp.int32(count),
                                  tile=tile)
    pt, lot, hit = tK.build_tiles(torch.tensor(pts), count, tile=tile)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(lot.numpy(), np.asarray(loj))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hij))


@pytest.mark.parametrize("n_cap,count,probe", [(8192, 6000, 12),
                                               (65536, 60000, 12),
                                               (65536, 60000, 32),
                                               (524288, 300000, 12)])
def test_knn_tiles_distances_and_recall(rng, n_cap, count, probe):
    """T = 64 tiles takes the exact selection; T = 512 the bin narrowing;
    T = 4096 the narrowing at the benchmark's fine capacity (2^19, 300,000
    points)."""
    pts = _wall_cloud(rng, n_cap, count)
    q = _wall_cloud(rng, 600, 600)[:, :] + rng.normal(
        0, 0.02, (600, 3)).astype(np.float32)
    k = 8 if probe == 12 else 1
    idx_t = tK.build_tiles(torch.tensor(pts), count)
    Dt, It = tK.knn_tiles(torch.tensor(q), *idx_t, k=k, probe=probe)
    Do, Io = tK.knn(torch.tensor(q), torch.tensor(pts), count, k=k)
    Dj, Ij = jK.knn_tiles(jnp.asarray(q),
                          *jK.build_tiles(jnp.asarray(pts), jnp.int32(count)),
                          k=k, probe=probe)
    Dt, It, Do = Dt.numpy(), It.numpy(), Do.numpy()
    assert It.max() < count
    # returned distances are the true distances of the returned ids
    d_true = np.sum((pts[It] - q[:, None]) ** 2, -1)
    np.testing.assert_allclose(Dt, d_true, rtol=1e-5, atol=1e-9)
    # recall against the exact oracle, as good as the reference's
    rec_t = np.mean([len(set(a) & set(b)) / k for a, b in zip(It, Io.numpy())])
    rec_j = np.mean([len(set(a) & set(b)) / k
                     for a, b in zip(np.asarray(Ij), Io.numpy())])
    assert rec_t >= min(0.98, rec_j - 0.01), (rec_t, rec_j)
    # where the reference and the port found the same ids, distances agree
    same = It == np.asarray(Ij)
    np.testing.assert_allclose(Dt[same], np.asarray(Dj)[same], rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("n_cap,count,probe", [(2048, 1600, 16),
                                               (8192, 300, 12),
                                               (65536, 1000, 16)])
def test_knn_tiles_fewer_filled_tiles_than_probe(rng, n_cap, count, probe):
    """With fewer tiles holding points than ``probe`` (early in a run, or
    the small mapping fixtures), every tile is searched once: no neighbour
    repeats, and the result is the exact one; below 512 tiles (the exact
    tile selection in both packages) the reference's too."""
    pts = _wall_cloud(rng, n_cap, count)
    q = pts[rng.integers(0, count, 300)] + rng.normal(
        0, 0.05, (300, 3)).astype(np.float32)
    Dt, It = tK.knn_tiles(torch.tensor(q), *tK.build_tiles(
        torch.tensor(pts), count), k=8, probe=probe)
    Do, Io = tK.knn(torch.tensor(q), torch.tensor(pts), count, k=8)
    Dj, _ = jK.knn_tiles(jnp.asarray(q),
                         *jK.build_tiles(jnp.asarray(pts), jnp.int32(count)),
                         k=8, probe=probe)
    assert all(len(set(r)) == 8 for r in It.numpy())
    np.testing.assert_allclose(Dt.numpy(), Do.numpy(), rtol=1e-6, atol=1e-9)
    if n_cap // 128 < tK.NARROW_MIN_TILES:
        np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=1e-6,
                                   atol=1e-9)


def test_knn_exact_matches_reference(rng):
    pts = _wall_cloud(rng, 1024, 700)
    q = rng.uniform(-1.5, 1.5, (90, 3)).astype(np.float32)
    Dj, Ij = jK.knn(jnp.asarray(q), jnp.asarray(pts), jnp.int32(700), k=8)
    Dt, It = tK.knn(torch.tensor(q), torch.tensor(pts), 700, k=8)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=1e-4,
                               atol=1e-5)
    rec = np.mean(It.numpy() == np.asarray(Ij))
    assert rec > 0.99
    # fewer valid points than k: BIG distances and id 0
    Dt2, It2 = tK.knn(torch.tensor(q[:5]), torch.tensor(pts), 3, k=8)
    assert (Dt2[:, 3:] >= tK.BIG).all() and (It2[:, 3:] == 0).all()
    counts = tK.neighbor_counts(Dt, torch.full((90,), 0.2))
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jK.neighbor_counts(Dj, jnp.full((90,),
                                                                   0.2))))


def test_pack_ids_roundtrip():
    ids = torch.tensor([0, 1, 7, (1 << 24) - 1])
    assert torch.equal(tK.unpack_ids(tK.pack_ids(ids)), ids)


def test_cuda_wrapper_refuses_bad_input():
    with pytest.raises(ValueError):
        tK.topk_rows(torch.zeros((4, 3), dtype=torch.float64), None, 2)
    with pytest.raises(ValueError):
        tK.topk_rows(torch.zeros((4, 3)), None, 4)
