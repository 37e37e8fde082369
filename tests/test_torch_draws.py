"""The port's own random draws in distribution (the lockstep tests hand
the reference's draws over, so they never hold these): the tracker's pixel
draws (ops.sampling.sample_indices, as tracker.track_frame calls it; the
reference's tracker.py stage_inputs), the union cache's pixel draws
(mapper.draw_cache_pixels; the reference's build_pixel_union_cache /
build_pixel_knn_cache frame draws) and the mapper's ray slots (mapper.
optimise; the reference's map_scan).  Over many draws from a fixed pool
each has the reference's support (the same set of values, the whole pool)
and uniform frequencies: a chi-square test at p > P_MIN, the seeds fixed,
for the port's draws and for the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.stats import chisquare

from hpslam_tpu_torch import mapper as tM
from hpslam_tpu_torch.ops import image as IM
from hpslam_tpu_torch.ops import optim as Opt
from hpslam_tpu_torch.ops import sampling as Samp

P_MIN = 1e-3
INT32_MAX = int(jnp.iinfo(jnp.int32).max)


def _pool(seed: int, H: int = 48, W: int = 64, holes: float = 0.3):
    """A valid-pixel pool (flat ids of positive depth) of a depth map with
    holes, as the engines build it."""
    depth = np.random.default_rng(seed).uniform(0.5, 4.0, (H, W))
    depth[np.random.default_rng(seed + 1).uniform(size=(H, W)) < holes] = 0
    return IM.valid_pixel_pool(depth.astype(np.float32), 0, H, 0, W)


def _uniform_over(draws, support):
    """The draws' values are the support, each value's count uniform."""
    values, counts = np.unique(np.asarray(draws), return_counts=True)
    np.testing.assert_array_equal(values, np.sort(np.asarray(support)))
    p = chisquare(counts).pvalue
    assert p > P_MIN, p
    return p


def test_tracker_pixel_draws_uniform_over_the_pool():
    """The tracker's draws (a pool padded to H*W, its first pool_len
    entries valid): the port's sample_indices on pool[:pool_len] and the
    reference's pool[randint(k, (pixels,), 0, pool_len)] over 60 draws of
    2000 pixels."""
    pool = _pool(0)
    n = len(pool)
    padded = np.zeros(48 * 64, np.int64)
    padded[:n] = pool
    gen = torch.Generator().manual_seed(0)
    port = torch.cat([Samp.sample_indices(gen, torch.as_tensor(padded)[:n],
                                          2000) for _ in range(60)])
    ref = np.concatenate([np.asarray(jnp.asarray(padded)[jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(0), s), (2000,), 0, n)])
        for s in range(60)])
    _uniform_over(port.numpy(), pool)
    _uniform_over(ref, pool)


def test_cache_pixel_draws_uniform_over_each_frame_pool():
    """The union cache's draws over a window of frames with pools of
    different lengths: the port's draw_cache_pixels and the reference's
    pools[f, randint(k_f, (P,), 0, int32 max) % pool_lens[f]], each frame
    uniform over its own pool."""
    pools = [_pool(s, holes=h) for s, h in ((1, 0.1), (2, 0.3), (3, 0.6))]
    F, HW, P = len(pools), 48 * 64, 60000
    padded = np.zeros((F, HW), np.int64)
    lens = np.array([len(p) for p in pools])
    for f, p in enumerate(pools):
        padded[f, :len(p)] = p
    port = tM.draw_cache_pixels(torch.Generator().manual_seed(0),
                                torch.as_tensor(padded),
                                torch.as_tensor(lens), P).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), F)
    for f in range(F):
        r = np.asarray(jax.random.randint(keys[f], (P,), 0, INT32_MAX))
        _uniform_over(port[f], pools[f])
        _uniform_over(padded[f, r % lens[f]], pools[f])


def test_mapper_ray_slots_uniform_over_the_cache():
    """The mapper's ray slots: mapper.optimise's draws of n_rays cache
    slots an iteration (recorded through its stage loss) and the
    reference's randint(k_it, (n_rays,), 0, P) over the same count,
    uniform over range(P)."""
    P, n_rays, iters = 500, 400, 250
    slots = []

    def stage_loss(op, fid, slot, with_color):
        slots.append(slot.clone())
        loss = (op["x"] ** 2).sum()
        return loss, loss, torch.zeros(())

    params = {"x": torch.ones(3)}
    tM.optimise(stage_loss, lambda op, row: {"x": 0.0}, params,
                Opt.init(params), torch.Generator().manual_seed(0),
                np.zeros((iters, 4), np.float32), 0, n_rays, P, 1)
    assert len(slots) == iters
    ref = np.concatenate([np.asarray(jax.random.randint(k, (n_rays,), 0, P))
                          for k in jax.random.split(jax.random.PRNGKey(0),
                                                    iters)])
    _uniform_over(torch.cat(slots).numpy(), np.arange(P))
    _uniform_over(ref, np.arange(P))

