"""A run with the timed path broken underneath comes out not correct:
faults planted in the program, the run driven on the CPU at a tiny size
(the check for a chip skipped).  One chip: no exchange to leave out."""
import numpy as np
import pytest

from benchmark.tests import tiny as T


def _state_unchanged(mp):
    import hpslam_tpu_torch.ops.optim as O
    mp.setattr(O, "update", lambda grads, state, params, lr, **kw:
               (params, dict(state, t=state["t"] + 1)))


def _half_batch(mp):
    import hpslam_tpu_torch.ops.sampling as Samp
    orig = Samp.sample_indices

    def half(gen, pool, n):
        ids = orig(gen, pool, n)
        return ids[:n // 2].repeat(2)[:n]
    mp.setattr(Samp, "sample_indices", half)


def _pose_altered(mp):
    import hpslam_tpu_torch.tracker as Tr
    orig = Tr.Tracker.track

    def moved(self, *a, **kw):
        c2w, info, op = orig(self, *a, **kw)
        if not info.get("skipped"):
            c2w = np.array(c2w)
            c2w[0, 3] += 0.01
        return c2w, info, op
    mp.setattr(Tr.Tracker, "track", moved)


def _points_altered(mp):
    import hpslam_tpu_torch.state as St
    orig = St.ray_points
    mp.setattr(St, "ray_points", lambda o, d, z: orig(o, d, z) + 1e-3)


def _writeback_skipped(mp):
    import hpslam_tpu_torch.state as St
    mp.setattr(St.NeuralPointCloud, "scatter_feats",
               lambda self, idx, geo, col, level: None)


def _fine_unchanged(mp):
    import hpslam_tpu_torch.state as St
    orig = St.NeuralPointCloud.scatter_feats

    def scatter(self, idx, geo, col, level):
        if level != "fine":
            orig(self, idx, geo, col, level)
    mp.setattr(St.NeuralPointCloud, "scatter_feats", scatter)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _pose_altered, _points_altered,
                                   _writeback_skipped, _fine_unchanged])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = T.run_tiny("scannet.explore")
    assert r["correct"] is False, r["checks"]
