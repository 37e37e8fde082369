"""The port's native runtime loader (hpslam_tpu_torch.native) on the CPU.

It builds native/hpslam_native.cpp with native/Makefile's flags into its
own build directory and never writes into native/; each binding gives the
hpslam_tpu bindings' results bit for bit on the same inputs (one source,
one compiler, the same flags); and tests/test_native.py's four tests run
on the port's bindings.
"""
import os

import numpy as np
import pytest

from hpslam_tpu import native as jN
from hpslam_tpu_torch import native as tN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")


def _listing(d):
    """native/'s files and their mtimes; the reference loader's own build
    product is listed without its mtime, since another test process may
    rebuild it meanwhile (the port's library has another name)."""
    return {f: (None if f == "libhpslam_native.so" else
                os.stat(os.path.join(d, f)).st_mtime_ns)
            for f in sorted(os.listdir(d))}


def test_loader_builds_into_its_own_dir(tmp_path, monkeypatch):
    jN._load()                       # the reference's own build, if due
    before = _listing(NATIVE)
    build = tmp_path / "build" / "native"
    monkeypatch.setenv("HPSLAM_NATIVE_BUILD", str(build))
    monkeypatch.setattr(tN, "_lib", None)
    lib = tN._load()
    assert lib is not None
    built = os.listdir(build)
    assert len(built) == 1 and built[0].startswith("libhpslam_native_") \
        and built[0].endswith(".so")
    assert _listing(NATIVE) == before
    # a second load serves the hashed file, it does not rebuild
    mtime = os.stat(build / built[0]).st_mtime_ns
    monkeypatch.setattr(tN, "_lib", None)
    tN._load()
    assert os.stat(build / built[0]).st_mtime_ns == mtime
    assert os.listdir(build) == built


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setenv("HPSLAM_NATIVE_BUILD", str(tmp_path / "b"))
    monkeypatch.setattr(tN, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="native build failed"):
        tN.build()


def _room(rng, n=3000):
    pts = []
    for axis in range(3):
        p = rng.uniform(-1, 1, (n // 3, 3))
        p[:, axis] = -1.0 + 0.05 * np.sin(3 * p[:, (axis + 1) % 3])
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def _sphere_frames():
    H, W, fx, cx, cy = 60, 80, 60.0, 39.5, 29.5
    center = np.array([0, 0, 1.0])
    for ang in (0.0, 0.9):
        cs, sn = np.cos(ang), np.sin(ang)
        Rw = np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]])
        cam_pos = center - Rw @ np.array([0, 0, 1.0])
        w2c = np.eye(4)
        w2c[:3, :3] = Rw.T
        w2c[:3, 3] = -Rw.T @ cam_pos
        jj, ii = np.mgrid[0:H, 0:W]
        rd = np.stack([(ii - cx) / fx, (jj - cy) / fx,
                       np.ones_like(ii, float)], -1) @ Rw.T
        oc = cam_pos - center
        a = np.einsum("hwc,hwc->hw", rd, rd)
        b = np.einsum("hwc,c->hw", rd, oc)
        disc = b * b - a * (oc @ oc - 0.16)
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / a, 0)
        col = np.stack([t / 2, 0.5 * np.ones_like(t), 1 - t / 2], -1)
        yield (np.maximum(t, 0).astype(np.float32), col.astype(np.float32),
               (fx, fx, cx, cy), w2c.astype(np.float32))


def _run(mod, what, rng):
    if what == "tsdf":
        vol = mod.TSDFVolume(0.02, 0.08)
        for depth, col, intr, w2c in _sphere_frames():
            vol.integrate(depth, col, intr, w2c, 5.0)
        return vol.extract_mesh()
    pts = _room(rng)
    q = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    if what == "kdtree":
        t = mod.KDTree(pts)
        return t.nearest(q) + t.knn(q, 7)
    if what == "normals":
        return (mod.estimate_normals(pts, k=20),
                mod.estimate_normals(pts, k=12, viewpoint=np.zeros(3)))
    nrm = mod.estimate_normals(pts, k=20, viewpoint=np.zeros(3))
    R = np.array([[np.cos(0.05), -np.sin(0.05), 0],
                  [np.sin(0.05), np.cos(0.05), 0], [0, 0, 1]], np.float32)
    src = (pts @ R.T + [0.05, -0.03, 0.02]).astype(np.float32)
    if what == "icp":
        return mod.icp_point_to_plane(src, pts, nrm, 0.2, max_iter=50)
    if what == "fpfh":
        sn = mod.estimate_normals(src, k=20, viewpoint=np.zeros(3))
        return mod.fpfh_ransac_register(src, sn, pts, nrm, 0.25, 0.06,
                                        max_iter=3000, seed=7)
    if what == "raycast":
        from hpslam_tpu.tools.make_synth_gt_mesh import box_mesh
        v, f = box_mesh(2.5, 8)
        ro = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
        rd = rng.normal(size=(500, 3)).astype(np.float32)
        return (mod.MeshRaycaster(v, f).cast(ro, rd),)
    raise ValueError(what)


@pytest.mark.parametrize("what", ["tsdf", "kdtree", "normals", "icp", "fpfh",
                                  "raycast"])
def test_bindings_match_reference_bitwise(what):
    a = _run(tN, what, np.random.default_rng(5))
    b = _run(jN, what, np.random.default_rng(5))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, float):
            assert x == y or (np.isnan(x) and np.isnan(y)), what
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=what)
    if what == "tsdf":
        assert a[2].shape[0] > 500


# --- tests/test_native.py on the port's bindings -------------------------

def test_kdtree_matches_scipy(rng):
    from scipy.spatial import cKDTree
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    t = tN.KDTree(pts)
    _idx, d2 = t.nearest(q)
    dref, _ = cKDTree(pts).query(q)
    np.testing.assert_allclose(np.sqrt(d2), dref, atol=1e-4)
    _idxk, d2k = t.knn(q, 5)
    drefk, _ = cKDTree(pts).query(q, k=5)
    np.testing.assert_allclose(np.sqrt(d2k), drefk, atol=1e-4)


def test_tsdf_sphere_reconstruction():
    from tests.test_native import _sphere_depth
    vol = tN.TSDFVolume(voxel_size=0.02, sdf_trunc=0.08)
    H, W = 100, 120
    fx = fy = 100.0
    cx, cy = 59.5, 49.5
    center = np.array([0, 0, 1.0])
    for ang in [0.0, 0.7, -0.7, 2.2]:
        cs, sn = np.cos(ang), np.sin(ang)
        Rw = np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]])
        cam_pos = center - Rw @ np.array([0, 0, 1.0])
        w2c = np.eye(4)
        w2c[:3, :3] = Rw.T
        w2c[:3, 3] = -Rw.T @ cam_pos
        depth = _sphere_depth(H, W, fx, fy, cx, cy, cam_pos, Rw, center, 0.4)
        vol.integrate(depth, np.full((H, W, 3), 0.5, np.float32),
                      (fx, fy, cx, cy), w2c.astype(np.float32), 5.0)
    verts, cols, faces = vol.extract_mesh()
    assert verts.shape[0] > 500 and faces.shape[0] > 500
    r = np.linalg.norm(verts - center, axis=1)
    assert abs(r.mean() - 0.4) < 0.01
    assert r.std() < 0.01
    assert np.allclose(cols.mean(), 0.5, atol=0.05)


def test_icp_recovers_transform(rng):
    tgt = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    tgt[:, 2] = 0.1 * np.sin(3 * tgt[:, 0]) + 0.05 * tgt[:, 1]
    nrm = tN.estimate_normals(tgt, k=20,
                              viewpoint=np.array([0, 0, 10], np.float32))
    ang = 0.02
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                   [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    T_true = np.eye(4)
    T_true[:3, :3] = Rz
    T_true[:3, 3] = [0.04, -0.02, 0.01]
    src = ((tgt - T_true[:3, 3]) @ Rz).astype(np.float32)
    T, fit, _rmse = tN.icp_point_to_plane(src, tgt, nrm, max_corr_dist=0.3,
                                          max_iter=200)
    assert fit > 0.95
    aligned = src @ T[:3, :3].T + T[:3, 3]
    assert np.median(np.linalg.norm(aligned - tgt, axis=1)) < 5e-3


def test_fpfh_ransac_global_registration(rng):
    n = 4000
    t = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    w = rng.integers(0, 3, n)
    pts = np.zeros((n, 3), np.float32)
    bump = 0.15 * np.sin(3.0 * t[:, 0]) * np.cos(2.0 * t[:, 1])
    pts[w == 0] = np.stack([t[w == 0, 0], t[w == 0, 1],
                            -1.5 + bump[w == 0]], -1)
    pts[w == 1] = np.stack([t[w == 1, 0], -1.5 + bump[w == 1],
                            t[w == 1, 1]], -1)
    pts[w == 2] = np.stack([-1.5 + bump[w == 2], t[w == 2, 0],
                            t[w == 2, 1]], -1)
    ang = np.deg2rad(10.0)
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t_gt = np.array([0.4, -0.25, 0.1], np.float32)
    src = (pts @ R.T + t_gt + rng.normal(0, 0.004, (n, 3))).astype(np.float32)
    vp = np.array([0.0, 0.0, 0.0], np.float32)
    tgt_n = tN.estimate_normals(pts, k=20, viewpoint=vp)
    src_n = tN.estimate_normals(src, k=20, viewpoint=vp)
    T, fit = tN.fpfh_ransac_register(src, src_n, pts, tgt_n,
                                     feature_radius=0.25, max_corr_dist=0.07,
                                     max_iter=60_000)
    assert fit > 0.5, f"global registration failed (fitness {fit})"
    T2, _fit2, _rmse = tN.icp_point_to_plane(src, pts, tgt_n,
                                             max_corr_dist=0.05,
                                             max_iter=100, init=T)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t_gt
    err = T2 @ T_gt
    assert np.abs(err[:3, 3]).max() < 0.03, f"translation error {err[:3, 3]}"
    assert np.abs(err[:3, :3] - np.eye(3)).max() < 0.03
