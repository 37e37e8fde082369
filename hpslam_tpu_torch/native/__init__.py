"""ctypes bindings of the first-party C++ runtime
(``native/hpslam_native.cpp``): TSDF fusion and marching-tetrahedra
extraction, a kd-tree, normal estimation, point-to-plane ICP, FPFH + RANSAC
registration and a BVH mesh raycaster, with the signatures of
``hpslam_tpu/native/__init__.py``; and of the port's own baseline JPEG
codec (``hpslam_tpu_torch/native/jpeg.cpp``: ``jpeg_decode``, what
``cv2.imread`` returns, bit for bit, and ``jpeg_encode``).

The port has its own loader: at first use it compiles each source with the
flags of ``native/Makefile`` (``-O3 -std=c++17 -fPIC -shared -Wall``, plus
``-march=native`` where the compiler takes it) into ``build/native/`` at the
repository root (or ``$HPSLAM_NATIVE_BUILD``), which ``.gitignore`` lists.
The file name carries a hash of the source, of the compiler's version,
of the flags and of the target that ``-march=native`` resolves to, so an
edited source, another compiler or another host's CPU is never served by a
stale build.  It never writes into
``native/``.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
SOURCE = os.path.join(_REPO, "native", "hpslam_native.cpp")
JPEG_SOURCE = os.path.join(_HERE, "jpeg.cpp")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall"]

_lib = None
_jpeg = None
_LOCK = threading.Lock()


def build_dir() -> str:
    d = os.environ.get("HPSLAM_NATIVE_BUILD") or os.path.join(
        _REPO, "build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"native build: C++ compiler {cxx!r} not found")
    return found


def compile_flags(cxx: str) -> list:
    """The Makefile's flags, with -march=native where the compiler takes
    it (as the Makefile probes)."""
    probe = subprocess.run([cxx, "-march=native", "-E", "-x", "c++",
                            os.devnull], capture_output=True)
    return CXXFLAGS + (["-march=native"] if probe.returncode == 0 else [])


def _compiler_id(cxx: str, flags: list) -> bytes:
    """The compiler's version and, under -march=native, the target options
    it enables on this host."""
    out = subprocess.run([cxx, "--version"], capture_output=True).stdout
    if "-march=native" in flags:
        out += subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                              capture_output=True).stdout
    return out


def lib_path(cxx: str, flags: list, source: Optional[str] = None,
             stem: str = "hpslam_native") -> str:
    h = hashlib.sha256((cxx + "\0" + " ".join(flags)).encode())
    h.update(_compiler_id(cxx, flags))
    with open(source or SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_dir(), f"lib{stem}_{h.hexdigest()[:16]}.so")


def build(source: Optional[str] = None, stem: str = "hpslam_native") -> str:
    """Compile a library (by default the runtime, ``SOURCE``) unless its
    hashed file exists; returns its path."""
    source = source or SOURCE
    cxx = compiler()
    flags = compile_flags(cxx)
    out = lib_path(cxx, flags, source, stem)
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({cxx}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64, f32, cint = ctypes.c_int64, ctypes.c_float, ctypes.c_int
        sigs = {
            "tsdf_create": ([f32, f32], i64),
            "tsdf_destroy": ([i64], None),
            "tsdf_integrate": ([i64, f32p, f32p, cint, cint, f32p, f32p,
                                f32], None),
            "tsdf_extract": ([i64, f32], i64),
            "mesh_counts": ([i64, i64p, i64p], None),
            "mesh_copy": ([i64, f32p, f32p, i32p], None),
            "mesh_destroy": ([i64], None),
            "kdtree_build": ([f32p, i64], i64),
            "kdtree_destroy": ([i64], None),
            "kdtree_nearest": ([i64, f32p, i64, i32p, f32p], None),
            "kdtree_knn": ([i64, f32p, i64, cint, i32p, f32p], None),
            "estimate_normals": ([f32p, i64, cint, f32p, f32p], None),
            "icp_point_to_plane": ([f32p, i64, f32p, f32p, i64, f32, cint,
                                    f32p, f32p, f32p], f32),
            "fpfh_ransac_register": ([f32p, i64, f32p, f32p, i64, f32p, f32,
                                      f32, cint, ctypes.c_uint64, f32p],
                                     f32),
            "bvh_build": ([f32p, i64, i32p, i64], i64),
            "bvh_destroy": ([i64], None),
            "bvh_raycast": ([i64, f32p, f32p, i64, f32p], None),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


_NULL = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))


class TSDFVolume:
    """Block-sparse TSDF fusion + marching-tetrahedra extraction."""

    def __init__(self, voxel_size: float, sdf_trunc: float):
        self.lib = _load()
        self.h = self.lib.tsdf_create(voxel_size, sdf_trunc)

    def integrate(self, depth: np.ndarray, color: Optional[np.ndarray],
                  intrinsics, w2c_cv: np.ndarray, depth_trunc: float = 4.5):
        """depth (H,W) metres; color (H,W,3) in [0,1] or None; intrinsics
        (fx, fy, cx, cy); w2c_cv: 4x4 world->camera in the CV convention
        (+z forward, +x right, +y down)."""
        depth = _f32(depth)
        H, W = depth.shape
        col = _f32(color) if color is not None else None
        intr = _f32(np.asarray(intrinsics))
        w2c = _f32(w2c_cv)
        self.lib.tsdf_integrate(self.h, _fp(depth),
                                _fp(col) if col is not None else _NULL, H, W,
                                _fp(intr), _fp(w2c), depth_trunc)

    def extract_mesh(self, weight_thresh: float = 0.0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(vertices (V, 3), colours (V, 3) in [0, 1], faces (F, 3))."""
        mh = self.lib.tsdf_extract(self.h, weight_thresh)
        nv, nf = ctypes.c_int64(), ctypes.c_int64()
        self.lib.mesh_counts(mh, ctypes.byref(nv), ctypes.byref(nf))
        verts = np.empty((nv.value, 3), np.float32)
        cols = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        if nv.value:
            self.lib.mesh_copy(mh, _fp(verts), _fp(cols), _ip(faces))
        self.lib.mesh_destroy(mh)
        return verts, cols, faces

    def __del__(self):
        if getattr(self, "h", None) is not None:
            self.lib.tsdf_destroy(self.h)


class KDTree:
    """Nearest-neighbour queries over a static cloud."""

    def __init__(self, points: np.ndarray):
        self.lib = _load()
        self._pts = _f32(points)
        self.h = self.lib.kdtree_build(_fp(self._pts), self._pts.shape[0])

    def nearest(self, queries: np.ndarray):
        """(index (n,), squared distance (n,)) of each query's nearest
        point."""
        q = _f32(queries)
        n = q.shape[0]
        idx = np.empty((n,), np.int32)
        d2 = np.empty((n,), np.float32)
        self.lib.kdtree_nearest(self.h, _fp(q), n, _ip(idx), _fp(d2))
        return idx, d2

    def knn(self, queries: np.ndarray, k: int):
        """(indices (n, k), squared distances (n, k)), nearest first."""
        q = _f32(queries)
        n = q.shape[0]
        idx = np.empty((n, k), np.int32)
        d2 = np.empty((n, k), np.float32)
        self.lib.kdtree_knn(self.h, _fp(q), n, k, _ip(idx), _fp(d2))
        return idx, d2

    def __del__(self):
        if getattr(self, "h", None) is not None:
            self.lib.kdtree_destroy(self.h)


def estimate_normals(points: np.ndarray, k: int = 30,
                     viewpoint: Optional[np.ndarray] = None) -> np.ndarray:
    """PCA normals over k neighbours, oriented towards viewpoint where
    given."""
    lib = _load()
    pts = _f32(points)
    out = np.empty_like(pts)
    vp = _f32(viewpoint) if viewpoint is not None else None
    lib.estimate_normals(_fp(pts), pts.shape[0], k,
                         _fp(vp) if vp is not None else _NULL, _fp(out))
    return out


class MeshRaycaster:
    """BVH ray-triangle intersection."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self.lib = _load()
        self._v = _f32(verts)
        self._f = np.ascontiguousarray(faces, dtype=np.int32)
        self.h = self.lib.bvh_build(_fp(self._v), self._v.shape[0],
                                    _ip(self._f), self._f.shape[0])

    def cast(self, rays_o: np.ndarray, rays_d: np.ndarray) -> np.ndarray:
        """t along each ray (> 0), or -1 for a miss."""
        ro = _f32(rays_o)
        rd = _f32(rays_d)
        out = np.empty((ro.shape[0],), np.float32)
        self.lib.bvh_raycast(self.h, _fp(ro), _fp(rd), ro.shape[0], _fp(out))
        return out

    def __del__(self):
        if getattr(self, "h", None) is not None:
            self.lib.bvh_destroy(self.h)


def icp_point_to_plane(src: np.ndarray, tgt: np.ndarray,
                       tgt_normals: np.ndarray, max_corr_dist: float,
                       max_iter: int = 500,
                       init: Optional[np.ndarray] = None):
    """Returns (T 4x4, fitness, inlier_rmse)."""
    lib = _load()
    src, tgt, nrm = _f32(src), _f32(tgt), _f32(tgt_normals)
    T0 = _f32(init if init is not None else np.eye(4))
    Tout = np.empty((4, 4), np.float32)
    rmse = ctypes.c_float()
    fit = lib.icp_point_to_plane(
        _fp(src), src.shape[0], _fp(tgt), _fp(nrm), tgt.shape[0],
        max_corr_dist, max_iter, _fp(T0), _fp(Tout), ctypes.byref(rmse))
    return Tout, float(fit), float(rmse.value)


def fpfh_ransac_register(src: np.ndarray, src_normals: np.ndarray,
                         tgt: np.ndarray, tgt_normals: np.ndarray,
                         feature_radius: float, max_corr_dist: float,
                         max_iter: int = 100_000, seed: int = 1219):
    """FPFH + RANSAC global registration.  Returns (T 4x4, fitness)."""
    lib = _load()
    src, tgt = _f32(src), _f32(tgt)
    sn, tn = _f32(src_normals), _f32(tgt_normals)
    Tout = np.empty((4, 4), np.float32)
    fit = lib.fpfh_ransac_register(
        _fp(src), src.shape[0], _fp(sn), _fp(tgt), tgt.shape[0], _fp(tn),
        feature_radius, max_corr_dist, max_iter, seed, _fp(Tout))
    return Tout, float(fit)


# ---------------------------------------------------------------------------
# baseline JPEG (jpeg.cpp)

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load_jpeg():
    global _jpeg
    with _LOCK:
        if _jpeg is not None:
            return _jpeg
        lib = ctypes.CDLL(build(JPEG_SOURCE, "hpjpeg"))
        ip = ctypes.POINTER(ctypes.c_int)
        lib.hp_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.POINTER(_U8P), ip, ip,
                                       ctypes.c_char_p, ctypes.c_int]
        lib.hp_jpeg_decode.restype = ctypes.c_int
        lib.hp_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(_U8P), ctypes.c_char_p,
                                       ctypes.c_int]
        lib.hp_jpeg_encode.restype = ctypes.c_int64
        lib.hp_jpeg_free.argtypes = [_U8P]
        lib.hp_jpeg_free.restype = None
        _jpeg = lib
        return lib


def jpeg_decode(data: bytes) -> np.ndarray:
    """A baseline JPEG file's bytes as (H, W, 3) uint8 RGB, what
    ``cv2.imread`` returns in BGR.  Raises ValueError with the reason
    (an unsupported process names its SOF marker)."""
    lib = _load_jpeg()
    out, h, w = _U8P(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.hp_jpeg_decode(data, len(data), ctypes.byref(out), ctypes.byref(h),
                          ctypes.byref(w), err, len(err)):
        raise ValueError(err.value.decode())
    try:
        return np.ctypeslib.as_array(out, (h.value, w.value, 3)).copy()
    finally:
        lib.hp_jpeg_free(out)


def jpeg_encode(img: np.ndarray, quality: int = 95,
                subsampling: str = "420") -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 as baseline JPEG bytes: the
    standard tables at ``quality``, chroma '420' or '444'."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("jpeg_encode: (H, W) or (H, W, 3) uint8 images")
    if subsampling not in ("420", "444"):
        raise ValueError(f"jpeg_encode: subsampling 420 or 444, not "
                         f"{subsampling!r}")
    lib = _load_jpeg()
    out = _U8P()
    err = ctypes.create_string_buffer(256)
    n = lib.hp_jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1],
                           1 if img.ndim == 2 else 3, int(quality),
                           int(subsampling == "420"), ctypes.byref(out), err,
                           len(err))
    if n < 0:
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.hp_jpeg_free(out)
