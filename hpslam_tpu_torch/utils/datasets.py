"""RGB-D frame readers (port of hpslam_tpu/utils/datasets.py).

The file-backed readers (Replica, ScanNet, Azure, CoFusion, TUM RGB-D)
follow the reference's conventions: colour file -> RGB float in [0, 1],
undistorted first where the config gives ``cam.distortion`` (colour only);
depth from a 16-bit PNG (or CoFusion's EXR) over ``png_depth_scale``;
optional ``crop_size`` resize (bilinear colour, nearest depth), then the
``crop_edge`` trim; the Replica / ScanNet / Azure / TUM poses have their y
and z columns negated into the -z-forward camera frame; TUM associates its
rgb / depth / pose lists by timestamp, keeps frames 1/32 s apart and
re-bases the first pose to the identity.  Images are decoded by the
port's own codecs (``image_io``, ``exr``): PNG and EXR in numpy, JPEG
(Replica, ScanNet, Azure colour) by its baseline decoder in C++
(``native.jpeg_decode``).  ``write_tum_rgbd`` and ``write_scannet_tree``
write frames as TUM RGB-D and ScanNet trees.

Plus the procedural ``synthetic`` family (the analytic textured cube room
with an orbiting camera, its sensor model and trajectories, identical to
the reference's).  Frames are numpy on the host with lazily uploaded
device tensors, and a background thread prefetches them.
"""
from __future__ import annotations

import glob
import os
import queue
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import image_io as IO


class Frame:
    __slots__ = ("index", "color", "depth", "c2w", "_dev")

    def __init__(self, index: int, color: np.ndarray, depth: np.ndarray,
                 c2w: np.ndarray):
        self.index = index
        self.color = color  # (H, W, 3) float32 RGB in [0, 1]
        self.depth = depth  # (H, W) float32 metres
        self.c2w = c2w      # (4, 4) float32
        self._dev = {}

    def color_t(self, device) -> torch.Tensor:
        """The colour image on ``device`` (uploaded once)."""
        key = ("c", str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.color, device=device)
        return self._dev[key]

    def depth_t(self, device) -> torch.Tensor:
        key = ("d", str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.depth, device=device)
        return self._dev[key]


class _Reader:
    def __init__(self, cfg: dict, input_folder: Optional[str] = None,
                 scale: float = 1.0, device=None):
        self.cfg = cfg
        self.scale = scale
        self.device = device
        self.input_folder = input_folder or cfg["data"].get("input_folder")
        self.crop_edge = cfg["cam"].get("crop_edge", 0) or 0
        self.poses = []


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


class BaseReader(_Reader):
    """The file readers' decode / undistort / resize / crop pipeline."""

    def __init__(self, cfg: dict, input_folder: Optional[str] = None,
                 scale: float = 1.0, device=None):
        super().__init__(cfg, input_folder, scale, device)
        cam = cfg["cam"]
        self.png_depth_scale = cam["png_depth_scale"]
        self.distortion = (np.array(cam["distortion"]) if "distortion" in cam
                           else None)
        self.crop_size = cam.get("crop_size")
        self.K = np.array([[cam["fx"], 0.0, cam["cx"]],
                           [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]])
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []

    def __len__(self):
        return self.n_img

    @property
    def n_img(self):
        return len(self.color_paths)

    def _decode_depth(self, path: str) -> np.ndarray:
        if path.endswith(".exr"):
            from .exr import read_exr_depth
            d = read_exr_depth(path)
            if d is None:
                raise ValueError(f"{path}: no depth channel (Y/Z/R) found")
        else:
            d = IO.read_png(path)
            if d.ndim != 2:
                raise ValueError(f"{path}: a depth image has one channel")
        return d.astype(np.float32) / self.png_depth_scale

    def __getitem__(self, index: int) -> Frame:
        color = IO.read_color(self.color_paths[index])
        depth = self._decode_depth(self.depth_paths[index])
        if self.distortion is not None:
            color = IO.undistort(color, self.K, self.distortion)
        color = color.astype(np.float32) / 255.0
        depth = depth * self.scale
        H, W = depth.shape
        if color.shape[:2] != (H, W):
            color = IO.resize(color, (W, H))
        if self.crop_size is not None:
            h, w = self.crop_size
            color = IO.resize(color, (w, h), "linear")
            depth = IO.resize(depth, (w, h), "nearest")
        e = self.crop_edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        c2w = self.poses[index].astype(np.float32).copy()
        c2w[:3, 3] *= self.scale
        return Frame(index, np.ascontiguousarray(color),
                     np.ascontiguousarray(depth), c2w)


class Replica(BaseReader):
    def __init__(self, cfg, input_folder=None, scale=1.0, device=None):
        super().__init__(cfg, input_folder, scale, device)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        with open(f"{self.input_folder}/traj.txt") as f:
            lines = f.readlines()
        self.poses = [_flip_yz(np.array(list(map(
            float, lines[i].split()))).reshape(4, 4))
            for i in range(len(self.color_paths))]


class ScanNet(BaseReader):
    def __init__(self, cfg, input_folder=None, scale=1.0, device=None):
        super().__init__(cfg, input_folder, scale, device)

        def by_num(p):
            return int(os.path.basename(p).split(".")[0])

        def listed(sub, ext):
            return sorted(glob.glob(os.path.join(self.input_folder, sub,
                                                 ext)), key=by_num)

        self.color_paths = listed("color", "*.jpg")
        self.depth_paths = listed("depth", "*.png")
        for p in listed("pose", "*.txt"):
            with open(p) as f:
                mat = np.array([list(map(float, ln.split()))
                                for ln in f.readlines()]).reshape(4, 4)
            self.poses.append(_flip_yz(mat))


class Azure(BaseReader):
    def __init__(self, cfg, input_folder=None, scale=1.0, device=None):
        super().__init__(cfg, input_folder, scale, device)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        traj = os.path.join(self.input_folder, "scene", "trajectory.log")
        if os.path.exists(traj):
            with open(traj) as f:
                content = f.readlines()
            for i in range(0, len(content), 5):
                mat = np.array(list(map(float, "".join(
                    content[i + 1:i + 5]).split()))).reshape(4, 4)
                self.poses.append(_flip_yz(mat))
        else:
            self.poses = [np.eye(4) for _ in self.color_paths]


class CoFusion(BaseReader):
    def __init__(self, cfg, input_folder=None, scale=1.0, device=None):
        super().__init__(cfg, input_folder, scale, device)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "colour", "*.png")))
        self.depth_paths = sorted(glob.glob(
            os.path.join(self.input_folder, "depth_noise", "*.exr")))
        # identity stand-in poses: CoFusion's frame cannot be aligned, and
        # the ATE's alignment absorbs it (as the reference)
        self.poses = [np.eye(4) for _ in self.color_paths]


class TUM_RGBD(BaseReader):
    def __init__(self, cfg, input_folder=None, scale=1.0, device=None,
                 frame_rate: int = 32):
        super().__init__(cfg, input_folder, scale, device)
        self._load(self.input_folder, frame_rate)

    @staticmethod
    def _parse_list(path, skiprows=0):
        return np.loadtxt(path, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        pairs = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_depth - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                pairs.append((i, j, k))
        return pairs

    def _load(self, folder, frame_rate):
        from scipy.spatial.transform import Rotation
        pose_file = os.path.join(folder, "groundtruth.txt")
        if not os.path.isfile(pose_file):
            pose_file = os.path.join(folder, "pose.txt")
        img = self._parse_list(os.path.join(folder, "rgb.txt"))
        dep = self._parse_list(os.path.join(folder, "depth.txt"))
        pose = self._parse_list(pose_file, skiprows=1)
        pose_vecs = pose[:, 1:].astype(np.float64)
        t_img = img[:, 0].astype(np.float64)
        t_dep = dep[:, 0].astype(np.float64)
        t_pose = pose[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_dep, t_pose)
        # keep frames more than 1/frame_rate s after the last kept one
        picks = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[picks[-1]][0]]
            if t_img[assoc[i][0]] - t0 > 1.0 / frame_rate:
                picks.append(i)
        inv_first = None
        for ix in picks:
            i, j, k = assoc[ix]
            self.color_paths.append(os.path.join(folder, str(img[i, 1])))
            self.depth_paths.append(os.path.join(folder, str(dep[j, 1])))
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(pose_vecs[k][3:]).as_matrix()
            c2w[:3, 3] = pose_vecs[k][:3]
            if inv_first is None:
                inv_first = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_first @ c2w
            self.poses.append(_flip_yz(c2w))


def write_tum_rgbd(folder: str, frames, png_depth_scale: float = 5000.0,
                   t0: float = 1305031102.175304, dt: float = 1.0 / 30):
    """Write frames (RGB colour in [0, 1], depth in metres, c2w in the
    readers' -z-forward frame) as a TUM RGB-D tree that ``TUM_RGBD`` reads
    back: rgb/ 8-bit PNG, depth/ 16-bit PNG at png_depth_scale (rows
    filtered by libpng's adaptive choice, as in the dataset), rgb.txt,
    depth.txt and groundtruth.txt (timestamps dt apart, poses with y and z
    flipped back, quaternions x y z w).  The reader re-bases the first pose
    to the identity."""
    from scipy.spatial.transform import Rotation
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    rgb, dep, gt = [], [], ["# timestamp tx ty tz qx qy qz qw"]
    for i, fr in enumerate(frames):
        t = f"{t0 + i * dt:.6f}"
        IO.write_png(os.path.join(folder, "rgb", t + ".png"),
                     np.round(np.clip(fr.color, 0, 1) * 255).astype(
                         np.uint8))
        IO.write_png(os.path.join(folder, "depth", t + ".png"),
                     np.round(np.clip(fr.depth * png_depth_scale, 0, 65535)
                              ).astype(np.uint16))
        rgb.append(f"{t} rgb/{t}.png")
        dep.append(f"{t} depth/{t}.png")
        pose = _flip_yz(np.asarray(fr.c2w, np.float64))
        q = Rotation.from_matrix(pose[:3, :3]).as_quat()
        gt.append(t + " " + " ".join(repr(float(v)) for v in
                                     list(pose[:3, 3]) + list(q)))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                        ("groundtruth.txt", gt)):
        with open(os.path.join(folder, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_scannet_tree(folder: str, frames, png_depth_scale: float = 1000.0):
    """Write frames (RGB colour in [0, 1], depth in metres, c2w in the
    readers' -z-forward frame) as a ScanNet tree that ``ScanNet`` reads
    back: color/<i>.jpg (baseline JPEG, quality 95, 4:2:0, through
    ``image_io.write_jpeg``), depth/<i>.png (16-bit at png_depth_scale),
    pose/<i>.txt (the 4x4 camera-to-world matrix with y and z flipped
    back, as ScanNet stores it)."""
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i, fr in enumerate(frames):
        IO.write_jpeg(os.path.join(folder, "color", f"{i}.jpg"),
                      np.round(np.clip(fr.color, 0, 1) * 255).astype(
                          np.uint8))
        IO.write_png(os.path.join(folder, "depth", f"{i}.png"),
                     np.round(np.clip(fr.depth * png_depth_scale, 0, 65535)
                              ).astype(np.uint16))
        np.savetxt(os.path.join(folder, "pose", f"{i}.txt"),
                   _flip_yz(np.asarray(fr.c2w, np.float64)))


class Synthetic(_Reader):
    """Analytic textured cube room with an orbiting camera (no files).

    Depth/colour are ray-cast against an axis-aligned box of half-size 2.5m
    with a procedural RGB texture; poses follow a smooth orbit.  Serves as
    the deterministic end-to-end fixture the reference lacks (SURVEY.md §4).

    Optional SENSOR MODEL (cfg.synthetic), default all off — stresses the
    ScanNet failure modes the clean fixture cannot (VERDICT r1 item 4):
      * depth_noise_std: multiplicative Gaussian depth noise, sigma =
        std * depth (Kinect-like range error growth);
      * depth_quant: quantisation step in metres (16-bit png depth);
      * depth_hole_frac: fraction of pixels dropped to 0 in blobs
        (specular/IR-shadow holes);
      * exposure_drift: per-frame global colour gain drifting sinusoidally
        by +-drift (exercises the exposure MLPs / affines);
      * texture_poor: fraction of the room (by wall x-extent) rendered
        with near-flat texture (exercises the dynamic add/query radii);
      * trajectory: 'orbit' (default quarter-orbit) or 'loop' — a full
        orbit returning to the start pose (exercises end_correction's
        tail-vs-early-cloud registration, reference Mapper.py:1080-1148).
    """

    HALF = 2.5

    def __init__(self, cfg, input_folder=None, scale=1.0, device=None):
        super().__init__(cfg, input_folder, scale, device)
        syn = cfg.get("synthetic", {})
        self._n = int(syn.get("n_frames", 30))
        self._radius = float(syn.get("radius", 1.2))
        self._depth_noise = float(syn.get("depth_noise_std", 0.0))
        self._depth_quant = float(syn.get("depth_quant", 0.0))
        self._hole_frac = float(syn.get("depth_hole_frac", 0.0))
        self._expo_drift = float(syn.get("exposure_drift", 0.0))
        self._chan_drift = float(syn.get("exposure_chan_drift", 0.0))
        self._gamma_drift = float(syn.get("gamma_drift", 0.0))
        self._texture_poor = float(syn.get("texture_poor", 0.0))
        self._trajectory = str(syn.get("trajectory", "orbit"))
        self._seed = int(cfg.get("seed", 1219))
        cam = cfg["cam"]
        self._H0, self._W0 = cam["H"], cam["W"]
        self._fx, self._fy = cam["fx"], cam["fy"]
        self._cx, self._cy = cam["cx"], cam["cy"]
        self.poses = [self._pose(i) for i in range(self._n)]

    @property
    def n_img(self):
        return self._n

    def __len__(self):
        return self._n

    def _pose(self, i: int) -> np.ndarray:
        frac = 1.0 if self._trajectory == "loop" else 0.25
        ang = 2 * np.pi * i / max(self._n, 1) * frac
        pos = np.array([self._radius * np.sin(ang), 0.3 * np.sin(2 * ang),
                        self._radius * np.cos(ang) - 0.5])
        yaw = ang * (1.0 if self._trajectory == "loop" else 0.6)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = pos
        return c2w

    @staticmethod
    def _texture(p: np.ndarray) -> np.ndarray:
        r = 0.5 + 0.5 * np.sin(3.1 * p[..., 0] + 1.7 * p[..., 1])
        g = 0.5 + 0.5 * np.sin(2.3 * p[..., 1] - 1.1 * p[..., 2] + 1.0)
        b = 0.5 + 0.5 * np.sin(1.9 * p[..., 2] + 2.9 * p[..., 0] + 2.0)
        return np.stack([r, g, b], -1).astype(np.float32)

    def __getitem__(self, index: int) -> Frame:
        H, W = self._H0, self._W0
        c2w = self.poses[index]
        jj, ii = np.mgrid[0:H, 0:W].astype(np.float32)
        dirs = np.stack([(ii - self._cx) / self._fx,
                         -(jj - self._cy) / self._fy,
                         -np.ones_like(ii)], -1)
        rd = dirs @ c2w[:3, :3].T
        ro = c2w[:3, 3]
        # slab intersection with the box interior (camera inside): take the
        # nearest positive exit along each axis
        t_exit = np.full((H, W), np.inf, np.float32)
        for ax in range(3):
            d = rd[..., ax]
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (self.HALF - ro[ax]) / d
                t2 = (-self.HALF - ro[ax]) / d
            for t in (t1, t2):
                valid = np.isfinite(t) & (t > 1e-4)
                t_exit = np.where(valid & (t < t_exit), t, t_exit)
        depth_along_ray = t_exit
        hit = ro[None, None, :] + rd * depth_along_ray[..., None]
        color = self._texture(hit)
        if self._texture_poor > 0:
            # near-flat texture over part of the room: hit points with
            # x above the quantile boundary lose almost all colour
            # gradient (dynamic radii go to radius_add_max there)
            bound = self.HALF * (1.0 - 2.0 * self._texture_poor)
            flat = hit[..., 0] > bound
            color = np.where(flat[..., None],
                             0.55 + 0.02 * color, color).astype(np.float32)
        # sensor depth convention: distance along -z in camera frame equals
        # t (rays have dz=-1 before rotation)
        depth = depth_along_ray.astype(np.float32)

        # --- sensor model (deterministic per frame)
        srng = np.random.default_rng(self._seed * 100003 + index)
        if self._depth_noise > 0:
            depth = depth * (1.0 + self._depth_noise
                             * srng.standard_normal(depth.shape)
                             ).astype(np.float32)
        if self._depth_quant > 0:
            depth = (np.round(depth / self._depth_quant)
                     * self._depth_quant).astype(np.float32)
        if self._hole_frac > 0:
            # blob holes: threshold smoothed noise so dropouts cluster
            # like IR-shadow patches rather than salt-and-pepper
            g = srng.standard_normal((H // 8 + 1, W // 8 + 1))
            gg = np.kron(g, np.ones((8, 8)))[:H, :W]
            thr = np.quantile(gg, self._hole_frac)
            depth = np.where(gg < thr, 0.0, depth).astype(np.float32)
        if self._expo_drift > 0 or self._chan_drift > 0 \
                or self._gamma_drift > 0:
            # exposure model the reference's per-frame 3x3 affine + bias
            # (decoder.py:606-614) exists to absorb: global gain drift,
            # PER-CHANNEL gain drift (white-balance wander; phase-shifted
            # per channel so no scalar gain explains it), and a mild gamma
            # drift (nonlinear — only approximable by the affine, which
            # keeps the task honest).  The scalar drift alone measured too
            # weak to separate exposure ON/OFF from the seed band
            # (VERDICT r02 item 5 / QUALITY_MATRIX.json r02).
            ph = 2 * np.pi * index / max(self._n, 1)
            gain = 1.0 + self._expo_drift * np.sin(2.0 * ph)
            cg = gain * np.ones(3)
            if self._chan_drift > 0:
                cg = cg * (1.0 + self._chan_drift
                           * np.sin(2.0 * ph + np.array([0.0, 2.1, 4.2])))
            color = color * cg.astype(np.float32)
            if self._gamma_drift > 0:
                gamma = 1.0 + self._gamma_drift * np.sin(3.0 * ph + 1.0)
                color = np.power(np.clip(color, 0.0, None), gamma)
            color = np.clip(color, 0.0, 1.0).astype(np.float32)

        e = self.crop_edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        return Frame(index, np.ascontiguousarray(color),
                     np.ascontiguousarray(depth), c2w.astype(np.float32))


dataset_registry = {
    "replica": Replica,
    "scannet": ScanNet,
    "cofusion": CoFusion,
    "azure": Azure,
    "tumrgbd": TUM_RGBD,
    "synthetic": Synthetic,
}


def get_dataset(cfg: dict, input_folder: Optional[str] = None,
                scale: float = 1.0, device=None):
    return dataset_registry[cfg["dataset"]](cfg, input_folder, scale, device)


class Prefetcher:
    """Background-thread frame prefetch."""

    def __init__(self, reader, depth: int = 2, start: int = 0):
        self.reader = reader
        self.start = start
        self.q: "queue.Queue[Tuple[int, Frame]]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for i in range(self.start, len(self.reader)):
            if self._stop.is_set():
                return
            self.q.put((i, self.reader[i]))
        self.q.put((-1, None))

    def __iter__(self):
        while True:
            i, frame = self.q.get()
            if i < 0:
                return
            yield frame

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
