"""RGB-D frame readers (port of hpslam_tpu/utils/datasets.py).

Only the procedural ``synthetic`` family is ported (the analytic textured
cube room with an orbiting camera, its sensor model and trajectories,
identical to the reference's); the file-backed readers (Replica, ScanNet,
TUM, ...) raise NotImplementedError.  Frames are numpy on the host with
lazily uploaded device tensors, and a background thread prefetches them.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional, Tuple

import numpy as np
import torch


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


def get_dataset(cfg: dict, input_folder: Optional[str] = None,
                scale: float = 1.0, device=None):
    if cfg["dataset"] != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg['dataset']!r} is not ported yet (only "
            "'synthetic'); see ROADMAP.md")
    return Synthetic(cfg, input_folder, scale, device)


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
