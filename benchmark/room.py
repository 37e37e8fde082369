"""The benchmark's traffic: frames of a procedural room along a trajectory.

A frozen copy, in PyTorch on the device, of the procedural room of
``hpslam_tpu_torch/utils/datasets.py`` (``Synthetic``): the box room of
half-size 2.5 m, its analytic texture, its texture-poor band and its
sensor model (multiplicative depth noise, quantisation, blob holes, global
and per-channel exposure drift, gamma drift).  The sensor's random draws
come from a ``torch.Generator`` seeded from the run's seed, where the
original draws from numpy per frame.

A trajectory is one parametric family read from a traffic file
(``traffic/<name>.json``): an orbit of ``orbit_turns`` turns over
``frames`` frames (radius, height wave, yaw a share of the orbit angle)
plus a sway (``sway_m`` along x and ``sway_yaw_deg`` of yaw, period
``sway_period_frames``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

HALF = 2.5


def poses(traffic: dict) -> np.ndarray:
    """(frames, 4, 4) camera-to-world matrices (-z forward)."""
    n = int(traffic["frames"])
    out = np.zeros((n, 4, 4))
    for i in range(n):
        ang = 2.0 * math.pi * float(traffic["orbit_turns"]) * i / n
        ph = 2.0 * math.pi * i / float(traffic["sway_period_frames"])
        r = float(traffic["orbit_radius_m"])
        pos = np.array([
            r * math.sin(ang) + float(traffic["sway_m"]) * math.sin(ph),
            float(traffic["orbit_height_m"]) * math.sin(2.0 * ang),
            r * math.cos(ang) + float(traffic["orbit_z_offset_m"])])
        yaw = (float(traffic["yaw_per_orbit_angle"]) * ang
               + math.radians(float(traffic["sway_yaw_deg"])) * math.sin(ph))
        c, s = math.cos(yaw), math.sin(yaw)
        out[i, :3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
        out[i, :3, 3] = pos
        out[i, 3, 3] = 1.0
    return out


def _texture(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.5 * torch.sin(3.1 * x + 1.7 * y)
    g = 0.5 + 0.5 * torch.sin(2.3 * y - 1.1 * z + 1.0)
    b = 0.5 + 0.5 * torch.sin(1.9 * z + 2.9 * x + 2.0)
    return torch.stack([r, g, b], -1)


class Room:
    """Renders frame i of a trajectory at one camera and sensor model."""

    def __init__(self, cam: dict, sensor: dict, traffic: dict, seed: int,
                 device):
        self.H, self.W = int(cam["H"]), int(cam["W"])
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        self.edge = int(cam.get("crop_edge", 0) or 0)
        self.sensor = {k: float(v) for k, v in sensor.items()}
        self.poses = poses(traffic)
        self.n = len(self.poses)
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        jj, ii = torch.meshgrid(
            torch.arange(self.H, dtype=torch.float32, device=device),
            torch.arange(self.W, dtype=torch.float32, device=device),
            indexing="ij")
        self.dirs = torch.stack([(ii - self.cx) / self.fx,
                                 -(jj - self.cy) / self.fy,
                                 -torch.ones_like(ii)], -1)

    def render(self, i: int):
        """(color (H', W', 3), depth (H', W'), c2w (4, 4)) of frame i,
        float32 numpy, cropped by the camera's crop edge."""
        sen = self.sensor.get
        dev = self.device
        c2w = torch.as_tensor(self.poses[i], dtype=torch.float32, device=dev)
        rd = self.dirs @ c2w[:3, :3].T
        ro = c2w[:3, 3]
        t_exit = torch.full((self.H, self.W), float("inf"), device=dev)
        for ax in range(3):
            d = rd[..., ax]
            for bound in (HALF, -HALF):
                t = (bound - ro[ax]) / d
                ok = torch.isfinite(t) & (t > 1e-4)
                t_exit = torch.where(ok & (t < t_exit), t, t_exit)
        hit = ro + rd * t_exit[..., None]
        color = _texture(hit)
        if sen("texture_poor", 0.0) > 0:
            bound = HALF * (1.0 - 2.0 * sen("texture_poor"))
            flat = hit[..., 0] > bound
            color = torch.where(flat[..., None], 0.55 + 0.02 * color, color)
        depth = t_exit
        if sen("depth_noise_std", 0.0) > 0:
            depth = depth * (1.0 + sen("depth_noise_std") * torch.randn(
                depth.shape, generator=self.gen, device=dev))
        if sen("depth_quant", 0.0) > 0:
            q = sen("depth_quant")
            depth = torch.round(depth / q) * q
        if sen("depth_hole_frac", 0.0) > 0:
            g = torch.randn((self.H // 8 + 1, self.W // 8 + 1),
                            generator=self.gen, device=dev)
            gg = torch.kron(g, torch.ones((8, 8), device=dev))[:self.H,
                                                                :self.W]
            thr = torch.quantile(g.reshape(-1).double(),
                                 sen("depth_hole_frac")).float()
            depth = torch.where(gg < thr, torch.zeros_like(depth), depth)
        drift = (sen("exposure_drift", 0.0), sen("exposure_chan_drift", 0.0),
                 sen("gamma_drift", 0.0))
        if any(v > 0 for v in drift):
            ph = 2.0 * math.pi * i / max(self.n, 1)
            gain = 1.0 + drift[0] * math.sin(2.0 * ph)
            cg = [gain * (1.0 + drift[1] * math.sin(2.0 * ph + o))
                  for o in (0.0, 2.1, 4.2)]
            color = color * torch.tensor(cg, device=dev)
            if drift[2] > 0:
                gamma = 1.0 + drift[2] * math.sin(3.0 * ph + 1.0)
                color = torch.pow(torch.clamp(color, min=0.0), gamma)
            color = torch.clamp(color, 0.0, 1.0)
        e = self.edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        return (color.contiguous().cpu().numpy(),
                depth.contiguous().cpu().numpy(),
                self.poses[i].astype(np.float32))
