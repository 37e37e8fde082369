"""Hierarchical neural point cloud (port of hpslam_tpu/state.py).

Per-level fixed-capacity device tensors with an active count, grown by
power-of-two re-allocation; insertion mirrors the reference's
``add_points``: a ray whose surface point already has a neighbour within the
per-pixel add radius is dropped (1-NN through the tile index, k=1,
probe=32), and N_add points are spread along each kept ray with N(0, 0.1)
features.  The count is a host integer (insertion returns the number of
added locations to the host anyway).  Updates are in place where the
reference returned new arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .ops import knn as K


@dataclasses.dataclass
class PointLevel:
    pos: torch.Tensor      # (N_cap, 3)
    normal: torch.Tensor   # (N_cap, 2) spherical normal angles
    geo: torch.Tensor      # (N_cap, c_dim)
    col: torch.Tensor      # (N_cap, c_dim)
    count: int

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def make_level(capacity: int, c_dim: int, device) -> PointLevel:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return PointLevel(pos=z(capacity, 3), normal=z(capacity, 2),
                      geo=z(capacity, c_dim), col=z(capacity, c_dim),
                      count=0)


def grow_level(level: PointLevel, new_capacity: int) -> PointLevel:
    pad = new_capacity - level.capacity
    if pad <= 0:
        raise ValueError("grow_level: new capacity must be larger")
    z = lambda a: torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return PointLevel(pos=z(level.pos), normal=z(level.normal),
                      geo=z(level.geo), col=z(level.col), count=level.count)


@torch.no_grad()
def add_points(level: PointLevel, tile_index, gen: torch.Generator, rays_o,
               rays_d, gt_depth, valid, r_add, near_surface: float,
               far_surface: float, n_add: int = 3, normals=None) -> int:
    """Masked insertion of up to B ray locations x n_add points into
    ``level`` (in place).  Returns the number of locations added."""
    B = rays_o.shape[0]
    pts_gt = rays_o + rays_d * gt_depth[:, None]
    D1, _ = K.knn_tiles(pts_gt, *tile_index, k=1, probe=32)
    keep = valid & (D1[:, 0] >= torch.square(r_add))
    t = torch.linspace(0.0, 1.0, n_add, device=rays_o.device)
    z_vals = near_surface * gt_depth[:, None] * (1 - t) \
        + far_surface * gt_depth[:, None] * t
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    C = level.geo.shape[1]
    geo_new = 0.1 * torch.randn((B, n_add, C), generator=gen,
                                device=rays_o.device)
    col_new = 0.1 * torch.randn((B, n_add, C), generator=gen,
                                device=rays_o.device)
    n_locs = int(keep.sum())
    if n_locs == 0:
        return 0
    if level.count + n_locs * n_add > level.capacity:
        raise ValueError("add_points: capacity exceeded (ensure_capacity "
                         "first)")
    # de-interleaved destinations: sibling s of kept location r goes to
    # count + s*n_locs + r (as the reference)
    dest = (level.count + torch.arange(n_locs, device=rays_o.device)[:, None]
            + n_locs * torch.arange(n_add, device=rays_o.device)[None, :])
    dest = dest.reshape(-1)
    level.pos[dest] = pts[keep].reshape(-1, 3)
    level.geo[dest] = geo_new[keep].reshape(-1, C)
    level.col[dest] = col_new[keep].reshape(-1, C)
    if normals is not None:
        level.normal[dest] = normals[keep][:, None, :].expand(
            -1, n_add, -1).reshape(-1, 2)
    else:
        level.normal[dest] = 0.0
    level.count += n_locs * n_add
    return n_locs


class NeuralPointCloud:
    """Host-side owner of the two-level point store."""

    GROWTH_HEADROOM = 32768
    TILE_COUNT_CAP = 4096

    def __init__(self, cfg: dict, device, initial_capacity: int = 1 << 16):
        pc = cfg["pointcloud"]
        initial_capacity = int(pc.get("initial_capacity", initial_capacity))
        self.cfg = cfg
        self.device = device
        self.c_dim = cfg["model"]["c_dim"]
        self.nn_num = pc["nn_num"]
        self.N_add = pc["N_add"]
        self.near_end_surface = pc["near_end_surface"]
        self.far_end_surface = pc["far_end_surface"]
        self.radius_add = pc["radius_add"]
        self.radius_min = pc["radius_min"]
        self.levels: Dict[str, PointLevel] = {
            lvl: make_level(initial_capacity, self.c_dim, device)
            for lvl in pc["radius_hierarchy"].keys()}
        self._input_pos: list = []
        self._input_rgb: list = []
        self._tile_index: Dict[str, tuple] = {}
        self._index_dirty: Dict[str, bool] = {}
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(cfg.get("seed", 1219)) + 1)

    def ensure_capacity(self, level: str, incoming: int):
        lv = self.levels[level]
        need = lv.count + incoming
        if need > lv.capacity:
            new_cap = max(lv.capacity * 2, 1 << (need - 1).bit_length())
            self.levels[level] = grow_level(lv, new_cap)
            self._index_dirty[level] = True

    def index(self, level: str):
        """Tile index of the level's current cloud (lazy rebuild)."""
        if self._index_dirty.get(level, True) or level not in self._tile_index:
            lv = self.levels[level]
            tile = max(128, lv.capacity // self.TILE_COUNT_CAP)
            self._tile_index[level] = K.build_tiles(lv.pos, lv.count,
                                                    tile=tile)
            self._index_dirty[level] = False
        return self._tile_index[level]

    def pts_num(self) -> Dict[str, int]:
        return {k: int(v.count) for k, v in self.levels.items()}

    def input_pos(self):
        return self._input_pos

    def input_rgb(self):
        return self._input_rgb

    @torch.no_grad()
    def scatter_feats(self, idx, geo, col, level: str):
        """Write back a compacted row subset; ids equal to the capacity
        (compaction padding) are dropped."""
        lv = self.levels[level]
        keep = idx < lv.capacity
        lv.geo[idx[keep]] = geo[keep]
        lv.col[idx[keep]] = col[keep]

    def add_neural_points(self, rays_o, rays_d, gt_depth, gt_color,
                          level: str, dynamic_radius=None,
                          is_pts_grad: bool = False, valid=None,
                          record_input: bool = True) -> int:
        """Insert points for one batch of rays (host numpy inputs); returns
        the number of locations added."""
        dev = self.device
        rays_o = torch.as_tensor(np.asarray(rays_o, np.float32), device=dev)
        rays_d = torch.as_tensor(np.asarray(rays_d, np.float32), device=dev)
        gt_depth = torch.as_tensor(np.asarray(gt_depth, np.float32),
                                   device=dev)
        B = rays_o.shape[0]
        if B == 0:
            return 0
        if valid is None:
            valid = gt_depth > 0
        else:
            valid = torch.as_tensor(np.asarray(valid), device=dev) \
                & (gt_depth > 0)
        if dynamic_radius is None:
            r = self.radius_min if is_pts_grad else self.radius_add
            r_add = torch.full((B,), r, dtype=torch.float32, device=dev)
        else:
            r_add = torch.as_tensor(np.asarray(dynamic_radius, np.float32),
                                    device=dev)
        if record_input:
            pts_gt = (rays_o + rays_d * gt_depth[:, None]).cpu().numpy()
            vm = valid.cpu().numpy()
            self._input_pos.extend(pts_gt[vm].tolist())
            self._input_rgb.extend((np.asarray(gt_color)[vm]
                                    * 255.0).tolist())
        self.ensure_capacity(level, B * self.N_add)
        n = add_points(self.levels[level], self.index(level), self.gen,
                       rays_o, rays_d, gt_depth, valid, r_add,
                       self.near_end_surface, self.far_end_surface,
                       n_add=self.N_add)
        self._index_dirty[level] = True
        return n
