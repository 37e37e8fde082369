"""Frozen copy of hpslam_tpu_torch/ops/sampling.py for the benchmark's
reference (imports nothing of the program).

Ray-depth samplers; pixel draws from an explicit ``torch.Generator``
(``sample_indices``).
"""
from __future__ import annotations

import torch


def sample_indices(gen: torch.Generator, pool: torch.Tensor,
                   n: int) -> torch.Tensor:
    """n flat pixel indices drawn uniformly, with replacement, from
    ``pool`` (the valid pixels) with the explicit generator ``gen`` (on
    ``pool``'s device)."""
    choice = torch.randint(0, pool.shape[0], (n,), generator=gen,
                           device=pool.device)
    return pool[choice]


def surface_z_vals(gt_depth, n_surface: int, near_end_surface: float,
                   far_end_surface: float, fix_interval: bool = False):
    """Depth-guided z values in [near*d, far*d]; (N,) -> (N, n_surface)."""
    t = torch.linspace(0.0, 1.0, n_surface, device=gt_depth.device)
    d = gt_depth[..., None]
    if fix_interval:
        return d + torch.linspace(-0.04, 0.04, n_surface,
                                  device=gt_depth.device)[None, :]
    return near_end_surface * d * (1.0 - t) + far_end_surface * d * t


def far_bound_from_depth(gt_depth_batch):
    """min(5*mean(d), max(1.2*d))."""
    return torch.minimum(5.0 * torch.mean(gt_depth_batch),
                         torch.max(gt_depth_batch * 1.2))
