"""Frozen copy of hpslam_tpu_torch/ops/composite.py for the benchmark's
reference (imports nothing of the program).

Volume compositor (port of hpslam_tpu/ops/composite.py)."""
from __future__ import annotations

import torch


def raw2outputs(raw, z_vals, rays_d, occupancy: bool = True,
                coef: float = 0.1):
    """(N, S, 4) RGB + occupancy logit -> depth (N,), depth variance (N,),
    rgb (N, 3), weights (N, S).  Transmittance uses the 1e-10 epsilon of
    the reference."""
    rgb = raw[..., :3]
    if occupancy:
        alpha = torch.sigmoid(coef * raw[..., -1])
    else:
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)],
                          -1) * torch.linalg.norm(rays_d[..., None, :],
                                                  dim=-1)
        alpha = 1.0 - torch.exp(-torch.relu(raw[..., -1]) * dists)
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], -1),
                          -1)[..., :-1]
    weights = alpha * trans
    weights_sum = torch.sum(weights, dim=-1) + 1e-10
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2) \
        / weights_sum[..., None]
    depth_map = torch.sum(weights * z_vals, dim=-1) / weights_sum
    tmp = z_vals - depth_map[..., None]
    depth_var = torch.sum(weights * tmp * tmp, dim=-1)
    return depth_map, depth_var, rgb_map, weights
