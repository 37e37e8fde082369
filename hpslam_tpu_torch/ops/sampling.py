"""Ray-depth samplers (port of hpslam_tpu/ops/sampling.py).

Random draws are passed in (``u`` for sample_pdf) or drawn by the caller
from a ``torch.Generator``: the port cannot reproduce ``jax.random``.
"""
from __future__ import annotations

import torch


def surface_z_vals(gt_depth, n_surface: int, near_end_surface: float,
                   far_end_surface: float, fix_interval: bool = False):
    """Depth-guided z values in [near*d, far*d]; (N,) -> (N, n_surface)."""
    t = torch.linspace(0.0, 1.0, n_surface, device=gt_depth.device)
    d = gt_depth[..., None]
    if fix_interval:
        return d + torch.linspace(-0.04, 0.04, n_surface,
                                  device=gt_depth.device)[None, :]
    return near_end_surface * d * (1.0 - t) + far_end_surface * d * t


def uniform_z_vals(n_rays: int, n_surface: int, near: float, far,
                   device=None):
    z = torch.linspace(near, float(far), n_surface, device=device)
    return z.expand(n_rays, n_surface)


def sample_pdf(bins, weights, u):
    """Inverse-CDF sampling.  bins (B, M+1), weights (B, M), u (B, n)
    uniforms in [0, 1) (or a deterministic linspace).  Returns (B, n)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def far_bound_from_depth(gt_depth_batch):
    """min(5*mean(d), max(1.2*d))."""
    return torch.minimum(5.0 * torch.mean(gt_depth_batch),
                         torch.max(gt_depth_batch * 1.2))
