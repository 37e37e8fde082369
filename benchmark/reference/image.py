"""Frozen copy of hpslam_tpu_torch/ops/image.py for the benchmark's
reference (imports nothing of the program).

Host-side image ops: grayscale, Sobel gradients, dynamic radius maps
(the port's own copy of hpslam_tpu/ops/image.py; numpy/scipy only).

These run once per frame on the host (numpy), feeding the device pipeline —
mirroring the reference's per-frame skimage/scipy preprocessing
(src/Tracker.py:297-325, src/Mapper.py:1026-1050).  Kept in numpy on purpose:
they are O(H*W) and off the hot path (SURVEY.md §7 host/device split).
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

# skimage.color.rgb2gray luma weights (ITU-R 601-2 as used by the reference)
_GRAY_W = np.array([0.2125, 0.7154, 0.0721])

# skimage.filters.sobel_h/sobel_v kernels (normalised by 4)
_SOBEL_H = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=np.float64) / 4.0
_SOBEL_V = _SOBEL_H.T


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float image in [0,1] -> (H, W) intensity."""
    return img @ _GRAY_W


def sobel_grad_mag(intensity: np.ndarray) -> np.ndarray:
    """Sobel gradient magnitude with reflect padding (skimage convention).

    Reference: src/Tracker.py:299-302 / src/common.py:174-183.
    """
    gy = ndimage.convolve(intensity, _SOBEL_H, mode="reflect")
    gx = ndimage.convolve(intensity, _SOBEL_V, mode="reflect")
    return np.sqrt(gx**2 + gy**2)


def color_grad_mag(color: np.ndarray, threshold: float) -> np.ndarray:
    """Clipped colour-gradient magnitude used for dynamic radii
    (src/Tracker.py:298-305)."""
    g = sobel_grad_mag(rgb2gray(color))
    return np.clip(g, 0.0, threshold)


def radius_map(grad_mag: np.ndarray, r_max: float, r_min: float,
               threshold: float) -> np.ndarray:
    """Piecewise-linear gradient->radius map.

    Equivalent to the reference's scipy ``interp1d([0, 0.01, thr],
    [r_max, r_max, r_min])`` (src/Tracker.py:314-318): flat at r_max below
    grad 0.01, linear down to r_min at the clip threshold.
    """
    t = np.clip((grad_mag - 0.01) / max(threshold - 0.01, 1e-12), 0.0, 1.0)
    return r_max + t * (r_min - r_max)


def dynamic_radii(color: np.ndarray, radius_hierarchy: dict, query_ratio: float,
                  threshold: float):
    """Per-level (r_add, r_query) maps for one frame.

    radius_hierarchy: {level: {'radius_add_max_*': .., 'radius_add_min_*': ..}}
    exactly as in configs/point_slam.yaml:197-203 (first key = max, second =
    min, matching the reference's ``list(keys())[0/1]`` access,
    src/Tracker.py:311-312).
    Returns ({level: r_add HxW}, {level: r_query HxW}) float32 arrays.
    """
    grad = color_grad_mag(color, threshold)
    r_add, r_query = {}, {}
    for level, rcfg in radius_hierarchy.items():
        keys = list(rcfg.keys())
        rmax, rmin = rcfg[keys[0]], rcfg[keys[1]]
        r_add[level] = radius_map(grad, rmax, rmin, threshold).astype(np.float32)
        r_query[level] = radius_map(
            grad, query_ratio * rmax, query_ratio * rmin, threshold
        ).astype(np.float32)
    return r_add, r_query


def top_grad_index_pool(color: np.ndarray, n: int, H0: int, H1: int, W0: int,
                        W1: int, ratio: int = 15, gt_depth: np.ndarray | None = None,
                        depth_limit: bool = False) -> np.ndarray:
    """Pool of top colour-gradient pixel indices within a region.

    Reference: ``get_selected_index_with_grad`` (src/common.py:199-233) —
    takes the top ``ratio*n`` gradient pixels image-wide, then masks to the
    region (and positive depth).  Returns flat indices into (H, W).
    """
    grad = sobel_grad_mag(rgb2gray(color))
    H, W = grad.shape
    k = min(ratio * n, grad.size)
    sel = np.argpartition(grad, -k, axis=None)[-k:]
    hh, ww = np.unravel_index(sel, (H, W))
    mask = (hh >= H0) & (hh < H1) & (ww >= W0) & (ww < W1)
    if gt_depth is not None:
        d = gt_depth[hh, ww]
        mask &= (d > 0.0) & (d <= 5.0) if depth_limit else (d > 0.0)
    hh, ww = hh[mask], ww[mask]
    return np.ravel_multi_index((hh, ww), (H, W))


def valid_pixel_pool(depth: np.ndarray, H0: int, H1: int, W0: int, W1: int,
                     depth_limit: float | None = None) -> np.ndarray:
    """Flat indices of pixels with positive (optionally bounded) depth inside
    a region — the sampling pool replacing the reference's sample-then-filter
    (src/common.py:236-258).

    Zero-depth exclusion is REFERENCE PARITY, not a shortcut: both the
    reference tracker (src/Tracker.py:164-168) and mapper optimization
    (src/Mapper.py:718) call get_samples with ``depth_filter=True``, which
    drops depth==0 pixels before rendering.  The reference's
    ``sample_near_pcl`` zero-depth path (src/utils/Renderer.py:196-208)
    only fires in full-image rendering (visualization / meshing), which we
    mirror via ``renderer.sample_near_pcl_z``."""
    H, W = depth.shape
    jj, ii = np.mgrid[H0:H1, W0:W1]
    d = depth[H0:H1, W0:W1]
    m = d > 0
    if depth_limit is not None:
        m &= d < depth_limit
    return np.ravel_multi_index((jj[m], ii[m]), (H, W))
