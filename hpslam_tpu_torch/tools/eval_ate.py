"""Absolute-trajectory-error evaluation (the port's copy of
hpslam_tpu/tools/eval_ate.py; reference src/tools/eval_ate.py,
itself derived from the standard TUM RGB-D benchmark script).

Semantics preserved: NaN/Inf ground-truth poses are masked before pairing
(ScanNet has some, eval_ate.py:250-267), alignment is Horn's closed-form
SE(3) fit, and the summary dict uses the same keys.  Runs in-process from
the SLAM loop (the reference shells out to a subprocess, Mapper.py:1222-1244)
and as a CLI over a checkpoint.  ``plot`` names a PNG of the x-y
trajectories (``plot_trajectories``), drawn without matplotlib.
"""
from __future__ import annotations

import argparse

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
    """Closed-form SE(3) alignment of model onto data (both 3xN).

    Returns (rot 3x3, trans 3x1, per-point translational error (N,)).
    """
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _d, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    aligned = rot @ model + trans
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return rot, trans, err


def ate_stats(trans_error: np.ndarray) -> dict:
    return {
        "compared_pose_pairs": int(len(trans_error)),
        "absolute_translational_error.rmse":
            float(np.sqrt(np.mean(trans_error ** 2))),
        "absolute_translational_error.mean": float(np.mean(trans_error)),
        "absolute_translational_error.median": float(np.median(trans_error)),
        "absolute_translational_error.std": float(np.std(trans_error)),
        "absolute_translational_error.min": float(np.min(trans_error)),
        "absolute_translational_error.max": float(np.max(trans_error)),
    }


def pose_mask(c2w_list: np.ndarray, n: int) -> np.ndarray:
    """Valid-pose mask: finite GT entries only (eval_ate.py:250-267)."""
    m = np.ones(n + 1, bool)
    for i in range(n + 1):
        if not np.isfinite(c2w_list[i]).all():
            m[i] = False
    return m


# the reference's figure: matplotlib's default 6.4 x 4.8 inches at 200 dpi
# and its default axes box (left 0.125, right 0.9, bottom 0.11, top 0.88)
PLOT_HW = (960, 1280)
PLOT_BOX = (160, 115, 1152, 854)
GT_COLOR = (0, 0, 0)           # "black"
EST_COLOR = (0, 0, 255)        # matplotlib's "blue"


def plot_trajectories(path: str, gt_xyz: np.ndarray, est_xyz: np.ndarray):
    """Ground truth in black and the (aligned) estimate in blue, in x-y,
    as polylines on one box with matplotlib's 5 % data margins, on a white
    canvas written as a PNG (``utils/telemetry.py``'s canvas; the card's
    machine has no matplotlib).  Deliberate deviation from the reference's
    figure: no title, legend, ticks or axis labels (there is no font)."""
    from ..utils.image_io import write_png
    from ..utils.telemetry import _draw_frame, _draw_polyline, project
    img = np.full(PLOT_HW + (3,), 255, np.uint8)
    _draw_frame(img, PLOT_BOX)
    series = []
    for xyz, color in ((gt_xyz, GT_COLOR), (est_xyz, EST_COLOR)):
        xy = np.asarray(xyz, np.float64)[:2]
        series.append((xy[:, np.isfinite(xy).all(0)], color))
    both = np.concatenate([xy for xy, _ in series], axis=1)
    if both.size:
        lims = []
        for lo, hi in zip(both.min(1), both.max(1)):
            pad = 0.05 * (hi - lo)
            lims.append((lo - pad, hi + pad))
        for xy, color in series:
            if xy.shape[1]:
                px, py = project(xy[0], xy[1], PLOT_BOX, *lims)
                _draw_polyline(img, px, py, color)
    write_png(path, img)


def evaluate_trajectory(gt_c2w_list, est_c2w_list, n: int, scale: float = 1.0,
                        plot: str | None = None,
                        use_alignment: bool = True) -> dict:
    gt = np.asarray(gt_c2w_list, np.float64)
    est = np.asarray(est_c2w_list, np.float64)
    mask = pose_mask(gt, n)
    gt_xyz = (gt[: n + 1, :3, 3] / scale)[mask].T    # (3, M)
    est_xyz = (est[: n + 1, :3, 3] / scale)[mask].T

    if use_alignment:
        rot, trans, err = horn_align(est_xyz, gt_xyz)
        est_aligned = rot @ est_xyz + trans
    else:
        err = np.sqrt(np.sum((est_xyz - gt_xyz) ** 2, axis=0))
        est_aligned = est_xyz

    if plot:
        plot_trajectories(plot, gt_xyz, est_aligned)
    return ate_stats(err)


def main(argv=None):
    from .. import config as C
    from ..utils.logger import latest_checkpoint, load_checkpoint

    p = argparse.ArgumentParser(description="Evaluate tracking ATE.")
    p.add_argument("config", type=str)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--no_align", action="store_true")
    args = p.parse_args(argv)

    cfg = C.load_config(args.config, "configs/point_slam.yaml")
    output = args.output or cfg["data"]["output"]
    ck = latest_checkpoint(output)
    if ck is None:
        print("no checkpoint found under", output)
        return 1
    state = load_checkpoint(ck)
    align_opt = "no_align" if args.no_align else "aligned"
    results = evaluate_trajectory(
        state["gt_c2w_list"], state["estimate_c2w_list"], state["idx"],
        cfg["scale"], plot=f"{output}/eval_ate_{align_opt}.png",
        use_alignment=not args.no_align)
    print(results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
