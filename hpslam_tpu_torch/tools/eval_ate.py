"""Absolute-trajectory-error evaluation (the port's copy of
hpslam_tpu/tools/eval_ate.py; reference src/tools/eval_ate.py,
itself derived from the standard TUM RGB-D benchmark script).

Semantics preserved: NaN/Inf ground-truth poses are masked before pairing
(ScanNet has some, eval_ate.py:250-267), alignment is Horn's closed-form
SE(3) fit, and the summary dict uses the same keys.  Runs in-process from
the SLAM loop (the reference shells out to a subprocess, Mapper.py:1222-1244)
and as a CLI over a checkpoint.
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


def evaluate_trajectory(gt_c2w_list, est_c2w_list, n: int, scale: float = 1.0,
                        plot: str | None = None, use_alignment: bool = True,
                        scene: str = "") -> dict:
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
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots()
            rmse = np.sqrt(np.mean(err ** 2))
            ax.set_title(f"ate-rmse of {err.size} pose pairs "
                         f"({'aligned' if use_alignment else 'no_align'}): "
                         f"{rmse:0.4f}m {scene}")
            ax.plot(gt_xyz[0], gt_xyz[1], "-", color="black",
                    label="ground truth")
            ax.plot(est_aligned[0], est_aligned[1], "-", color="blue",
                    label="estimated")
            ax.legend()
            ax.set_xlabel("x [m]")
            ax.set_ylabel("y [m]")
            fig.savefig(plot, dpi=200)
            plt.close(fig)
        except Exception as e:  # noqa: BLE001 — plotting is best-effort
            print(f"ATE plot failed: {e}")
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
        use_alignment=not args.no_align, scene=args.config)
    print(results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
