#!/usr/bin/env python
"""Scene-tree preflight: validate a dataset tree against its config before
a long SLAM run on it (port of hpslam_tpu/tools/preflight.py, the same
checks and levels, on the port's readers).

Checks (hard failures marked [F], warnings [W]):
  [F] the tree has frames; colour / depth / pose file counts match
  [F] not every pose is non-finite ([W] if some are: eval_ate masks them);
      pose bottom rows [0, 0, 0, 1]; the first rotation orthonormal
  [W] pose translation span against mapping.bound
  [F] the first colour file decodes (JPEG through the port's own decoder)
      and its resolution is reported
  [F] frames 0, n/2, n-1 decode, their depth is non-empty and its median
      lies in 0.1-20 m after cam.png_depth_scale, and the post-crop shape
      is what cam.H / W / crop give
  [W] principal point near the image centre; fx / fy aspect
  [W] cross-frame depth reprojection (frame 0 into a frame 5-25 degrees
      away) within 15 % median error: an axis flip, a depth scale or a
      pose convention mismatch breaks it
  A runtime estimate from the config's budgets, scaled from per-iteration
  costs that chip_smoke.py's slam_scannet run measured on one card (the
  constants below), not from TPU figures.

Usage:
  python -m hpslam_tpu_torch.tools.preflight configs/ScanNet/scene0059.yaml
      [--input_folder PATH] [--frames N]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

# per-iteration wall time at the ScanNet operating point (480x640,
# configs/ScanNet/scene0059.yaml's full width), from chip_smoke.py's
# slam_scannet run: track_ms_mean over its 30 tracking iterations of 5000
# pixels, map_ms_mean over its mean mapping iterations of 10000 pixels
# (88 a mapped frame), on "NVIDIA H100 80GB HBM3, 700.00 W"; the run that
# measured them is recorded in PERF.md (§7); host-noisy, up to 2x
# between runs
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
TRACK_MS_PER_ITER = 22.966     # at 5000 pixels
MAP_MS_PER_ITER = 28.556       # at 10000 pixels


def fail(msgs, msg):
    msgs.append(("FAIL", msg))


def warn(msgs, msg):
    msgs.append(("warn", msg))


def ok(msgs, msg):
    msgs.append(("ok", msg))


def _reprojection(msgs, ds, poses, finite, n, cam):
    """Back-project a sparse grid of frame 0's depth through pose 0 into a
    frame with 5-25 degrees of relative rotation (else frame 2) and
    compare with that frame's depth."""
    fx, fy = float(cam["fx"]), float(cam["fy"])
    cx, cy = float(cam["cx"]), float(cam["cy"])
    Ta = poses[0].astype(np.float64)
    bi = min(2, n - 1)
    for j in range(1, n):
        if not finite[j]:
            continue
        Rrel = Ta[:3, :3].T @ poses[j][:3, :3]
        ang = np.degrees(np.arccos(np.clip((np.trace(Rrel) - 1) / 2, -1,
                                           1)))
        if 5.0 <= ang <= 25.0:
            bi = j
        elif ang > 25.0:
            break
    fa, fb = ds[0], ds[bi]
    Tb_inv = np.linalg.inv(poses[bi].astype(np.float64))
    Hc, Wc = fa.depth.shape
    e = int(cam.get("crop_edge", 0) or 0)
    cx_c, cy_c = cx - e, cy - e
    jj, ii = np.mgrid[8:Hc - 8:12, 8:Wc - 8:12]
    jj, ii = jj.ravel(), ii.ravel()
    d = fa.depth[jj, ii]
    keep = d > 0
    jj, ii, d = jj[keep], ii[keep], d[keep]
    dirs = np.stack([(ii - cx_c) / fx, -(jj - cy_c) / fy, -np.ones_like(d)],
                    -1)
    pw = (Ta[:3, :3] @ (dirs * d[:, None]).T).T + Ta[:3, 3]
    pc = (Tb_inv[:3, :3] @ pw.T).T + Tb_inv[:3, 3]
    zb = -pc[:, 2]
    infront = zb > 1e-3
    ib = cx_c + fx * pc[:, 0] / np.maximum(zb, 1e-6)
    jb = cy_c - fy * pc[:, 1] / np.maximum(zb, 1e-6)
    inside = infront & (ib >= 0) & (ib < Wc - 1) & (jb >= 0) & (jb < Hc - 1)
    if inside.sum() < 50:
        warn(msgs, "reprojection check: frames 0/2 barely overlap — "
                   "skipped")
        return
    db = fb.depth[jb[inside].astype(int), ib[inside].astype(int)]
    valid = db > 0
    if valid.sum() < 50:
        warn(msgs, "reprojection check: too few valid target depths (low "
                   "overlap?)")
        return
    rel = np.abs(db[valid] - zb[inside][valid]) / np.maximum(db[valid], 1e-6)
    med_rel = float(np.median(rel))
    if med_rel > 0.15:
        warn(msgs, f"cross-frame depth reprojection median error "
                   f"{100 * med_rel:.0f}% — axis flip / depth scale / pose "
                   "convention mismatch likely")
    else:
        ok(msgs, f"cross-frame depth reprojection consistent (median "
                 f"{100 * med_rel:.1f}% over {int(valid.sum())} px)")


def preflight(cfg: dict, input_folder=None, n_check: int = 3) -> list:
    """Run all checks; returns [(level, message)], 'FAIL' entries being
    hard failures."""
    from ..utils import image_io as IO
    from ..utils.datasets import get_dataset

    msgs = []
    try:
        ds = get_dataset(cfg, input_folder=input_folder)
    except Exception as e:  # noqa: BLE001 -- any reader error is the finding
        fail(msgs, f"dataset constructor failed: {type(e).__name__}: {e}")
        return msgs
    n = ds.n_img
    if n == 0:
        fail(msgs, f"no frames found under {ds.input_folder!r} (dataset "
                   f"{cfg['dataset']!r} glob patterns)")
        return msgs
    ok(msgs, f"{n} color frames under {ds.input_folder}")
    color_paths = getattr(ds, "color_paths", [])
    depth_paths = getattr(ds, "depth_paths", [])
    if color_paths or depth_paths:
        nc, nd = len(color_paths), len(depth_paths)
        if nd != nc:
            fail(msgs, f"color/depth count mismatch: {nc} color vs {nd} "
                       "depth")
    else:
        ok(msgs, "virtual dataset (no files) — skipping count checks")
    npo = len(ds.poses)
    if npo != n:
        fail(msgs, f"color/pose count mismatch: {n} color vs {npo} poses")

    poses = np.asarray(ds.poses, np.float64) if npo else np.zeros((0, 4, 4))
    finite = np.isfinite(poses).all(axis=(1, 2))
    n_bad = int((~finite).sum())
    if npo and n_bad == npo:
        fail(msgs, "ALL poses are non-finite — wrong/corrupt pose files")
    elif n_bad:
        warn(msgs, f"{n_bad}/{npo} poses non-finite (eval_ate masks them; "
                   "ScanNet scenes do ship some)")
    else:
        ok(msgs, "all poses finite")
    if npo and finite.any():
        fp = poses[finite]
        br = np.abs(fp[:, 3, :] - np.array([0, 0, 0, 1.0])).max()
        if br > 1e-3:
            fail(msgs, f"pose bottom row not [0,0,0,1] (max err {br:.2g}) — "
                       "row-major/column-major mixup?")
        R = fp[0, :3, :3]
        ortho = np.abs(R @ R.T - np.eye(3)).max()
        if ortho > 1e-2:
            fail(msgs, f"first pose rotation not orthonormal (err "
                       f"{ortho:.2g})")
        span = fp[:, :3, 3].max(0) - fp[:, :3, 3].min(0)
        ok(msgs, "trajectory span (m): "
                 + np.array2string(span, precision=2))
        bound = cfg.get("mapping", {}).get("bound")
        if bound is not None:
            b = np.asarray(bound, np.float64)
            lo, hi = fp[:, :3, 3].min(0), fp[:, :3, 3].max(0)
            if (lo < b[:, 0]).any() or (hi > b[:, 1]).any():
                warn(msgs, f"trajectory [{lo.round(2)}..{hi.round(2)}] "
                           f"escapes mapping.bound {bound}")
            else:
                ok(msgs, "trajectory inside mapping.bound")

    cam = cfg["cam"]
    H_cfg, W_cfg = int(cam["H"]), int(cam["W"])
    if color_paths:
        try:
            raw = IO.read_color(color_paths[0])
            ok(msgs, f"first color file decodes: {raw.shape[1]}x"
                     f"{raw.shape[0]} (config {W_cfg}x{H_cfg} pre-crop; "
                     "the reader resizes colour to the depth's size)")
        except Exception as e:  # noqa: BLE001 -- the decode error is the finding
            fail(msgs, f"first color file failed to decode: "
                       f"{type(e).__name__}: {e}")
    for idx in sorted({0, n // 2, n - 1})[:max(1, n_check)]:
        try:
            fr = ds[idx]
        except Exception as e:  # noqa: BLE001
            fail(msgs, f"frame {idx} failed to decode: "
                       f"{type(e).__name__}: {e}")
            continue
        d = fr.depth
        valid = d[d > 0]
        if valid.size == 0:
            fail(msgs, f"frame {idx}: depth image all-zero")
            continue
        med = float(np.median(valid))
        if not (0.1 <= med <= 20.0):
            fail(msgs, f"frame {idx}: median depth {med:.3g} m implausible "
                       f"— wrong cam.png_depth_scale "
                       f"({cam['png_depth_scale']})?")
        else:
            ok(msgs, f"frame {idx}: median depth {med:.2f} m, "
                     f"{100 * valid.size / d.size:.0f}% valid")
        e = int(cam.get("crop_edge", 0) or 0)
        exp = (H_cfg - 2 * e, W_cfg - 2 * e)
        if cam.get("crop_size"):
            h, w = cam["crop_size"]
            exp = (h - 2 * e, w - 2 * e)
        if fr.depth.shape != exp:
            fail(msgs, f"frame {idx}: post-crop shape {fr.depth.shape} != "
                       f"expected {exp} from cam.H/W/crop")

    cx, cy = float(cam["cx"]), float(cam["cy"])
    if not (0.3 * W_cfg < cx < 0.7 * W_cfg) or \
            not (0.3 * H_cfg < cy < 0.7 * H_cfg):
        warn(msgs, f"principal point ({cx:.0f},{cy:.0f}) far from image "
                   f"center ({W_cfg / 2:.0f},{H_cfg / 2:.0f}) — transposed "
                   "or unscaled intrinsics?")
    fx, fy = float(cam["fx"]), float(cam["fy"])
    if not (0.5 < fx / fy < 2.0):
        warn(msgs, f"fx/fy aspect {fx / fy:.2f} unusual")

    if n >= 3 and npo == n and finite[:min(3, n)].all():
        try:
            _reprojection(msgs, ds, poses, finite, n, cam)
        except Exception as ex:  # noqa: BLE001 -- diagnostic only
            warn(msgs, f"reprojection check errored: {type(ex).__name__}: "
                       f"{ex}")

    t, m = cfg["tracking"], cfg["mapping"]
    per_frame_ms = (TRACK_MS_PER_ITER * t["iters"] * t["pixels"] / 5000
                    + MAP_MS_PER_ITER * m["iters"] * m["pixels"] / 10000
                    / max(1, m["every_frame"]))
    ok(msgs, f"estimated runtime: ~{per_frame_ms:.0f} ms/frame x {n} frames"
             f" ≈ {n * per_frame_ms / 6e4:.0f} min on one {CARD} (scaled "
             "from chip_smoke.py's slam_scannet; + meshing/eval)")
    return msgs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--input_folder", default=None)
    ap.add_argument("--frames", type=int, default=3,
                    help="frames to decode-check")
    args = ap.parse_args(argv)
    from ..config import default_config_path, load_config
    cfg = load_config(args.config, default_config_path())
    msgs = preflight(cfg, input_folder=args.input_folder,
                     n_check=args.frames)
    n_fail = 0
    for level, msg in msgs:
        print(f"[{level:4s}] {msg}")
        n_fail += level == "FAIL"
    print(f"preflight: {'FAIL' if n_fail else 'OK'} ({n_fail} hard "
          "failure(s))")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
