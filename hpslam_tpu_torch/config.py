"""Config system: recursive YAML inheritance + CLI flag overrides.

The port's own copy of hpslam_tpu/config.py (same merge rules and flags,
plus ``--device``).  YAML is read with PyYAML.

Behavioural parity with the reference (src/config.py:10-56 `inherit_from`
chains, src/Point_SLAM.py:62-139 flag table): a scene yaml inherits a
dataset yaml inherits configs/point_slam.yaml; paired --use_x/--no_x CLI
flags win over the files.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import yaml


def update_recursive(dst: dict, src: dict) -> dict:
    """Deep-merge src into dst (src wins)."""
    for k, v in src.items():
        if isinstance(v, dict):
            node = dst.setdefault(k, {})
            if isinstance(node, dict):
                update_recursive(node, v)
            else:
                dst[k] = v
        else:
            dst[k] = v
    return dst


def load_config(path: str, default_path: Optional[str] = None) -> dict:
    """Load a config file, following its ``inherit_from`` chain."""
    with open(path, "r") as f:
        cfg_special = yaml.safe_load(f)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        # inherit paths are repo-root-relative like the reference's
        if not os.path.exists(inherit_from):
            here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            cand = os.path.join(here, inherit_from)
            if os.path.exists(cand):
                inherit_from = cand
        cfg = load_config(inherit_from, default_path)
    elif default_path is not None and os.path.abspath(default_path) != os.path.abspath(path):
        with open(default_path, "r") as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = {}
    update_recursive(cfg, cfg_special)
    cfg.setdefault("config_path", path)
    return cfg


# ---------------------------------------------------------------------------
# CLI surface (reference run.py:24-72; same public flag set)

_PAIRED_FLAGS = [
    # (on_flag, off_flag, cfg_path)
    ("dynamic_r", "fixed_r", ("use_dynamic_radius",)),
    ("use_viewdir", "no_viewdir", ("use_view_direction",)),
    ("encode_viewdir", "no_encode_viewdir", ("model", "encode_viewd")),
    ("use_exposure", "no_exposure", ("model", "encode_exposure")),
    ("end_correct", "no_end_correct", ("mapping", "end_correction")),
    ("use_color_track", "no_color_track", ("tracking", "use_color_in_tracking")),
    ("use_BA", "no_BA", ("mapping", "BA")),
    ("wandb", "no_wandb", ("wandb",)),
    ("rel_pos_in_col", "no_rel_pos_in_col", ("model", "encode_rel_pos_in_col")),
    ("eval_img", "no_eval_img", ("rendering", "eval_img")),
    ("depth_limit", "no_depth_limit", ("tracking", "depth_limit")),
    ("track_color", "track_uniform", ("tracking", "sample_with_color_grad")),
]

_VALUE_FLAGS = [
    ("radius_add_max", float, ("pointcloud", "radius_add_max")),
    ("radius_add", float, ("pointcloud", "radius_add")),
    ("radius_query", float, ("pointcloud", "radius_query")),
    ("track_w_color_loss", float, ("tracking", "w_color_loss")),
    ("track_iter", int, ("tracking", "iters")),
    ("resample", int, ("tracking", "resample_stages")),
    ("union_size", int, ("mapping", "union_size")),
    ("map_iter", int, ("mapping", "iters")),
    ("min_iter_ratio", float, ("mapping", "min_iter_ratio")),
    ("map_every", int, ("mapping", "every_frame")),
    ("kf_every", int, ("mapping", "keyframe_every")),
    ("map_win_size", int, ("mapping", "mapping_window_size")),
    ("kf_t_thre", float, ("mapping", "kf_trans_thre")),
    ("kf_r_thre", float, ("mapping", "kf_rot_thre")),
    ("project_name", str, ("project_name",)),
    # SPMD device-mesh spec for the production engines: "dp8", "dp4,tp2",
    # or a bare device count (framework extension — the reference has no
    # distributed backend, SURVEY.md §2)
    ("mesh", str, ("mesh",)),
]


def build_arg_parser(description: str = "Hierarchical Point-SLAM, "
                                         "PyTorch / CUDA port"):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("config", type=str, help="Path to scene config file.")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--input_folder", type=str, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--nice", action="store_true", default=True)
    p.add_argument("--gt_camera", action="store_true")
    p.add_argument("--kf_selection", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the output "
                        "dir (framework extension; reference checkpoints "
                        "are write-only)")
    for on, off, _ in _PAIRED_FLAGS:
        p.add_argument(f"--{on}", action="store_true")
        p.add_argument(f"--{off}", action="store_true")
    for name, typ, _ in _VALUE_FLAGS:
        p.add_argument(f"--{name}", type=typ, default=None)
    return p


def _set_path(cfg: dict, path, value):
    node = cfg
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def apply_args(cfg: dict, args: argparse.Namespace) -> dict:
    """Merge CLI flags into cfg (flags win — Point_SLAM.py:62-139)."""
    if getattr(args, "output", None):
        cfg["data"]["output"] = args.output
    if getattr(args, "input_folder", None):
        cfg["data"]["input_folder"] = args.input_folder
    if getattr(args, "resume", False):
        cfg["resume"] = True
    if getattr(args, "gt_camera", False):
        cfg["tracking"]["gt_camera"] = True
    if getattr(args, "kf_selection", False):
        cfg["mapping"]["use_kf_selection"] = True
    for on, off, path in _PAIRED_FLAGS:
        if getattr(args, on, False):
            _set_path(cfg, path, True)
        elif getattr(args, off, False):
            _set_path(cfg, path, False)
    for name, _typ, path in _VALUE_FLAGS:
        v = getattr(args, name, None)
        if v is not None:
            _set_path(cfg, path, v)
    return cfg
