"""Checkpointing (port of hpslam_tpu/utils/logger.py): one pickle per
checkpoint of numpy-converted state, in the reference's layout."""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..ops.optim import tree_map


def to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if torch.is_tensor(x) else np.asarray(x), tree)


class Logger:
    def __init__(self, cfg: dict, slam):
        self.verbose = cfg.get("verbose", True)
        self.ckptsdir = slam.ckptsdir
        self.slam = slam
        self.save_keyframe_images = cfg["mapping"].get(
            "save_keyframe_images", False)

    def log(self, idx: int, npc, params, exposure_feat, keyframe_list,
            keyframe_dict, selected_keyframes, estimate_c2w_list,
            gt_c2w_list):
        path = os.path.join(self.ckptsdir, f"{idx:05d}.ckpt")
        levels = {}
        for name, lv in npc.levels.items():
            n = int(lv.count)
            levels[name] = {k: getattr(lv, k)[:n].cpu().numpy()
                            for k in ("pos", "normal", "geo", "col")}
            levels[name]["count"] = n
        kf_dict = []
        for kf in keyframe_dict:
            kf_dict.append({
                k: v for k, v in kf.items()
                if not k.endswith("_t")  # device tensors stay on device
                and (self.save_keyframe_images
                     or k not in ("color", "depth", "r_query_mid",
                                  "r_query_fine"))})
        state = {
            "levels": levels,
            "pts_num": npc.pts_num(),
            "input_pos": np.asarray(npc.input_pos(), np.float32),
            "input_rgb": np.asarray(npc.input_rgb(), np.float32),
            "input_normal": np.zeros((0, 2), np.float32),
            "decoder_params": to_numpy(params),
            "exposure_feat": np.asarray(exposure_feat),
            "gt_c2w_list": np.asarray(gt_c2w_list),
            "estimate_c2w_list": np.asarray(estimate_c2w_list),
            "keyframe_list": list(keyframe_list),
            "keyframe_dict": kf_dict,
            "selected_keyframes": selected_keyframes,
            "idx": idx,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f, protocol=4)
        if self.verbose:
            print(f"Saved checkpoint {path}")
        return path


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint this program wrote (pickle: trusted files only)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def latest_checkpoint(output: str) -> Optional[str]:
    d = os.path.join(output, "ckpts")
    if not os.path.isdir(d):
        return None
    cks = sorted(p for p in os.listdir(d) if p.endswith(".ckpt"))
    return os.path.join(d, cks[-1]) if cks else None
