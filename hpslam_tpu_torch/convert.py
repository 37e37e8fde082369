"""Carry JAX-side state into the port: nested dicts/lists of numpy arrays
(``np.asarray`` over the reference decoders' ``init_nicer`` tree, or a
``PointLevel``'s fields) become the port's tensors, one to one."""
from __future__ import annotations

import numpy as np
import torch

from .ops.optim import tree_map
from .state import PointLevel


def params_from_numpy(tree, device="cpu"):
    """Decoder parameter tree of numpy arrays -> the same tree of float32
    tensors on ``device``."""
    return tree_map(lambda a: torch.as_tensor(
        np.array(a, dtype=np.float32, copy=True), device=device), tree)


def params_to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def level_from_numpy(pos, normal, geo, col, count, device="cpu") -> PointLevel:
    """A point level from the reference's PointLevel fields."""
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32, copy=True),
                                  device=device)
    return PointLevel(pos=t(pos), normal=t(normal), geo=t(geo), col=t(col),
                      count=int(count))
