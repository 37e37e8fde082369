"""Frozen copy of hpslam_tpu_torch/ops/optim.py for the benchmark's
reference (imports nothing of the program).

Adam with per-leaf, per-step learning rates (port of
hpslam_tpu/ops/optim.py, reproduced term for term: beta=(0.9, 0.999),
eps added after the square root, bias correction from a shared step count,
no weight decay).  ``torch.optim.Adam`` is not used: its update order and
its per-group step counts differ from the reference's.

Parameters are nested dicts/lists of tensors.  ``update`` returns new
tensors (functional, like the reference) and runs without autograd.
"""
from __future__ import annotations

import torch


def tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_unflatten(tree, leaves) -> object:
    """A tree shaped like ``tree`` holding ``leaves`` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init(params) -> dict:
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params), "t": 0}


@torch.no_grad()
def update(grads, state, params, lr, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8):
    """One Adam step.  lr: a number, or a tree matching ``params``' outer
    structure whose leaves are numbers or tensors broadcastable to the
    parameter (e.g. a per-column LR row).  A ``None`` grad counts as 0."""
    t = state["t"] + 1
    tf = torch.tensor(float(t), dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** tf)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** tf)
    grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                     grads, params)
    new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
    new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                     grads)
    if isinstance(lr, (float, int)) or torch.is_tensor(lr):
        lr_tree = tree_map(lambda _: lr, params)
    else:
        lr_tree = _expand_lr(lr, params)

    def step(p, m, v, lr_):
        mh = m / c1
        vh = v / c2
        return p - lr_ * mh / (torch.sqrt(vh) + eps)

    new_params = tree_map(step, params, new_m, new_v, lr_tree)
    return new_params, {"m": new_m, "v": new_v, "t": t}


def _expand_lr(lr, params):
    """Broadcast an LR tree whose leaves may sit above the params' leaves
    (one LR for a whole sub-tree)."""
    if isinstance(params, dict):
        if isinstance(lr, dict):
            return {k: _expand_lr(lr[k], params[k]) for k in params}
        return tree_map(lambda _: lr, params)
    if isinstance(params, (list, tuple)):
        if isinstance(lr, (list, tuple)):
            return type(params)(_expand_lr(a, b) for a, b in zip(lr, params))
        return tree_map(lambda _: lr, params)
    return lr
