"""Frozen copy of hpslam_tpu_torch/ops/interpolate.py for the benchmark's
reference (imports nothing of the program).

Inverse-distance feature interpolation (port of
hpslam_tpu/ops/interpolate.py).

Gradient structure as in the reference: mapper mode weights come from the
(detached) search distances; tracker mode (``diff_pos``) re-derives the
distances from gathered neighbour positions so pose gradients flow through
the weights; the out-of-radius mask is always taken on detached values.
The reference's custom-VJP gathers become autograd Functions whose
backward scatter-adds rows with ``index_add_rows``: ``index_add_`` on the
CPU; on CUDA, where ``index_add_`` adds with float atomics in an order that
changes from run to run, a stable sort by target row and a segment sum, so
every target adds its sources in their original order and runs repeat.
"""
from __future__ import annotations

import torch


def interp_weights(D, I, p, cloud_pos, r_query, min_nn_num: int,
                   weighting: str = "distance", diff_pos: bool = False,
                   neighbor_pos=None):
    """Normalised neighbour weights (Q, k, 1) and has_neighbors (Q,)."""
    r = torch.as_tensor(r_query, dtype=D.dtype, device=D.device)
    if r.dim() == 1:
        r = r[:, None]
    r2 = r * r
    nn_num = torch.sum(D < r2, dim=-1)
    has_neighbors = nn_num > (min_nn_num - 1)
    if diff_pos:
        if neighbor_pos is None:
            neighbor_pos = cloud_pos[I]
        Dd = torch.sum(torch.square(neighbor_pos - p[:, None, :]), dim=-1)
        out = Dd > r2
        fill = 1e4 if weighting == "distance" else 50.0
        Dd = torch.where(out, torch.full_like(Dd, fill), Dd)
    else:
        Dd = D
    if weighting == "distance":
        w = 1.0 / (Dd + 1e-10)
    else:
        w = torch.exp(-20.0 * torch.sqrt(Dd))
    w = torch.where(Dd.detach() > r2, torch.zeros_like(w), w)
    norm = torch.clamp(torch.sum(torch.abs(w), dim=-1, keepdim=True),
                       min=1e-12)
    w = w / norm
    return w[..., None], has_neighbors


def index_add_rows(rows: int, idx, src):
    """``zeros((rows, C)).index_add_(0, idx, src)`` with every target row's
    sources added in their order in ``idx``, on every device (a
    deterministic scatter-add; see the module docstring)."""
    out = torch.zeros((rows, src.shape[-1]), dtype=src.dtype,
                      device=src.device)
    if src.device.type == "cpu":
        return out.index_add_(0, idx, src)
    sidx, order = torch.sort(idx, stable=True)
    lengths = torch.bincount(sidx, minlength=rows)
    return torch.segment_reduce(src[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


class _InterpGather(torch.autograd.Function):
    """sum_k w_k * feats[I_k] with an index_add_rows backward."""

    @staticmethod
    def forward(ctx, feats, I, weights):
        gathered = feats[I]                                   # (Q, k, C)
        ctx.save_for_backward(I, weights, gathered)
        ctx.rows = feats.shape[0]
        return torch.sum(weights * gathered.to(weights.dtype), dim=1)

    @staticmethod
    def backward(ctx, dc):
        I, weights, gathered = ctx.saved_tensors
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            upd = (weights * dc[:, None, :]).reshape(-1, dc.shape[-1])
            dfeats = index_add_rows(ctx.rows, I.reshape(-1), upd).to(
                gathered.dtype)
        if ctx.needs_input_grad[2]:
            dw = torch.sum(gathered.to(dc.dtype) * dc[:, None, :], dim=-1,
                           keepdim=True).to(weights.dtype)
        return dfeats, None, dw


def interp_gather(feats, I, weights):
    return _InterpGather.apply(feats, I, weights)


class _RowGather(torch.autograd.Function):
    """feats[idx] with an index_add_rows backward (the mapper's
    per-iteration union-row gather)."""

    @staticmethod
    def forward(ctx, feats, idx):
        ctx.save_for_backward(idx)
        ctx.rows = feats.shape[0]
        return feats[idx]

    @staticmethod
    def backward(ctx, d_out):
        (idx,) = ctx.saved_tensors
        C = d_out.shape[-1]
        return index_add_rows(ctx.rows, idx.reshape(-1),
                              d_out.reshape(-1, C)), None


def gather_rows(feats, idx):
    return _RowGather.apply(feats, idx)


def weighted_gather(feats, I, weights, has_neighbors):
    """sum_k w_k * feats[I_k]; rows without neighbours are zero."""
    c = interp_gather(feats, I, weights)
    return torch.where(has_neighbors[:, None], c, torch.zeros_like(c))


def weighted_dense(gathered, weights, has_neighbors):
    """sum_k w_k * gathered_k over pre-gathered (Q, k, C) features."""
    c = torch.sum(weights * gathered.to(weights.dtype), dim=1)
    return torch.where(has_neighbors[:, None], c, torch.zeros_like(c))
