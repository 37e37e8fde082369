"""Tensor-parallel kNN (port of hpslam_tpu/parallel/knn_tp.py): the point
cloud sharded by capacity across the mesh's ``tp`` ranks, the queries
replicated.

Each rank takes an exact top-k over its own shard (``ops.knn.knn``), shifts
the ids to global ones, the (Q, k) candidates of every shard are gathered
over the tp group, and one row top-k (kernel 1, ``topk_rows``, the ids as
its payload) merges the k * n_shards candidates per query: the collective
carries Q x k x n_shards values whatever the cloud's size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import knn as K
from .mesh import Mesh


def make_tp_knn(mesh: Mesh, k: int = 8):
    """Returns knn_fn(query (Q, 3) the same on every rank, this rank's
    point shard (N_cap / tp, 3), count (the global active count)) -> (D
    (Q, k) ascending, I (Q, k) global ids), the same on every tp rank."""
    n_shards = mesh.tp

    def tp_knn(query, pts_shard, count):
        sid = mesh.tp_rank
        shard = pts_shard.shape[0]
        local = min(max(int(count) - sid * shard, 0), shard)
        D, I = K.knn(query, pts_shard, local, k=k)
        I = I + sid * shard
        Ds = [torch.empty_like(D) for _ in range(n_shards)]
        Is = [torch.empty_like(I) for _ in range(n_shards)]
        dist.all_gather(Ds, D.contiguous(), group=mesh.tp_group)
        dist.all_gather(Is, I.contiguous(), group=mesh.tp_group)
        Dg = torch.cat(Ds, 1).contiguous()
        Ig = torch.cat(Is, 1)
        Dm, sel = K.topk_rows(Dg, K.pack_ids(Ig), k)
        return Dm, K.unpack_ids(sel)

    return tp_knn
