"""Frozen copy of the plain path of hpslam_tpu_torch/ops/knn.py for the
benchmark's reference (imports nothing of the program): the tile index
(``build_tiles``), the search through it (``knn_tiles``: the ``probe``
tiles with the smallest AABB lower bound, 4-fold bin narrowing from 512
tiles on, an exact top-k over their points) and the row top-k as k passes
of first-occurrence argmin (``topk_rows_plain``), which kernel #1 matches
bit for bit.  Distances are squared L2, ascending; BIG marks missing
neighbours.
"""
from __future__ import annotations

import torch

BIG = 1e10
LB_MAX = 0.5 * BIG      # tile lower bounds are clamped here (see above)
NARROW_MIN_TILES = 512
NARROW_FACTOR = 4


# ---------------------------------------------------------------------------
# kernel 1: row top-k

def topk_rows_plain(x: torch.Tensor, payload, k: int):
    """k passes of first-occurrence argmin (_topk_rows_passes): (n, C)
    [+ payload (n, C)] -> (values (n, k) ascending, selected (n, k) f32:
    payload values or column indices).  Rows with k entries below BIG and
    no NaN or sign bit take torch.topk instead, which picks the same k
    values; where equal values meet among them or at the k-th (ties, which
    torch.topk may pick or order apart), the entries below the k-th value
    and the first entries equal to it (by column) up to k, in column
    order, then a stable sort by value: the passes' picks and order."""
    n, C = x.shape
    D, cols = torch.topk(x, k, dim=1, largest=False, sorted=True)
    tie = (D[:, 1:] == D[:, :-1]).any(1) | ((x <= D[:, -1:]).sum(1) > k)
    if bool(tie.any()):
        xt = x[tie]
        vk = D[tie][:, -1:]
        below = xt < vk
        tied = xt == vk
        take = below | (tied & (torch.cumsum(tied, 1)
                                <= k - below.sum(1, keepdim=True)))
        iota = torch.arange(C, device=x.device).expand(xt.shape[0], C)
        # (fewer than k taken only on rows the passes take below)
        tc = torch.topk(torch.where(take, iota, C), k, dim=1, largest=False,
                        sorted=True).values.clamp(max=C - 1)
        Dt, order = torch.sort(torch.gather(xt, 1, tc), dim=1, stable=True)
        D[tie], cols[tie] = Dt, torch.gather(tc, 1, order)
    sel = (cols.to(torch.float32) if payload is None
           else torch.gather(payload, 1, cols))
    rest = ~((D[:, -1] < BIG)
             & ~(torch.isnan(x) | torch.signbit(x)).any(1))
    if bool(rest.any()):
        D[rest], sel[rest] = _topk_rows_passes(
            x[rest], None if payload is None else payload[rest], k)
    return D, sel


def _topk_rows_passes(x: torch.Tensor, payload, k: int):
    """topk_rows_plain's definition: k passes of first-occurrence argmin,
    each masking its pick with BIG."""
    n, C = x.shape
    x = x.clone()
    iota = torch.arange(C, device=x.device).expand(n, C)
    big = torch.tensor(BIG, dtype=x.dtype, device=x.device)
    Ds, Vs = [], []
    for _ in range(k):
        m = torch.min(x, dim=1, keepdim=True).values
        first = torch.min(torch.where(x <= m, iota, C), dim=1,
                          keepdim=True).values
        Ds.append(m[:, 0])
        firstc = torch.clamp(first, max=C - 1)
        if payload is None:
            sel = first.to(torch.float32)
        else:
            sel = torch.gather(payload, 1, firstc)
        Vs.append(torch.where(first < C, sel, torch.zeros_like(sel))[:, 0])
        x = torch.where(iota == first, big, x)
    return torch.stack(Ds, 1), torch.stack(Vs, 1)


def topk_rows(x: torch.Tensor, payload, k: int):
    """Row top-k: topk_rows_plain on every device."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("topk_rows: x must be a 2-D float32 tensor")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"topk_rows: k={k} outside [1, {x.shape[1]}]")
    if x.shape[0] == 0:
        e = torch.empty((0, k), dtype=torch.float32, device=x.device)
        return e, e.clone()
    return topk_rows_plain(x.contiguous(), None if payload is None
                           else payload.contiguous(), k)


def topk_extract(d2: torch.Tensor, k: int):
    """Ascending top-k with int64 column ids (first-occurrence ties)."""
    D, sel = topk_rows(d2, None, k)
    return D, torch.round(sel).to(torch.int64)


def topk_candidates(d2: torch.Tensor, k: int, ids_f=None):
    """Final candidate top-k; the f32-encoded candidate ids ride through the
    selection as payload."""
    if ids_f is None:
        return topk_extract(d2, k)
    return topk_rows(d2, ids_f, k)


def first_argmin(x: torch.Tensor, dim: int):
    """(min, first index of the min) along ``dim`` — a tie rule that does
    not depend on the backend."""
    m = torch.min(x, dim=dim, keepdim=True).values
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    iota = torch.arange(n, device=x.device).reshape(shape)
    first = torch.min(torch.where(x <= m, iota, n), dim=dim).values
    return m.squeeze(dim), first


def select_tiles(lb2: torch.Tensor, probe: int) -> torch.Tensor:
    """Top-``probe`` tile ids by lower bound, (q, T) -> (q, probe) int64."""
    q, T = lb2.shape
    if T >= NARROW_MIN_TILES and T % NARROW_FACTOR == 0 \
            and T // NARROW_FACTOR >= probe:
        nb = T // NARROW_FACTOR
        v, grp = first_argmin(lb2.reshape(q, NARROW_FACTOR, nb), dim=1)
        tile_of_bin = grp * nb + torch.arange(nb, device=lb2.device)
        _, sel = topk_rows(v.contiguous(), pack_ids(tile_of_bin), probe)
        return unpack_ids(sel)
    _, sel = topk_rows(lb2.contiguous(), None, probe)
    return torch.round(sel).to(torch.int64)


def pack_ids(ids: torch.Tensor) -> torch.Tensor:
    """Row ids (< 2^24) as exact f32 VALUES (never a bitcast)."""
    return ids.to(torch.float32)


def unpack_ids(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).to(torch.int64)


# ---------------------------------------------------------------------------
# tile index

def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def build_tiles(points: torch.Tensor, count, tile: int = 128):
    """Tile index: (packed (T, 4*tile) rows [x*tile | y*tile | z*tile |
    pack_ids(row ids)], tile_lo (3, T), tile_hi (3, T)).  Invalid rows sort
    last and sit at a far sentinel (1e6)."""
    N_cap = points.shape[0]
    if N_cap % tile:
        raise ValueError("capacity must be a multiple of tile")
    if N_cap >= (1 << 24):
        raise ValueError("pack_ids requires capacity < 2^24")
    dev = points.device
    count = int(count)
    slot = torch.arange(N_cap, device=dev)
    valid = slot < count
    inf = torch.tensor(float("inf"), device=dev)
    lo = torch.min(torch.where(valid[:, None], points, inf), dim=0).values
    hi = torch.max(torch.where(valid[:, None], points, -inf), dim=0).values
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(torch.isfinite(hi), hi, torch.ones_like(hi))
    scale = 1023.0 / torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((points - lo) * scale, 0.0, 1023.0).to(torch.int64)
    key = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
           | (_spread_bits(q[:, 2]) << 2))
    key = torch.where(valid, key, torch.full_like(key, 0xFFFFFFFF))
    perm = torch.argsort(key, stable=True)
    sorted_valid = perm < count
    sorted_pos = torch.where(sorted_valid[:, None], points[perm],
                             torch.full_like(points, 1e6))
    T = N_cap // tile
    tp = sorted_pos.reshape(T, tile, 3)
    tv = sorted_valid.reshape(T, tile)[..., None]
    tlo = torch.min(torch.where(tv, tp, torch.full_like(tp, 1e6)),
                    dim=1).values
    thi = torch.max(torch.where(tv, tp, torch.full_like(tp, -1e6)),
                    dim=1).values
    packed = torch.cat([tp.permute(0, 2, 1).reshape(T, 3 * tile),
                        pack_ids(perm.reshape(T, tile))], dim=1)
    return packed.contiguous(), tlo.T.contiguous(), thi.T.contiguous()


def knn_tiles(query, packed, tile_lo, tile_hi, k: int = 8,
              probe: int = 16, q_chunk: int = 4096):
    """kNN through the tile index: (D (Q, k), I (Q, k) int64)."""
    tile = packed.shape[1] // 4
    T = tile_lo.shape[1]
    probe = min(probe, T)
    Ds, Is = [], []
    for s in range(0, query.shape[0], q_chunk):
        q = query[s:s + q_chunk]
        qc = q.shape[0]
        lb2 = 0.0
        for c in range(3):
            d = torch.clamp(torch.maximum(tile_lo[c][None] - q[:, c:c + 1],
                                          q[:, c:c + 1] - tile_hi[c][None]),
                            min=0.0)
            lb2 = lb2 + d * d
        tsel = select_tiles(torch.clamp(lb2, max=LB_MAX), probe)
        crow = packed[tsel]                          # (qc, probe, 4*tile)
        d2 = 0.0
        for c in range(3):
            cpos = crow[:, :, c * tile:(c + 1) * tile].reshape(
                qc, probe * tile)
            d2 = d2 + torch.square(q[:, c:c + 1] - cpos)
        cidx_f = crow[:, :, 3 * tile:].reshape(qc, probe * tile)
        Dk, If = topk_candidates(d2.contiguous(), k,
                                 ids_f=cidx_f.contiguous())
        Ds.append(Dk)
        Is.append(unpack_ids(If))
    if not Ds:
        return (torch.full((0, k), BIG, device=query.device),
                torch.zeros((0, k), dtype=torch.int64, device=query.device))
    D, I = torch.cat(Ds), torch.cat(Is)
    inval = D >= BIG
    return (torch.where(inval, torch.full_like(D, BIG), D),
            torch.where(inval, torch.zeros_like(I), I))
