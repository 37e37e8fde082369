"""Radius-bounded kNN over the neural point cloud (port of
hpslam_tpu/ops/knn.py) and the row-top-k kernel's wrapper.

Distances are squared L2, ascending; BIG marks missing neighbours.  The
tile index (``build_tiles``) Morton-sorts the cloud into fixed-size tiles;
``knn_tiles`` keeps the ``probe`` tiles with the smallest AABB lower bound
and takes an exact top-k over their points.

Kernel 1, ``topk_rows``: exact ascending row top-k with first-occurrence
ties and an optional f32 payload (hpslam_tpu/ops/knn.py `_pl_topk` /
`_topk_rows_kernel`).  CUDA tensors go to ``csrc/topk_rows.cu`` (one
streaming pass with per-lane register lists for k <= 32, a k-pass kernel
for larger k); CPU tensors to ``topk_rows_plain``, the same k argmin passes
in PyTorch.  Both return copies of existing floats, so they agree bit for
bit.

Tile selection (``select_tiles``): below ``NARROW_MIN_TILES`` tiles, the exact
top-``probe`` over the bounds through kernel 1.  From there on, the bounds are
first narrowed ``NARROW_FACTOR``-fold by a deterministic bin minimum (tile t
-> bin t mod T/NARROW_FACTOR, so Morton neighbours land in different bins),
then kernel 1 takes the top-``probe`` bins with the bin -> tile ids as
payload.  The reference narrows with XLA's approx_min_k (16-fold on the
TPU, exact on the CPU); a 16-fold bin minimum measured recall@8 0.9075
against the reference's 0.945 on a 60k-point wall (tests/test_torch_knn.py
fixture), 4-fold 0.9448, so the port narrows 4-fold.
"""
from __future__ import annotations

import functools

import torch

from .. import _cuda

BIG = 1e10
NARROW_MIN_TILES = 512
NARROW_FACTOR = 4


# ---------------------------------------------------------------------------
# kernel 1: row top-k

def topk_rows_plain(x: torch.Tensor, payload, k: int):
    """k passes of first-occurrence argmin: (n, C) [+ payload (n, C)] ->
    (values (n, k) ascending, selected (n, k) f32: payload values or column
    indices)."""
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


@functools.lru_cache(maxsize=None)
def _launcher():
    """hp_topk_rows, built and bound on first use."""
    return _cuda.lib("topk_rows").hp_topk_rows


def _topk_rows_cuda(x, payload, k: int):
    """Launch kernel 1: one (2, n, k) allocation for both outputs."""
    n, C = x.shape
    out = torch.empty((2, n, k), dtype=torch.float32, device=x.device)
    base = out.data_ptr()
    rc = _launcher()(x.data_ptr(),
                     payload.data_ptr() if payload is not None else None,
                     n, C, k, base, base + 4 * n * k,
                     torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(rc, "topk_rows")
    return out[0], out[1]


def topk_rows(x: torch.Tensor, payload, k: int):
    """Row top-k (kernel 1).  x: (n, C) f32 contiguous; payload: None or
    (n, C) f32.  CUDA tensors launch the kernel; CPU tensors take
    topk_rows_plain."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("topk_rows: x must be a 2-D float32 tensor")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"topk_rows: k={k} outside [1, {x.shape[1]}]")
    if payload is not None and (payload.shape != x.shape
                                or payload.dtype != torch.float32
                                or payload.device != x.device):
        raise ValueError("topk_rows: payload must match x (shape, float32, "
                         "device)")
    if x.device.type == "cpu":
        return topk_rows_plain(x, payload, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk_rows: unsupported device {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    if payload is not None and not payload.is_contiguous():
        payload = payload.contiguous()
    if x.shape[0] == 0:
        e = torch.empty((0, k), dtype=torch.float32, device=x.device)
        return e, e.clone()
    _cuda.LAUNCHES["topk_rows"] += 1
    return _topk_rows_cuda(x, payload, k)


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
# exact search (oracle / small clouds)

def knn(query, points, count, k: int = 8, q_chunk: int = 4096,
        n_tile: int = 8192):
    """Exact masked kNN: (D (Q, k) ascending, BIG where < k valid;
    I (Q, k) int64, 0 where invalid)."""
    Q = query.shape[0]
    count = int(count)
    valid_pts = points[:count]
    Ds, Is = [], []
    for s in range(0, max(Q, 1), q_chunk):
        q = query[s:s + q_chunk]
        if q.shape[0] == 0:
            break
        bestD = torch.full((q.shape[0], k), BIG, device=query.device)
        bestI = torch.zeros((q.shape[0], k), dtype=torch.int64,
                            device=query.device)
        for t in range(0, count, n_tile):
            p = valid_pts[t:t + n_tile]
            d2 = torch.sum(torch.square(q[:, None, :] - p[None, :, :]), -1)
            idx = torch.arange(t, t + p.shape[0], device=query.device)
            allD = torch.cat([bestD, d2], 1)
            allI = torch.cat([bestI, idx.expand(q.shape[0], -1)], 1)
            kk = min(k, allD.shape[1])
            vals, sel = torch.sort(allD, dim=1, stable=True)
            bestD, bestI = vals[:, :kk], torch.gather(allI, 1, sel[:, :kk])
        Ds.append(bestD)
        Is.append(bestI)
    if not Ds:
        return (torch.full((0, k), BIG, device=query.device),
                torch.zeros((0, k), dtype=torch.int64, device=query.device))
    D, I = torch.cat(Ds), torch.cat(Is)
    return D, torch.where(D >= BIG, torch.zeros_like(I), I)


def knn_segmin(query, points, count, k: int = 8, q_chunk: int = 2500,
               n_tile=None, m: int = 2):
    """Segment-top-m kNN: the m smallest per n_tile-point segment, then an
    exact top-k over the segment candidates."""
    N_cap = points.shape[0]
    if n_tile is None:
        n_tile = max(256, min(2048, N_cap // 128))
    n_tile = min(n_tile, N_cap)
    num_tiles = -(-N_cap // n_tile)
    pad = num_tiles * n_tile - N_cap
    pts = torch.cat([points, points.new_zeros((pad, 3))]) if pad else points
    invalid = torch.arange(pts.shape[0], device=points.device) >= int(count)
    Ds, Is = [], []
    for s in range(0, query.shape[0], q_chunk):
        q = query[s:s + q_chunk]
        d2 = torch.sum(torch.square(q[:, None, :] - pts[None, :, :]), -1)
        d2 = torch.where(invalid[None, :], torch.full_like(d2, BIG), d2)
        d2 = d2.reshape(q.shape[0], num_tiles, n_tile)
        cD, cI = [], []
        base = torch.arange(num_tiles, device=q.device)[None, :] * n_tile
        for _ in range(m):
            v, am = first_argmin(d2, dim=2)
            cD.append(v)
            cI.append(base + am)
            d2 = torch.where(torch.arange(n_tile, device=q.device)
                             == am[..., None], torch.full_like(d2, BIG), d2)
        D = torch.stack(cD, -1).reshape(q.shape[0], -1)
        I = torch.stack(cI, -1).reshape(q.shape[0], -1)
        kk = min(k, D.shape[1])
        Dk, sel = topk_extract(D.contiguous(), kk)
        Ik = torch.gather(I, 1, sel)
        if kk < k:
            Dk = torch.cat([Dk, torch.full((Dk.shape[0], k - kk), BIG,
                                           device=q.device)], 1)
            Ik = torch.cat([Ik, torch.zeros((Ik.shape[0], k - kk),
                                            dtype=Ik.dtype,
                                            device=q.device)], 1)
        Ds.append(Dk)
        Is.append(Ik)
    D, I = torch.cat(Ds), torch.cat(Is)
    return D, torch.where(D >= BIG, torch.zeros_like(I), I)


_EXACT_MAX_N = 1 << 15


def knn_auto(query, points, count, k: int = 8):
    """Exact for small clouds, segment-min (m=8) at scale (non-hot callers:
    renders that pass no tile index)."""
    if points.shape[0] <= _EXACT_MAX_N:
        return knn(query, points, count, k=k)
    return knn_segmin(query, points, count, k=k, m=8)


def neighbor_counts(D, radius):
    r = torch.as_tensor(radius, dtype=D.dtype, device=D.device)
    if r.dim() == 1:
        r = r[:, None]
    return torch.sum(D < r * r, dim=-1)


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
        tsel = select_tiles(lb2, probe)
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
