"""The row-top-k kernel's selection (kernel #1, topk_rows_lists in
hpslam_tpu_torch/csrc/topk_rows.cu), emulated in plain Python on the CPU,
against the port's plain version (topk_rows_plain) and the reference's
Pallas kernel (hpslam_tpu.ops.knn._pl_topk, interpret mode), bit for bit.

The emulation does what the kernel does, step for step: a group of
``lanes`` lanes takes a row; each lane reads its columns in increasing
order, in batches of 16 (4-column chunks l, l + lanes, ...), keeps a
sorted register list of the K >= k smallest (value, column) pairs below
BIG it has seen (K a power of two; strict-< insertion by the kernel's
shift-or-place steps), the first column <= BIG and the first-occurrence
minimum above BIG before it.  With 32 lanes and K >= 4 an entry enters a
list only if it is not above T, the k-th smallest of the lanes' minima so
far (a bound on the row's k-th smallest, taken before each batch).  Then
k rounds of an argmin on (value, column) over the lists' heads, the
winner popping its head; the BIG tail rule once the lists are empty.
The k argmin passes that the reference runs overwrite each pick with BIG,
so a row with fewer than k entries below BIG picks a column again: the
rows all BIG, partly BIG, at 3e12, exactly BIG and +inf below test that
rule.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.ops import knn as jK
from hpslam_tpu_torch.ops import knn as tK

BIG = float(np.float32(tK.BIG))
NONE = 2 ** 31 - 1                   # INT_MAX: an empty slot's column

# (name, rows, C, k, payload): the smoke's shapes at fewer rows (candidate
# top-k, narrowed tile selection, insertion 1-NN, union ranking, the
# insertion's tile selection at probe 32), k = C, and a ragged C
SHAPES = [("candidates", 16, 1536, 8, True),
          ("tile_select", 16, 128, 12, True),
          ("insertion", 16, 4096, 1, True),
          ("union_rank", 40, 40, 8, False),
          ("insert_tiles", 16, 128, 32, True),
          ("k_is_C", 16, 32, 32, True),
          ("ragged_C", 16, 37, 8, True)]


@functools.lru_cache(maxsize=None)
def _case(name):
    """(x, payload or None, k), made with numpy; the same for every lane
    count."""
    _, n, C, k, with_payload = next(s for s in SHAPES if s[0] == name)
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.uniform(0, 1, (n, C)).astype(np.float32)
    x[::7, 10 % C] = x[::7, 3]               # exact ties across columns
    x[5] = BIG                               # all BIG
    x[6, C // 3:] = BIG                      # partly BIG
    x[8] = 3e12                              # above BIG only
    x[9] = rng.uniform(0.5, 1, C)            # ties at the minimum
    x[9, ::5] = 0.25
    x[10] = 3e12                             # one entry below BIG, then the
    x[10, [1, C // 2]] = BIG                 # tail at the first BIG column
    x[10, C - 1] = 0.5
    x[11] = 5e12                             # no entry below BIG, its
    x[11, [C // 2, C - 2]] = BIG             # minimum exactly BIG
    x[12] = np.inf                           # +inf with one finite entry
    x[12, 3] = 0.125
    x[13] = np.inf
    payload = None
    if with_payload:
        ids = rng.integers(0, 1 << 22, (n, C)).astype(np.int32)
        payload = ids.astype(np.float32)
    return x, payload, k


@functools.lru_cache(maxsize=None)
def _references(name):
    """(topk_rows_plain's, _pl_topk's) (values, selected) as numpy."""
    x, payload, k = _case(name)
    pt = None if payload is None else torch.tensor(payload)
    plain = [t.numpy() for t in tK.topk_rows_plain(torch.tensor(x), pt, k)]
    pj = None if payload is None else jnp.asarray(payload)
    pallas = [np.asarray(a) for a in jK._pl_topk(jnp.asarray(x), pj, k,
                                                 interpret=True)]
    return plain, pallas


BATCH = 16                           # entries per lane per batch


def _batch_columns(C, lanes, lane, base):
    """The lane's columns of the batch at ``base`` (4-column chunks
    base / 4 + lane + u lanes, read with one 16-byte load each where the
    row allows it, else column by column), in the order the lane sees
    them; past C: None."""
    cols = [base + 4 * lane + 4 * lanes * u + j
            for u in range(BATCH // 4) for j in range(4)]
    return [c if c < C else None for c in cols]


def _insert(lv, lc, v, c):
    """list_insert: the caller checked v < lv[-1]."""
    for j in range(len(lv) - 1, 0, -1):
        shift = v < lv[j - 1]
        here = not shift and v < lv[j]
        if shift:
            lv[j], lc[j] = lv[j - 1], lc[j - 1]
        elif here:
            lv[j], lc[j] = v, c
    if v < lv[0]:
        lv[0], lc[0] = v, c


class _Lane:
    """One lane's registers: the list, cle, (mo, co)."""

    def __init__(self, K):
        self.lv, self.lc = [BIG] * K, [NONE] * K
        self.cle, self.mo, self.co = NONE, float("inf"), NONE

    def see(self, T, v, c):
        if v < self.lv[-1] and v <= T:
            _insert(self.lv, self.lc, v, c)
        if self.cle == NONE:
            if v <= BIG:
                self.cle, self.mo, self.co = c, BIG, c
            elif v < self.mo or (v == self.mo and c < self.co):
                self.mo, self.co = v, c


def _tail(p, none, mo, co, cle):
    """Pick p's (value, column) once the lists hold no entry for it; none:
    the row has no entry below BIG."""
    if p == 0:
        return mo, co
    return BIG, co if none else cle


def _merge_rounds(L, k, mo, co, cle):
    """k rounds of an argmin over the lists' heads; the winner pops."""
    picks = []
    for p in range(k):
        hv, hc = min((ln.lv[0], ln.lc[0]) for ln in L)
        if hv < BIG:
            picks.append((hv, hc))
            ln = next(ln for ln in L if ln.lc[0] == hc)
            del ln.lv[0], ln.lc[0]
            ln.lv.append(BIG)
            ln.lc.append(NONE)
        else:
            picks.append(_tail(p, p == 0 or picks[0][0] >= BIG, mo, co,
                               cle))
    return picks


def emulate_lists(x, payload, k, lanes):
    """(values (n, k), selected (n, k)) as topk_rows_lists computes them."""
    n, C = x.shape
    K = 1
    while K < k:
        K *= 2
    bound = lanes == 32 and K >= 4
    out_d = np.zeros((n, k), np.float32)
    out_v = np.zeros((n, k), np.float32)
    for r in range(n):
        row = x[r].tolist()
        L = [_Lane(K) for _ in range(lanes)]
        T = BIG
        for base in range(0, C, BATCH * lanes):
            cols = [_batch_columns(C, lanes, i, base) for i in range(lanes)]
            if bound:                    # warp_kth of the lanes' minima
                m = [min([ln.lv[0]] + [row[c] for c in cs if c is not None])
                     for ln, cs in zip(L, cols)]
                T = min(T, sorted(m)[k - 1])
            for ln, cs in zip(L, cols):
                for c in cs:
                    if c is not None:
                        ln.see(T, row[c], c)
        cle = min(ln.cle for ln in L)
        mo, co = min((ln.mo, ln.co) for ln in L)
        for p, (ov, oc) in enumerate(_merge_rounds(L, k, mo, co, cle)):
            out_d[r, p] = ov
            if oc < C:
                out_v[r, p] = payload[r, oc] if payload is not None else oc
    return out_d, out_v


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
@pytest.mark.parametrize("name", [s[0] for s in SHAPES])
def test_lane_lists_match_plain_and_pallas(name, lanes):
    """The emulated selection equals topk_rows_plain and _pl_topk bit for
    bit, values and payload (or column ids)."""
    x, payload, k = _case(name)
    (pd, pv), (jd, jv) = _references(name)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pv, jv)
    ed, ev = emulate_lists(x, payload, k, lanes)
    np.testing.assert_array_equal(ed, pd, err_msg="values")
    np.testing.assert_array_equal(ev, pv, err_msg="selected")
