"""Decoder weights from the seed, made on the device in two draws.

The four NICE-SLAM / Point-SLAM decoders (geometry and colour, mid and fine
levels) in the port's parameter layout (dict of tensors, weights
(fan_in, fan_out), a layer is x @ w + b), with the distributions of their
initialisers (``hpslam_tpu_torch/models/decoder.py``): dense layers uniform
in +-gain * sqrt(6 / (fan_in + fan_out)) with zero bias, the feature
injections torch's ``nn.Linear`` default, the neighbour MLP Xavier, the
exposure MLP normal(0, 0.01), the Fourier matrices normal times their
scale.  One uniform and one normal draw of the whole size are carved into
the leaves.
"""
from __future__ import annotations

import math

import torch


def _spec(cfg: dict):
    """[(path, shape, kind, scale)], kind in uniform / zeros / normal."""
    w = cfg["widths"]
    C = int(cfg["model"]["c_dim"])
    nb, skip = int(w["n_blocks"]), int(w["skip"])
    out = []

    def dense(path, fi, fo, gain):
        out.append((path + ("w",), (fi, fo), "uniform",
                    gain * math.sqrt(6.0 / (fi + fo))))
        out.append((path + ("b",), (fo,), "zeros", 0.0))

    def linear(path, fi, fo):
        out.append((path + ("w",), (fi, fo), "uniform", 1.0 / math.sqrt(fi)))
        out.append((path + ("b",), (fo,), "uniform", 1.0 / math.sqrt(fi)))

    def core(path, hidden, emb, nout, out_gain):
        for i in range(nb):
            fi = emb if i == 0 else (hidden + emb if i == skip + 1 else hidden)
            dense(path + ("layers", i), fi, hidden, math.sqrt(2.0))
        for i in range(nb):
            linear(path + ("fc_c", i), C, hidden)
        dense(path + ("out",), hidden, nout, out_gain)

    for lv in ("mid", "fine"):
        g = (f"geo_{lv}",)
        out.append((g + ("B",), (3, int(w["geo_embed"])), "normal",
                    float(w["geo_scale"])))
        core(g + ("core",), int(w["hidden_geo"]), int(w["geo_embed"]), 1,
             math.sqrt(2.0))
    for lv in ("mid", "fine"):
        c = (f"col_{lv}",)
        hid, emb, rel = (int(w["hidden_col"]), int(w["col_embed"]),
                         int(w["rel_embed"]))
        out.append((c + ("B",), (3, emb), "normal", float(w["col_scale"])))
        core(c + ("core",), hid, 2 * emb, 3, 1.0)
        out.append((c + ("rel_B",), (3, rel), "normal", float(w["rel_scale"])))
        for name, fi, fo in (("l1", C + 2 * rel, hid), ("l2", hid, C)):
            out.append((c + ("mlp_neighbor", name, "w"), (fi, fo), "uniform",
                        math.sqrt(6.0 / (fi + fo))))
            out.append((c + ("mlp_neighbor", name, "b"), (fo,), "uniform",
                        1.0 / math.sqrt(fi)))
        if cfg["model"]["encode_exposure"]:
            E = int(cfg["model"]["exposure_dim"])
            for name, fi, fo in (("l1", E, hid), ("l2", hid, 12)):
                out.append((c + ("exposure", name, "w"), (fi, fo), "normal",
                            0.01))
                out.append((c + ("exposure", name, "b"), (fo,), "uniform",
                            1.0 / math.sqrt(fi)))
    return out


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value


def make_params(cfg: dict, seed: int, device) -> dict:
    """The decoders of ``cfg`` drawn from ``seed`` on ``device``."""
    spec = _spec(cfg)
    n_u = sum(math.prod(s) for _, s, k, _ in spec if k == "uniform")
    n_n = sum(math.prod(s) for _, s, k, _ in spec if k == "normal")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    uni = torch.rand((n_u,), generator=g, device=device) * 2.0 - 1.0
    nor = torch.randn((n_n,), generator=g, device=device)
    params: dict = {}
    ou = on = 0
    for path, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "uniform":
            t = uni[ou:ou + n] * scale
            ou += n
        elif kind == "normal":
            t = nor[on:on + n] * scale
            on += n
        else:
            t = torch.zeros((n,), device=device)
        _put(params, path, t.reshape(shape).contiguous())
    return params
