#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (hpslam_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases device,build,topk,maploss
    python3 chip_smoke.py --phases device,build,trunks,trackloss

Phases, each printed as one JSON line when it starts and when it ends:
  device   nvidia-smi's name and power limit, torch's device name
  build    nvcc builds every kernel source (one nvcc per source, in parallel)
  topk     row-top-k kernel against its plain version, bitwise, at the main
           path's shapes, the insertion's tile selection (k = 32), a k above
           32 (the k-pass kernel) and a ragged C; the kernel's device time
           per launch (torch.profiler) with the L2 cache flushed between
           launches and warm, the wrapper's time, the plain version's and
           torch.topk's; blocks per SM
  maploss  mapping-loss kernel pair against the plain version (autograd)
           at bench.py's operating point (10000 rays) and the SLAM run's
           (4000 rays), a ragged n (4001 rays) and without the weight
           gradients; kernel #3 twice, bitwise; kernel / plain times
  trunks   fused-trunk kernel pair through its autograd wrapper against
           fused_trunks_plain(_bwd) at the fused-trunk mapping path's shape
           (4000 rays x 5 samples): colour, geometry only, with the
           position cotangent, a ragged n (20003 samples) with colour and
           geometry only, and without the weight gradients; each twice,
           bitwise; kernel / plain times (#4 geometry only beside colour);
           blocks per SM of the tile kernels; digests of #4's and #5's
           outputs (the same bits on any tree whose kernels compute the
           same)
  trackloss  fused tracker-render kernel pair against trackloss_plain
           (autograd) at the tracker's 2000 rays: sigmoid tail, exposure
           affine, exp weighting, and a ragged 2001 rays; #8-9 twice,
           bitwise; kernel / plain times, #8's and #9's device time per
           pass (under torch.profiler), blocks per SM of the tile passes
           and the peak device memory of one #8 launch
  composite  fused-composite kernel #6 through its autograd wrapper
           (nicer_fused_composite) against composite_plain under autograd,
           and kernel #7 (fused_comp_bwd) against the composition it
           replaces (composite_bwd_plain), at the mesh mapping path's shape
           (4000 rays x 5 samples): colour with the sigmoid tail, colour
           raw (encode_exposure), geometry only, and a ragged 601 rays;
           the wrapper and #7 twice, bitwise; kernel / plain times, #6's
           and #7's device time per pass, #7 beside the composition the
           path runs (the compositor backward in tensor ops, then #5),
           blocks per SM of both tile passes and the device memory of one
           #6 and one #7 launch
  slam     the port's CLI entry point on configs/Synthetic/synth_tpu.yaml,
           cut to 10 frames, output in a temporary directory; ATE, per-frame
           times and every kernel's launches during the run (with
           --profile each SLAM run is repeated under torch.profiler, whose
           kernels must include, and exclude, those of PROFILE_KERNELS)
  slam_fused  the same run with tracking.fused_loss on and
           model.fused_composite off: the fused tracker render and union
           mapping on the fused trunks
  slam_mesh  the same run with mesh: "dp1" inside a world-1 NCCL process
           group that the smoke opens and closes: the dp-mesh tracker and
           union mapping through the fused composite (kernels #6, #5)
  repeat   the deterministic scatter-add (ops.interpolate.index_add_rows)
           three times on the same inputs, bitwise; then every SLAM run of
           this process again, whose trajectory and ATE must equal the
           first run's bitwise
  kernels  one JSON line describing every ported kernel, with its bound
           at the f32 rate (bound_ms) and with the operations on the
           tensor cores at f32 accuracy (tc_bound_ms, 3xTF32)

The last line is {"ok": true, "device": {...}}, printed only when every
phase passed; any failure exits non-zero.  Without CUDA, or without the
hpslam_tpu_torch package beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ["device", "build", "topk", "maploss", "trunks", "trackloss",
          "composite", "slam", "slam_fused", "slam_mesh", "repeat",
          "kernels"]

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
F32_FLOPS = 67e12
# TF32 tensor cores (495 TFLOP/s dense) at f32 accuracy: 3xTF32 takes
# three passes per product
TC_F32_FLOPS = 495e12 / 3

# tolerances of the kernel-vs-plain comparisons
TOPK_TOL = "bitwise"            # selection copies existing floats
LOSS_RTOL = 1e-4                # f32 sums of 1e4 per-ray terms, other order
GRAD_REL_FRO = 1e-4             # ||kernel - plain|| / ||plain|| per tensor
GRAD_ELEM_TOL = 1e-3            # |kernel - plain| <= tol * max|plain| ...
GRAD_ELEM_FRAC = 1e-4           # ... for all but this fraction of elements
# d rays of the tracker render: the distance weight 1/(d^2+1e-10) enters
# through its square, so f32 rounding is amplified by the inputs'
# conditioning; the kernel and the f32 plain version are both held against
# the plain version in float64, the kernel to within this factor of the
# f32 plain version's own distance, in Frobenius norm (or GRAD_REL_FRO, if
# larger) and entry by entry against the plain version's largest error on
# the same ray (plus GRAD_ELEM_TOL of the largest entry; check_drays)
COND_FACTOR = 2.0
ATE_MAX_M = 0.05


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, record: dict):
    emit({"phase": name, "status": "start"})
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        emit({"phase": name, "status": "failed",
              "seconds": time.perf_counter() - t0,
              "error": f"{type(e).__name__}: {e}"[:2000]})
        raise
    dt = time.perf_counter() - t0
    record[name] = dt
    emit({"phase": name, "status": "ok", "seconds": dt})


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    """(least time, "bytes" or "operations", least time with the
    operations on the tensor cores at f32 accuracy): the larger of the
    bytes over the memory rate and the operations over the f32 rate (or
    over TC_F32_FLOPS)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS * 1e3
    tc = max(tb, flops / TC_F32_FLOPS * 1e3)
    return (tb, "bytes", tc) if tb >= tf else (tf, "operations", tc)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# ---------------------------------------------------------------------------

def ptxas_kernels(log: str) -> dict:
    """{kernel: {"registers", "spill_bytes", "stack_bytes", "smem_bytes"}}
    from the -Xptxas -v output of one source (smem: static shared memory;
    the tile kernels take theirs dynamically)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?_Z(\d+)(\w+)", ln)
        if m:
            name = m.group(2)[:int(m.group(1))]
            targs = re.match(r"I((?:Li\d+E)+)E", m.group(2)[int(m.group(1)):])
            if targs:        # a template instantiation: name<K,G>
                name += "<" + ",".join(re.findall(r"Li(\d+)E",
                                                  targs.group(1))) + ">"
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name]["stack_bytes"] = int(m.group(1))
            out[name]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def run_build(out_dir: str) -> dict:
    from hpslam_tpu_torch import _cuda
    d = _cuda.build_dir()
    lock = os.path.join(d, "lock")
    if os.path.exists(lock):
        os.remove(lock)
    logs = _cuda.build_all(extra=("-Xptxas", "-v"))
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    kernels = {k: v for log in logs.values()
               for k, v in ptxas_kernels(log).items()}
    for name in logs:
        _cuda.lib(name)
    return {"built": sorted(logs),
            "spilling_kernels": sorted(k for k, v in kernels.items()
                                       if v.get("spill_bytes")),
            "tile_kernels": {k: v for k, v in sorted(kernels.items())
                             if "tiles" in k},
            "topk_kernels": {k: v for k, v in sorted(kernels.items())
                             if "topk" in k}}


def topk_cases(torch, dev):
    """(name, x, payload, k) at the main path's shapes: candidate top-k
    (4096 x 12 tiles x 128, k=8, id payload), narrowed tile selection
    (4096 x 128 bins, k=12, bin->tile payload), insertion 1-NN (ragged 2047
    rows x 32 tiles x 128, k=1), union ranking (14000 x 40, k=8, no
    payload), the insertion's tile selection (state.add_points: probe 32
    over mapping.pixels_adding 2000 rays, 512 tiles narrowed to 128 bins,
    bin->tile payload); then a k above 32 (the k-pass kernel, which no
    path launches) and a ragged C (not a multiple of 4: single-column
    loads).  Rows with exact ties and BIG sentinels are included."""
    g = torch.Generator(device=dev).manual_seed(0)
    BIG = 1e10

    def mk(n, C, payload, tie=True):
        x = torch.rand((n, C), generator=g, device=dev)
        if tie:
            x[::7, 10] = x[::7, 3]
            x[5] = BIG
            x[6, C // 3:] = BIG
            x[9] = 3e12
        p = None
        if payload:
            p = torch.randint(0, 1 << 22, (n, C), generator=g,
                              device=dev).float()
        return x.contiguous(), p

    cases = []
    for name, n, C, k, pay in [("candidates", 4096, 12 * 128, 8, True),
                               ("tile_select", 4096, 128, 12, True),
                               ("insertion", 2047, 32 * 128, 1, True),
                               ("union_rank", 14000, 40, 8, False),
                               ("insert_tiles", 2000, 128, 32, True),
                               ("k_above_32", 4096, 256, 48, True),
                               ("ragged_C", 4096, 1531, 8, True)]:
        x, p = mk(n, C, pay)
        cases.append((name, x, p, k))
    return cases


def run_topk(results: dict) -> dict:
    """Kernel #1 against topk_rows_plain, bitwise, at each case of
    topk_cases.  Times per launch: the kernel's device time
    (torch.profiler) with the L2 cache flushed between launches (each row
    read from device memory, as the path reads a freshly written d2) and
    warm (back to back: the rows partly in L2); the wrapper's time (host
    work included, back to back between events); the plain version's and
    torch.topk's.  The bound's share is taken of the flushed device
    time."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.ops import knn as K
    dev = torch.device("cuda")
    # absent from trees older than the one-pass kernel (parent runs)
    blocks_per_sm = getattr(_cuda.lib("topk_rows"), "hp_topk_blocks_per_sm",
                            None)
    flush = torch.empty((2 * L2_BYTES // 4,), device=dev)
    rows = []
    worst = 0.0
    for name, x, p, k in topk_cases(torch, dev):
        d1, v1 = K.topk_rows(x, p, k)          # the wrapper: CUDA kernel
        d0, v0 = K.topk_rows_plain(x, p, k)
        torch.cuda.synchronize()
        if not (torch.equal(d0, d1) and torch.equal(v0, v1)):
            bad = int((d0 != d1).sum() + (v0 != v1).sum())
            raise AssertionError(f"topk {name}: {bad} elements differ")

        def call():
            return K.topk_rows(x, p, k)

        def device_ms(**kw):
            # the profiler drops some events of such short sessions: the
            # mean over the launches it recorded, if at least half
            for _ in range(3):
                got = [v for kname, v in kernel_launches(
                    call, iters=20, **kw).items() if "topk" in kname]
                n_rec = sum(n for _ms, n in got)
                if n_rec >= 10:
                    return sum(ms for ms, _n in got) / n_rec
            raise AssertionError(f"topk {name}: the profiler recorded "
                                 f"{n_rec} of 20 launches")
        cold = device_ms(flush=flush)
        warm = device_ms()
        ms = cuda_time_ms(call)
        plain = cuda_time_ms(lambda: K.topk_rows_plain(x, p, k), iters=5)
        lib = cuda_time_ms(lambda: torch.topk(x, k, dim=1, largest=False))
        n, C = x.shape
        # the rows read once, the k selected payload values per row, the
        # (n, k) values and indices written once
        nbytes = 4 * n * C + 4 * n * k * (p is not None) + 8 * n * k
        b, by, tc = bound_ms(nbytes, float(n) * C * k)
        rows.append({"case": name, "shape": [n, C], "k": k, "ms": cold,
                     "device_ms_warm": warm, "wrapper_ms": ms,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": b,
                     "bound_by": by, "tc_bound_ms": tc,
                     "bound_share": b / cold,
                     "blocks_per_sm": (blocks_per_sm(C, k) if blocks_per_sm
                                       else None)})
        worst = max(worst, float((d0 - d1).abs().max()))
    main = rows[0]   # the candidate top-k dominates the path's launches
    results["topk_rows"] = {
        "max_abs_err": worst, "ms": main["ms"],
        "device_ms_warm": main["device_ms_warm"],
        "wrapper_ms": main["wrapper_ms"], "plain_ms": main["plain_ms"],
        "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "tc_bound_ms": main["tc_bound_ms"],
        "cases": rows}
    return {"tolerance": TOPK_TOL, "cases": rows}


def maploss_inputs(torch, dev, with_color: bool, n=10000, S=5, u=8):
    """Mapping operating point of bench.py (10000 rays, S=5, u=8) at the
    full model width, random weights from a seed."""
    from hpslam_tpu_torch.models import decoder as Dec
    from hpslam_tpu_torch.ops import fused_mlp as FM
    mcfg = Dec.ModelConfig()
    g = torch.Generator(device=dev).manual_seed(1)
    params = Dec.init_nicer(g, mcfg, dev)
    C = mcfg.c_dim
    z = (2.0 + 0.5 * torch.rand((n, 1), generator=g, device=dev)) \
        * torch.linspace(0.96, 1.04, S, device=dev)
    rd = torch.randn((n, 3), generator=g, device=dev)
    pts = rd[:, None, :] * z[..., None] \
        + 0.01 * torch.randn((n, S, 3), generator=g, device=dev)
    d_gt = z[:, S // 2:S // 2 + 1] * (1 + 0.02 * torch.randn(
        (n, 1), generator=g, device=dev))
    c_gt = torch.rand((n, 3), generator=g, device=dev)
    pm = (torch.rand((n, S), generator=g, device=dev) > 0.1).float()
    Wm = torch.rand((n, S, u), generator=g, device=dev)
    Wm = (Wm / Wm.sum(-1, keepdim=True)).reshape(n, S * u)
    uids = torch.zeros((n, u), device=dev)
    row = torch.cat([z, pts.reshape(n, 3 * S), rd, d_gt, c_gt, pm, Wm,
                     uids], 1).contiguous()
    fs = 2 * C if with_color else C
    uf = (0.1 * torch.randn((n, u * fs), generator=g,
                            device=dev)).contiguous()
    okf = (torch.rand((n, 1), generator=g, device=dev) > 0.05).float()
    aff = (torch.eye(3, device=dev).reshape(1, 9).repeat(n, 1)
           + 0.05 * torch.randn((n, 9), generator=g, device=dev))
    aff = torch.cat([aff, 0.05 * torch.randn((n, 3), generator=g,
                                             device=dev)], 1).contiguous()
    gd, cd = params["geo_fine"], params["col_fine"]
    geo = [w.contiguous() for w in FM.flatten_core(gd["core"])]
    col = [w.contiguous() for w in FM.flatten_core(cd["core"])]
    return dict(uf=uf, aff=aff, col=col, row=row, okf=okf, geo=geo,
                Bs=(gd["B"].contiguous(), cd["B"].contiguous()),
                kw=dict(n_blocks=mcfg.n_blocks, skip=mcfg.skip, S=S, u=u,
                        C=C, coef=0.1), mcfg=mcfg)


def trunk_flops(mcfg, emb, hid, nout, with_embed_cot: bool):
    """(forward, cotangent) flops per sample of one trunk, counted as
    maploss_work counts them: every dense product of the forward; for the
    cotangents the output layer, the hidden part of every later block's
    input and the feature injections, plus, with with_embed_cot, the
    embedding's own cotangent (the first block's input product and the
    skip block's embedding part) and its projection back to the point."""
    C, nb, skip = mcfg.c_dim, mcfg.n_blocks, mcfg.skip
    ins = [emb if i == 0 else (hid + emb if i == skip + 1 else hid)
           for i in range(nb)]
    fwd = 2 * (sum(ins) * hid + nb * C * hid + hid * nout)
    cot = 2 * (hid * nout + (nb - 1) * hid * hid + nb * C * hid)
    if with_embed_cot:
        cot += 2 * (2 * emb * hid + 3 * emb)
    return fwd, cot


def maploss_work(mcfg, n, S, u, with_color, backward, geo_numel,
                 col_numel, need_wgrads=True):
    """(bytes, flops) the function must move / do at this shape.

    Per sample the forward runs the union mix and both trunks.  The
    backward adds, per trunk, the cotangents the inputs that are
    differentiated need: the output layer, the hidden part of every later
    block's input and the feature injections (the embedding is not
    differentiated, so the first block's input product and the skip
    block's embedding part are left out); and, with colour, the colour
    core's weight gradients (one product per weight, as in the forward)
    and the union-mix backward."""
    C = mcfg.c_dim
    fg, cg = trunk_flops(mcfg, mcfg.geo_embed, mcfg.hidden_geo, 1, False)
    fc, cc = (trunk_flops(mcfg, 2 * mcfg.col_embed, mcfg.hidden_col, 3,
                          False) if with_color else (0, 0))
    mix = 2 * u * C * (2 if with_color else 1)
    per = fg + fc + mix
    wg = with_color and need_wgrads
    if backward:
        per += cg + cc + (fc if wg else 0) + mix
    D = 5 * S + 7 + S * u + u
    fs = 2 * C if with_color else C
    weights = geo_numel + (col_numel if with_color else 0)
    nbytes = 4 * (n * (D + u * fs + 1 + 12) + weights)
    if backward:
        nbytes += 4 * (n * (u * fs + 12) + (col_numel if wg else 0))
    return nbytes, float(per) * n * S


def compare_grads(name, k, p, what="maploss"):
    import torch
    diff = (k - p).abs()
    scale = float(p.abs().max())
    fro = float(torch.linalg.norm(k - p) / max(float(torch.linalg.norm(p)),
                                                1e-30))
    frac = float((diff > GRAD_ELEM_TOL * scale + 1e-12).float().mean())
    if fro > GRAD_REL_FRO or frac > GRAD_ELEM_FRAC:
        raise AssertionError(f"{what} {name}: rel fro {fro:.3g}, "
                             f"fraction off {frac:.3g}")
    return float(diff.max()), fro


def run_maploss(results: dict) -> dict:
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.ops import fused_mlp as FM
    dev = torch.device("cuda")
    cases = []
    worst_fwd = worst_bwd = 0.0
    timing = {}
    w_color = 0.1
    # bench.py's operating point (10000 rays) and the smoke's SLAM run
    # (mapping.pixels = 4000 rays per iteration); the colour stage without
    # the affine is the one the SLAM run takes, so it goes into the
    # kernels line; then a ragged n (4001 rays: 20005 samples, not a
    # multiple of the 64-sample tile) and the colour stage without the
    # weight gradients
    for n_rays, with_color, use_aff, need_wg in (
            (10000, True, False, True), (10000, True, True, True),
            (10000, False, False, True), (4000, True, False, True),
            (4000, True, True, True), (4000, False, False, True),
            (4001, True, False, True), (4000, True, False, False)):
        I = maploss_inputs(torch, dev, with_color, n=n_rays)
        kw = dict(I["kw"], with_color=with_color, sigmoid_rgb=not use_aff,
                  use_affine=use_aff)

        def leaves():
            return ([I["uf"].clone().requires_grad_(),
                     I["aff"].clone().requires_grad_()]
                    + [w.clone().requires_grad_() for w in I["col"]])

        def grads_of(fn, ts):
            gl, cl = fn(ts[0], ts[1], ts[2:], I["row"], I["okf"], I["geo"],
                        I["Bs"], **kw)
            (gl + w_color * cl if with_color else gl).backward()
            return gl.detach(), cl.detach(), [
                t.grad if t.grad is not None else torch.zeros_like(t)
                for t in ts]

        def kernel3(*a, **k):
            return FM.nicer_fused_maploss(*a, w_color=w_color,
                                          need_wgrads=need_wg, **k)

        # kernel 3 through the wrapper under autograd, twice (the two must
        # agree bit for bit); the plain version differentiated by autograd
        gk, ck, dk = grads_of(kernel3, leaves())
        gk2, ck2, dk2 = grads_of(kernel3, leaves())
        gp, cp, dp = grads_of(FM.maploss_plain, leaves())
        with torch.no_grad():                   # kernel 2 through the wrapper
            g2, c2 = FM.nicer_fused_maploss(
                I["uf"], I["aff"], I["col"], I["row"], I["okf"], I["geo"],
                I["Bs"], w_color=w_color, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip([gk, ck] + dk, [gk2, ck2] + dk2)):
            raise AssertionError(f"maploss: kernel 3 does not repeat "
                                 f"bitwise (n={n_rays})")
        if not need_wg and any(t.any() for t in dk[2:]):
            raise AssertionError("maploss: colour-core gradients without "
                                 "need_wgrads")
        for name, a, b in (("gl", gk, gp), ("cl", ck, cp), ("gl_fwd", g2, gp),
                           ("cl_fwd", c2, cp)):
            rel = float((a - b).abs() / max(float(b.abs()), 1e-12))
            if rel > LOSS_RTOL:
                raise AssertionError(f"maploss {name}: rel err {rel:.3g}")
            e = float((a - b).abs())
            if name.endswith("_fwd"):
                worst_fwd = max(worst_fwd, e)
            else:
                worst_bwd = max(worst_bwd, e)
        names = ["duf", "daff"] + [f"dcol{i}" for i in range(len(I["col"]))]
        stats = {}
        for name, a, b in zip(names, dk, dp):
            if name == "daff" and not use_aff:
                continue
            if name.startswith("dcol") and not (with_color and need_wg):
                continue
            mx, fro = compare_grads(name, a, b)
            worst_bwd = max(worst_bwd, mx)
            stats[name] = fro
        n, S, u = I["row"].shape[0], kw["S"], kw["u"]
        ts = leaves()
        t3 = cuda_time_ms(lambda: FM.nicer_fused_maploss(
            ts[0], ts[1], ts[2:], I["row"], I["okf"], I["geo"], I["Bs"],
            w_color=w_color, need_wgrads=need_wg, **kw), iters=10)

        def kernel_fwd():
            with torch.no_grad():
                return FM.nicer_fused_maploss(
                    I["uf"], I["aff"], I["col"], I["row"], I["okf"],
                    I["geo"], I["Bs"], w_color=w_color, **kw)
        t2 = cuda_time_ms(kernel_fwd, iters=10)
        pts_ = leaves()
        tp3 = cuda_time_ms(lambda: grads_of(FM.maploss_plain, pts_), iters=5)

        def plain_fwd():
            with torch.no_grad():
                return FM.maploss_plain(I["uf"], I["aff"], I["col"],
                                        I["row"], I["okf"], I["geo"],
                                        I["Bs"], **kw)
        tp2 = cuda_time_ms(plain_fwd, iters=5)
        numel = [sum(t.numel() for t in I[k]) + I["Bs"][i].numel()
                 for i, k in enumerate(("geo", "col"))]
        b3 = bound_ms(*maploss_work(I["mcfg"], n, S, u, with_color, True,
                                    *numel, need_wgrads=need_wg))
        b2 = bound_ms(*maploss_work(I["mcfg"], n, S, u, with_color, False,
                                    *numel))
        cases.append({"with_color": with_color, "affine": use_aff, "n": n,
                      "need_wgrads": need_wg, "fwd_ms": t2,
                      "fwd_plain_ms": tp2, "fwd_bound_ms": b2[0],
                      "bwd_ms": t3, "bwd_plain_ms": tp3,
                      "bwd_bound_ms": b3[0], "bwd_tc_bound_ms": b3[2],
                      "bound_by": b3[1], "bitwise_repeat": True,
                      "grad_rel_fro_max": max(stats.values()),
                      "worst": max(stats, key=stats.get)})
        if n == 4000 and with_color and not use_aff and need_wg:
            timing = {"fwd": (t2, tp2, b2), "bwd": (t3, tp3, b3)}
    results["maploss_fwd"] = {
        "max_abs_err": worst_fwd, "ms": timing["fwd"][0],
        "plain_ms": timing["fwd"][1], "bound_ms": timing["fwd"][2][0],
        "bound_by": timing["fwd"][2][1],
        "tc_bound_ms": timing["fwd"][2][2], "library_ms": None}
    results["maploss_bwd"] = {
        "max_abs_err": worst_bwd, "ms": timing["bwd"][0],
        "plain_ms": timing["bwd"][1], "bound_ms": timing["bwd"][2][0],
        "bound_by": timing["bwd"][2][1],
        "tc_bound_ms": timing["bwd"][2][2], "library_ms": None}
    _cuda.reset_launches()
    return {"tolerance": {"loss_rtol": LOSS_RTOL,
                          "grad_rel_fro": GRAD_REL_FRO,
                          "grad_elem": [GRAD_ELEM_TOL, GRAD_ELEM_FRAC]},
            "cases": cases}


def trunks_work(mcfg, n, with_color, backward, need_dp, need_wgrads,
                geo_numel, col_numel):
    """(bytes, flops) of kernel #4 (forward) or #5 (backward: the forward
    recomputed, the cotangents, with need_wgrads the colour core's weight
    gradients) on n samples."""
    C = mcfg.c_dim
    fg, cg = trunk_flops(mcfg, mcfg.geo_embed, mcfg.hidden_geo, 1, need_dp)
    fc, cc = (trunk_flops(mcfg, 2 * mcfg.col_embed, mcfg.hidden_col, 3,
                          need_dp) if with_color else (0, 0))
    per = fg + fc
    nbytes = 4 * (n * (3 + C * (2 if with_color else 1)) + geo_numel
                  + (col_numel if with_color else 0))
    if not backward:
        return nbytes + 4 * n * 4, float(per) * n
    per += cg + cc + (fc if need_wgrads and with_color else 0)
    nbytes += 4 * n * 4                               # g_occ, g_rgb
    nbytes += 4 * n * (3 * need_dp + C * (2 if with_color else 1))
    nbytes += 4 * (col_numel if need_wgrads and with_color else 0)
    return nbytes, float(per) * n


def trunks_inputs(torch, dev, n=20000):
    """The fused-trunk mapping path's shape (mapping.pixels 4000 rays x
    N_surface 5 samples) at the full model width, random weights from a
    seed, sample positions at room scale (1-3 m)."""
    from hpslam_tpu_torch.models import decoder as Dec
    from hpslam_tpu_torch.ops import fused_mlp as FM
    mcfg = Dec.ModelConfig()
    g = torch.Generator(device=dev).manual_seed(2)
    params = Dec.init_nicer(g, mcfg, dev)
    C = mcfg.c_dim
    rd = torch.randn((n, 3), generator=g, device=dev)
    p = rd * (1.0 + 2.0 * torch.rand((n, 1), generator=g, device=dev))
    gd, cd = params["geo_fine"], params["col_fine"]
    return dict(
        mcfg=mcfg, p=p.contiguous(),
        cg=(0.1 * torch.randn((n, C), generator=g, device=dev)),
        cc=(0.1 * torch.randn((n, C), generator=g, device=dev)),
        g_occ=torch.randn((n,), generator=g, device=dev),
        g_rgb=torch.randn((n, 3), generator=g, device=dev),
        geo=[w.contiguous() for w in FM.flatten_core(gd["core"])],
        col=[w.contiguous() for w in FM.flatten_core(cd["core"])],
        Bs=(gd["B"].contiguous(), cd["B"].contiguous()))


def trunks_via_wrapper(I, with_color, need_dp, need_wgrads=True):
    """Kernels #4-5 through the autograd wrapper the mapping path calls
    (nicer_fused_color / nicer_fused_geo), every input requiring grad:
    (occ, rgb, p.grad, c_geo.grad, c_col.grad, colour-core weight grads).
    The geometry core must get no gradient."""
    import torch
    from hpslam_tpu_torch.ops import fused_mlp as FM
    mcfg = I["mcfg"]
    p = I["p"].clone().requires_grad_()
    cg = I["cg"].clone().requires_grad_()
    cc = I["cc"].clone().requires_grad_()
    geo = [w.clone().requires_grad_() for w in I["geo"]]
    col = [w.clone().requires_grad_() for w in I["col"]]
    if with_color:
        occ, rgb = FM.nicer_fused_color(p, cg, cc, geo, col, I["Bs"],
                                        mcfg.n_blocks, mcfg.skip,
                                        need_dp=need_dp,
                                        need_wgrads=need_wgrads)
        torch.autograd.backward([occ, rgb], [I["g_occ"], I["g_rgb"]])
    else:
        occ = FM.nicer_fused_geo(p, cg, geo, I["Bs"][0], mcfg.n_blocks,
                                 mcfg.skip, need_dp=need_dp)
        occ.backward(I["g_occ"])
        rgb = None
    if any(w.grad is not None for w in geo):
        raise AssertionError("trunks: the geometry core got a gradient")
    if not with_color and (cc.grad is not None
                           or any(w.grad is not None for w in col)):
        raise AssertionError("trunks: geometry only, colour got a gradient")
    if not need_wgrads and any(w.grad is not None for w in col):
        raise AssertionError("trunks: colour-core gradients without "
                             "need_wgrads")
    return (occ.detach(), None if rgb is None else rgb.detach(), p.grad,
            cg.grad, cc.grad, [w.grad for w in col])


def run_trunks(results: dict) -> dict:
    """Kernels #4-5 through their autograd wrapper against
    fused_trunks_plain / fused_trunks_plain_bwd: colour with the weight
    gradients (the mapping path's colour stages), geometry only (its
    geometry stages), colour with the position cotangent (need_dp, the
    bundle-adjustment form), a ragged n (20003 samples, not a multiple of
    the 64-sample tile) with colour and geometry only, and colour without
    the weight gradients.  Two runs of the wrapper must agree bit for bit.
    The bare launcher is timed (and #4's device time, without the host's
    launch overhead), and the occupancy calculator's blocks per SM of the
    tile kernels reported."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.ops import fused_mlp as FM
    dev = torch.device("cuda")
    inputs = {n: trunks_inputs(torch, dev, n=n) for n in (20000, 20003)}
    cases = []
    worst = {"fwd": 0.0, "bwd": 0.0}
    for with_color, need_dp, n, wg in (
            (True, False, 20000, True), (False, False, 20000, False),
            (True, True, 20000, True), (True, False, 20003, True),
            (False, True, 20003, False), (False, False, 20003, False),
            (True, False, 20000, False)):
        I = inputs[n]
        mcfg = I["mcfg"]
        col = I["col"] if with_color else []
        args = (I["p"], I["cg"], I["cc"] if with_color else None, I["Bs"],
                I["geo"], col, mcfg.n_blocks, mcfg.skip, with_color)
        occ, rgb, dp, dcg, dcc, dcol = trunks_via_wrapper(I, with_color,
                                                          need_dp, wg)
        again = trunks_via_wrapper(I, with_color, need_dp, wg)
        first = (occ, rgb, dp, dcg, dcc, *dcol)
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(first, (*again[:5], *again[5]))):
            raise AssertionError(f"trunks: kernels 4-5 do not repeat "
                                 f"bitwise (n={n})")
        occ0, rgb0 = FM.fused_trunks_plain(*args)
        bwd0 = FM.fused_trunks_plain_bwd(*args[:6], I["g_occ"], I["g_rgb"],
                                         *args[6:], need_dp, wg)
        torch.cuda.synchronize()
        stats = {}
        pairs = [("occ", occ, occ0, "fwd")]
        if with_color:
            pairs.append(("rgb", rgb, rgb0, "fwd"))
        pairs.append(("dcg", dcg, bwd0[1], "bwd"))
        if need_dp:
            pairs.append(("dp", dp, bwd0[0], "bwd"))
        elif dp is not None and dp.any():
            raise AssertionError("trunks: dp must be zero without need_dp")
        if with_color:
            pairs.append(("dcc", dcc, bwd0[2], "bwd"))
        if wg:
            pairs += [(f"dcol{i}", a, b, "bwd")
                      for i, (a, b) in enumerate(zip(dcol, bwd0[3]))]
        for name, a, b, which in pairs:
            mx, fro = compare_grads(name, a, b, "trunks")
            worst[which] = max(worst[which], mx)
            stats[name] = fro
        t_f = cuda_time_ms(lambda: FM.launch_trunks(*args, backward=False))
        t_b = cuda_time_ms(lambda: FM.launch_trunks(
            *args, backward=True, g_occ=I["g_occ"], g_rgb=I["g_rgb"],
            need_dp=need_dp, need_wgrads=wg), iters=10)
        tp_f = cuda_time_ms(lambda: FM.fused_trunks_plain(*args), iters=10)
        tp_b = cuda_time_ms(lambda: FM.fused_trunks_plain_bwd(
            *args[:6], I["g_occ"], I["g_rgb"], *args[6:], need_dp, wg),
            iters=5)
        numel = [sum(t.numel() for t in I["geo"]) + I["Bs"][0].numel(),
                 sum(t.numel() for t in I["col"]) + I["Bs"][1].numel()]
        b_f = bound_ms(*trunks_work(mcfg, n, with_color, False, False, False,
                                    *numel))
        b_b = bound_ms(*trunks_work(mcfg, n, with_color, True, need_dp, wg,
                                    *numel))
        case = {"with_color": with_color, "need_dp": need_dp, "n": n,
                "need_wgrads": wg, "fwd_ms": t_f, "fwd_plain_ms": tp_f,
                "fwd_bound_ms": b_f[0], "bwd_ms": t_b, "bwd_plain_ms": tp_b,
                "bwd_bound_ms": b_b[0], "bwd_tc_bound_ms": b_b[2],
                "bound_by": b_b[1], "bitwise_repeat": True,
                "rel_fro_max": max(stats.values()),
                "worst": max(stats, key=stats.get)}
        dp5, dcg5, dcc5, dcol5 = FM.launch_trunks(
            *args, backward=True, g_occ=I["g_occ"], g_rgb=I["g_rgb"],
            need_dp=need_dp, need_wgrads=wg)
        case["bwd_sha256"] = digest(dp5, dcg5, dcc5, *(dcol5 or []))
        if not need_dp and n == 20000 and wg == with_color:
            case["fwd_device_ms"] = kernel_ms(
                lambda: FM.launch_trunks(*args, backward=False))
            case["fwd_sha256"] = digest(*FM.launch_trunks(*args,
                                                          backward=False))
        cases.append(case)
        if with_color and not need_dp and n == 20000 and wg:
            main = (case, b_f, b_b)
        if not with_color and not need_dp and n == 20000:
            geo = (case, b_f)
    case, b_f, b_b = main
    results["trunks_fwd"] = {
        "max_abs_err": worst["fwd"], "ms": case["fwd_ms"],
        "plain_ms": case["fwd_plain_ms"], "bound_ms": b_f[0],
        "bound_by": b_f[1], "tc_bound_ms": b_f[2],
        "library_ms": None, "geo_only_ms": geo[0]["fwd_ms"],
        "geo_only_plain_ms": geo[0]["fwd_plain_ms"],
        "geo_only_bound_ms": geo[1][0], "geo_only_tc_bound_ms": geo[1][2]}
    results["trunks_bwd"] = {
        "max_abs_err": worst["bwd"], "ms": case["bwd_ms"],
        "plain_ms": case["bwd_plain_ms"], "bound_ms": b_b[0],
        "bound_by": b_b[1], "tc_bound_ms": b_b[2],
        "library_ms": None}
    widths = tile_widths(inputs[20000])
    lib = _cuda.lib("trunks")
    occupancy = {
        f"{k} {w}": lib.hp_trunks_blocks_per_sm(*widths, int(w == "colour"),
                                                int(k == "bwd"))
        for k in ("fwd", "bwd") for w in ("colour", "geometry")}
    return {"tolerance": {"grad_rel_fro": GRAD_REL_FRO,
                          "grad_elem": [GRAD_ELEM_TOL, GRAD_ELEM_FRAC]},
            "blocks_per_sm": occupancy, "cases": cases}


def tile_widths(I):
    """(C, emb_g, hid_g, emb_c, hid_c) of a case's model."""
    return (I["mcfg"].c_dim, I["Bs"][0].shape[1], I["geo"][0].shape[1],
            2 * I["Bs"][1].shape[1], I["col"][0].shape[1])


def kernel_launches(fn, iters: int = 10, flush=None) -> dict:
    """{kernel: (device ms, launches recorded)} of each kernel that ``fn``
    launches, summed by torch.profiler over ``iters`` calls after one
    warm-up call; with ``flush`` (a tensor larger than the L2 cache)
    zeroed before each call, so that ``fn`` finds its inputs in device
    memory (the zeroing kernel is listed under its own name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us and us > 0:
            name = ev.key.split("(")[0]
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + us / 1e3, n + ev.count)
    return out


def kernel_ms(fn, iters: int = 10, flush=None) -> dict:
    """Device time per call (ms) of each kernel that ``fn`` launches
    (kernel_launches)."""
    return {k: v[0] / iters
            for k, v in kernel_launches(fn, iters, flush).items()}


def launch_memory(fn) -> dict:
    """Device memory of one call of ``fn``: the allocator's peak during the
    call, and that peak less what was allocated before it (the call's own
    outputs and scratch)."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return {"peak_bytes": peak, "call_bytes": peak - before}


def digest(*ts) -> str:
    """sha256 (first 16 hex digits) of tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def trackloss_work(mcfg, n, S, K, backward, geo_numel, col_numel):
    """(bytes, flops) of kernel #8 (forward) or #9 (backward: the forward
    recomputed, the compositor and tail backward, both trunk backwards with
    the embedding cotangents, the weight route) on n rays of S samples."""
    C = mcfg.c_dim
    fg, cg = trunk_flops(mcfg, mcfg.geo_embed, mcfg.hidden_geo, 1, True)
    fc, cc = trunk_flops(mcfg, 2 * mcfg.col_embed, mcfg.hidden_col, 3, True)
    mix = 2 * K * 2 * C + 10 * K            # feature mix + weights
    per = fg + fc + mix
    Dr = 2 * S + 6 + 3 * S * K
    nbytes = 4 * (n * (6 + Dr + S * K * 2 * C + 12) + geo_numel + col_numel)
    if not backward:
        return nbytes + 4 * n * 5, float(per) * n * S
    per += cg + cc + 2 * K * 2 * C + 12 * K  # cotangents + weight route
    return nbytes + 4 * n * 4 + 4 * n * 18, float(per) * n * S


def trackloss_inputs(torch, dev, n=2000, S=5, K=8, r=0.3):
    """The tracker's operating point (tracking.pixels 2000 rays, N_surface
    5, nn_num 8) at the full model width: rays toward a wall at ~2 m, K
    cached neighbours per sample between 1e-2 and 1.2 r away (some outside
    the radius, one padded slot at the 1e6 sentinel), `has` from those
    distances."""
    from hpslam_tpu_torch.models import decoder as Dec
    from hpslam_tpu_torch.ops import fused_mlp as FM
    mcfg = Dec.ModelConfig()
    C = mcfg.c_dim
    g = torch.Generator(device=dev).manual_seed(3)
    params = Dec.init_nicer(g, mcfg, dev)
    ro = 0.05 * torch.randn((n, 3), generator=g, device=dev)
    rd = torch.cat([torch.rand((n, 2), generator=g, device=dev) - 0.5,
                    -torch.ones((n, 1), device=dev)], 1)
    z = (1.8 + 0.4 * torch.rand((n, 1), generator=g, device=dev)) \
        * torch.linspace(0.96, 1.04, S, device=dev)
    pts = ro[:, None] + z[..., None] * rd[:, None]
    u = torch.randn((n, S, K, 3), generator=g, device=dev)
    u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    dist = 1e-2 + (1.2 * r - 1e-2) * torch.rand((n, S, K, 1), generator=g,
                                                device=dev)
    cpos = pts[:, :, None] + u * dist
    cpos[:, :, -1] = 1e6
    has = (torch.sum(torch.sum((cpos - pts[:, :, None]) ** 2, -1) < r * r,
                     -1) >= 2).float()
    rowc = torch.cat([z, z[:, S // 2:S // 2 + 1],
                      torch.rand((n, 3), generator=g, device=dev),
                      torch.full((n, 1), r * r, device=dev), has,
                      torch.ones((n, 1), device=dev), cpos.reshape(n, -1)],
                     1).contiguous()
    aff = torch.cat([torch.eye(3, device=dev).reshape(1, 9).repeat(n, 1),
                     torch.zeros((n, 3), device=dev)], 1) \
        + 0.05 * torch.randn((n, 12), generator=g, device=dev)
    gd, cd = params["geo_fine"], params["col_fine"]
    return dict(
        mcfg=mcfg, S=S, K=K, rays=torch.cat([ro, rd], 1).contiguous(),
        rowc=rowc, aff=aff.contiguous(),
        cfeat=(0.1 * torch.randn((n, S * K * 2 * C), generator=g,
                                 device=dev)),
        g_depth=torch.randn((n,), generator=g, device=dev),
        g_color=torch.randn((n, 3), generator=g, device=dev),
        geo=[w.contiguous() for w in FM.flatten_core(gd["core"])],
        col=[w.contiguous() for w in FM.flatten_core(cd["core"])],
        Bs=(gd["B"].contiguous(), cd["B"].contiguous()))


def drays_f64(I, static):
    """d rays of trackloss_plain evaluated in float64 on the same inputs."""
    import torch
    from hpslam_tpu_torch.ops import fused_mlp as FM

    def dbl(ts):
        return [t.double() for t in ts]
    r = I["rays"].double().requires_grad_()
    d, _v, c = FM.trackloss_plain(
        r, I["aff"].double(), I["rowc"].double(), I["cfeat"].double(),
        dbl(I["geo"]), dbl(I["col"]), tuple(dbl(I["Bs"])), *static)
    torch.autograd.backward([d, c], [I["g_depth"].double(),
                                     I["g_color"].double()])
    return r.grad


def check_drays(I, static, k, p):
    """d rays of the kernel (k) and of the f32 plain version (p) against
    the plain version in float64; the f32 plain version's distance measures
    how far the inputs' conditioning carries f32 rounding.  The kernel is
    held (1) in relative Frobenius distance to max(GRAD_REL_FRO,
    COND_FACTOR x the f32 plain version's) and (2) element-wise:
    |k - f64| <= COND_FACTOR x (the f32 plain version's largest error on
    the same ray) + GRAD_ELEM_TOL x max|f64|, for all but GRAD_ELEM_FRAC of
    the entries.  Returns the readings."""
    import torch
    p64 = drays_f64(I, static)
    e_k, e_p = (k.double() - p64).abs(), (p.double() - p64).abs()
    norm = max(float(torch.linalg.norm(p64)), 1e-30)
    fro_k = float(torch.linalg.norm(e_k)) / norm
    fro_p = float(torch.linalg.norm(e_p)) / norm
    scale = float(p64.abs().max())
    lim = COND_FACTOR * e_p.amax(1, keepdim=True) + GRAD_ELEM_TOL * scale
    frac = float((e_k > lim).double().mean())
    out = {"n": k.shape[0], "rel_fro_kernel": fro_k, "rel_fro_plain_f32":
           fro_p, "max_abs_f64": scale, "max_err_kernel": float(e_k.max()),
           "max_err_plain_f32": float(e_p.max()),
           "worst_err_over_limit": float((e_k / lim).max()),
           "fraction_off": frac}
    if fro_k > max(GRAD_REL_FRO, COND_FACTOR * fro_p) \
            or frac > GRAD_ELEM_FRAC:
        raise AssertionError(f"trackloss drays: {out}")
    return out


def run_trackloss(results: dict) -> dict:
    """Kernels #8-9 under autograd (the wrapper) against trackloss_plain
    differentiated by autograd: the SLAM run's sigmoid tail with distance
    weights, the exposure affine, exp weighting, and a ragged 2001 rays
    (10005 samples, not a multiple of #9's 64-sample tile).  Two runs of
    the wrapper must agree bit for bit.  The bare launcher is timed, #8's
    and #9's device time split by pass, the occupancy calculator's blocks
    per SM of the tile passes and the device memory of one #8 launch
    reported."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.ops import fused_mlp as FM
    dev = torch.device("cuda")
    inputs = {n: trackloss_inputs(torch, dev, n=n) for n in (2000, 2001)}
    cases = []
    worst = {"fwd": 0.0, "bwd": 0.0}
    main = None
    for use_aff, wmode, n in ((False, 0, 2000), (True, 0, 2000),
                              (False, 1, 2000), (False, 0, 2001)):
        I = inputs[n]
        mcfg, S, K = I["mcfg"], I["S"], I["K"]
        C = mcfg.c_dim
        static = (mcfg.n_blocks, mcfg.skip, S, K, C, 0.1, wmode, use_aff,
                  not use_aff)
        consts = (I["rowc"], I["cfeat"], I["geo"], I["col"], I["Bs"])

        def run(fn):
            r = I["rays"].clone().requires_grad_()
            a = I["aff"].clone().requires_grad_()
            d, v, c = fn(r, a, I["rowc"], I["cfeat"], I["geo"], I["col"],
                         I["Bs"], *static)
            torch.autograd.backward([d, c], [I["g_depth"], I["g_color"]])
            return [d.detach(), v.detach(), c.detach(), r.grad,
                    a.grad if a.grad is not None else torch.zeros_like(a)]

        k, again = run(FM.nicer_fused_trackloss), run(FM.nicer_fused_trackloss)
        p = run(FM.trackloss_plain)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(k, again)):
            raise AssertionError(f"trackloss: kernels 8-9 do not repeat "
                                 f"bitwise (n={n})")
        stats = {}
        names = ["depth", "var", "color", "drays", "daff"]
        for name, a, b in zip(names, k, p):
            if name == "daff" and not use_aff:
                if a.any():
                    raise AssertionError("trackloss: daff must be zero "
                                         "without the affine")
                continue
            if name == "drays":
                stats["drays_f64"] = check_drays(I, static, a, b)
                mx = float((a - b).abs().max())
                fro = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
            else:
                mx, fro = compare_grads(name, a, b, "trackloss")
            which = "bwd" if name.startswith("d") and name != "depth" \
                else "fwd"
            worst[which] = max(worst[which], mx)
            stats[name] = fro
        kw = dict(zip(("n_blocks", "skip", "S", "K", "C", "coef", "wmode",
                       "use_affine", "sigmoid_plain"), static))

        def kernel8():
            return FM.launch_trackloss(I["rays"], I["aff"], *consts,
                                       backward=False, **kw)

        def kernel9():
            return FM.launch_trackloss(
                I["rays"], I["aff"], *consts, backward=True,
                g_depth=I["g_depth"], g_color=I["g_color"], **kw)
        t_f = cuda_time_ms(kernel8)
        t_b = cuda_time_ms(kernel9)

        def plain_fwd():
            with torch.no_grad():
                return FM.trackloss_plain(I["rays"], I["aff"], *consts,
                                          *static)
        tp_f = cuda_time_ms(plain_fwd, iters=10)
        tp_b = cuda_time_ms(lambda: run(FM.trackloss_plain), iters=5)
        numel = [sum(t.numel() for t in I["geo"]) + I["Bs"][0].numel(),
                 sum(t.numel() for t in I["col"]) + I["Bs"][1].numel()]
        b_f = bound_ms(*trackloss_work(mcfg, n, S, K, False, *numel))
        b_b = bound_ms(*trackloss_work(mcfg, n, S, K, True, *numel))
        case = {"affine": use_aff, "wmode": wmode, "n": n, "fwd_ms": t_f,
                "fwd_plain_ms": tp_f, "fwd_bound_ms": b_f[0], "bwd_ms": t_b,
                "bwd_plain_ms": tp_b, "bwd_bound_ms": b_b[0],
                "bound_by": b_b[1], "bitwise_repeat": True,
                "drays_vs_float64": stats.pop("drays_f64"),
                "rel_fro_max": max(stats.values())}
        if main is None:
            case["fwd_pass_ms"] = {
                k_: v for k_, v in kernel_ms(kernel8).items()
                if k_.startswith("tl_")}
            case["bwd_pass_ms"] = {
                k_: v for k_, v in kernel_ms(kernel9).items()
                if k_.startswith("tl_")}
            case["fwd_memory"] = launch_memory(kernel8)
            main = (case, b_f, b_b)
        cases.append(case)
    case, b_f, b_b = main
    passes = case["bwd_pass_ms"]
    results["trackloss_fwd"] = {
        "max_abs_err": worst["fwd"], "ms": case["fwd_ms"],
        "plain_ms": case["fwd_plain_ms"], "bound_ms": b_f[0],
        "bound_by": b_f[1], "tc_bound_ms": b_f[2],
        "library_ms": None, "pass_ms": case["fwd_pass_ms"]}
    results["trackloss_bwd"] = {
        "max_abs_err": worst["bwd"], "ms": case["bwd_ms"],
        "plain_ms": case["bwd_plain_ms"], "bound_ms": b_b[0],
        "bound_by": b_b[1], "tc_bound_ms": b_b[2],
        "library_ms": None, "pass_ms": passes,
        "without_recompute_ms": passes.get("tl_bwd_tiles", 0.0)
        + passes.get("tl_drays", 0.0)}
    I = inputs[2000]
    C, emb_g, hid_g, emb_c, hid_c = tile_widths(I)
    lib = _cuda.lib("trackloss")
    occupancy = {name: lib.hp_trackloss_blocks_per_sm(
        C, I["K"], emb_g, hid_g, emb_c, hid_c, k)
        for name, k in (("pass 1 (#8, #9)", 1), ("pass 3 (#9)", 3))}
    return {"tolerance": {"grad_rel_fro": GRAD_REL_FRO,
                          "grad_elem": [GRAD_ELEM_TOL, GRAD_ELEM_FRAC],
                          "drays_vs_float64": COND_FACTOR},
            "blocks_per_sm": occupancy, "cases": cases}


# flops per sample of the occupancy compositor, counted from comp_fwd
# (occ forcing, sigmoid, transmittance, weights, depth, colour, variance,
# the rgb sigmoid) and comp_bwd (the dw terms, d rgb, the sigmoid chain,
# the suffix loop, d occ); small beside the trunks' ~0.2 MFLOP
COMP_FWD_FLOPS = 34
COMP_BWD_FLOPS = 42
COMP_COEF = 0.1                 # mapping.sigmoid_coef_mapper


def composite_work(mcfg, n_r, S, with_color, backward, need_wgrads,
                   geo_numel, col_numel):
    """(bytes, flops) of kernel #6 (forward) or #7 (backward) on n_r rays of
    S samples, the trunks counted as trunks_work counts them: #6 reads the
    sample rows (p, c_geo, c_col), z, pm and the weights, runs both trunk
    forwards and the compositor, and writes depth, var, colour per ray and
    occ, rgb per sample; #7 reads dD, dV, dC instead of writing the ray
    outputs, adds the compositor backward, the trunk cotangents (no
    position cotangent) and, with need_wgrads and colour, the colour core's
    weight gradients, and writes dc_geo, dc_col (and those gradients)."""
    n = n_r * S
    C = mcfg.c_dim
    nc = 2 if with_color else 1
    fg, cg = trunk_flops(mcfg, mcfg.geo_embed, mcfg.hidden_geo, 1, False)
    fc, cc = (trunk_flops(mcfg, 2 * mcfg.col_embed, mcfg.hidden_col, 3,
                          False) if with_color else (0, 0))
    per = fg + fc + COMP_FWD_FLOPS
    cw = col_numel if with_color else 0
    nbytes = 4 * (n * (3 + C * nc + 2) + geo_numel + cw)
    if not backward:
        return nbytes + 4 * (5 * n_r + 4 * n), float(per) * n
    wg = need_wgrads and with_color
    per += cg + cc + COMP_BWD_FLOPS + (fc if wg else 0)
    nbytes += 4 * (5 * n_r + n * C * nc + (cw if wg else 0))
    return nbytes, float(per) * n


def composite_inputs(torch, dev, n_r=4000, S=5):
    """The union mapping path's shape under a mesh (mapping.pixels 4000 rays
    x N_surface 5 samples) at the full model width, random weights from a
    seed: rays from the origin, samples 1-3 m along them around the
    surface, a tenth of the samples padded (pm = 0), per-ray cotangents."""
    from hpslam_tpu_torch.models import decoder as Dec
    from hpslam_tpu_torch.ops import fused_mlp as FM
    mcfg = Dec.ModelConfig()
    g = torch.Generator(device=dev).manual_seed(5)
    params = Dec.init_nicer(g, mcfg, dev)
    n, C = n_r * S, mcfg.c_dim
    rd = torch.randn((n_r, 3), generator=g, device=dev)
    rd = rd / torch.linalg.norm(rd, dim=1, keepdim=True)
    z = (1.0 + 2.0 * torch.rand((n_r, 1), generator=g, device=dev)) \
        * torch.linspace(0.96, 1.04, S, device=dev)
    gd, cd = params["geo_fine"], params["col_fine"]
    return dict(
        mcfg=mcfg, S=S, z=z.contiguous(),
        p=(rd[:, None, :] * z[..., None]).reshape(n, 3).contiguous(),
        pm=(torch.rand((n_r, S), generator=g, device=dev) > 0.1).float(),
        cg=0.1 * torch.randn((n, C), generator=g, device=dev),
        cc=0.1 * torch.randn((n, C), generator=g, device=dev),
        dD=torch.randn((n_r,), generator=g, device=dev),
        dV=torch.randn((n_r,), generator=g, device=dev),
        dC=torch.randn((n_r, 3), generator=g, device=dev),
        geo=[w.contiguous() for w in FM.flatten_core(gd["core"])],
        col=[w.contiguous() for w in FM.flatten_core(cd["core"])],
        Bs=(gd["B"].contiguous(), cd["B"].contiguous()))


def composite_autograd(I, fn, with_color, sigmoid_rgb):
    """(depth, var, color, c_geo.grad, c_col.grad, colour-core weight
    grads) of ``fn`` ("wrapper": nicer_fused_composite, kernel #6 forward
    and the _ncomp_bwd backward; "plain": composite_plain under autograd)
    for the per-ray cotangents dD, dV, dC.  Through the wrapper the
    geometry core must get no gradient."""
    import torch
    from hpslam_tpu_torch.ops import fused_mlp as FM
    mcfg, S = I["mcfg"], I["S"]
    cg = I["cg"].clone().requires_grad_()
    cc = I["cc"].clone().requires_grad_()
    geo = [w.clone().requires_grad_() for w in I["geo"]]
    col = [w.clone().requires_grad_() for w in I["col"]]
    if fn == "wrapper":
        d, v, c = FM.nicer_fused_composite(
            cg, cc if with_color else None, I["p"], I["z"], I["pm"], geo,
            col, I["Bs"], mcfg.n_blocks, mcfg.skip, with_color, S,
            COMP_COEF, True, sigmoid_rgb)
    else:
        d, v, c, _occ, _rgb = FM.composite_plain(
            I["p"], cg, cc if with_color else None, I["z"], I["pm"],
            I["Bs"], geo, col, mcfg.n_blocks, mcfg.skip, with_color, S,
            COMP_COEF, sigmoid_rgb)
    torch.autograd.backward([d, v, c], [I["dD"], I["dV"], I["dC"]])
    if fn == "wrapper" and any(w.grad is not None for w in geo):
        raise AssertionError("composite: the geometry core got a gradient")
    zero = torch.zeros_like
    return (d.detach(), v.detach(), c.detach(), cg.grad,
            cc.grad if cc.grad is not None else zero(cc),
            [w.grad if w.grad is not None else zero(w) for w in col])


def run_composite(results: dict) -> dict:
    """Kernel #6 through nicer_fused_composite under autograd against
    composite_plain under autograd (depth, var, colour and the gradients of
    c_geo, c_col and the colour core), and kernel #7 through fused_comp_bwd
    against composite_bwd_plain, on the same inputs: colour with the
    sigmoid tail (the SLAM run's encode_exposure False), colour raw
    (encode_exposure), geometry only, and a ragged 601 rays (3005 samples,
    not a multiple of the 64-sample tile).  Two runs of the wrapper, and of
    #7, must agree bit for bit.  The bare launchers are timed, #7 beside
    the composition that nicer_fused_composite's backward runs on #6's
    saved occ and rgb (comp_cotangents in tensor ops, then #5), each
    kernel's device time split by pass, the occupancy calculator's blocks
    per SM of both tile passes and the device memory of one #6 and one #7
    launch reported."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.ops import fused_mlp as FM
    dev = torch.device("cuda")
    inputs = {n_r: composite_inputs(torch, dev, n_r=n_r)
              for n_r in (4000, 601)}
    cases = []
    worst = {"fwd": 0.0, "bwd": 0.0}
    main = None
    for with_color, sigmoid_rgb, n_r in ((True, True, 4000),
                                         (True, False, 4000),
                                         (False, False, 4000),
                                         (True, True, 601)):
        I = inputs[n_r]
        mcfg, S = I["mcfg"], I["S"]
        before = dict(_cuda.LAUNCHES)
        k = composite_autograd(I, "wrapper", with_color, sigmoid_rgb)
        for name in ("composite_fwd", "trunks_bwd"):
            if _cuda.LAUNCHES[name] != before.get(name, 0) + 1:
                raise AssertionError(f"composite: the wrapper did not "
                                     f"launch {name} once")
        again = composite_autograd(I, "wrapper", with_color, sigmoid_rgb)
        if not all(torch.equal(a, b) for a, b in
                   zip((*k[:5], *k[5]), (*again[:5], *again[5]))):
            raise AssertionError(f"composite: kernel 6 (and its backward) "
                                 f"does not repeat bitwise (n_r={n_r})")
        p = composite_autograd(I, "plain", with_color, sigmoid_rgb)
        args = (I["p"], I["cg"], I["cc"] if with_color else None, I["z"],
                I["pm"], I["Bs"], I["geo"], I["col"] if with_color else [],
                mcfg.n_blocks, mcfg.skip, with_color, S, COMP_COEF,
                sigmoid_rgb)
        cot = (I["dD"], I["dV"], I["dC"])
        k7 = FM.fused_comp_bwd(*args[:8], *cot, *args[8:13], True,
                               sigmoid_rgb)
        k7b = FM.fused_comp_bwd(*args[:8], *cot, *args[8:13], True,
                                sigmoid_rgb)
        p7 = FM.composite_bwd_plain(*args[:8], *cot, *args[8:13], True,
                                    sigmoid_rgb)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip((*k7[:2], *k7[2]), (*k7b[:2], *k7b[2]))):
            raise AssertionError(f"composite: kernel 7 does not repeat "
                                 f"bitwise (n_r={n_r})")
        pairs = [("depth", k[0], p[0], "fwd"), ("var", k[1], p[1], "fwd"),
                 ("dcg", k[3], p[3], "bwd"), ("k7 dcg", k7[0], p7[0], "bwd")]
        if with_color:
            pairs += [("color", k[2], p[2], "fwd"), ("dcc", k[4], p[4], "bwd"),
                      ("k7 dcc", k7[1], p7[1], "bwd")]
            pairs += [(f"dcol{i}", a, b, "bwd")
                      for i, (a, b) in enumerate(zip(k[5], p[5]))]
            pairs += [(f"k7 dcol{i}", a, b, "bwd")
                      for i, (a, b) in enumerate(zip(k7[2], p7[2]))]
        elif k[2].any() or k7[1].any():
            raise AssertionError("composite: colour without colour")
        stats = {}
        for name, a, b, which in pairs:
            mx, fro = compare_grads(name, a, b, "composite")
            worst[which] = max(worst[which], mx)
            stats[name] = fro
        case = {"with_color": with_color, "sigmoid_rgb": sigmoid_rgb,
                "n_rays": n_r, "S": S, "bitwise_repeat": True,
                "rel_fro_max": max(stats.values()),
                "worst": max(stats, key=stats.get)}
        cases.append(case)
        if n_r != 4000:
            continue

        def kernel6():
            return FM.launch_composite(*args)

        def kernel7():
            return FM.launch_composite(*args, backward=True, dD=I["dD"],
                                       dV=I["dV"], dC=I["dC"],
                                       need_wgrads=True)
        _d, _v, _c, occ, rgb = kernel6()

        def composition():
            g_occ, g_rgb = FM.comp_cotangents(occ, rgb, I["z"], I["pm"],
                                              COMP_COEF, *cot,
                                              sigmoid_rgb and with_color)
            return FM.launch_trunks(
                I["p"], I["cg"], args[2], I["Bs"], I["geo"], args[7],
                mcfg.n_blocks, mcfg.skip, with_color, backward=True,
                g_occ=g_occ.contiguous(), g_rgb=g_rgb.contiguous(),
                need_dp=False, need_wgrads=True)
        t6 = cuda_time_ms(kernel6)
        t7 = cuda_time_ms(kernel7, iters=10)
        t_comp = cuda_time_ms(composition, iters=10)

        def plain_fwd():
            with torch.no_grad():
                return FM.composite_plain(*args)
        tp6 = cuda_time_ms(plain_fwd, iters=10)
        tp7 = cuda_time_ms(lambda: FM.composite_bwd_plain(
            *args[:8], *cot, *args[8:13], True, sigmoid_rgb), iters=5)
        numel = [sum(t.numel() for t in I["geo"]) + I["Bs"][0].numel(),
                 sum(t.numel() for t in I["col"]) + I["Bs"][1].numel()]
        b6 = bound_ms(*composite_work(mcfg, n_r, S, with_color, False, False,
                                      *numel))
        b7 = bound_ms(*composite_work(mcfg, n_r, S, with_color, True, True,
                                      *numel))
        case.update({"fwd_ms": t6, "fwd_plain_ms": tp6,
                     "fwd_bound_ms": b6[0], "fwd_tc_bound_ms": b6[2],
                     "fwd_pass_ms": {
                         k_: v for k_, v in kernel_ms(kernel6).items()
                         if k_.startswith("cp_")},
                     "fwd_memory": launch_memory(kernel6),
                     "bwd_ms": t7, "bwd_plain_ms": tp7,
                     "bwd_bound_ms": b7[0], "bwd_tc_bound_ms": b7[2],
                     "bound_by": b7[1],
                     "bwd_pass_ms": {
                         k_: v for k_, v in kernel_ms(kernel7).items()
                         if k_.startswith(("cp_", "wg_tc_"))},
                     "bwd_memory": launch_memory(kernel7),
                     "composition_ms": t_comp,
                     "composition_device_ms": sum(
                         kernel_ms(composition).values()),
                     "composition_memory": launch_memory(composition)})
        if main is None:
            main = (case, b6, b7)
    _cuda.reset_launches()
    case, b6, b7 = main
    results["composite_fwd"] = {
        "max_abs_err": worst["fwd"], "ms": case["fwd_ms"],
        "plain_ms": case["fwd_plain_ms"], "bound_ms": b6[0],
        "bound_by": b6[1], "tc_bound_ms": b6[2],
        "library_ms": None, "pass_ms": case["fwd_pass_ms"],
        "geo_only_ms": cases[2]["fwd_ms"],
        "geo_only_tc_bound_ms": cases[2]["fwd_tc_bound_ms"]}
    results["composite_bwd"] = {
        "max_abs_err": worst["bwd"], "ms": case["bwd_ms"],
        "plain_ms": case["bwd_plain_ms"], "bound_ms": b7[0],
        "bound_by": b7[1], "tc_bound_ms": b7[2],
        "library_ms": None, "pass_ms": case["bwd_pass_ms"],
        "composition_ms": case["composition_ms"],
        "geo_only_ms": cases[2]["bwd_ms"],
        "geo_only_composition_ms": cases[2]["composition_ms"]}
    widths = tile_widths(inputs[4000])
    lib = _cuda.lib("composite")
    occupancy = {f"{k} {w}": lib.hp_composite_blocks_per_sm(
        *widths, int(w == "colour"), int(k == "bwd"))
        for k in ("fwd", "bwd") for w in ("colour", "geometry")}
    return {"tolerance": {"grad_rel_fro": GRAD_REL_FRO,
                          "grad_elem": [GRAD_ELEM_TOL, GRAD_ELEM_FRAC]},
            "blocks_per_sm": occupancy, "cases": cases}


def run_scatter_repeat() -> dict:
    """The deterministic scatter-add of the feature gathers' backward
    (index_add_rows) at the union mapping path's shape (4000 rays x 8 union
    slots into 2000 feature rows of 64 channels, ~16 sources per row):
    three runs bitwise equal, its distance from a float64 index_add_, and
    whether torch's atomic index_add_ repeats on the same inputs; times of
    both."""
    import torch
    from hpslam_tpu_torch.ops import interpolate as IT
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rows = 2000
    idx = torch.randint(0, rows, (32000,), generator=g, device=dev)
    src = torch.randn((32000, 64), generator=g, device=dev)
    outs = [IT.index_add_rows(rows, idx, src) for _ in range(3)]
    atomic = [torch.zeros((rows, 64), device=dev).index_add_(0, idx, src)
              for _ in range(3)]
    ref = torch.zeros((rows, 64), dtype=torch.float64, device=dev)
    ref.index_add_(0, idx, src.double())
    cpu = torch.zeros((rows, 64)).index_add_(0, idx.cpu(), src.cpu())
    out = {"repeats_bitwise": all(torch.equal(outs[0], o) for o in outs),
           "equals_cpu_index_add_bitwise": torch.equal(outs[0].cpu(), cpu),
           "max_abs_err_vs_f64": float((outs[0].double() - ref).abs().max()),
           "atomic_index_add_repeats_bitwise": all(
               torch.equal(atomic[0], a) for a in atomic),
           "ms": cuda_time_ms(lambda: IT.index_add_rows(rows, idx, src)),
           "atomic_ms": cuda_time_ms(lambda: torch.zeros(
               (rows, 64), device=dev).index_add_(0, idx, src))}
    if not out["repeats_bitwise"]:
        raise AssertionError(f"index_add_rows does not repeat: {out}")
    return out


# kernel-name fragments of the device-time groups that --profile reports
PROFILE_GROUPS = [
    ("maploss kernels", ("ml_", "loss_reduce")),
    ("trunks kernels", ("tr_fwd_tiles", "tr_bwd_tiles")),
    ("composite kernels", ("cp_",)),
    ("trackloss kernels", ("tl_",)),
    ("weight-gradient passes", ("wgrad_", "wg_tc_")),
    ("topk_rows kernel", ("topk_rows",)),
    ("matmul (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "gemv", "dot_")),
    ("index / gather / scatter", ("index", "gather", "scatter")),
    ("reductions", ("reduce",)),
    ("sort / unique / scan", ("sort", "radix", "unique", "scan",
                              "cumsum")),
    ("elementwise", ("elementwise",)),
]


# kernel-name fragments that a profiled SLAM run must show (and must not):
# #1 runs its one-pass kernel (k <= 32 on every path), #8 and #6 the tile
# passes, not the scalar passes they replaced
PROFILE_KERNELS = {
    "slam": (("topk_rows_lists",), ("topk_rows_kpass",)),
    "slam_fused": (("tl_fwd_tiles", "tl_rays", "tl_bwd_tiles"),
                   ("tl_fwd_samples",)),
    "slam_mesh": (("cp_fwd_tiles", "cp_rays"), ("cp_samples",)),
}


def profile_run(run_once, name: str = "") -> dict:
    """Run ``run_once()`` under torch.profiler: wall time, device busy
    share (summed kernel time over wall time, one stream), device time per
    group of PROFILE_GROUPS and the 15 costliest kernels.  Fails if the
    kernels miss one that PROFILE_KERNELS[name] requires or show one that
    it excludes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        summary = run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        kind = getattr(getattr(ev, "device_type", None), "name", "CUDA")
        if dev_us and dev_us > 0 and kind == "CUDA":
            us, cnt = kernels.get(ev.key, (0.0, 0))
            kernels[ev.key] = (us + dev_us, cnt + ev.count)
    groups: dict = {}
    counts: dict = {}
    for name, (us, cnt) in kernels.items():
        low = name.lower()
        g = next((g for g, keys in PROFILE_GROUPS
                  if any(k in low for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + cnt
    shown, hidden = PROFILE_KERNELS.get(name, ((), ()))
    missing = [k for k in shown if not any(k in n for n in kernels)]
    present = [k for k in hidden if any(k in n for n in kernels)]
    if missing or present:
        raise AssertionError(f"{name} profile: kernels missing {missing}, "
                             f"kernels present {present}")
    total_s = sum(v[0] for v in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_s": wall, "device_kernel_s": total_s,
            "device_busy_share": total_s / wall,
            "track_ms_mean": summary["track_ms_mean"],
            "map_ms_mean": summary["map_ms_mean"],
            "groups_ms": {g: us / 1e3 for g, us in
                          sorted(groups.items(), key=lambda kv: -kv[1])},
            "groups_launches": counts,
            "top_kernels": [{"name": n[:90], "ms": us / 1e3, "launches": c}
                            for n, (us, c) in top]}


# kernels each SLAM run must launch (> 0) or must not launch (== 0)
SLAM_RUNS = {
    # the default path: plain tracker, union mapping on the mapping loss;
    # the reference's mapper evaluates the loss only under a gradient, so
    # kernel 2 (the forward alone) is never launched on this path; it is
    # held against the plain version in the maploss phase
    "slam": ("", ("topk_rows", "maploss_bwd"), ()),
    # the fused tracker render and union mapping on the fused trunks;
    # no mapping-loss launch proves that the knob routed the mapper
    "slam_fused": ("tracking:\n  fused_loss: True\n"
                   "model:\n  fused_composite: False\n",
                   ("topk_rows", "trunks_fwd", "trunks_bwd", "trackloss_fwd",
                    "trackloss_bwd"), ("maploss_bwd", "maploss_fwd")),
    # the dp-mesh path on one card: the tracker's dp branch (no fused
    # render under a mesh) and union mapping through the fused composite
    # (kernel #6, its backward on kernel #5), never the mapping loss
    "slam_mesh": ('mesh: "dp1"\n',
                  ("topk_rows", "composite_fwd", "trunks_bwd"),
                  ("maploss_bwd", "maploss_fwd", "trackloss_fwd",
                   "trackloss_bwd", "trunks_fwd")),
}


@contextlib.contextmanager
def world1_group(name: str):
    """For slam_mesh: a world-1 NCCL process group on this card (an
    in-process store, no launcher), so that the mesh's collectives run on
    the card; destroyed afterwards."""
    if name != "slam_mesh":
        yield
        return
    import torch
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_slam(out_dir: str, name: str = "slam", profile: bool = False,
             tag: str = ""):
    """The 10-frame SLAM run through the port's CLI entry point, with the
    config additions of SLAM_RUNS[name]; with ``profile`` the same run is
    repeated under torch.profiler (the first run is its warm-up) and its
    summary returned under "profile".  Returns (summary, estimated
    trajectory from the run's last checkpoint)."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch import run as R
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    work = tempfile.mkdtemp(prefix="hpslam_smoke_")
    try:
        cfg_path = os.path.join(work, "smoke.yaml")
        base = os.path.join(HERE, "configs", "Synthetic", "synth_tpu.yaml")
        with open(cfg_path, "w") as f:
            f.write(f"inherit_from: {base}\n"
                    "synthetic:\n  n_frames: 10\n"
                    "tracking:\n  vis_freq: 1000\n"
                    "mapping:\n  vis_freq: 1000\n"
                    "verbose: False\n" + SLAM_RUNS[name][0])
        argv = [cfg_path, "--input_folder", os.path.join(work, "in")]
        with world1_group(name):
            _cuda.reset_launches()
            torch.cuda.synchronize()
            results, summary = R.run(argv + ["--output",
                                             os.path.join(work, "out")])
            torch.cuda.synchronize()
            launches = dict(_cuda.LAUNCHES)
            prof = (profile_run(lambda: R.run(
                argv + ["--output", os.path.join(work, "prof")])[1], name)
                if profile else None)
        traj = load_checkpoint(latest_checkpoint(os.path.join(
            work, "out")))["estimate_c2w_list"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ate = results["absolute_translational_error.rmse"]
    out = {"ate_rmse_m": ate, "track_ms_mean": summary["track_ms_mean"],
           "map_ms_mean": summary["map_ms_mean"],
           "n_frames": summary["n_frames"], "launches": launches}
    if prof is not None:
        out["profile"] = prof
    with open(os.path.join(out_dir, f"{name}{tag}_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    if not ate < ATE_MAX_M:
        raise AssertionError(f"ATE RMSE {ate} m above {ATE_MAX_M} m")
    _cfg, launched, not_launched = SLAM_RUNS[name]
    for k in launched:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"{name} path")
    for k in not_launched:
        if launches.get(k, 0) != 0:
            raise AssertionError(f"kernel {k} was launched on the {name} "
                                 "path")
    return out, traj


def run_repeat(out_dir: str, first: dict) -> dict:
    """The scatter check, then each SLAM run of ``first`` ({name: (summary,
    trajectory)}) again in this process: the estimated trajectories and
    the ATEs must be bitwise equal."""
    import numpy as np
    out = {"scatter": run_scatter_repeat()}
    bad = []
    for name, (s0, traj0) in first.items():
        s1, traj1 = run_slam(out_dir, name, tag="_repeat")
        same = bool(np.array_equal(traj0, traj1))
        out[name] = {
            "trajectory_bitwise_equal": same,
            "ate_bitwise_equal": s0["ate_rmse_m"] == s1["ate_rmse_m"],
            "ate_rmse_m": [s0["ate_rmse_m"], s1["ate_rmse_m"]],
            "max_abs_pose_diff": float(np.abs(traj0 - traj1).max()),
            "first_frame_that_differs": next(
                (i for i in range(len(traj0))
                 if not np.array_equal(traj0[i], traj1[i])), None),
            "track_ms_mean": s1["track_ms_mean"],
            "map_ms_mean": s1["map_ms_mean"]}
        if not (same and out[name]["ate_bitwise_equal"]):
            bad.append(name)
    if bad:
        emit({"repeat": out})
        raise AssertionError(f"runs do not repeat: {bad}")
    return out


KERNELS = [
    ("topk_rows", "hpslam_tpu_torch/csrc/topk_rows.cu",
     "hpslam_tpu/ops/knn.py:235"),
    ("maploss_fwd", "hpslam_tpu_torch/csrc/maploss.cu",
     "hpslam_tpu/ops/fused_mlp.py:1066"),
    ("maploss_bwd", "hpslam_tpu_torch/csrc/maploss.cu",
     "hpslam_tpu/ops/fused_mlp.py:1098"),
    ("trunks_fwd", "hpslam_tpu_torch/csrc/trunks.cu",
     "hpslam_tpu/ops/fused_mlp.py:278"),
    ("trunks_bwd", "hpslam_tpu_torch/csrc/trunks.cu",
     "hpslam_tpu/ops/fused_mlp.py:299"),
    ("trackloss_fwd", "hpslam_tpu_torch/csrc/trackloss.cu",
     "hpslam_tpu/ops/fused_mlp.py:1565"),
    ("trackloss_bwd", "hpslam_tpu_torch/csrc/trackloss.cu",
     "hpslam_tpu/ops/fused_mlp.py:1581"),
    ("composite_fwd", "hpslam_tpu_torch/csrc/composite.cu",
     "hpslam_tpu/ops/fused_mlp.py:379"),
    ("composite_bwd", "hpslam_tpu_torch/csrc/composite.cu",
     "hpslam_tpu/ops/fused_mlp.py:418"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default=None,
                    help="directory for the full logs (default: none)")
    ap.add_argument("--profile", action="store_true",
                    help="repeat each SLAM run under torch.profiler and "
                         "report where the device time goes")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "hpslam_tpu_torch")):
        print("chip_smoke: the hpslam_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hpslam_tpu_torch.device import resolve_device
    resolve_device("cuda")          # TF32 off, as the port runs
    out_dir = args.out or tempfile.mkdtemp(prefix="hpslam_smoke_logs_")
    os.makedirs(out_dir, exist_ok=True)
    seconds: dict = {}
    results: dict = {}
    t_all = time.perf_counter()
    smi = nvidia_smi()
    if "device" in phases:
        with phase("device", seconds):
            emit({"nvidia_smi": smi,
                  "torch_device": torch.cuda.get_device_name(0),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "python": sys.version.split()[0]})
    if "build" in phases:
        with phase("build", seconds):
            emit(run_build(out_dir))
    if "topk" in phases:
        with phase("topk", seconds):
            emit(run_topk(results))
    if "maploss" in phases:
        with phase("maploss", seconds):
            emit(run_maploss(results))
    if "trunks" in phases:
        with phase("trunks", seconds):
            emit(run_trunks(results))
    if "trackloss" in phases:
        with phase("trackloss", seconds):
            emit(run_trackloss(results))
    if "composite" in phases:
        with phase("composite", seconds):
            emit(run_composite(results))
    # each kernel's launches come from the first run that launches it
    launches = {}
    first_runs = {}
    for name in ("slam", "slam_fused", "slam_mesh"):
        if name in phases:
            with phase(name, seconds):
                s, traj = run_slam(out_dir, name, args.profile)
                first_runs[name] = (s, traj)
                for k, v in s["launches"].items():
                    if not launches.get(k):
                        launches[k] = v
                emit(s)
    if "repeat" in phases:
        with phase("repeat", seconds):
            emit({"repeat": run_repeat(out_dir, first_runs)})
    if "kernels" in phases:
        with phase("kernels", seconds):
            rows = []
            for name, src, rep in KERNELS:
                r = results.get(name, {})
                rows.append({"name": name, "route": "cuda", "source": src,
                             "replaces": rep,
                             "launches": int(launches.get(name, 0)),
                             "max_abs_err": r.get("max_abs_err"),
                             "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                             "wrapper_ms": r.get("wrapper_ms"),
                             "bound_ms": r.get("bound_ms"),
                             "bound_by": r.get("bound_by"),
                             "tc_bound_ms": r.get("tc_bound_ms"),
                             "library_ms": r.get("library_ms")})
    seconds["total"] = time.perf_counter() - t_all
    emit({"phase_seconds": seconds})
    with open(os.path.join(out_dir, "smoke_results.json"), "w") as f:
        json.dump({"seconds": seconds, "results": results,
                   "launches": launches}, f, indent=1, default=str)
    if not args.out:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(smi, flush=True)
    if "kernels" in phases:
        emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
