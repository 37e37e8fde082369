#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (hpslam_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases device,build,topk,maploss
    python3 chip_smoke.py --phases device,build,trunks,trackloss
    python3 chip_smoke.py --phases device,build,band      # ATE band, ~7 min
    python3 chip_smoke.py --phases device,build,orbit --scenario synth_tpu \
        --route fused plain --seeds 0 1 2   # orbit_compare.py's port side
    python3 chip_smoke.py --phases device,build,quality   # repro_quality.sh
                                                          # at seeds 0-2

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
           affine, exp weighting, a ragged 2001 rays, and bf16 features
           (model.mm_bf16; the same bf16 rows for both, the f32
           tolerances); #8-9 twice, bitwise; kernel / plain times, #8's
           and #9's device time per pass (under torch.profiler) on f32 and
           on bf16 features, blocks per SM of the tile passes and the peak
           device memory of one #8 launch
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
           times and every kernel's launches during the run; the run's
           metrics.jsonl must carry the loss curves (loss_curve with each
           track record, geo_loss_curve and color_loss_curve with each map
           record) and its eval_ate_aligned.png must decode with both
           trajectories drawn, as for every SLAM run below (with
           --profile each SLAM run is repeated under torch.profiler, whose
           kernels must include, and exclude, those of PROFILE_KERNELS)
  slam_fused  the same run with tracking.fused_loss on and
           model.fused_composite off: the fused tracker render and union
           mapping on the fused trunks
  slam_mesh  the same run with mesh: "dp1" inside a world-1 NCCL process
           group that the smoke opens and closes: the dp-mesh tracker and
           union mapping through the fused composite (kernels #6, #5)
  slam_tum  configs/TUM_RGBD/freiburg1_desk.yaml on a TUM RGB-D tree the
           smoke writes (8 frames of the synthetic room rendered at the
           config's 480x640 intrinsics, PNG through the port's writer with
           libpng's adaptive row filters), distortion zeroed and iterations
           cut (TUM_CUTS); first the decoded first frame against the
           rendered one, and the reader's and the PNG decode's times; the
           per-sample mapper with rel-pos colour: #1 and none of the fused
           kernels
  slam_ba  the slam run with mapping.BA on and keyframes and mappings
           every 2nd frame, so that the last mapping bundle-adjusts: the
           per-sample mapper in tracker mode on the fused trunks (#4-5)
  slam_bf16  the slam run with model.mm_bf16 and tracking.fused_loss:
           the tracker's bf16 feature table into #8-9 (their bf16
           launches counted apart), union mapping on #3
  slam_geo the slam run with fix_geo_decoder_mid / _fine off: the union
           mapping path trains both geometry decoders on the plain trunks
           (no decoder kernel); both decoders must have changed
  slam_scannet  configs/ScanNet/scene0059.yaml on a ScanNet tree the smoke
           writes (8 frames of the synthetic room at the config's 480x640
           intrinsics, 2.9 cm apart, colour as baseline JPEG through the
           port's encoder),
           iterations cut (SCANNET_CUTS): tools/preflight.py first (exit
           0), the decoded first frame, the reader's ms per frame and the
           JPEG decode's ms per file; the plain tracker, union mapping with
           exposure on #3, end correction (its event printed); the
           per-iteration costs tools/preflight.py's estimate scales
  scannet_scale  the benchmark workload (hpslam_tpu_torch/bench.py) at
           bench.py's full sizes: 300,000 fine and 60,000 mid points in
           capacities of 2^19 and 2^17, 460x620, one tracked frame (100
           iterations x 5000 pixels) and one mapped frame (301 + 299
           iterations x 10,000 rays over a 20-frame window): per-stage
           times (each stage ended by a synchronisation), peak memory,
           launches (#1 and #3 only), #1 bitwise on rows the run produced
           (a 4096 x 1024 tile-selection chunk, the 40,000 x 40 union
           ranking) with its times beside torch.topk's, #3 against its
           plain version on the run's own packed rows, the deterministic
           scatter beside index_add_, recall@8 of the narrowed tile search
           within SCALE_RECALL_LOSS_MAX of the exact selection's, finite
           losses, the rows outside the compacted sets unchanged, the
           tracked frame repeated bitwise (with --profile: the two frames
           again under torch.profiler)
  slam_vis the slam run with tracking and mapping panels at frame 5
           (vis_freq 5), the fine level's rendered image and a checkpoint
           at frame 5: the panels and the image decoded to their shapes,
           the fine level's depth residual (under 0.05 m) and colour PSNR,
           render_img's ms per 120x160 image and level; the trajectory and
           ATE must be slam's bit for bit; #4 launched (the renders are
           its only callers on this config), #5 not
  resume   slam_vis's frame-5 checkpoint copied to a fresh output and
           resumed to frame 9 through the CLI: keyframes carried over,
           points no fewer, poses 0-5 equal, 6-9 filled, ATE under the
           limit; whether the trajectory equals slam_vis's bit for bit
  mesh     the meshing CLI on slam_vis's final checkpoint (every 5th
           frame rendered, voxel 5/512 m), the synthetic room's GT mesh
           culled by the run's poses, accuracy / completion / F-score
           (accuracy under 5 cm); the render's and the fusion's seconds
  telemetry  slam_vis's plots/summary.png (the run summary that every run
           ends with) decodes at its canvas size with line pixels in all
           four panels
  points   renderer.eval_points (the mesher's query) on slam_vis's final
           checkpoint at 200,000 points of the room's box (a grid of
           POINTS_GRID cells, each point jittered in its cell from a
           seed), both levels: through each level's tile index (#1,
           launches counted, nothing else launched; #1 bitwise against its
           plain version on the rows it was given there, with its times),
           then through knn_auto (at these capacities the approximate
           segment-min search, m=8); ops.knn.find_neighbors (the exact
           search) at the query radius, its counts neighbor_counts'; per
           level every point that the tile route or the exact search finds
           neighbours for has the exact search's neighbours within the
           radius through the tile index, the tile route's mask is the
           exact one, and where the segment-min route also has them the
           masks are equal and occupancy and colour within LOSS_RTOL; each
           route's ms
  lockstep frame 6 tracked, then mapped (LOCKSTEP_MAP_ITERS iterations at
           the CPU's tracked pose), from slam_vis's frame-5 checkpoint on
           the CPU and then on the card in this process, on the same draws
           (a CPU generator, the ids moved to the card), each of the card's
           Adam steps taken from the CPU's parameters and moments of that
           iteration and its union caches the CPU's, their differing pixels
           counted (tests/test_torch_lockstep.py holds the CPU against
           hpslam_tpu the same way): the card's own step of the pose at
           every iteration within LOCKSTEP_STEP_ATOL of the CPU's, both
           loss curves within LOCKSTEP_LOSS_RTOL (TF32 off), the mapping
           gradient leaf by leaf within LOCKSTEP_GEO_GRAD_MAX /
           LOCKSTEP_GRAD_LEAF_MAX of the CPU's and the card's own mapping
           steps within LOCKSTEP_OWN_RTOL / _ATOL (run_lockstep), #1 and #3
           launched; both poses, the curves and the largest differences
           printed
  loop     configs/Synthetic/synth_loop.yaml, all 60 frames, iterations
           cut (LOOP_CUTS): the end correction is applied and lowers the
           ATE of the same trajectory (its last checkpoint) evaluated
           before it
  repeat   the deterministic scatter-add (ops.interpolate.index_add_rows)
           three times on the same inputs, bitwise; then every SLAM run of
           this process again, whose trajectory and ATE must equal the
           first run's bitwise (slam's second run is slam_vis, the same
           config and seed with panels, so slam does not run a third time)
  kernels  one JSON line describing every ported kernel, with its bound
           at the f32 rate (bound_ms) and with the operations on the
           tensor cores at f32 accuracy (tc_bound_ms, 3xTF32), and #8's and
           #9's time on bf16 features (bf16_ms)
  band     (only when named in --phases) synth_tpu.yaml and
           synth_noisy.yaml (--band-configs) for all 30 frames at seeds
           0-4 (BAND_SEEDS, or --seeds) on the slam and slam_fused paths:
           each ATE beside the reference's band
  orbit    (only when named in --phases) the port's side of
           orbit_compare.py's comparison on the card: the configs that
           orbit_compare.write_config writes for each --scenario
           (synth_tpu: 15 frames; synth_quality: 120) on each --route
           (fused, plain) at --seeds (ORBIT_SEEDS), each run through the
           CLI as the slam run is, each route's kernels asserted launched
           and not (ORBIT_KERNELS); one record a run (impl port, device
           cuda, scenario, route, seed, ATE, seconds, launches), printed
           and appended to <--out>/orbit/runs.jsonl, both of which
           orbit_compare.py --summary reads
  quality  (only when named in --phases) repro_quality.sh on the port
           at seeds 0, 1, 2 (QUALITY_SEEDS, or --seeds): the 120 frames
           of synth_quality.yaml, its mesh at voxel 5/512 m against the
           culled GT box (accuracy, completion, F-score), then
           synth_loop.yaml uncut with its ATE before and after the end
           correction; beside the reference's numbers (TPU history, one
           seed)

The last line is {"ok": true, "device": {...}}, printed only when every
phase passed; any failure exits non-zero.  Without CUDA, or without the
hpslam_tpu_torch package beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
          "composite", "slam", "slam_fused", "slam_mesh", "slam_tum",
          "slam_ba", "slam_bf16", "slam_geo", "slam_scannet",
          "scannet_scale", "slam_vis", "resume", "mesh", "telemetry",
          "points", "lockstep", "loop", "repeat", "kernels"]
SLAM_PHASES = ["slam", "slam_fused", "slam_mesh", "slam_tum", "slam_ba",
               "slam_bf16", "slam_geo", "slam_scannet"]

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
    """Every kernel source (one nvcc each, all at once) and, beside them,
    the native C++ runtime that end correction and meshing use and the
    port's JPEG codec."""
    import threading

    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch import native
    d = _cuda.build_dir()
    lock = os.path.join(d, "lock")
    if os.path.exists(lock):
        os.remove(lock)
    nat: dict = {}

    def build_native():
        t0 = time.perf_counter()
        try:
            nat["library"] = os.path.basename(native.build())
            nat["jpeg_library"] = os.path.basename(native.build(
                native.JPEG_SOURCE, "hpjpeg"))
        except BaseException as e:      # re-raised below
            nat["error"] = e
        nat["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=build_native)
    th.start()
    logs = _cuda.build_all(extra=("-Xptxas", "-v"))
    th.join()
    if "error" in nat:
        raise nat["error"]
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    kernels = {k: v for log in logs.values()
               for k, v in ptxas_kernels(log).items()}
    for name in logs:
        _cuda.lib(name)
    return {"built": sorted(logs), "native": nat,
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


def topk_case(name, x, p, k, flush, blocks_per_sm=None) -> dict:
    """Kernel #1 on one case against topk_rows_plain, bitwise, and its
    times per launch: the kernel's device time (torch.profiler) with the
    L2 cache flushed between launches (each row read from device memory,
    as the path reads a freshly written d2) and warm (back to back: the
    rows partly in L2); the wrapper's time (host work included, back to
    back between events); the plain version's and torch.topk's.  The
    bound's share is taken of the flushed device time."""
    import torch
    from hpslam_tpu_torch.ops import knn as K
    d1, v1 = K.topk_rows(x, p, k)          # the wrapper: CUDA kernel
    d0, v0 = K.topk_rows_plain(x, p, k)
    torch.cuda.synchronize()
    if not (torch.equal(d0, d1) and torch.equal(v0, v1)):
        bad = int((d0 != d1).sum() + (v0 != v1).sum())
        raise AssertionError(f"topk {name}: {bad} elements differ")

    def call():
        return K.topk_rows(x, p, k)

    def device_ms(**kw):
        return sum(device_ms_per_launch(call, ("topk",), f"topk {name}",
                                        **kw).values())
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
    return {"case": name, "shape": [n, C], "k": k, "ms": cold,
            "device_ms_warm": warm, "wrapper_ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": b, "bound_by": by,
            "tc_bound_ms": tc, "bound_share": b / cold,
            "blocks_per_sm": (blocks_per_sm(C, k) if blocks_per_sm
                              else None),
            "max_abs_err": float((d0 - d1).abs().max())}


def run_topk(results: dict) -> dict:
    """Kernel #1 at each case of topk_cases (topk_case)."""
    import torch
    from hpslam_tpu_torch import _cuda
    dev = torch.device("cuda")
    # absent from trees older than the one-pass kernel (parent runs)
    blocks_per_sm = getattr(_cuda.lib("topk_rows"), "hp_topk_blocks_per_sm",
                            None)
    flush = torch.empty((2 * L2_BYTES // 4,), device=dev)
    rows = [topk_case(name, x, p, k, flush, blocks_per_sm)
            for name, x, p, k in topk_cases(torch, dev)]
    worst = max(r.pop("max_abs_err") for r in rows)
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


def maploss_scratch_bytes(lib, a, backward, need_wgrads):
    """Bytes of scratch one launch of kernel #2 or #3 asks for on the
    arguments ``a`` (maploss_case), or None in a tree whose scratch size
    does not depend on the kernel (before the forward moved onto the
    tiles)."""
    fn = lib.hp_maploss_scratch_floats
    if len(fn.argtypes) != 10:
        return None
    row, geo, col, Bs = a[3], a[5], a[2], a[6]
    n_blocks, with_color, S, C = a[7], a[9], a[10], a[12]
    return 4 * fn(row.shape[0], S, C, geo[0].shape[1], 2 * Bs[1].shape[1],
                  col[0].shape[1], n_blocks, int(with_color), int(backward),
                  int(need_wgrads))


def maploss_case(a: tuple, need_wg: bool, mcfg, what: str = "maploss"):
    """Kernel #3 through nicer_fused_maploss under autograd, twice (the two
    must agree bit for bit), against maploss_plain differentiated by
    autograd, on the arguments ``a`` = (uf, aff, col_core, row, okf,
    geo_core, Bs, n_blocks, skip, with_color, S, u, C, coef, sigmoid_rgb,
    use_affine, w_color): the losses to LOSS_RTOL, every cotangent by
    compare_grads.  Reported: the wrapper's time, the plain version's, the
    bounds, the device memory and scratch of one bare launch and a digest
    of its outputs (gl, cl, duf, daff, dcol: copy this smoke into another
    tree and run it there to compare bit for bit).  Returns (that report,
    the plain version's losses)."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.ops import fused_mlp as FM
    uf, aff, col, row, okf, geo, Bs = a[:7]
    with_color, S, u = a[9:12]
    use_aff, w_color = a[15:17]

    def leaves():
        return ([uf.clone().requires_grad_(), aff.clone().requires_grad_()]
                + [w.clone().requires_grad_() for w in col])

    def kernel(ts):
        return FM.nicer_fused_maploss(ts[0], ts[1], ts[2:], row, okf, geo,
                                      Bs, *a[7:], need_wgrads=need_wg)

    def plain(ts):
        return FM.maploss_plain(ts[0], ts[1], ts[2:], row, okf, geo, Bs,
                                *a[7:16])

    def grads_of(fn):
        ts = leaves()
        gl, cl = fn(ts)
        (gl + w_color * cl if with_color else gl).backward()
        return [gl.detach(), cl.detach()] + [
            t.grad if t.grad is not None else torch.zeros_like(t)
            for t in ts]
    k1, k2, p = grads_of(kernel), grads_of(kernel), grads_of(plain)
    torch.cuda.synchronize()
    n = row.shape[0]
    if not all(torch.equal(x, y) for x, y in zip(k1, k2)):
        raise AssertionError(f"{what}: kernel 3 does not repeat bitwise "
                             f"(n={n})")
    if not need_wg and any(t.any() for t in k1[4:]):
        raise AssertionError(f"{what}: colour-core gradients without "
                             "need_wgrads")
    worst = 0.0
    for name, x, y in (("gl", k1[0], p[0]), ("cl", k1[1], p[1])):
        rel = float((x - y).abs() / max(float(y.abs()), 1e-12))
        if rel > LOSS_RTOL:
            raise AssertionError(f"{what} {name}: rel err {rel:.3g}")
        worst = max(worst, float((x - y).abs()))
    fro = {}
    names = ["duf", "daff"] + [f"dcol{i}" for i in range(len(col))]
    for name, x, y in zip(names, k1[2:], p[2:]):
        if name == "daff" and not use_aff:
            continue
        if name.startswith("dcol") and not (with_color and need_wg):
            continue
        mx, fro[name] = compare_grads(name, x, y, what)
        worst = max(worst, mx)
    worst_grad = max(fro, key=fro.get)
    ts = leaves()
    ms = cuda_time_ms(lambda: kernel(ts), iters=10)
    plain_ms = cuda_time_ms(lambda: grads_of(plain), iters=5)
    numel = [sum(t.numel() for t in ws) + Bw.numel()
             for ws, Bw in ((geo, Bs[0]), (col, Bs[1]))]
    b, by, tc = bound_ms(*maploss_work(mcfg, n, S, u, with_color, True,
                                       *numel, need_wgrads=need_wg))

    def bare():
        return FM.launch_maploss(*a, backward=True, need_wgrads=need_wg)
    out = bare()
    return {"n": n, "with_color": with_color, "affine": use_aff,
            "need_wgrads": need_wg, "max_abs_err": worst,
            "bitwise_repeat": True, "grad_rel_fro_max": fro[worst_grad],
            "worst": worst_grad, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "tc_bound_ms": tc,
            "bound_share": b / ms,
            "scratch_bytes": maploss_scratch_bytes(
                _cuda.lib("maploss"), a, True, need_wg),
            "memory": launch_memory(bare),
            "sha256": digest(*out[:4], *out[4])}, (p[0], p[1])


def run_maploss(results: dict) -> dict:
    """Kernel #3 (maploss_case) and kernel #2 through nicer_fused_maploss
    without a gradient against maploss_plain's losses at eight cases; #2's
    two launches on the same inputs must agree bit for bit.  Reported per
    case beside maploss_case's report: #2's wrapper time beside the plain
    version's and the bounds; its device time per call from the profiler
    (L2 flushed between calls, and warm), split by pass; the device memory
    of one bare launch (allocator peak less what was allocated before) and
    the scratch it asks for."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.ops import fused_mlp as FM
    dev = torch.device("cuda")
    lib = _cuda.lib("maploss")
    flush = torch.empty((2 * L2_BYTES // 4,), device=dev)
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
        k = I["kw"]
        a = (I["uf"], I["aff"], I["col"], I["row"], I["okf"], I["geo"],
             I["Bs"], k["n_blocks"], k["skip"], with_color, k["S"], k["u"],
             k["C"], k["coef"], not use_aff, use_aff, w_color)
        bwd, (gp, cp) = maploss_case(a, need_wg, I["mcfg"])
        worst_bwd = max(worst_bwd, bwd["max_abs_err"])

        def kernel_fwd():
            with torch.no_grad():               # kernel 2 through the wrapper
                return FM.nicer_fused_maploss(*a)
        g2, c2 = kernel_fwd()
        g2b, c2b = kernel_fwd()
        torch.cuda.synchronize()
        if not (torch.equal(g2, g2b) and torch.equal(c2, c2b)):
            raise AssertionError(f"maploss: kernel 2 does not repeat "
                                 f"bitwise (n={n_rays})")
        for name, x, y in (("gl_fwd", g2, gp), ("cl_fwd", c2, cp)):
            rel = float((x - y).abs() / max(float(y.abs()), 1e-12))
            if rel > LOSS_RTOL:
                raise AssertionError(f"maploss {name}: rel err {rel:.3g}")
            worst_fwd = max(worst_fwd, float((x - y).abs()))
        n, S, u = I["row"].shape[0], k["S"], k["u"]
        t2 = cuda_time_ms(kernel_fwd, iters=10)
        passes = ("ml_", "loss_reduce")
        pass2 = device_ms_per_launch(kernel_fwd, passes, f"maploss #2 n={n}",
                                     flush=flush)
        pass2_warm = device_ms_per_launch(kernel_fwd, passes,
                                          f"maploss #2 n={n}")

        def plain_fwd():
            with torch.no_grad():
                return FM.maploss_plain(*a[:16])
        tp2 = cuda_time_ms(plain_fwd, iters=5)
        numel = [sum(t.numel() for t in I[key]) + I["Bs"][i].numel()
                 for i, key in enumerate(("geo", "col"))]
        b2 = bound_ms(*maploss_work(I["mcfg"], n, S, u, with_color, False,
                                    *numel))
        cases.append({"with_color": with_color, "affine": use_aff, "n": n,
                      "need_wgrads": need_wg,
                      "fwd_device_ms": sum(pass2.values()),
                      "fwd_device_ms_warm": sum(pass2_warm.values()),
                      "fwd_pass_ms": pass2, "fwd_wrapper_ms": t2,
                      "fwd_plain_ms": tp2, "fwd_bound_ms": b2[0],
                      "fwd_tc_bound_ms": b2[2],
                      "fwd_memory": launch_memory(lambda: FM.launch_maploss(
                          *a, backward=False, need_wgrads=False)),
                      "fwd_scratch_bytes": maploss_scratch_bytes(
                          lib, a, False, False),
                      "bwd_memory": bwd["memory"],
                      "bwd_scratch_bytes": bwd["scratch_bytes"],
                      "bwd_sha256": bwd["sha256"],
                      "bwd_ms": bwd["ms"], "bwd_plain_ms": bwd["plain_ms"],
                      "bwd_bound_ms": bwd["bound_ms"],
                      "bwd_tc_bound_ms": bwd["tc_bound_ms"],
                      "bound_by": bwd["bound_by"], "bitwise_repeat": True,
                      "grad_rel_fro_max": bwd["grad_rel_fro_max"],
                      "worst": bwd["worst"]})
        if n == 4000 and with_color and not use_aff and need_wg:
            timing = {"fwd": (t2, tp2, b2), "bwd": bwd,
                      "fwd_device": cases[-1]}
    fwd_case, bwd = timing["fwd_device"], timing["bwd"]
    results["maploss_fwd"] = {
        "max_abs_err": worst_fwd, "ms": fwd_case["fwd_device_ms"],
        "device_ms_warm": fwd_case["fwd_device_ms_warm"],
        "pass_ms": fwd_case["fwd_pass_ms"], "wrapper_ms": timing["fwd"][0],
        "plain_ms": timing["fwd"][1], "bound_ms": timing["fwd"][2][0],
        "bound_by": timing["fwd"][2][1],
        "tc_bound_ms": timing["fwd"][2][2], "library_ms": None}
    results["maploss_bwd"] = {
        "max_abs_err": worst_bwd, "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "tc_bound_ms": bwd["tc_bound_ms"],
        "library_ms": None}
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
            # "void tl_fwd_tiles<float>(...)" -> "tl_fwd_tiles<float>"
            name = ev.key.split("(")[0].removeprefix("void ")
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + us / 1e3, n + ev.count)
    return out


def device_ms_per_launch(fn, keys, what: str, flush=None) -> dict:
    """{kernel: device ms per launch} of the kernels that ``fn`` launches
    whose names contain one of ``keys`` (kernel_launches over 20 calls):
    each kernel's mean over the launches the profiler recorded.  It drops
    some events of such short sessions, at times all of them; where three
    profiles record fewer than half, the 20 calls are timed between CUDA
    events instead, each call alone (after the flush, if any), under the
    one key "<what> (CUDA events)", and a line says so."""
    import torch
    for _ in range(3):
        got = {k: v for k, v in kernel_launches(fn, iters=20,
                                                flush=flush).items()
               if any(key in k for key in keys)}
        n_rec = min((n for _ms, n in got.values()), default=0)
        if n_rec >= 10:
            return {k: ms / n for k, (ms, n) in got.items()}
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(20)]
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sum(start.elapsed_time(end) for start, end in events) / 20
    emit({"profiler_fallback": what, "recorded": n_rec, "event_ms": ms})
    return {f"{what} (CUDA events)": ms}


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
    weights, the exposure affine, exp weighting, a ragged 2001 rays
    (10005 samples, not a multiple of #9's 64-sample tile), and the SLAM
    run's case on bfloat16 features (model.mm_bf16: the same bf16 rows for
    the kernel and the plain version, which upcast each element exactly,
    so the f32 tolerances hold).  Two runs of the wrapper must agree bit
    for bit.  The bare launcher is timed, #8's and #9's device time split
    by pass (the f32 and the bf16 variant of the SLAM run's case, in this
    call), the occupancy calculator's blocks per SM of the tile passes and
    the device memory of one #8 launch reported."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.ops import fused_mlp as FM
    dev = torch.device("cuda")
    inputs = {n: trackloss_inputs(torch, dev, n=n) for n in (2000, 2001)}
    cases = []
    worst = {"fwd": 0.0, "bwd": 0.0}
    main = bf16_case = None
    for use_aff, wmode, n, bf16 in ((False, 0, 2000, False),
                                    (True, 0, 2000, False),
                                    (False, 1, 2000, False),
                                    (False, 0, 2001, False),
                                    (False, 0, 2000, True)):
        I = inputs[n]
        if bf16:
            I = dict(I, cfeat=I["cfeat"].to(torch.bfloat16))
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
        case = {"affine": use_aff, "wmode": wmode, "n": n,
                "cfeat": "bfloat16" if bf16 else "float32", "fwd_ms": t_f,
                "fwd_plain_ms": tp_f, "fwd_bound_ms": b_f[0], "bwd_ms": t_b,
                "bwd_plain_ms": tp_b, "bwd_bound_ms": b_b[0],
                "bound_by": b_b[1], "bitwise_repeat": True,
                "drays_vs_float64": stats.pop("drays_f64"),
                "rel_fro_max": max(stats.values())}
        if main is None or bf16:
            case["fwd_pass_ms"] = {
                k_: v for k_, v in kernel_ms(kernel8).items()
                if k_.startswith("tl_")}
            case["bwd_pass_ms"] = {
                k_: v for k_, v in kernel_ms(kernel9).items()
                if k_.startswith("tl_")}
            case["fwd_device_ms"] = sum(case["fwd_pass_ms"].values())
            case["bwd_device_ms"] = sum(case["bwd_pass_ms"].values())
        if main is None:
            case["fwd_memory"] = launch_memory(kernel8)
            main = (case, b_f, b_b)
        if bf16:
            bf16_case = case
        cases.append(case)
    case, b_f, b_b = main
    passes = case["bwd_pass_ms"]
    results["trackloss_fwd"] = {
        "max_abs_err": worst["fwd"], "ms": case["fwd_ms"],
        "plain_ms": case["fwd_plain_ms"], "bound_ms": b_f[0],
        "bound_by": b_f[1], "tc_bound_ms": b_f[2],
        "library_ms": None, "pass_ms": case["fwd_pass_ms"],
        "bf16_ms": bf16_case["fwd_ms"],
        "device_ms": case["fwd_device_ms"],
        "bf16_device_ms": bf16_case["fwd_device_ms"]}
    results["trackloss_bwd"] = {
        "max_abs_err": worst["bwd"], "ms": case["bwd_ms"],
        "plain_ms": case["bwd_plain_ms"], "bound_ms": b_b[0],
        "bound_by": b_b[1], "tc_bound_ms": b_b[2],
        "library_ms": None, "pass_ms": passes,
        "bf16_ms": bf16_case["bwd_ms"],
        "device_ms": case["bwd_device_ms"],
        "bf16_device_ms": bf16_case["bwd_device_ms"],
        "without_recompute_ms": sum(
            v for k_, v in passes.items()
            if k_.startswith(("tl_bwd_tiles", "tl_drays")))}
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
                   ("tl_fwd_samples", "tl_fwd_tiles<__nv_bfloat16")),
    # #8-9's bf16-feature variant on the tracker, #3 on the mapper
    "slam_bf16": (("tl_fwd_tiles<__nv_bfloat16", "tl_bwd_tiles<__nv_bfloat16",
                   "ml_bwd_tiles"),
                  ("tl_fwd_tiles<float", "tr_fwd_tiles", "tr_bwd_tiles",
                   "cp_fwd_tiles")),
    # trained geometry decoders: the plain trunks, no decoder kernel
    "slam_geo": (("topk_rows_lists",),
                 ("ml_fwd_tiles", "ml_bwd_tiles", "tr_fwd_tiles",
                  "tr_bwd_tiles", "tl_fwd_tiles", "tl_bwd_tiles",
                  "cp_fwd_tiles", "cp_bwd_tiles")),
    "slam_scannet": (("topk_rows_lists", "ml_bwd_tiles"),
                     ("tl_fwd_tiles", "tl_bwd_tiles", "cp_fwd_tiles",
                      "cp_bwd_tiles", "tr_bwd_tiles")),
    "scannet_scale": (("topk_rows_lists", "ml_bwd_tiles"),
                      ("tl_fwd_tiles", "tl_bwd_tiles", "cp_fwd_tiles",
                       "cp_bwd_tiles", "tr_fwd_tiles", "tr_bwd_tiles")),
    "slam_mesh": (("cp_fwd_tiles", "cp_rays"), ("cp_samples",)),
    "slam_tum": (("topk_rows_lists",),
                 ("ml_fwd_tiles", "ml_bwd_tiles", "tr_fwd_tiles",
                  "tr_bwd_tiles", "tl_fwd_tiles", "tl_bwd_tiles",
                  "cp_fwd_tiles", "cp_bwd_tiles")),
    "slam_ba": (("tr_fwd_tiles", "tr_bwd_tiles", "ml_bwd_tiles"),
                ("tl_fwd_tiles", "tl_bwd_tiles", "cp_fwd_tiles",
                 "cp_bwd_tiles")),
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


def merged(*parts: dict) -> dict:
    """The config additions ``parts`` deep-merged, later ones winning."""
    out: dict = {}
    for part in parts:
        for k, v in part.items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = merged(out[k], v)
            else:
                out[k] = v
    return out


SYNTH_CFG = "configs/Synthetic/synth_tpu.yaml"
# the synthetic runs: synth_tpu.yaml cut to 10 frames (its vis_freq of 50
# and no_vis_on_first_frame fire no panel in them)
SYNTH_CUTS = {"synthetic": {"n_frames": 10}}
# slam_vis: panels of frame 5 (tracking and mapping, both levels), the
# fine level's rendered image, a checkpoint at frame 5 for resume
VIS_FRAME = 5
VIS = {"tracking": {"vis_freq": VIS_FRAME},
       "mapping": {"vis_freq": VIS_FRAME, "save_rendered_image": True,
                   "ckpt_freq": VIS_FRAME}}
VIS_DEPTH_L1_MAX_M = 0.05
MESH_ACC_MAX_CM = 5.0
MESH_VOXEL = 5.0 / 512
LOOP_CFG = "configs/Synthetic/synth_loop.yaml"
# loop: all 60 frames (the orbit must close), iterations cut for time
LOOP_CUTS = {"tracking.iters": "60 -> 20", "mapping.iters": "150 -> 40",
             "mapping.iters_first": "200 -> 80",
             "mapping.geo_iter_first": "80 -> 30"}
LOOP_ADDITIONS = {"tracking": {"iters": 20},
                  "mapping": {"iters": 40, "iters_first": 80,
                              "geo_iter_first": 30}}
QUALITY_CFG = "configs/Synthetic/synth_quality.yaml"
# the reference's numbers (TPU history, QUALITY.md), beside the quality
# phase's
QUALITY_REFERENCE = {"synth_quality": {"ate_cm": 1.35, "accuracy_cm": 0.96,
                                       "completion_cm": 1.43,
                                       "fscore": 0.458},
                     "synth_loop": {"ate_cm_end_correction_on": 21.75,
                                    "ate_cm_end_correction_off": 39.52}}
QUALITY_SEEDS = (0, 1, 2)
FUSED = {"tracking": {"fused_loss": True},
         "model": {"fused_composite": False}}
# slam_bf16: model.mm_bf16 (the tracker's bf16 feature table into #8-9)
BF16 = {"model": {"mm_bf16": True}, "tracking": {"fused_loss": True}}
# slam_geo: both geometry decoders trained on the union mapping path, on
# the plain trunks (about twice slam's map time per frame); uncut: with
# tracking cut to 30 iterations and mapping to 50 / 80 first / 30
# geometry first its ATE rose to 5.87 cm (PERF.md §6)
GEO = {"mapping": {"fix_geo_decoder_mid": False,
                   "fix_geo_decoder_fine": False}}
SCANNET_CFG = "configs/ScanNet/scene0059.yaml"
SCANNET_FRAMES = 8
# the tree's frames are the first 8 of a quarter orbit over 64 (2.9 cm and
# 0.84 degrees a frame, the scale of ScanNet's 30 Hz handheld motion):
# scene0059.yaml tracks with lr 0.0005, which over 30 iterations moves a
# pose coordinate at most ~1.5 cm, and slam_tum's orbit (23 cm a frame)
# leaves the constant-speed prediction ~4.6 cm off a frame
SCANNET_ORBIT = 64
# slam_scannet keeps scene0059.yaml's model width, 480x640 images (crop
# edge 10), pixel budgets (tracking 5000, mapping 10000), window (20),
# exposure and end correction; what it cuts, each listed in its JSON line
SCANNET_CUTS = {
    "frames": f"{SCANNET_FRAMES} (synthetic room rendered at the config's "
              f"intrinsics, 1/{SCANNET_ORBIT} of a quarter orbit apart, "
              "colour as baseline JPEG)",
    "tracking.iters": "100 -> 30",
    "mapping.iters": "600 -> 60",
    "mapping.iters_first": "500 -> 150",
    "mapping.geo_iter_first": "200 -> 40",
}
SCANNET_ADDITIONS = {"tracking": {"iters": 30},
                     "mapping": {"iters": 60, "iters_first": 150,
                                 "geo_iter_first": 40}}
TUM_CFG = "configs/TUM_RGBD/freiburg1_desk.yaml"
TUM_FRAMES = 8
# slam_tum keeps freiburg1_desk.yaml's model width, 480x640 images (crop
# edge 8), pixel budgets (tracking 5000, mapping 5000), window (10) and
# rel-pos colour; what it cuts, each listed in its JSON line
TUM_CUTS = {
    "frames": f"{TUM_FRAMES} (synthetic room rendered at the config's "
              "intrinsics)",
    "cam.distortion": "zeros (the reference undistorts colour, not depth)",
    "tracking.iters": "200 -> 30",
    "mapping.iters_first": "1500 -> 150",
    "mapping.geo_iter_first": "400 -> 40",
    "mapping.iters": "300 -> 60",
}
TUM_ADDITIONS = {
    "cam": {"distortion": [0.0] * 5}, "tracking": {"iters": 30},
    "mapping": {"iters_first": 150, "geo_iter_first": 40, "iters": 60}}
# the fused kernels that the per-sample paths must not reach
_MAPLOSS = ("maploss_fwd", "maploss_bwd")
_TRACKLOSS = ("trackloss_fwd", "trackloss_bwd")
# #8-9's launches on bf16 features (counted again under these names)
_TRACKLOSS_BF16 = ("trackloss_fwd_bf16", "trackloss_bwd_bf16")
_COMPOSITE = ("composite_fwd", "composite_bwd")
_TRUNKS = ("trunks_fwd", "trunks_bwd")

# each SLAM run: (base config, config additions, kernels it must launch
# (> 0), kernels it must not launch (== 0))
SLAM_RUNS = {
    # the default path: plain tracker, union mapping on the mapping loss;
    # the reference's mapper evaluates the loss only under a gradient, so
    # kernel 2 (the forward alone) is never launched on this path; it is
    # held against the plain version in the maploss phase
    "slam": (SYNTH_CFG, SYNTH_CUTS, ("topk_rows", "maploss_bwd"), ()),
    # the fused tracker render and union mapping on the fused trunks;
    # no mapping-loss launch proves that the knob routed the mapper
    "slam_fused": (SYNTH_CFG, merged(SYNTH_CUTS, FUSED),
                   ("topk_rows",) + _TRUNKS + _TRACKLOSS,
                   _MAPLOSS + _TRACKLOSS_BF16),
    # the dp-mesh path on one card: the tracker's dp branch (no fused
    # render under a mesh) and union mapping through the fused composite
    # (kernel #6, its backward on kernel #5), never the mapping loss
    "slam_mesh": (SYNTH_CFG, merged(SYNTH_CUTS, {"mesh": "dp1"}),
                  ("topk_rows", "composite_fwd", "trunks_bwd"),
                  _MAPLOSS + _TRACKLOSS + ("trunks_fwd",)),
    # a TUM RGB-D tree through the file reader, the per-sample mapper with
    # rel-pos colour (plain trunks) and the plain tracker: a union mapping
    # would launch the mapping loss, and nothing else reaches the fused
    # kernels on this config
    "slam_tum": (TUM_CFG, TUM_ADDITIONS, ("topk_rows",),
                 _MAPLOSS + _TRUNKS + _TRACKLOSS + _COMPOSITE),
    # BA: keyframes every 2nd frame, mapped every 2nd frame, so that the
    # last mapping (frame 9) has five keyframes and bundle-adjusts; the
    # frames before map on the union path (kernel #3).  Only the BA branch
    # reaches the fused trunks (#4-5, with the position cotangent) on this
    # config: the tracker runs them off, the union mapper takes the mapping
    # loss
    "slam_ba": (SYNTH_CFG, merged(SYNTH_CUTS, {"mapping": {
        "BA": True, "every_frame": 2, "keyframe_every": 2}}),
        ("topk_rows", "maploss_bwd") + _TRUNKS, _TRACKLOSS + _COMPOSITE),
    # the slam run with panels at frame 5: the renders (render_img, no
    # gradient) are the only callers of the fused trunks on this config,
    # so #4 launched and #5 not proves that they went through #4
    "slam_vis": (SYNTH_CFG, merged(SYNTH_CUTS, VIS),
                 ("topk_rows", "maploss_bwd", "trunks_fwd"),
                 ("trunks_bwd",) + _TRACKLOSS + _COMPOSITE),
    # model.mm_bf16: the tracker hands its bf16 feature rows to #8-9 (the
    # fused render), the mapper runs the default union path on #3
    "slam_bf16": (SYNTH_CFG, merged(SYNTH_CUTS, BF16),
                  ("topk_rows", "maploss_bwd") + _TRACKLOSS
                  + _TRACKLOSS_BF16, _TRUNKS + _COMPOSITE),
    # fix_geo_decoder_* off: the union mapping path trains both geometry
    # decoders on the plain trunks (the fused ones freeze the geometry
    # core), so no decoder kernel runs; the tracker is the plain one
    "slam_geo": (SYNTH_CFG, merged(SYNTH_CUTS, GEO), ("topk_rows",),
                 _MAPLOSS + _TRUNKS + _TRACKLOSS + _COMPOSITE),
    # scene0059.yaml on a ScanNet tree (JPEG colour through the port's
    # decoder): the plain tracker, union mapping with exposure on #3, end
    # correction; no render fires in 8 frames (vis_freq 100 / 40)
    "slam_scannet": (SCANNET_CFG, SCANNET_ADDITIONS,
                     ("topk_rows", "maploss_bwd"),
                     _TRACKLOSS + _COMPOSITE + _TRUNKS),
    # synth_loop.yaml's 60 frames with end correction (panels at frame 50)
    "loop": (LOOP_CFG, LOOP_ADDITIONS, ("topk_rows", "maploss_bwd"),
             ("trunks_bwd",) + _TRACKLOSS + _COMPOSITE),
}
# the band: 30-frame runs of two configs on two paths at three seeds
BAND_CONFIGS = {"synth_tpu": SYNTH_CFG,
                "synth_noisy": "configs/Synthetic/synth_noisy.yaml"}
BAND_PATHS = {"slam": {}, "slam_fused": FUSED}
BAND_SEEDS = (0, 1, 2, 3, 4)
# the reference's 30-frame ATE (cm) on the TPU at its seeds (history, the
# band the port is held to; ABLATIONS.md round 5, QUALITY.md)
BAND_REFERENCE_CM = {"synth_tpu": {"seeds": [0, 1, 2],
                                   "ate_cm": [1.29, 1.42, 1.59]},
                     "synth_noisy": {"seeds": [1219, 7, 3],
                                     "ate_cm": [1.92, 2.59, 2.19]}}

# orbit: orbit_compare.py's synthetic scenarios (synth_tpu at 15 frames,
# synth_quality uncut) on its two routes, the port's side on the card
ORBIT_SCENARIOS = ("synth_tpu",)
ORBIT_ROUTES = ("fused", "plain")
ORBIT_SEEDS = (0, 1, 2, 3, 4)
# the kernels each route must launch (> 0) and must not (== 0): the fused
# route is the slam run's path (the plain tracker, union mapping on #3;
# synth_quality's panels at frames 50 and 100 render on #4); the plain
# route runs the decoders' plain trunks, so #1 alone
ORBIT_KERNELS = {
    "fused": (("topk_rows", "maploss_bwd"),
              ("maploss_fwd", "trunks_bwd") + _TRACKLOSS + _COMPOSITE),
    "plain": (("topk_rows",), _MAPLOSS + _TRUNKS + _TRACKLOSS + _COMPOSITE
              + _TRACKLOSS_BF16)}


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


def write_tum_tree(folder: str) -> dict:
    """slam_tum's input: TUM_FRAMES frames of the synthetic room rendered
    at freiburg1_desk.yaml's 480x640 intrinsics, written as a TUM RGB-D
    tree by the port's PNG writer (libpng's adaptive row filters, as real
    TUM files have them).  Returns the rendered frames' first
    colour and depth for the decode check."""
    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch.utils import datasets as D
    cam = dict(C.load_config(os.path.join(HERE, TUM_CFG), os.path.join(
        HERE, "configs", "point_slam.yaml"))["cam"], crop_edge=0)
    cam.pop("distortion")
    syn = D.Synthetic({"dataset": "synthetic", "seed": 1219, "data": {},
                       "synthetic": {"n_frames": TUM_FRAMES, "radius": 1.2},
                       "cam": cam})
    frames = [syn[i] for i in range(TUM_FRAMES)]
    D.write_tum_rgbd(folder, frames, png_depth_scale=cam["png_depth_scale"])
    return {"color": frames[0].color, "depth": frames[0].depth}


def png_row_filters(path: str) -> list:
    """The number of rows of each PNG filter type (0-4) in a
    non-interlaced PNG file."""
    import struct
    import zlib

    import numpy as np
    with open(path, "rb") as fh:
        buf = fh.read()
    off, idat, H = 8, [], 0
    while off + 8 <= len(buf):
        n, kind = struct.unpack_from(">I4s", buf, off)
        if kind == b"IHDR":
            H = struct.unpack_from(">I", buf, off + 12)[0]
        elif kind == b"IDAT":
            idat.append(buf[off + 8:off + 8 + n])
        off += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return np.bincount(raw.reshape(H, -1)[:, 0], minlength=5).tolist()


def check_tum_decode(cfg_path: str, tree: str, first: dict) -> dict:
    """The run's reader (the port's TUM reader on the run's config) gives
    back the rendered first frame up to the PNG quantisation, cut by the
    config's crop edge; with zero distortion the undistortion is the
    identity, bit for bit.  The colour files must hold Average or Paeth
    rows (the decoder's anti-diagonal pass).  Times the reader per frame
    (decode, undistort, crop; mean over the tree), each of frame 0's two
    decodes, and the decode of its depth rewritten with Paeth rows alone
    (what a depth file of libpng's choice can cost)."""
    import numpy as np
    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch.utils import datasets as D
    from hpslam_tpu_torch.utils import image_io as IO
    cfg = C.load_config(cfg_path, os.path.join(HERE, "configs",
                                               "point_slam.yaml"))
    reader = D.get_dataset(cfg, input_folder=tree)
    fr = reader[0]
    e = cfg["cam"]["crop_edge"]
    col = first["color"][e:-e, e:-e]
    dep = first["depth"][e:-e, e:-e]
    raw = IO.read_color(reader.color_paths[0])
    out = {"frames": len(reader), "shape": list(fr.color.shape),
           "color_max_err": float(np.abs(fr.color - col).max()),
           "depth_max_err_m": float(np.abs(fr.depth - dep).max()),
           "undistort_identity": bool(np.array_equal(
               IO.undistort(raw, reader.K, reader.distortion), raw))}
    t0 = time.perf_counter()
    for i in range(len(reader)):
        reader[i]
    out["read_ms_per_frame"] = 1e3 * (time.perf_counter() - t0) / len(reader)
    paeth = os.path.join(tree, "depth_paeth.png")
    IO.write_png(paeth, IO.read_png(reader.depth_paths[0]), "paeth")
    for key, path in (("rgb", reader.color_paths[0]),
                      ("depth", reader.depth_paths[0]),
                      ("depth_all_paeth", paeth)):
        t0 = time.perf_counter()
        IO.read_png(path)
        out[f"png_decode_ms_{key}"] = 1e3 * (time.perf_counter() - t0)
        out[f"png_row_filters_{key}"] = png_row_filters(path)
    os.remove(paeth)
    scale = cfg["cam"]["png_depth_scale"]
    if not (len(reader) == TUM_FRAMES and out["undistort_identity"]
            and out["color_max_err"] <= 0.5 / 255 + 1e-6
            and out["depth_max_err_m"] <= 0.5 / scale + 1e-6
            and sum(out["png_row_filters_rgb"][3:]) > 0):
        raise AssertionError(f"TUM tree decode: {out}")
    return out


def write_scannet_tree(folder: str) -> dict:
    """slam_scannet's input: the first SCANNET_FRAMES frames of the
    synthetic room's quarter orbit in SCANNET_ORBIT frames, rendered at
    scene0059.yaml's 480x640 intrinsics, written as a ScanNet
    tree (color/*.jpg through the port's baseline JPEG encoder, depth/*.png
    16-bit, pose/*.txt).  Returns the rendered first colour and depth."""
    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch.utils import datasets as D
    cam = dict(C.load_config(os.path.join(HERE, SCANNET_CFG),
                             C.default_config_path())["cam"], crop_edge=0)
    syn = D.Synthetic({"dataset": "synthetic", "seed": 1219, "data": {},
                       "synthetic": {"n_frames": SCANNET_ORBIT,
                                     "radius": 1.2}, "cam": cam})
    frames = [syn[i] for i in range(SCANNET_FRAMES)]
    D.write_scannet_tree(folder, frames,
                         png_depth_scale=cam["png_depth_scale"])
    return {"color": frames[0].color, "depth": frames[0].depth}


def check_scannet_tree(cfg_path: str, tree: str, first: dict) -> dict:
    """preflight on the tree (must exit 0), then the run's reader (the
    port's ScanNet reader, JPEG through its own decoder): the first frame
    against the rendered one, cut by the crop edge (colour within the JPEG
    loss, depth within the PNG quantisation); the reader's ms per frame
    (decode, crop; mean over the tree) and the JPEG decode's ms per file
    (mean over the tree's colour files)."""
    import io

    import numpy as np
    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch.tools import preflight as PF
    from hpslam_tpu_torch.utils import datasets as D
    from hpslam_tpu_torch.utils import image_io as IO
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = PF.main([cfg_path, "--input_folder", tree])
    lines = buf.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"preflight exit {rc}: {lines}")
    cfg = C.load_config(cfg_path, C.default_config_path())
    reader = D.get_dataset(cfg, input_folder=tree)
    fr = reader[0]
    e = cfg["cam"]["crop_edge"]
    col = first["color"][e:-e, e:-e]
    dep = first["depth"][e:-e, e:-e]
    out = {"preflight_exit": rc, "preflight": lines,
           "frames": len(reader), "shape": list(fr.color.shape),
           "color_mean_abs_err": float(np.abs(fr.color - col).mean()),
           "color_max_err": float(np.abs(fr.color - col).max()),
           "depth_max_err_m": float(np.abs(fr.depth - dep).max())}
    t0 = time.perf_counter()
    for i in range(len(reader)):
        reader[i]
    out["read_ms_per_frame"] = 1e3 * (time.perf_counter() - t0) / len(reader)
    t0 = time.perf_counter()
    for path in reader.color_paths:
        IO.read_color(path)
    out["jpeg_decode_ms_per_file"] = (1e3 * (time.perf_counter() - t0)
                                      / len(reader.color_paths))
    t0 = time.perf_counter()
    for path in reader.depth_paths:
        IO.read_png(path)
    out["png_decode_ms_per_file"] = (1e3 * (time.perf_counter() - t0)
                                     / len(reader.depth_paths))
    scale = cfg["cam"]["png_depth_scale"]
    if not (len(reader) == SCANNET_FRAMES
            and out["color_mean_abs_err"] <= 2.0 / 255
            and out["depth_max_err_m"] <= 0.5 / scale + 1e-6):
        raise AssertionError(f"ScanNet tree decode: {out}")
    return out


def geo_decoder_changes(cfg_path: str, state: dict) -> dict:
    """The largest change of each geometry decoder's parameters between
    the run's start (init_nicer from the config's seed, as PointSLAM draws
    them) and its final checkpoint; fails unless both changed."""
    import numpy as np
    import torch
    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch.convert import params_to_numpy
    from hpslam_tpu_torch.models import decoder as Dec
    from hpslam_tpu_torch.ops import optim as Opt
    cfg = C.load_config(cfg_path, C.default_config_path())
    gen = torch.Generator(device="cuda").manual_seed(
        int(cfg.get("seed", 1219)))
    start = params_to_numpy(Dec.init_nicer(gen, Dec.ModelConfig.from_cfg(cfg),
                                           torch.device("cuda")))
    out = {}
    for name in ("geo_mid", "geo_fine"):
        change = Opt.tree_leaves(Opt.tree_map(
            lambda x, y: float(np.abs(np.asarray(x) - np.asarray(y)).max()),
            start[name], state["decoder_params"][name]))
        out[name] = {"max_abs_change": max(change),
                     "leaves_changed": sum(c > 0 for c in change),
                     "leaves": len(change)}
    if not all(v["max_abs_change"] > 0 for v in out.values()):
        raise AssertionError(f"slam_geo: geometry decoders unchanged: {out}")
    return out


def slam_config(spec, seed=None) -> dict:
    """The config run_slam writes for ``spec`` (base config, additions,
    ...) at ``seed``: the additions over the base, quiet."""
    base, additions = spec[:2]
    return merged(additions, {"inherit_from": os.path.join(HERE, base),
                              "verbose": False},
                  {} if seed is None else {"seed": seed})


def run_slam(out_dir: str, name: str = "slam", profile: bool = False,
             tag: str = "", spec=None, seed=None, max_ate=ATE_MAX_M,
             keep: bool = False):
    """One SLAM run through the port's CLI entry point on ``spec`` (by
    default SLAM_RUNS[name]: config, additions, kernels launched and not),
    at ``seed`` where given; for slam_tum on a TUM tree written first.
    Fails on the kernels or an ATE of max_ate or more (None: no limit).
    With ``profile`` the same run is repeated under torch.profiler (the
    first run is its warm-up) and its summary returned under "profile".
    With ``keep`` the run's temporary directory stays (its path under
    "work": smoke.yaml, the output in out/) for the caller to remove.
    Returns (summary, estimated trajectory from the run's last
    checkpoint)."""
    import torch
    import yaml
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch import run as R
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    spec = spec or SLAM_RUNS[name]
    launched, not_launched = spec[2:]
    work = tempfile.mkdtemp(prefix="hpslam_smoke_")
    try:
        cfg_path = os.path.join(work, "smoke.yaml")
        cfg = slam_config(spec, seed)
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        argv = [cfg_path, "--input_folder", os.path.join(work, "in")]
        decode = None
        if name == "slam_tum":
            first = write_tum_tree(os.path.join(work, "in"))
            decode = check_tum_decode(cfg_path, os.path.join(work, "in"),
                                      first)
        elif name == "slam_scannet":
            first = write_scannet_tree(os.path.join(work, "in"))
            decode = check_scannet_tree(cfg_path, os.path.join(work, "in"),
                                        first)
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
        state = load_checkpoint(latest_checkpoint(os.path.join(work,
                                                               "out")))
        traj = state["estimate_c2w_list"]
        extra = {"products": run_products(os.path.join(work, "out"))}
        if name == "slam_geo":
            extra["geo_decoders"] = geo_decoder_changes(cfg_path, state)
        elif name == "slam_scannet":
            wo = os.path.join(work, "out")
            extra["end_correction"] = read_events(wo, "end_correction")
            extra["map_iterations"] = [e["iters"] for e in
                                       read_events(wo, "map")]
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    if not keep:
        shutil.rmtree(work, ignore_errors=True)
    ate = results["absolute_translational_error.rmse"]
    out = {"ate_rmse_m": ate, "track_ms_mean": summary["track_ms_mean"],
           "map_ms_mean": summary["map_ms_mean"],
           "n_frames": summary["n_frames"], "launches": launches}
    if keep:
        out["work"] = work
    out.update(extra)
    if name == "slam_tum":
        out["decode"] = decode
        out["cuts"] = TUM_CUTS
    elif name == "slam_scannet":
        out["decode"] = decode
        out["cuts"] = SCANNET_CUTS
        # per-iteration costs for tools/preflight.py's runtime estimate
        out["track_ms_per_iter"] = (summary["track_ms_mean"]
                                    / SCANNET_ADDITIONS["tracking"]["iters"])
        its = extra["map_iterations"]
        out["map_ms_per_iter"] = summary["map_ms_mean"] / (sum(its)
                                                           / len(its))
        emit({"slam_scannet_end_correction": extra["end_correction"]})
    if prof is not None:
        out["profile"] = prof
    with open(os.path.join(out_dir, f"{name}{tag}_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    if max_ate is not None and not ate < max_ate:
        raise AssertionError(f"ATE RMSE {ate} m above {max_ate} m")
    for k in launched:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"{name} path")
    for k in not_launched:
        if launches.get(k, 0) != 0:
            raise AssertionError(f"kernel {k} was launched on the {name} "
                                 "path")
    return out, traj


def run_band(out_dir: str, seeds=BAND_SEEDS, configs=tuple(BAND_CONFIGS)
             ) -> dict:
    """The BAND_CONFIGS named in ``configs`` for all their 30 frames at
    ``seeds``, on the default (slam) and the slam_fused path: each run's
    ATE, beside the reference's band.  Reports; holds no limit."""
    out = {"reference_cm": BAND_REFERENCE_CM, "runs": []}
    for cfg_name in configs:
        base = BAND_CONFIGS[cfg_name]
        for path, additions in BAND_PATHS.items():
            for seed in seeds:
                t0 = time.perf_counter()
                s, _traj = run_slam(
                    out_dir, "band", tag=f"_{cfg_name}_{path}_{seed}",
                    spec=(base, additions, (), ()), seed=seed,
                    max_ate=None)
                row = {"config": cfg_name, "path": path, "seed": seed,
                       "ate_cm": 100 * s["ate_rmse_m"],
                       "track_ms_mean": s["track_ms_mean"],
                       "map_ms_mean": s["map_ms_mean"],
                       "seconds": time.perf_counter() - t0}
                out["runs"].append(row)
                emit({"band_run": row})
    return out


def orbit_spec(scenario: str, route: str, seed: int) -> tuple:
    """run_slam's spec for orbit_compare.py's run of ``scenario`` on
    ``route`` at ``seed``: the config that orbit_compare.write_config
    writes for it (its data.output left to run_slam) and ORBIT_KERNELS'
    kernels for the route."""
    import yaml
    import orbit_compare
    with tempfile.TemporaryDirectory(prefix="hpslam_orbit_") as d:
        path = os.path.join(d, "orbit.yaml")
        orbit_compare.write_config(path, scenario, seed,
                                   os.path.join(d, "out"), route=route)
        with open(path) as f:
            cfg = yaml.safe_load(f)
    base = cfg.pop("inherit_from")
    cfg["data"].pop("output")
    if not cfg["data"]:
        del cfg["data"]
    return (base, cfg) + ORBIT_KERNELS[route]


def run_orbit(out_dir: str, seeds=ORBIT_SEEDS, scenarios=ORBIT_SCENARIOS,
              routes=ORBIT_ROUTES) -> dict:
    """The port's side of orbit_compare.py on the card: each of
    ``scenarios`` on each of ``routes`` at ``seeds`` through run_slam (the
    route's kernels asserted launched, and not), each run's record (the
    fields of orbit_compare's, device "cuda", the launches) printed and
    appended to <out_dir>/orbit/runs.jsonl.  Reports; holds no ATE
    limit."""
    os.makedirs(os.path.join(out_dir, "orbit"), exist_ok=True)
    n = 0
    for scenario in scenarios:
        for route in routes:
            for seed in seeds:
                t0 = time.perf_counter()
                s, _traj = run_slam(
                    out_dir, "orbit", tag=f"_{scenario}_{route}_{seed}",
                    spec=orbit_spec(scenario, route, seed), seed=seed,
                    max_ate=None)
                rec = {"impl": "port", "device": "cuda",
                       "scenario": scenario, "route": route, "seed": seed,
                       "rc": 0, "ate_rmse_m": s["ate_rmse_m"],
                       "seconds": time.perf_counter() - t0,
                       "track_ms_mean": s["track_ms_mean"],
                       "map_ms_mean": s["map_ms_mean"],
                       "n_frames": s["n_frames"],
                       "launches": s["launches"]}
                emit(rec)
                with open(os.path.join(out_dir, "orbit", "runs.jsonl"),
                          "a") as f:
                    f.write(json.dumps(rec) + "\n")
                n += 1
    return {"runs": n}


def run_repeat(out_dir: str, first: dict, served=None) -> dict:
    """The scatter check, then each SLAM run of ``first`` ({name: (summary,
    trajectory)}) again in this process: the estimated trajectories and
    the ATEs must be bitwise equal.  ``served`` ({name: (phase, (summary,
    trajectory))}) names runs that a later phase already ran again on the
    same config and seed (slam_vis repeats slam, with panels): they are
    compared, not run a third time."""
    import numpy as np
    served = served or {}
    out = {"scatter": run_scatter_repeat()}
    bad = []
    for name, (s0, traj0) in first.items():
        if name in served:
            by, (s1, traj1) = served[name]
        else:
            by = None
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
        if by:
            out[name]["served_by"] = by
        if not (same and out[name]["ate_bitwise_equal"]):
            bad.append(name)
    if bad:
        emit({"repeat": out})
        raise AssertionError(f"runs do not repeat: {bad}")
    return out


def run_products(out: str) -> dict:
    """A finished run's records carry the loss curves (every track record
    a finite loss_curve, every map record finite geo_loss_curve and
    color_loss_curve of one length), and the run wrote
    eval_ate_aligned.png, which decodes at the figure's size with the
    aligned estimate drawn in blue beside the ground truth in black."""
    import numpy as np
    from hpslam_tpu_torch.tools import eval_ate as EA
    from hpslam_tpu_torch.utils import image_io as IO
    tracks, maps = read_events(out, "track"), read_events(out, "map")
    curves_ok = bool(tracks and maps) and all(
        r.get("loss_curve") and np.isfinite(r["loss_curve"]).all()
        for r in tracks) and all(
        r.get("geo_loss_curve") and len(r["geo_loss_curve"])
        == len(r.get("color_loss_curve") or ())
        and np.isfinite(r["geo_loss_curve"] + r["color_loss_curve"]).all()
        for r in maps)
    img = IO.read_png(os.path.join(out, "eval_ate_aligned.png"))
    drawn = {name: int((img == np.array(c, np.uint8)).all(-1).sum())
             for name, c in (("gt_pixels", EA.GT_COLOR),
                             ("estimate_pixels", EA.EST_COLOR))}
    rec = {"track_curves": len(tracks), "map_curves": len(maps),
           "loss_curve_len": len(tracks[-1]["loss_curve"]) if tracks else 0,
           "eval_ate_aligned_png": list(img.shape), **drawn}
    if not (curves_ok and img.shape == EA.PLOT_HW + (3,)
            and drawn["estimate_pixels"] > 0
            and sum(drawn.values()) > 100):
        raise AssertionError(f"run products: {rec}")
    return rec


def read_events(out: str, event: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["event"] == event]


def check_panels(out: str, H: int, W: int) -> dict:
    """slam_vis's files: the tracking and mapping panels of frame VIS_FRAME
    for both levels and its rendered image, each decoded by the port's PNG
    reader to the expected shape; the fine level's mapping residuals."""
    from hpslam_tpu_torch.utils import image_io as IO
    files = {}
    for sub in ("tracking_vis", "mapping_vis"):
        names = sorted(os.listdir(os.path.join(out, sub)))
        frames = sorted({int(n[:5]) for n in names})
        levels = sorted(n.rsplit("_", 1)[1][:-4] for n in names)
        if frames != [VIS_FRAME] or levels != ["fine", "mid"]:
            raise AssertionError(f"{sub}: {names}")
        for n in names:
            if IO.read_png(os.path.join(out, sub, n)).shape != (2 * H, 3 * W,
                                                               3):
                raise AssertionError(f"{sub}/{n}: shape")
        files[sub] = names
    img = os.path.join(out, "rendered_image", f"frame_{VIS_FRAME:05d}.png")
    if IO.read_png(img).shape != (H, W, 3):
        raise AssertionError(f"{img}: shape")
    vis = read_events(out, "vis")
    fine = [e for e in vis if e["what"] == "mapping" and e["level"] == "fine"
            and e["idx"] == VIS_FRAME]
    if len(vis) != 4 or len(fine) != 1:
        raise AssertionError(f"vis events: {vis}")
    if not fine[0]["depth_l1_m"] < VIS_DEPTH_L1_MAX_M:
        raise AssertionError(f"depth residual {fine[0]['depth_l1_m']} m")
    return {"files": files, "rendered_image": os.path.basename(img),
            "mapping_fine_depth_l1_m": fine[0]["depth_l1_m"],
            "mapping_fine_psnr_db": fine[0]["psnr_db"],
            "depth_l1_max_m": VIS_DEPTH_L1_MAX_M,
            "render_img_ms": [{k: e[k] for k in ("what", "level",
                                                 "render_ms")}
                              for e in vis],
            "render_img_ms_per_image_level": sum(
                e["render_ms"] for e in vis) / len(vis),
            "image": [H, W]}


def run_slam_vis(out_dir: str, first: dict):
    """The slam run with panels at frame VIS_FRAME, kept for resume and
    mesh.  Its trajectory and ATE must be slam's (when slam ran in this
    process) bit for bit: rendering changes nothing."""
    import numpy as np
    s, traj = run_slam(out_dir, "slam_vis", keep=True)
    try:
        from hpslam_tpu_torch import config as C
        cfg = C.load_config(os.path.join(s["work"], "smoke.yaml"),
                            C.default_config_path())
        s["panels"] = check_panels(os.path.join(s["work"], "out"),
                                   cfg["cam"]["H"], cfg["cam"]["W"])
        if "slam" in first:
            s0, traj0 = first["slam"]
            s["trajectory_bitwise_slam"] = bool(np.array_equal(traj, traj0))
            s["ate_bitwise_slam"] = s["ate_rmse_m"] == s0["ate_rmse_m"]
            if not (s["trajectory_bitwise_slam"] and s["ate_bitwise_slam"]):
                raise AssertionError("the panels changed the run: ATE "
                                     f"{s['ate_rmse_m']} vs "
                                     f"{s0['ate_rmse_m']}")
    except BaseException:
        shutil.rmtree(s["work"], ignore_errors=True)
        raise
    return s, traj


def run_resume(vis: dict, traj_vis) -> dict:
    """slam_vis's frame-5 checkpoint copied into a fresh output directory
    and resumed to the end through the CLI (--resume): the checks of
    tests/test_resume.py, and whether the trajectory is slam_vis's bit for
    bit."""
    import numpy as np
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch import run as R
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    work = vis["work"]
    out = os.path.join(work, "resume")
    ck = os.path.join(work, "out", "ckpts", f"{VIS_FRAME:05d}.ckpt")
    os.makedirs(os.path.join(out, "ckpts"))
    shutil.copy(ck, os.path.join(out, "ckpts"))
    state0 = load_checkpoint(ck)
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, summary = R.run([os.path.join(work, "smoke.yaml"),
                              "--input_folder", os.path.join(work, "in"),
                              "--output", out, "--resume"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    state = load_checkpoint(latest_checkpoint(out))
    traj = state["estimate_c2w_list"]
    n0 = VIS_FRAME + 1
    kf0 = list(state0["keyframe_list"])
    ate = results["absolute_translational_error.rmse"]
    checks = {
        "keyframes_carried": list(state["keyframe_list"][:len(kf0)]) == kf0,
        "points_no_fewer": all(state["pts_num"][k] >= state0["pts_num"][k]
                               for k in state0["pts_num"]),
        "poses_0_5_equal": bool(np.array_equal(
            traj[:n0], state0["estimate_c2w_list"][:n0])),
        "poses_6_9_filled": bool(np.abs(traj[n0:]).sum() > 0
                                 and np.isfinite(traj[n0:]).all()),
        "ate_finite_under_limit": bool(np.isfinite(ate) and ate < ATE_MAX_M),
        "topk_rows_launched": launches.get("topk_rows", 0) > 0}
    out_rec = {"checkpoint": os.path.basename(ck), "resumed_at": n0,
               "ate_rmse_m": ate, "seconds": seconds,
               "track_ms_mean": summary["track_ms_mean"],
               "map_ms_mean": summary["map_ms_mean"], "launches": launches,
               "checks": checks,
               "trajectory_bitwise_uninterrupted": bool(
                   np.array_equal(traj, traj_vis)),
               "ate_bitwise_uninterrupted": ate == vis["ate_rmse_m"],
               "max_abs_pose_diff_uninterrupted": float(
                   np.abs(traj - traj_vis).max())}
    if not all(checks.values()):
        raise AssertionError(f"resume: {out_rec}")
    return out_rec


def run_telemetry(vis: dict) -> dict:
    """slam_vis's run (slam's config and seed) ended with
    plots/summary.png: it decodes through the port's PNG reader at the
    summary's canvas size, and each of its four panels holds line pixels
    (neither the white canvas nor the grey frame)."""
    import numpy as np
    from hpslam_tpu_torch.utils import image_io as IO
    from hpslam_tpu_torch.utils import telemetry as T
    path = os.path.join(vis["work"], "out", "plots", "summary.png")
    img = IO.read_png(path)
    lines = []
    for k in range(4):
        x0, y0, x1, y1 = T.panel_box(k)
        box = img[y0 + 1:y1, x0 + 1:x1].astype(int)
        lines.append(int((np.abs(box - 255).sum(-1) > 0).sum()))
    out = {"file": os.path.relpath(path, vis["work"]),
           "shape": list(img.shape), "line_pixels_per_panel": lines}
    if not (img.shape == T.CANVAS_HW + (3,) and all(lines)):
        raise AssertionError(f"telemetry: {out}")
    return out


# points: the mesher's query (renderer.eval_points) on slam_vis's final
# checkpoint at 200,000 points of the synthetic room's box, on a grid of
# POINTS_GRID cells, each point jittered within its cell (a generator seeded
# with POINTS_SEED)
POINTS_GRID = (50, 50, 80)
POINTS_SEED = 0


def points_grid(torch, dev, half: float):
    """POINTS_GRID cells over the box [-half, half]^3, one point in each,
    uniform within its cell: (n, 3) float32 on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(POINTS_SEED)
    axes = [((torch.arange(n, device=dev) + 0.5) / n * 2 - 1) * half
            for n in POINTS_GRID]
    cell = torch.tensor([2 * half / n for n in POINTS_GRID], device=dev)
    p = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return (p + (torch.rand(p.shape, generator=g, device=dev) - 0.5)
            * cell).contiguous()


def within_radius_ids(D, I, r2):
    """Each row's neighbour ids within the radius, sorted, -1 elsewhere."""
    import torch
    return torch.sort(torch.where(D < r2, I, torch.full_like(I, -1)),
                      dim=1).values


def run_points(vis: dict) -> dict:
    """renderer.eval_points, the mesher's query, on slam_vis's final
    checkpoint (synth_tpu.yaml's full-width decoders) at POINTS_GRID's
    200,000 points of the room's box, through both levels: first with each
    level's tile index (#1's route, the launches counted), then without
    (knn_auto: at these capacities, above knn._EXACT_MAX_N, the
    approximate segment-min search).  #1 bitwise against its plain version
    on the rows the tile route gave it.  Per level ops.knn.find_neighbors,
    the exact search, at the query radius: its counts neighbor_counts'
    over its D; every point that the tile route or the exact search finds
    neighbours for has the exact neighbours within the radius through the
    tile index, and the tile route's mask is the exact one; on the points
    where the segment-min route has them too, masks equal and occupancy
    and colour within LOSS_RTOL.  The routes' ms."""
    import numpy as np
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch import renderer as R
    from hpslam_tpu_torch import state as St
    from hpslam_tpu_torch.convert import params_from_numpy
    from hpslam_tpu_torch.models import decoder as Dec
    from hpslam_tpu_torch.ops import knn as K
    from hpslam_tpu_torch.utils.datasets import Synthetic
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    dev = torch.device("cuda")
    cfg = C.load_config(os.path.join(vis["work"], "smoke.yaml"),
                        C.default_config_path())
    ck = latest_checkpoint(os.path.join(vis["work"], "out"))
    state = load_checkpoint(ck)
    npc = St.NeuralPointCloud(cfg, dev)
    for name, lv in state["levels"].items():
        npc.restore_level(name, lv["pos"], lv["normal"], lv["geo"],
                          lv["col"], int(lv.get("capacity", 0)))
    params = params_from_numpy(state["decoder_params"], dev)
    mcfg = Dec.ModelConfig.from_cfg(cfg)
    expo = (torch.as_tensor(np.asarray(state["exposure_feat"], np.float32),
                            device=dev) if mcfg.encode_exposure else None)
    p = points_grid(torch, dev, Synthetic.HALF)
    rq = float(cfg["pointcloud"]["radius_query"])
    r_query = torch.full((p.shape[0],), rq, device=dev)
    levels = list(npc.levels)
    indexes = {lv: npc.index(lv) for lv in levels}
    torch.cuda.synchronize()

    def route(lv, tiles: bool):
        c = npc.levels[lv]
        with torch.no_grad():
            return R.eval_points(params, mcfg, p, c.pos, c.count, c.geo,
                                 c.col, r_query, nn_num=npc.nn_num,
                                 level=lv, exposure_feat=expo,
                                 tile_index=indexes[lv] if tiles else None)

    cur = {}
    cap: dict = {}
    knn: dict = {}

    def take_topk(x, pl, k):
        key = f"{cur['lv']} {x.shape[1]} k={k}"
        if key not in cap:
            cap[key] = (x.clone(), None if pl is None else pl.clone(), k)

    def take_knn(out, *a, **kw):
        knn[(cur["route"], cur["lv"])] = out

    out: dict = {"points": int(p.shape[0]), "grid": list(POINTS_GRID),
                 "r_query": rq, "checkpoint": os.path.basename(ck),
                 "levels": {}, "ms": {}}
    res = {}
    for name, tiles, fn in (("tiles", True, "knn_tiles"),
                            ("knn_auto", False, "knn_auto")):
        cur["route"] = name
        if tiles:
            _cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tapped(K, "topk_rows", before=take_topk if tiles else None), \
                tapped(K, fn, after=take_knn):
            for lv in levels:
                cur["lv"] = lv
                res[(name, lv)] = route(lv, tiles)
        torch.cuda.synchronize()
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        if tiles:
            launches = dict(_cuda.LAUNCHES)
    for k, v in launches.items():
        if (v > 0) != (k == "topk_rows"):
            raise AssertionError(f"points: kernel {k} launched {v} times "
                                 "on the tile route")
    if not launches.get("topk_rows"):
        raise AssertionError("points: #1 not launched on the tile route")
    out["launches"] = launches

    flush = torch.empty((2 * L2_BYTES // 4,), device=dev)
    blocks = getattr(_cuda.lib("topk_rows"), "hp_topk_blocks_per_sm", None)
    out["topk"] = [topk_case(key, *cap[key], flush, blocks) for key in cap]
    del flush

    r2 = rq * rq

    def misses(same, seen):
        return int((seen & ~same).sum())

    for lv in levels:
        occ_t, rgb_t, m_t = res[("tiles", lv)]
        occ_a, rgb_a, m_a = res[("knn_auto", lv)]
        c = npc.levels[lv]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D, I, nn = K.find_neighbors(p, c.pos, c.count, r_query,
                                    k=npc.nn_num)
        torch.cuda.synchronize()
        fn_ms = (time.perf_counter() - t0) * 1e3
        exact = within_radius_ids(D, I, r2)
        ids_t = within_radius_ids(*knn[("tiles", lv)], r2)
        ids_a = within_radius_ids(*knn[("knn_auto", lv)], r2)
        m_x = nn >= mcfg.min_nn_num      # eval_points' mask, exactly
        same_t = (ids_t == exact).all(1)
        same_a = (ids_a == exact).all(1)
        both = same_t & same_a
        rec = {"count": int(c.count), "capacity": int(c.capacity),
               "tiles": int(indexes[lv][1].shape[1]),
               "masked_tiles": int(m_t.sum()),
               "masked_knn_auto": int(m_a.sum()),
               "masked_exact": int(m_x.sum()),
               "with_neighbours_exact": int((nn > 0).sum()),
               "tiles_not_exact_of_with_neighbours": misses(
                   same_t, (ids_t >= 0).any(1) | (nn > 0)),
               "knn_auto_not_exact_of_with_neighbours": misses(
                   same_a, (ids_a >= 0).any(1) | (nn > 0)),
               "mask_mismatches_tiles_exact": int((m_t != m_x).sum()),
               "mask_mismatches_tiles_knn_auto": int((m_t != m_a).sum()),
               "occ_max_abs_diff_both_exact": float(
                   (occ_t - occ_a).abs()[both].max()),
               "rgb_max_abs_diff_both_exact": float(
                   (rgb_t - rgb_a).abs()[both].max()),
               "occ_max_abs_diff_all": float((occ_t - occ_a).abs().max()),
               "find_neighbors_ms": fn_ms,
               "knn_auto_D_equal_exact": bool(
                   torch.equal(D, knn[("knn_auto", lv)][0])),
               "neighbours_in_radius_mean": float(nn.float().mean())}
        out["levels"][lv] = rec
        emit({"points_level": {lv: rec}})
        tol = LOSS_RTOL
        ok = (rec["tiles_not_exact_of_with_neighbours"] == 0
              and rec["mask_mismatches_tiles_exact"] == 0
              and int(((m_t != m_a) & both).sum()) == 0
              and rec["masked_tiles"] > 0
              and torch.allclose(occ_t[both], occ_a[both], rtol=tol,
                                 atol=tol)
              and torch.allclose(rgb_t[both], rgb_a[both], rtol=tol,
                                 atol=tol)
              and bool(torch.isfinite(occ_t).all())
              and bool(torch.isfinite(rgb_t).all())
              and torch.equal(nn, K.neighbor_counts(D, r_query)))
        if not ok:
            raise AssertionError(f"points {lv}: {rec}")
    out["tolerance"] = {"topk": TOPK_TOL, "occ_rgb_rtol_atol": LOSS_RTOL}
    return out


# lockstep: the card against the CPU on one tracked and one mapped frame
# from slam_vis's frame-5 checkpoint (the mapping cut to LOCKSTEP_MAP_ITERS
# iterations: the CPU side of synth_tpu's 150 takes minutes), iteration by
# iteration: the card's every Adam step is taken from the CPU's parameters
# and moments of that iteration, as tests/test_torch_lockstep.py holds the
# port against the reference; free-running, the two part beyond these
# tolerances within a few tracking iterations (rounding-level gradient
# differences, carried by Adam's normalised steps over the robust loss's
# discontinuities).  Card against CPU, f32, TF32 off:
LOCKSTEP_FRAME = VIS_FRAME + 1
LOCKSTEP_MAP_ITERS = 30
LOCKSTEP_SEED = 0
LOCKSTEP_STEP_ATOL = 1e-4       # the card's own step of the pose
LOCKSTEP_LOSS_RTOL = 1e-4       # both loss curves
# the card's mapping gradient leaf by leaf (relative norm): the geometry
# features (a ReLU at its kink parts single steps; the median too), every
# other leaf (decoders, colour features, exposure)
LOCKSTEP_GEO_GRAD_MAX, LOCKSTEP_GEO_GRAD_MEDIAN = 5e-2, 1e-4
LOCKSTEP_GRAD_LEAF_MAX = 1e-4
# the card's own mapping step on every leaf but the geometry features,
# where the CPU's gradient is at least LOCKSTEP_OWN_GRAD_SHARE of the
# leaf's largest (elsewhere Adam turns a rounding-level gradient into a
# step of the learning rate's size)
LOCKSTEP_OWN_RTOL, LOCKSTEP_OWN_ATOL = 1e-3, 1e-5
LOCKSTEP_OWN_GRAD_SHARE = 1e-2


def grad_groups(tree, path=()):
    """(label, array) for each leaf of a parameter or gradient tree on the
    host, the mapper's packed feature table split into its geometry and
    colour halves ('feat.geo', 'feat.col')."""
    import torch
    if isinstance(tree, dict):
        return [x for k in tree for x in grad_groups(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in grad_groups(v, path + (i,))]
    a = tree.detach().cpu().double() if torch.is_tensor(tree) else tree
    if path == ("feat",):
        C = a.shape[1] // 2
        return [("feat.geo", a[:, :C]), ("feat.col", a[:, C:])]
    return [(".".join(map(str, path)), a)]


@contextlib.contextmanager
def adam_steps(follow=None):
    """Inside: the port's Adam step (ops.optim.update) records each step's
    result and gradient on the host, or, given ``follow`` (such a record),
    takes its own step, keeps per step its largest difference from the
    followed one (per parameter leaf name), each gradient leaf's relative
    difference from the followed gradient (grad_groups), and each leaf's
    own step beyond LOCKSTEP_OWN_RTOL / _ATOL of the followed one where the
    followed gradient is at least LOCKSTEP_OWN_GRAD_SHARE of the leaf's
    largest (the geometry features aside), and returns the followed
    result, moved to the caller's device.  Yields the list of records, or
    of differences."""
    import torch
    from hpslam_tpu_torch.ops import optim as O
    step = O.update
    out = []

    def host(t):
        return t.detach().cpu().clone() if torch.is_tensor(t) else t

    def update(grads, state, params, lr, *a, **kw):
        new_p, new_s = step(grads, state, params, lr, *a, **kw)
        grads = O.tree_map(lambda g, p: torch.zeros_like(p) if g is None
                           else g, grads, params)
        if follow is None:
            out.append(O.tree_map(host, (new_p, new_s, grads)))
            return new_p, new_s
        ref_p, ref_s, ref_g = follow[len(out)]
        grad, own = {}, {}
        for (key, g), (_, gr), (_, pn), (_, pr) in zip(
                grad_groups(grads), grad_groups(ref_g), grad_groups(new_p),
                grad_groups(ref_p)):
            den = float(gr.norm())
            num = float((g - gr).norm())
            grad[key] = (num / den if den > 0
                         else (0.0 if num == 0 else float("inf")))
            if key != "feat.geo":
                mask = gr.abs() >= LOCKSTEP_OWN_GRAD_SHARE * gr.abs().max()
                own[key] = float(((pn - pr).abs() - LOCKSTEP_OWN_RTOL
                                  * pr.abs())[mask].max().clamp(min=0))
        out.append({"step": {k: max(float((x.detach().cpu() - y).abs().max())
                                    for x, y in zip(O.tree_leaves(v),
                                                    O.tree_leaves(ref_p[k])))
                             for k, v in new_p.items()},
                    "grad": grad, "own_excess": own})
        dev = O.tree_leaves(params)[0].device
        to = lambda t: t.to(dev) if torch.is_tensor(t) else t
        return O.tree_map(to, ref_p), O.tree_map(to, ref_s)

    O.update = update
    try:
        yield out
    finally:
        O.update = step


@contextlib.contextmanager
def cpu_draws(seed: int):
    """torch.randint / torch.randn drawn on a CPU generator seeded with
    ``seed`` whatever generator and device the caller names, the result
    moved to that device: the same draws on the card and on the CPU."""
    import torch
    g = torch.Generator().manual_seed(seed)
    randint, randn = torch.randint, torch.randn

    def cpu_randint(low, high, size, generator=None, device=None, **kw):
        return randint(low, high, size, generator=g, **kw).to(device or "cpu")

    def cpu_randn(size, generator=None, device=None, **kw):
        return randn(size, generator=g, **kw).to(device or "cpu")

    torch.randint, torch.randn = cpu_randint, cpu_randn
    try:
        yield
    finally:
        torch.randint, torch.randn = randint, randn


@contextlib.contextmanager
def union_caches(follow=None):
    """Inside: the mapper's union caches (mapper.build_pixel_union_cache)
    recorded on the host, or, given ``follow`` (such a record), built,
    counted against the followed ones (the cache pixels whose unions
    differ: ties and neighbours at the query radius fall either way) and
    replaced by them, moved to the caller's device, so that the compacted
    tables, and the Adam steps adam_steps hands over, index the same rows.
    Yields the list of records, or of counts."""
    import torch
    from hpslam_tpu_torch import mapper as M
    build = M.build_pixel_union_cache
    out = []

    def move(tree, dev):
        if isinstance(tree, dict):
            return {k: move(v, dev) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(move(v, dev) for v in tree)
        return tree.to(dev)

    def cache(*a, **kw):
        own = build(*a, **kw)
        if follow is None:
            out.append(move(own, "cpu"))
            return own
        ref = follow[len(out)]
        u = own[1].shape[-1]
        out.append(int((own[1].cpu().reshape(-1, u)
                        != ref[1].reshape(-1, u)).any(1).sum()))
        return move(ref, own[1].device)

    M.build_pixel_union_cache = cache
    try:
        yield out
    finally:
        M.build_pixel_union_cache = build


def lockstep_side(vis: dict, device: str, c2w_map=None,
                  follow=None) -> dict:
    """slam_vis's frame-5 checkpoint restored on ``device``; frame 6
    tracked, then mapped at ``c2w_map`` (the tracked pose where None), on
    the draws of cpu_draws(LOCKSTEP_SEED), the Adam steps and the union
    caches recorded or, with ``follow`` (the CPU side's result), followed
    (adam_steps, union_caches).  Returns the tracked pose, the unrounded
    loss curves, the levels and decoders after the mapping, the steps, the
    caches, and the kernel launches."""
    import numpy as np
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch import mapper as M
    from hpslam_tpu_torch import tracker as T
    from hpslam_tpu_torch.convert import params_to_numpy
    from hpslam_tpu_torch.slam import PointSLAM
    cfg = C.load_config(os.path.join(vis["work"], "smoke.yaml"),
                        C.default_config_path())
    cfg["mapping"].update(iters=LOCKSTEP_MAP_ITERS,
                          more_iters_when_adding=False)
    cfg["data"]["output"] = tempfile.mkdtemp(prefix="hpslam_lockstep_")
    got: dict = {}
    track_frame, map_scan = T.track_frame, M.map_scan

    def record(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            got.setdefault(name, []).append(out[2].detach().cpu().numpy())
            return out
        return wrapped

    try:
        slam = PointSLAM(cfg, device=device)
        # the checkpoint's torch generator states are the card's, and
        # cpu_draws replaces every torch draw: only the mapper's numpy
        # stream is restored
        slam.set_rng_states = lambda states: setattr(
            slam.mapper.rng.bit_generator, "state", states["mapper_np"])
        slam.restore_from(os.path.join(vis["work"], "out", "ckpts",
                                       f"{VIS_FRAME:05d}.ckpt"))
        frame = slam.frame_reader[LOCKSTEP_FRAME]
        T.track_frame = record("track", track_frame)
        M.map_scan = record("map", map_scan)
        _cuda.reset_launches()
        with cpu_draws(LOCKSTEP_SEED), \
                adam_steps(follow and follow["steps"]) as steps, \
                union_caches(follow and follow["caches"]) as caches:
            c2w, _info, _op = slam.tracker.track(
                LOCKSTEP_FRAME, frame, slam.npc, slam.params,
                slam.exposure_feat, slam.estimate_c2w_list, frame.c2w)
            params, _expo, _minfo = slam.mapper.map(
                LOCKSTEP_FRAME, frame, slam.npc, slam.params,
                slam.exposure_feat, c2w if c2w_map is None else c2w_map)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        T.track_frame, M.map_scan = track_frame, map_scan
        shutil.rmtree(cfg["data"]["output"], ignore_errors=True)
    return {"c2w": c2w, "track_losses": got["track"][0],
            "map_losses": np.concatenate(got["map"]),
            "levels": {k: {"count": lv.count,
                           "geo": lv.geo[:lv.count].cpu().numpy(),
                           "col": lv.col[:lv.count].cpu().numpy()}
                       for k, lv in slam.npc.levels.items()},
            "decoders": params_to_numpy(params), "steps": steps,
            "caches": caches,
            "launches": dict(_cuda.LAUNCHES)}


def run_lockstep(vis: dict) -> dict:
    """Frame 6 tracked and then mapped (LOCKSTEP_MAP_ITERS iterations) from
    slam_vis's frame-5 checkpoint on the CPU and then on the card in this
    process, on the same draws (a CPU generator, the ids moved to the
    card), each card Adam step from the CPU's parameters and moments of the
    iteration, its union caches the CPU's (after counting the pixels whose
    unions differ), the mapping of both at the CPU's tracked pose.  So the
    card's tracked pose (held within LOCKSTEP_STEP_ATOL all the same) and
    its levels and decoders after the mapping are the CPU's by
    construction; what the card computes is held: its own step of the
    pose at every iteration within LOCKSTEP_STEP_ATOL of the CPU's, both
    loss curves within LOCKSTEP_LOSS_RTOL, the mapping gradient (#3's
    output on the card) leaf by leaf and the own mapping steps as
    adam_steps sets out, #1 launched on the card and #3 on its union
    mapping."""
    import numpy as np
    cpu = lockstep_side(vis, "cpu")
    card = lockstep_side(vis, "cuda", c2w_map=cpu["c2w"], follow=cpu)
    n_track = len(cpu["track_losses"])
    steps = {"track": card["steps"][:n_track],
             "map": card["steps"][n_track:]}

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in tree for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [np.asarray(tree)]

    def worst(records, field, group=lambda k: k):
        out = {}
        for r in records:
            for k, v in r[field].items():
                out[group(k)] = max(out.get(group(k), 0.0), v)
        return out

    dec = lambda k: "dec" if k.startswith("dec.") else k
    geo_grad = [r["grad"]["feat.geo"] for r in steps["map"]]
    out = {
        "frame": LOCKSTEP_FRAME, "map_iters": LOCKSTEP_MAP_ITERS,
        "pose_card": np.asarray(card["c2w"]).tolist(),
        "pose_cpu": np.asarray(cpu["c2w"]).tolist(),
        "pose_abs_max": float(np.abs(card["c2w"] - cpu["c2w"]).max()),
        "track_loss_card": card["track_losses"].tolist(),
        "track_loss_cpu": cpu["track_losses"].tolist(),
        "track_loss_rel_max": rel(card["track_losses"], cpu["track_losses"]),
        "map_loss_card": card["map_losses"].tolist(),
        "map_loss_cpu": cpu["map_losses"].tolist(),
        "map_loss_rel_max": rel(card["map_losses"], cpu["map_losses"]),
        "counts_card": {k: v["count"] for k, v in card["levels"].items()},
        "counts_cpu": {k: v["count"] for k, v in cpu["levels"].items()},
        "feature_abs_max": {
            k: float(max(np.abs(card["levels"][k][f]
                                - cpu["levels"][k][f]).max()
                         for f in ("geo", "col")))
            for k in cpu["levels"]
            if card["levels"][k]["count"] == cpu["levels"][k]["count"]},
        "decoder_abs_max": float(max(
            np.abs(a - b).max() for a, b in zip(leaves(card["decoders"]),
                                                 leaves(cpu["decoders"])))),
        "union_pixels_differing": card["caches"],
        "own_step_abs_max": {k: worst(v, "step") for k, v in steps.items()},
        "grad_rel_max": {k: worst(v, "grad", dec) for k, v in steps.items()},
        "map_geo_grad_rel_median": float(np.median(geo_grad)),
        "map_own_step_excess_max": worst(steps["map"], "own_excess", dec),
        "launches": card["launches"],
        "tolerance": {
            "step_atol": LOCKSTEP_STEP_ATOL, "loss_rtol": LOCKSTEP_LOSS_RTOL,
            "geo_grad_max": LOCKSTEP_GEO_GRAD_MAX,
            "geo_grad_median": LOCKSTEP_GEO_GRAD_MEDIAN,
            "grad_leaf_max": LOCKSTEP_GRAD_LEAF_MAX,
            "own_rtol_atol": [LOCKSTEP_OWN_RTOL, LOCKSTEP_OWN_ATOL],
            "own_grad_share": LOCKSTEP_OWN_GRAD_SHARE}}
    emit({"lockstep_detail": out})
    bad = []
    if not out["pose_abs_max"] <= LOCKSTEP_STEP_ATOL:
        bad.append(f"pose {out['pose_abs_max']}")
    for i, r in enumerate(steps["track"]):
        for k, v in r["step"].items():
            if not v <= LOCKSTEP_STEP_ATOL:
                bad.append(f"tracking step {i} own {k} {v}")
    for k in ("track", "map"):
        if not out[f"{k}_loss_rel_max"] <= LOCKSTEP_LOSS_RTOL:
            bad.append(f"{k} losses {out[f'{k}_loss_rel_max']}")
    for i, r in enumerate(steps["map"]):
        for k, v in r["grad"].items():
            limit = (LOCKSTEP_GEO_GRAD_MAX if k == "feat.geo"
                     else LOCKSTEP_GRAD_LEAF_MAX)
            if not v <= limit:
                bad.append(f"mapping step {i} gradient {k} {v}")
        for k, v in r["own_excess"].items():
            if not v <= LOCKSTEP_OWN_ATOL:
                bad.append(f"mapping step {i} own {k} {v}")
    if not out["map_geo_grad_rel_median"] <= LOCKSTEP_GEO_GRAD_MEDIAN:
        bad.append(f"mapping geometry gradient median "
                   f"{out['map_geo_grad_rel_median']}")
    for k in ("topk_rows", "maploss_bwd"):
        if card["launches"].get(k, 0) <= 0:
            bad.append(f"{k} not launched")
    if bad:
        raise AssertionError(f"lockstep: {bad}")
    return {k: out[k] for k in ("frame", "map_iters", "pose_abs_max",
                                "track_loss_rel_max", "map_loss_rel_max",
                                "own_step_abs_max", "grad_rel_max",
                                "map_geo_grad_rel_median",
                                "map_own_step_excess_max",
                                "union_pixels_differing", "counts_card",
                                "counts_cpu", "feature_abs_max",
                                "decoder_abs_max", "launches")}


def mesh_and_metrics(cfg_path: str, run_out: str, render_every: int,
                     gt_res: int = 60, launched=()) -> dict:
    """repro_quality.sh's steps on the port: the TSDF mesh of the run's
    latest checkpoint through the meshing CLI, the synthetic room's GT mesh,
    the GT culled by the run's poses, and the reconstruction metrics."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch.tools import cull_mesh as CM
    from hpslam_tpu_torch.tools import get_mesh_tsdf_fusion as MT
    from hpslam_tpu_torch.tools import make_synth_gt_mesh as GT
    from hpslam_tpu_torch.tools.eval_recon import eval_recon_3d
    mdir = os.path.join(run_out, "mesh")
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if MT.main([cfg_path, "--output", run_out, "--render_every",
                str(render_every), "--voxel_size", repr(MESH_VOXEL),
                "--no_eval", "-s"]) != 0:
        raise AssertionError("get_mesh_tsdf_fusion failed")
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    with open(os.path.join(mdir, "final_mesh.json")) as f:
        stats = json.load(f)
    gt = os.path.join(mdir, "gt_mesh.ply")
    culled = os.path.join(mdir, "gt_mesh_culled.ply")
    t0 = time.perf_counter()
    GT.main([gt, "--res", str(gt_res)])
    CM.main([cfg_path, gt, "--output", run_out, "--out_mesh", culled])
    t_gt = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = eval_recon_3d(os.path.join(mdir, "final_mesh.ply"), culled)
    out = {"verts": stats["verts"], "faces": stats["faces"],
           "frames_rendered": stats["frames"], "voxel_m": MESH_VOXEL,
           "render_s": stats["render_s"], "fuse_s": stats["fuse_s"],
           "extract_s": stats["extract_s"], "cli_s": t_cli,
           "gt_and_cull_s": t_gt, "eval_s": time.perf_counter() - t0,
           "launches": launches, **metrics}
    for k in launched:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"meshing did not launch {k}")
    if not (out["faces"] > 0 and metrics["accuracy_cm"] < MESH_ACC_MAX_CM):
        raise AssertionError(f"mesh: {out}")
    out["accuracy_max_cm"] = MESH_ACC_MAX_CM
    return out


def run_mesh(vis: dict) -> dict:
    """The mesh of slam_vis's final checkpoint (every 5th frame rendered,
    voxel 5/512) against the culled GT box."""
    return mesh_and_metrics(os.path.join(vis["work"], "smoke.yaml"),
                            os.path.join(vis["work"], "out"), 5,
                            launched=("topk_rows", "trunks_fwd"))


def end_correction_ates(s: dict) -> dict:
    """A kept run's end_correction event and the ATE of its trajectory
    before the correction (its last checkpoint, written before the
    correction) beside the run's ATE after it."""
    from hpslam_tpu_torch.tools.eval_ate import evaluate_trajectory
    from hpslam_tpu_torch.utils.logger import (latest_checkpoint,
                                               load_checkpoint)
    out = os.path.join(s["work"], "out")
    ev = read_events(out, "end_correction")
    state = load_checkpoint(latest_checkpoint(out))
    n = len(state["estimate_c2w_list"])
    before = evaluate_trajectory(state["gt_c2w_list"],
                                 state["estimate_c2w_list"], n - 1,
                                 plot=None, use_alignment=True)
    return {"end_correction": ev,
            "ate_before_correction_m":
                before["absolute_translational_error.rmse"],
            "ate_after_correction_m": s["ate_rmse_m"]}


def run_loop(out_dir: str) -> dict:
    """synth_loop.yaml, all 60 frames, iterations cut (LOOP_CUTS): the end
    correction is applied and lowers the ATE."""
    s, _traj = run_slam(out_dir, "loop", keep=True, max_ate=None)
    try:
        s.update(end_correction_ates(s))
    finally:
        shutil.rmtree(s.pop("work"), ignore_errors=True)
    s["cuts"] = LOOP_CUTS
    ev = s["end_correction"]
    if not (len(ev) == 1 and ev[0]["applied"]
            and s["ate_after_correction_m"] < s["ate_before_correction_m"]):
        raise AssertionError(f"loop: {s}")
    return s


def run_quality(out_dir: str, seeds=QUALITY_SEEDS) -> dict:
    """repro_quality.sh on the port at each of ``seeds``:
    synth_quality.yaml's 120 frames, the mesh (voxel 5/512, every 5th
    frame), the culled GT and the metrics; then synth_loop.yaml uncut,
    with its ATE before and after the end correction.  Reports beside the
    reference's numbers; holds no limit but the mesh's sanity bound."""
    runs = []
    for seed in seeds:
        s, _traj = run_slam(out_dir, "quality", tag=f"_{seed}",
                            spec=(QUALITY_CFG, {}, (), ()), seed=seed,
                            keep=True, max_ate=None)
        try:
            s["mesh"] = mesh_and_metrics(
                os.path.join(s["work"], "smoke.yaml"),
                os.path.join(s["work"], "out"), 5)
        finally:
            shutil.rmtree(s.pop("work"), ignore_errors=True)
        emit({"quality_synth_quality": dict(s, seed=seed)})
        loop, _traj = run_slam(out_dir, "quality_loop", tag=f"_{seed}",
                               spec=(LOOP_CFG, {}, (), ()), seed=seed,
                               keep=True, max_ate=None)
        try:
            loop.update(end_correction_ates(loop))
        finally:
            shutil.rmtree(loop.pop("work"), ignore_errors=True)
        emit({"quality_synth_loop": dict(loop, seed=seed)})
        runs.append({"seed": seed, "synth_quality": s, "synth_loop": loop})
    return {"reference": QUALITY_REFERENCE, "runs": [{
        "seed": r["seed"],
        "ate_cm": 100 * r["synth_quality"]["ate_rmse_m"],
        **{k: r["synth_quality"]["mesh"][k] for k in
           ("accuracy_cm", "completion_cm", "fscore")},
        "loop_ate_cm_before": 100 * r["synth_loop"][
            "ate_before_correction_m"],
        "loop_ate_cm_after": 100 * r["synth_loop"][
            "ate_after_correction_m"],
        "loop_end_correction": r["synth_loop"]["end_correction"]}
        for r in runs]}


# scannet_scale: the benchmark workload (hpslam_tpu_torch/bench.py) at
# bench.py's full sizes; the tile-index narrowing may cost at most this
# much recall@8 against the exact tile selection on the same queries
SCALE_RECALL_LOSS_MAX = 0.01
SCALE_RECALL_QUERIES = 4096


@contextlib.contextmanager
def tapped(module, name: str, before=None, after=None):
    """``module.name`` wrapped for the block: ``before(*args, **kw)`` ahead
    of each call, ``after(result, *args, **kw)`` behind it."""
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        if before is not None:
            before(*a, **kw)
        out = fn(*a, **kw)
        if after is not None:
            after(out, *a, **kw)
        return out
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def recall_at(I, Io, Do) -> float:
    """Share of the exact neighbours (ids Io, distances Do, BIG where
    missing) that the search found (ids I)."""
    from hpslam_tpu_torch.ops import knn as K
    valid = Do < K.BIG
    hit = (Io[:, :, None] == I[:, None, :]).any(-1) & valid
    return float(hit.sum()) / max(int(valid.sum()), 1)


def run_scannet_scale(out_dir: str, profile: bool = False) -> dict:
    """One tracked and one mapped frame of the benchmark workload
    (hpslam_tpu_torch/bench.py) at bench.py's full sizes: per-stage times
    (each stage ended by a synchronisation), peak memory, launches (#1 and
    #3 only), #1 bitwise on rows the run produced (a tile-selection chunk
    of the fine level and the union ranking), #3 against its plain version
    on the run's own packed rows (a geometry and a colour iteration),
    recall@8 of the narrowed tile search against the exact one, finite
    losses, rows outside the compacted sets unchanged, the tracked frame
    repeated bitwise."""
    import torch
    from hpslam_tpu_torch import _cuda
    from hpslam_tpu_torch import bench as B
    from hpslam_tpu_torch.ops import fused_mlp as FM
    from hpslam_tpu_torch.ops import knn as K
    dev = torch.device("cuda")
    s = B.Sizes()
    t0 = time.perf_counter()
    w = B.make_workload(s, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # the tile index of each level, twice (the first call warms up)
    tiles_ms = {}
    for _ in range(2):
        for lv in B.LEVELS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w.indexes[lv] = K.build_tiles(*w.levels[lv][:2])
            torch.cuda.synchronize()
            tiles_ms[lv] = (time.perf_counter() - t0) * 1e3
    T = {lv: w.indexes[lv][1].shape[1] for lv in B.LEVELS}
    nb_fine = T["fine"] // K.NARROW_FACTOR
    n_union = s.window * s.P
    cap: dict = {}

    def take_topk(x, p, k):
        key = ("tile_select" if tuple(x.shape) == (4096, nb_fine) and k == 12
               else "union_rank" if tuple(x.shape) == (n_union, 5 * 8)
               and k == 8 else None)
        if key and key not in cap:
            cap[key] = (x.clone(), None if p is None else p.clone(), k)

    knn_ms: list = []
    clock = {}

    def knn_start(*a, **kw):
        torch.cuda.synchronize()
        clock["t"] = time.perf_counter()

    def knn_end(*a, **kw):
        torch.cuda.synchronize()
        knn_ms.append((time.perf_counter() - clock["t"]) * 1e3)

    def take_queries(q, packed, lo, hi, **kw):
        if lo.shape[1] == T["fine"] and "queries" not in cap:
            cap["queries"] = q[:SCALE_RECALL_QUERIES].clone()

    def take_maploss(*a, need_wgrads=True):
        key = "maploss_colour" if a[9] else "maploss_geometry"
        if key not in cap:
            cap[key] = (tuple(t.detach().clone() if torch.is_tensor(t)
                              else [x.detach().clone() for x in t]
                              if isinstance(t, (list, tuple)) else t
                              for t in a), need_wgrads)

    # the main path: one tracked frame, then one mapped frame
    _cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tapped(K, "topk_rows", before=take_topk), \
            tapped(K, "knn_tiles", before=knn_start, after=knn_end):
        cam, best, track_losses, _ = B.run_track(w, torch.Generator(
            device=dev).manual_seed(0))
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    track_peak = torch.cuda.max_memory_allocated()
    track_launches = dict(_cuda.LAUNCHES)
    # the tracked frame again on the same state (warm, no synchronisation
    # inside): the same bits
    t0 = time.perf_counter()
    again = B.run_track(w, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    if not all(torch.equal(x, y) for x, y in
               zip((cam, best, track_losses), again[:3])):
        raise AssertionError("scannet_scale: the tracked frame does not "
                             "repeat bitwise")
    del again
    before = {lv: (w.levels[lv][2].clone(), w.levels[lv][3].clone())
              for lv in B.LEVELS}
    _cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times: dict = {}
    t0 = time.perf_counter()
    with tapped(K, "topk_rows", before=take_topk), \
            tapped(K, "knn_tiles", before=take_queries), \
            tapped(FM, "nicer_fused_maploss", before=take_maploss):
        mapped = B.run_map(w, torch.Generator(device=dev).manual_seed(1),
                           times)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    map_peak = torch.cuda.max_memory_allocated()
    map_launches = dict(_cuda.LAUNCHES)
    launches = {k: track_launches.get(k, 0) + map_launches.get(k, 0)
                for k, _src, _rep in KERNELS}
    for k, v in launches.items():
        if (v > 0) != (k in ("topk_rows", "maploss_bwd")):
            raise AssertionError(f"scannet_scale: kernel {k} launched {v} "
                                 "times")
    if track_launches.get("maploss_bwd", 0):
        raise AssertionError("scannet_scale: #3 launched by the tracker")

    # finite losses; the rows outside each compacted set keep their bits
    if not bool(torch.isfinite(track_losses).all()):
        raise AssertionError("scannet_scale: tracking losses not finite")
    for lv, m in mapped.items():
        if not bool(torch.isfinite(m["losses"]).all()):
            raise AssertionError(f"scannet_scale: {lv} losses not finite")
        outside = torch.ones(w.levels[lv][0].shape[0], dtype=torch.bool,
                             device=dev)
        uniq = m["uniq"]
        outside[uniq[uniq < outside.numel()]] = False
        for old, new in zip(before[lv], w.levels[lv][2:]):
            if not torch.equal(old[outside], new[outside]):
                raise AssertionError(f"scannet_scale: {lv} rows outside "
                                     "the compacted set changed")
    del before

    # #1 bitwise on the run's own rows, with its times beside torch.topk's
    flush = torch.empty((2 * L2_BYTES // 4,), device=dev)
    blocks = getattr(_cuda.lib("topk_rows"), "hp_topk_blocks_per_sm", None)
    topk = [topk_case(key, *cap[key], flush, blocks)
            for key in ("tile_select", "union_rank")]
    del flush
    # #3 against its plain version on the run's own rows
    maploss = {key: maploss_case(*cap[key], w.mcfg, "scannet_scale #3")[0]
               for key in ("maploss_geometry", "maploss_colour")}
    # the deterministic scatter of the feature-row gather's backward at
    # the colour iteration's ids, beside index_add_ (float atomics)
    from hpslam_tpu_torch.ops import interpolate as IT
    a = cap["maploss_colour"][0]
    o = FM.row_offsets(a[10], a[11])
    ids = K.unpack_ids(a[3][:, o["uids"]:o["uids"] + a[11]]).reshape(-1)
    rows_U = int(mapped["mid"]["uniq"].numel())
    src = torch.randn((ids.numel(), 2 * a[12]), device=dev)
    scatter = {"rows": rows_U, "sources": ids.numel(),
               "ms": cuda_time_ms(lambda: IT.index_add_rows(rows_U, ids,
                                                            src)),
               "index_add_ms": cuda_time_ms(lambda: torch.zeros(
                   (rows_U, src.shape[1]), device=dev).index_add_(
                       0, ids, src))}
    # recall@8 of the fine level's search, narrowed and exact selection
    q = cap["queries"]
    pos, count = w.levels["fine"][:2]
    Do, Io = K.knn(q, pos, count, k=8)
    _, In = K.knn_tiles(q, *w.indexes["fine"], k=8, probe=12)
    narrow_min = K.NARROW_MIN_TILES
    K.NARROW_MIN_TILES = T["fine"] + 1
    try:
        _, Ie = K.knn_tiles(q, *w.indexes["fine"], k=8, probe=12)
    finally:
        K.NARROW_MIN_TILES = narrow_min
    recall = {"queries": int(q.shape[0]), "tiles": T["fine"],
              "narrowed": recall_at(In, Io, Do),
              "exact_selection": recall_at(Ie, Io, Do)}
    if recall["narrowed"] < recall["exact_selection"] \
            - SCALE_RECALL_LOSS_MAX:
        raise AssertionError(f"scannet_scale: recall@8 {recall}")

    stage_ids = {lv: w.schedules[lv][0] for lv in B.LEVELS}
    out = {
        "sizes": dict(dataclasses.asdict(s), tiles=T,
                      map_iters={lv: int(v.size)
                                 for lv, v in stage_ids.items()},
                      geo_iters={lv: int((v == 0).sum())
                                 for lv, v in stage_ids.items()},
                      compacted_rows={lv: int(m["uniq"].numel())
                                      for lv, m in mapped.items()}),
        "setup_s": setup_s, "tile_build_ms": tiles_ms,
        "track": {"ms": track_s * 1e3, "knn_ms": knn_ms,
                  "steps_ms": track_s * 1e3 - sum(knn_ms),
                  "repeat_ms": repeat_s * 1e3, "peak_bytes": track_peak,
                  "launches": track_launches,
                  "loss_first_last": [float(track_losses[0]),
                                      float(track_losses[-1])]},
        "map": {"ms": map_s * 1e3,
                "stage_ms": {k: v * 1e3 for k, v in times.items()},
                "map_scan_ms_per_iter": {
                    lv: times[f"{lv}_map_scan"] * 1e3 / stage_ids[lv].size
                    for lv in B.LEVELS},
                "peak_bytes": map_peak, "launches": map_launches,
                "losses_last": {lv: m["losses"][-1].tolist()
                                for lv, m in mapped.items()}},
        "launches": launches, "topk": topk, "maploss": maploss,
        "scatter": scatter, "recall": recall,
        "tolerance": {"topk": TOPK_TOL, "loss_rtol": LOSS_RTOL,
                      "grad_rel_fro": GRAD_REL_FRO,
                      "grad_elem": [GRAD_ELEM_TOL, GRAD_ELEM_FRAC],
                      "recall_loss_max": SCALE_RECALL_LOSS_MAX}}
    if profile:
        def once():
            t0 = time.perf_counter()
            B.run_track(w, torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            B.run_map(w, torch.Generator(device=dev).manual_seed(1))
            torch.cuda.synchronize()
            return {"track_ms_mean": (t1 - t0) * 1e3,
                    "map_ms_mean": (time.perf_counter() - t1) * 1e3}
        out["profile"] = profile_run(once, "scannet_scale")
    with open(os.path.join(out_dir, "scannet_scale_summary.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    del w, cap, mapped
    torch.cuda.empty_cache()
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
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="the seeds of the band, orbit and quality "
                         "phases (default: BAND_SEEDS, ORBIT_SEEDS, "
                         "QUALITY_SEEDS)")
    ap.add_argument("--band-configs", default=",".join(BAND_CONFIGS),
                    help="the band phase's configs, comma-separated")
    ap.add_argument("--scenario", nargs="+", default=list(ORBIT_SCENARIOS),
                    choices=["synth_tpu", "synth_quality"],
                    help="the orbit phase's orbit_compare.py scenarios")
    ap.add_argument("--route", nargs="+", default=list(ORBIT_ROUTES),
                    choices=["fused", "plain"],
                    help="the orbit phase's orbit_compare.py routes")
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
    for name in SLAM_PHASES:
        if name in phases:
            with phase(name, seconds):
                s, traj = run_slam(out_dir, name, args.profile)
                first_runs[name] = (s, traj)
                for k, v in s["launches"].items():
                    if not launches.get(k):
                        launches[k] = v
                emit(s)
    if "scannet_scale" in phases:
        with phase("scannet_scale", seconds):
            scale = run_scannet_scale(out_dir, args.profile)
            for k, v in scale["launches"].items():
                if not launches.get(k):
                    launches[k] = v
            emit({"scannet_scale": scale})
    vis = None
    served = {}
    try:
        if "slam_vis" in phases:
            with phase("slam_vis", seconds):
                vis, traj_vis = run_slam_vis(out_dir, first_runs)
                if "slam" in first_runs:
                    served["slam"] = ("slam_vis", (vis, traj_vis))
                emit({"slam_vis": {k: v for k, v in vis.items()
                                   if k != "work"}})
        for name, fn in (("resume", lambda: run_resume(vis, traj_vis)),
                         ("mesh", lambda: run_mesh(vis)),
                         ("telemetry", lambda: run_telemetry(vis)),
                         ("points", lambda: run_points(vis)),
                         ("lockstep", lambda: run_lockstep(vis))):
            if name in phases:
                with phase(name, seconds):
                    if vis is None:
                        raise AssertionError(f"{name} needs slam_vis")
                    emit({name: fn()})
    finally:
        if vis is not None:
            shutil.rmtree(vis["work"], ignore_errors=True)
    if "loop" in phases:
        with phase("loop", seconds):
            emit({"loop": run_loop(out_dir)})
    if "repeat" in phases:
        with phase("repeat", seconds):
            emit({"repeat": run_repeat(out_dir, first_runs, served)})
    if "band" in phases:
        with phase("band", seconds):
            emit({"band": run_band(
                out_dir, args.seeds or BAND_SEEDS,
                args.band_configs.split(","))})
    if "orbit" in phases:
        with phase("orbit", seconds):
            emit({"orbit": run_orbit(out_dir, args.seeds or ORBIT_SEEDS,
                                     args.scenario, args.route)})
    if "quality" in phases:
        with phase("quality", seconds):
            emit({"quality": run_quality(out_dir,
                                         args.seeds or QUALITY_SEEDS)})
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
                             "library_ms": r.get("library_ms"),
                             "bf16_ms": r.get("bf16_ms")})
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
