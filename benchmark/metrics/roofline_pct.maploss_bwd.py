"""roofline_pct.maploss_bwd: The union mapping loss with its backward
(kernel #3: ops/fused_mlp.py, csrc/maploss.cu) against its roofline over
the traced mapping period: the least time of the iterations the mapped
frames ran (rays x samples x union slots x trunk widths, geometry or
colour stage, work.maploss_work) over the device time of #3's kernels."""

from benchmark import work

NAMES = ("ml_fwd_tiles", "ml_rays", "ml_bwd_tiles", "ml_union_bwd",
         "loss_reduce", "wg_tc_partial", "wg_tc_reduce")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.device_time(lambda n: any(k in n for k in NAMES))
    if t <= 0:
        return None
    cfg = ctx.cfg
    m = cfg["mapping"]
    w = work.widths(cfg)
    n = int(m["pixels"])
    S = int(cfg["rendering"]["N_surface"])
    u = int(m.get("union_size", 8))
    wg = not m["fix_color_decoder"]
    least = 0.0
    for idx in ctx.traced_frames():
        iters = ctx.frames[idx].get("map_iters")
        if not iters:
            continue
        n_geo, n_col = work.stage_counts(cfg, iters, idx == 0)
        for with_color, cnt in ((False, n_geo), (True, n_col)):
            least += cnt * work.bound_s(*work.maploss_work(
                w, n, S, u, with_color, True, wg))
    if least <= 0:
        return None
    return 100.0 * least / t
