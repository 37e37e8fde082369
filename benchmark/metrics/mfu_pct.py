"""mfu_pct: The decoders' operations in the window (forward and backward,
tracking and mapping), counted from the model's widths and the
configuration's pixels, rays, samples and neighbours (work.frame_flops),
over window time x 67 TFLOP/s (float32, the configuration's precision)."""

from benchmark import work


def read(ctx):
    t = ctx.totals()
    if t["window_s"] <= 0 or t["n_tracked"] == 0:
        return None
    flops = 0.0
    for idx, rec in ctx.frames.items():
        if rec.get("tracked"):
            flops += work.track_frame_flops(ctx.cfg)
        if rec.get("map_iters"):
            flops += work.map_frame_flops(ctx.cfg, rec["map_iters"],
                                          idx == 0)
    return 100.0 * flops / (t["window_s"] * work.F32_FLOPS)
