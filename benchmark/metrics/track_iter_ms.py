"""track_iter_ms: The tracker's span over the tracking iterations the
configuration runs (ms per iteration)."""


def read(ctx):
    t = ctx.totals()
    iters = int(ctx.cfg["tracking"]["iters"])
    if t["n_tracked"] == 0 or iters == 0:
        return None
    return 1e3 * t["track_s"] / (t["n_tracked"] * iters)
