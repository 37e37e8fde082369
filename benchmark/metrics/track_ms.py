"""track_ms: The latency of a pose (ms): total tracking time, each call
ended by a device synchronise, over the frames tracked."""


def read(ctx):
    t = ctx.totals()
    if t["n_tracked"] == 0:
        return None
    return 1e3 * t["track_s"] / t["n_tracked"]
