"""map_ms: How fresh the map is (ms): total mapping time (insertion through
write- back, synchronised) over the frames mapped."""


def read(ctx):
    t = ctx.totals()
    if t["n_mapped"] == 0:
        return None
    return 1e3 * t["map_s"] / t["n_mapped"]
