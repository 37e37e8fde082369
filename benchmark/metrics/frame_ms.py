"""frame_ms: GPU time paid per frame of a scan (ms/frame). (window time -
mapping time) / frames tracked + (mapping time / frames mapped) /
mapping.every_frame: the amortised cost of a frame whatever mix of
mapped and plain frames the window caught."""


def read(ctx):
    t = ctx.totals()
    if t["n_tracked"] == 0 or t["n_mapped"] == 0:
        return None
    every = int(ctx.cfg["mapping"]["every_frame"])
    return 1e3 * ((t["window_s"] - t["map_s"]) / t["n_tracked"]
                  + t["map_s"] / t["n_mapped"] / every)
