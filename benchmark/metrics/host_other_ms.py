"""host_other_ms: Window time outside the tracker's and the mapper's spans
(the orchestrator's own work: pose bookkeeping, radii for keyframes,
keyframe registration, frame hand-over), over the frames tracked
(ms/frame)."""


def read(ctx):
    t = ctx.totals()
    if t["n_tracked"] == 0:
        return None
    return 1e3 * (t["window_s"] - t["track_s_all"] - t["map_s"]) \
        / t["n_tracked"]
