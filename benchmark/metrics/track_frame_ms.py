"""track_frame_ms: The tracker's span per frame tracked (ms), each call
ended by a device synchronise: ``track_ms``'s quantity, read per layer in
the cells whose host spreads it too widely for an end-to-end bound."""


def read(ctx):
    t = ctx.totals()
    if t["n_tracked"] == 0:
        return None
    return 1e3 * t["track_s"] / t["n_tracked"]
