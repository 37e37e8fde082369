"""points_added: Mean point locations inserted per mapped frame (the
mapper's frame_pts_add, fine level)."""


def read(ctx):
    t = ctx.totals()
    if t["n_mapped"] == 0:
        return None
    return t["points_added"] / t["n_mapped"]
