"""map_iter_ms: The mapper's span over the joint iterations it ran (its own
n_joint_iters), ms per iteration."""


def read(ctx):
    t = ctx.totals()
    if t["map_iters"] == 0:
        return None
    return 1e3 * t["map_s"] / t["map_iters"]
