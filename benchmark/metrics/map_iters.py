"""map_iters: Mean joint iterations per mapped frame (the mapper's
n_joint_iters): the amount of mapping work, so that a change in work can
be told apart from a change in speed."""


def read(ctx):
    t = ctx.totals()
    if t["n_mapped"] == 0:
        return None
    return t["map_iters"] / t["n_mapped"]
