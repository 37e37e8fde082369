"""device_idle_pct: 100 x (1 - union of the device's operation intervals /
the traced wall time), over the traced mapping period."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
