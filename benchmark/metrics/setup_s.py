"""setup_s: Time to the first frame of the window (s), from process start:
loading the program and its kernels, rendering the frames, building
PointSLAM, frames 0-1 and the tracker's warm-up."""


def read(ctx):
    return ctx.setup_s
