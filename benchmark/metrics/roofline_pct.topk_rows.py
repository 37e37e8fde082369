"""roofline_pct.topk_rows: Kernel #1 (ops/knn.py, csrc/topk_rows.cu)
against its roofline over the traced mapping period: the least time of
every row top-k the period asked for (bytes of its rows, payload and
outputs over 3.35 TB/s, or its comparisons over 67 TFLOP/s, whichever is
larger), over the device time of the kernels named topk_rows."""

from benchmark import work


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.topk_calls:
        return None
    t = tr.device_time(lambda n: "topk_rows" in n)
    if t <= 0:
        return None
    least = sum(work.bound_s(*work.topk_work(n, C, k, p))
                for n, C, k, p in ctx.topk_calls)
    return 100.0 * least / t
