"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  With
``--trace 0`` the line's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a device trace of the
window's first mapping period and from host spans.  The check's numbers,
each beside its limit, are the last lines on standard error and the last
key of the line.  Needs a CUDA device; exits non-zero and prints no line
without one, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys



def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import guard, harness
    harness.set_cache_dirs(os.getcwd())
    if not os.path.exists("BENCHMARK.json"):
        print("BENCHMARK.json not found in the working directory",
              file=sys.stderr)
        return 2
    import torch
    from .registry import Registry
    reg = Registry()
    chips = int(reg.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(args, "cuda", reg)
    bad = guard.offending()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
