"""Command-line entry point of the port (mirrors the repository's run.py):

    python -m hpslam_tpu_torch.run configs/Synthetic/synth_tpu.yaml \
        [--output DIR] [--device cuda|cpu] [--mesh dp1]

``--mesh dp1`` runs the dp-mesh path in one process on one card; N cards
take one process each:

    torchrun --nproc_per_node N -m hpslam_tpu_torch.run CONFIG --mesh dpN
"""
from __future__ import annotations

import os
import sys

import numpy as np


def run(argv=None):
    """Parse the arguments, run the SLAM loop; returns (ATE results,
    summary)."""
    from . import config as C
    from .slam import PointSLAM

    args = C.build_arg_parser().parse_args(argv)
    cfg = C.load_config(args.config, C.default_config_path())
    cfg = C.apply_args(cfg, args)
    np.random.seed(cfg.get("seed", 1219))
    slam = PointSLAM(cfg, args, device=args.device)
    if slam.verbose:
        print(f"INFO: output folder is {slam.output}", flush=True)
    return slam.run()


def main(argv=None) -> int:
    results, summary = run(argv)
    # under a mesh every rank holds the same results; rank 0 prints them
    if int(os.environ.get("RANK", 0)) == 0:
        print("summary:", summary)
        print("ate_rmse:", results["absolute_translational_error.rmse"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
