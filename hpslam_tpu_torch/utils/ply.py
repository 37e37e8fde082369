"""Point-cloud PLY writer (the port's own copy of hpslam_tpu/utils/ply.py's
write_ply_points)."""
from __future__ import annotations

import numpy as np


def write_ply_points(path: str, points: np.ndarray,
                     colors: np.ndarray | None = None):
    """Binary little-endian point-cloud PLY; colors in [0,1]."""
    n = points.shape[0]
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + props + ["end_header", ""])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            c = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
            rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]
            f.write(rec.tobytes())
