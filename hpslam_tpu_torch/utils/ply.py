"""PLY point-cloud and triangle-mesh writers and a reader (the port's own
copy of hpslam_tpu/utils/ply.py)."""
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


def write_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
                   vertex_colors: np.ndarray | None = None):
    """Binary little-endian triangle-mesh PLY; colors in [0,1]."""
    nv, nf = vertices.shape[0], faces.shape[0]
    props = ["property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {nv}"] + props +
        [f"element face {nf}", "property list uchar int vertex_indices",
         "end_header", ""])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if vertex_colors is None:
            f.write(vertices.astype("<f4").tobytes())
        else:
            c = np.clip(vertex_colors * 255.0, 0, 255).astype(np.uint8)
            rec = np.zeros(nv, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                      ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = vertices.T
            rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]
            f.write(rec.tobytes())
        frec = np.zeros(nf, dtype=[("n", "u1"), ("i", "<i4", (3,))])
        frec["n"] = 3
        frec["i"] = faces.astype(np.int32)
        f.write(frec.tobytes())


def read_ply(path: str):
    """Read a PLY written by this module (or ascii/binary_le with x,y,z
    floats [+ rgb uchar] and optional int vertex_indices faces).

    Returns (vertices (N,3) f32, colors (N,3) f32 in [0,1] or None,
    faces (M,3) i32 or None).
    """
    with open(path, "rb") as f:
        # header
        line = f.readline().strip()
        assert line == b"ply", "not a ply file"
        fmt = None
        elems = []  # (name, count, props)
        cur = None
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.split()
            if parts[0] == b"format":
                fmt = parts[1].decode()
            elif parts[0] == b"element":
                cur = (parts[1].decode(), int(parts[2]), [])
                elems.append(cur)
            elif parts[0] == b"property":
                cur[2].append([p.decode() for p in parts[1:]])

        verts = colors = faces = None
        for name, count, props in elems:
            if name == "vertex":
                dt = []
                for p in props:
                    typ = {"float": "<f4", "float32": "<f4", "uchar": "u1",
                           "uint8": "u1", "double": "<f8"}[p[0]]
                    dt.append((p[1], typ))
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.array(rows, dtype=np.float64)
                    verts = arr[:, :3].astype(np.float32)
                    if arr.shape[1] >= 6:
                        colors = (arr[:, 3:6] / 255.0).astype(np.float32)
                else:
                    rec = np.frombuffer(f.read(np.dtype(dt).itemsize * count),
                                        dtype=dt)
                    verts = np.stack([rec["x"], rec["y"], rec["z"]],
                                     -1).astype(np.float32)
                    names = [d[0] for d in dt]
                    if "red" in names:
                        colors = np.stack(
                            [rec["red"], rec["green"], rec["blue"]],
                            -1).astype(np.float32) / 255.0
            elif name == "face":
                if fmt == "ascii":
                    rows = [list(map(int, f.readline().split()))
                            for _ in range(count)]
                    faces = np.array([r[1:4] for r in rows], np.int32)
                else:
                    frec = np.frombuffer(
                        f.read((1 + 12) * count),
                        dtype=[("n", "u1"), ("i", "<i4", (3,))])
                    faces = frec["i"].astype(np.int32)
    return verts, colors, faces
