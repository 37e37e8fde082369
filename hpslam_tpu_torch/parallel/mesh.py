"""Device mesh for the dp-sharded engines (port of
hpslam_tpu/parallel/mesh.py) on ``torch.distributed``.

The reference pins each per-ray batch's leading axis onto the mesh's
``dp`` axis and lets GSPMD partition the per-ray work and insert the
gradient and loss sums.  Here the program is SPMD by hand, one process per
rank: every rank draws the same full batch (the same seeds), keeps its dp
slice (``shard_batch``), and the engines take every whole-batch reduction
and gradient sum with the explicit collectives below over the dp group
(``all_reduce_sum``, ``all_gather_rows``).  NCCL's and gloo's all-reduce
sum in a fixed order for a fixed world size, so a dp run repeats.  ``tp``
shards the point cloud by capacity for the tensor-parallel kNN
(``knn_tp``).

A world of one runs in one plain process: when no process group is open,
``make_mesh`` opens a world-1 group on an in-process store (``Mesh.close``
destroys it).  dp > 1 runs one process per rank: under ``torchrun``, one
card each (NCCL; rank r uses ``cuda:<LOCAL_RANK>``), or CPU processes
(gloo).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


class Mesh:
    """A dp x tp ``DeviceMesh`` with dims ("dp", "tp"): its process groups
    and this rank's coordinate on each axis."""

    def __init__(self, device_mesh, owns_group: bool = False):
        self.device_mesh = device_mesh
        self.shape = {"dp": device_mesh.size(0), "tp": device_mesh.size(1)}
        self.dp, self.tp = self.shape["dp"], self.shape["tp"]
        self.dp_group = device_mesh.get_group("dp")
        self.tp_group = device_mesh.get_group("tp")
        self.dp_rank = device_mesh.get_local_rank("dp")
        self.tp_rank = device_mesh.get_local_rank("tp")
        self.owns_group = owns_group

    @property
    def is_main(self) -> bool:
        """Rank 0 of the world: the one process that writes outputs."""
        return dist.get_rank() == 0

    def close(self) -> None:
        """Destroy the process group if make_mesh opened it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def local_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` under torchrun, the CPU
    for gloo ranks."""
    if device_type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device(device_type)


def _ensure_group(device_type: str, n: int) -> bool:
    """Open the default process group if none is open: from torchrun's
    environment, or, for a mesh of one device, a world of one on an
    in-process store.  Returns whether it opened one."""
    if dist.is_initialized():
        return False
    dev = local_device(device_type)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kw)
    elif n == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        raise ValueError(f"a mesh of {n} devices needs one process per "
                         "device (torchrun, or an open process group)")
    return True


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int = 1, device_type: str = "cuda") -> Mesh:
    """A dp x tp mesh over every process of the world (one device each),
    opening the process group if none is open (``_ensure_group``)."""
    owns = _ensure_group(device_type, n_devices or (dp or 1) * tp)
    try:
        world = dist.get_world_size()
        n = world if n_devices is None else n_devices
        if dp is None:
            dp = n // tp
        if dp * tp != n:
            raise ValueError(f"mesh {dp}x{tp} != {n} devices")
        if n != world:
            raise ValueError(f"mesh of {n} devices in a world of {world} "
                             "processes: the mesh spans the whole world")
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(device_type, (dp, tp),
                              mesh_dim_names=("dp", "tp"))
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise
    return Mesh(dm, owns_group=owns)


def parse_mesh_spec(spec, device_type: str = "cuda") -> Mesh | None:
    """Build a mesh from a config / CLI spec, with the reference's grammar:
    ``None`` / '' / 'none' / 0 (no mesh, the single-device program), an
    int-like ('8') for pure dp, or 'dp4,tp2' / 'dp4' axis lists.  The
    product must not exceed the world size (one process per device)."""
    if spec in (None, "", "none", "None", 0, "0"):
        return None
    dp = tp = None
    if isinstance(spec, int) or (isinstance(spec, str) and spec.isdigit()):
        dp, tp = int(spec), 1
    else:
        for part in str(spec).split(","):
            part = part.strip()
            if part.startswith("dp"):
                dp = int(part[2:])
            elif part.startswith("tp"):
                tp = int(part[2:])
            else:
                raise ValueError(f"bad mesh axis {part!r} in {spec!r}")
        tp = tp or 1
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if dp is None:
        dp = world // tp
    n = dp * tp
    if n > world:
        raise ValueError(
            f"mesh {spec!r} needs {n} devices, have {world}")
    return make_mesh(n, dp=dp, tp=tp, device_type=device_type)


def shard_bounds(n: int, parts: int, i: int) -> tuple:
    """Rows [lo, hi) of part i when n rows are cut into ``parts``
    contiguous blocks of near-equal size."""
    return n * i // parts, n * (i + 1) // parts


def shard_batch(mesh: Mesh | None, *ts):
    """This rank's dp slice of each tensor's leading axis (all of the same
    length).  No-op when ``mesh`` is None, so the single-device programs
    stay as they are."""
    if mesh is None:
        return ts if len(ts) > 1 else ts[0]
    out = []
    for t in ts:
        if t is None:
            out.append(None)
            continue
        lo, hi = shard_bounds(t.shape[0], mesh.dp, mesh.dp_rank)
        out.append(t[lo:hi])
    return tuple(out) if len(out) > 1 else out[0]


def all_reduce_sum(mesh: Mesh | None, *ts):
    """Sum each tensor over the dp group (one collective for all of them,
    through one flat buffer); returns new tensors.  Identity without a
    mesh."""
    if mesh is None:
        return ts if len(ts) > 1 else ts[0]
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=mesh.dp_group)
    out, o = [], 0
    for t in ts:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return tuple(out) if len(out) > 1 else out[0]


def all_reduce_grads(mesh: Mesh, grads, leaves, *extra):
    """``torch.autograd.grad``'s gradients (None as zero) and ``extra``
    tensors summed over the dp group in one collective: (grads list,
    *extra)."""
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    out = all_reduce_sum(mesh, *grads, *extra)
    return (list(out[:len(grads)]), *out[len(grads):])


def all_gather_rows(mesh: Mesh | None, t, n: int, axis: str = "dp"):
    """Concatenate every rank's ``shard_batch`` slice of an n-row batch
    back into the n rows, in rank order, over the ``axis`` group.
    Identity without a mesh."""
    if mesh is None:
        return t
    parts = mesh.shape[axis]
    group = mesh.dp_group if axis == "dp" else mesh.tp_group
    m = -(-n // parts)
    pad = torch.zeros((m - t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    buf = [torch.empty((m,) + tuple(t.shape[1:]), dtype=t.dtype,
                       device=t.device) for _ in range(parts)]
    dist.all_gather(buf, torch.cat([t, pad]), group=group)
    rows = [b[:hi - lo] for b, (lo, hi) in zip(
        buf, (shard_bounds(n, parts, i) for i in range(parts)))]
    return torch.cat(rows)
