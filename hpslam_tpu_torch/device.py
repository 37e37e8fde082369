"""Device selection: the port runs on CUDA unless asked for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA request without a card raises; the
    CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hpslam_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' (--device cpu) to run on "
                "the CPU")
        # the reference's geometry runs at full f32 precision
        # (Precision.HIGHEST); keep TF32 off for matmuls and convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
