"""Convert the reference's pretrained ConvONet geometry checkpoint
(``pretrained/middle_fine.pt``, torch) into the .npz that
``slam.PointSLAM.load_pretrain`` reads (port of
hpslam_tpu/tools/convert_pretrained.py).

The checkpoint's 'coarse' decoder weights go into BOTH geometry decoders
(the reference, Point_SLAM.py:237-260).  Keys map as:

    model.decoder.coarse.pts_linears.{i}.weight -> pts_linears.{i}.w (T)
    model.decoder.coarse.fc_c.{i}.weight        -> fc_c.{i}.w (T)
    model.decoder.coarse.output_linear.weight   -> output_linear.w (T)
    (embedder._B if present)                    -> embedder.B

The checkpoint is read with ``torch.load(..., weights_only=True)``: a
state dict of tensors loads so, and a file that needs arbitrary unpickling
is refused (the reference unpickles without that guard).

Usage: python -m hpslam_tpu_torch.tools.convert_pretrained middle_fine.pt
       out.npz
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def convert(in_path: str, out_path: str) -> dict:
    ckpt = torch.load(in_path, map_location="cpu", weights_only=True)
    model = ckpt.get("model", ckpt)
    prefix = None
    for key in model.keys():
        if "decoder" in key and "coarse" in key and "encoder" not in key:
            prefix = key.split("coarse")[0] + "coarse."
            break
    if prefix is None:
        raise ValueError("no coarse decoder keys found in checkpoint")
    out = {}
    for key, val in model.items():
        if not key.startswith(prefix):
            continue
        sub = key[len(prefix):]
        arr = val.detach().numpy()
        if sub.endswith(".weight"):
            out[sub[:-7] + ".w"] = arr.T  # torch Linear stores (out, in)
        elif sub.endswith(".bias"):
            out[sub[:-5] + ".b"] = arr
        elif sub.endswith("_B") or sub.endswith(".B"):
            out["embedder.B"] = arr
    np.savez(out_path, **out)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("torch_ckpt")
    p.add_argument("out_npz")
    args = p.parse_args(argv)
    out = convert(args.torch_ckpt, args.out_npz)
    print(f"wrote {args.out_npz} with {len(out)} arrays:",
          sorted(out.keys()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
