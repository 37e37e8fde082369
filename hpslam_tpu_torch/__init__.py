"""hpslam_tpu_torch — the PyTorch / CUDA port of hpslam_tpu for NVIDIA H100s.

The JAX package ``hpslam_tpu`` is the reference; this package reproduces its
SLAM loop (tracking every frame, union-path mapping every
``mapping.every_frame``-th frame, ATE evaluation) in PyTorch, on one device
or dp-sharded over a ``torch.distributed`` mesh, with every Pallas kernel
replaced by a hand-written CUDA kernel (``csrc/``, built by ``_cuda``).  It
imports neither ``jax`` nor anything of ``hpslam_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version.

Layers (as in hpslam_tpu):
  ops/       geometry, sampling, compositor, Adam, kNN (+ row-top-k kernel),
             interpolation, the fused decoder kernels (fused_mlp)
  parallel/  the dp x tp mesh, its collectives, tensor-parallel kNN
  state.py   fixed-capacity two-level point store
  models/    NICER decoders (dict-of-tensors parameters)
  renderer   depth-guided volume renderer
  tracker / mapper   per-frame optimisation loops
  slam.py    orchestrator; run.py the CLI
"""

__version__ = "0.1.0"
