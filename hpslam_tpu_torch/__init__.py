"""hpslam_tpu_torch — the PyTorch / CUDA port of hpslam_tpu for one NVIDIA H100.

The JAX package ``hpslam_tpu`` is the reference; this package reproduces its
default single-device SLAM loop (tracking every frame, union-path mapping
every ``mapping.every_frame``-th frame, ATE evaluation) in PyTorch, with the
Pallas kernels on that path replaced by hand-written CUDA kernels
(``csrc/``, built by ``_cuda``).  It imports neither ``jax`` nor anything of
``hpslam_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version.

Layers (as in hpslam_tpu):
  ops/       geometry, sampling, compositor, Adam, kNN (+ row-top-k kernel),
             interpolation, mapping loss (+ its kernel pair)
  state.py   fixed-capacity two-level point store
  models/    NICER decoders (dict-of-tensors parameters)
  renderer   depth-guided volume renderer
  tracker / mapper   per-frame optimisation loops
  slam.py    orchestrator; run.py the CLI
"""

__version__ = "0.1.0"
