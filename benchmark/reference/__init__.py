"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch route (no CUDA kernel, no program import), float32 with TF32 off,
that ``benchmark.check`` runs from the program's snapshots.  The control
sets ``decoder.PRECISION`` to "tf32"."""
