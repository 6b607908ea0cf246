"""catnerf_torch — the PyTorch/CUDA port of catnerf_tpu.

The JAX package `catnerf_tpu` beside it is the reference. This package
imports torch and numpy only: never jax, and never a module of
catnerf_tpu; it keeps its own copy of the host code it needs.

Layer map (the JAX package's sub-package layout):
  config    — scene configuration (a copy)
  data      — scenes, ray buffers, the device ray store
  models    — parameter modules and initialisers (CodeNeRF, OccupancyMap)
  ops       — 3D sampling, rendering math, losses
  kernels   — hand-written CUDA kernels for Hopper with plain versions
  csrc      — the CUDA C++ sources those kernels build from
  train     — the training step, optimizer, session and CLI
"""

__version__ = "0.1.0"
