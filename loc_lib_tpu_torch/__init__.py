"""loc_lib_tpu_torch: the PyTorch + CUDA port of loc_lib_tpu.

Mirrors the JAX package module for module (same relative paths), runs on
one NVIDIA H100, and carries hand-written Hopper kernels for the fused
scan-matching linearizations under `csrc/` (bound in `ops/kernels.py`).
The JAX package `loc_lib_tpu` stays the reference every module is held
against; this package imports neither it nor jax.
"""

import torch as _torch

# SLAM solvers depend on fp32-true linear algebra: residuals are metre-scale
# values at ~70 m range, so TF32 products (~2^-11 relative) would inject
# centimetre-level noise into every Gauss-Newton step. Mirrors the JAX
# package's "highest" matmul precision pin.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
