"""lambda_elliptic_curves_tpu_torch — the PyTorch / CUDA port of
lambda_elliptic_curves_tpu for NVIDIA Hopper.

It mirrors the JAX package's module paths and names.  Bulk data is
``(8, *batch)`` int32 limb tensors (Stark252, Montgomery form with
R = 2^256, the JAX package's bits), always on an explicit device: a CUDA
tensor runs the hand-written kernels of ``csrc/`` (built at first use), a
CPU tensor runs their plain PyTorch versions.  The package never imports
jax.
"""

__version__ = "0.1.0"

from . import fields  # noqa: F401
from .fields import Stark252  # noqa: F401
