"""Polynomials: NTT/FFT over limb tensors, tensor helpers."""

from .polynomial import field_sum  # noqa: F401
from . import ntt  # noqa: F401
