"""Field facade: one object per prime field bundling the host (exact int)
path and the tensor path.

Counterpart of ``lambda_elliptic_curves_tpu/fields/field.py``.  On a device
there are no element objects, only ``(8, *batch)`` int32 limb tensors in
Montgomery form (layout: :mod:`..ops.limbs`); the arithmetic runs the field
kernel on a CUDA tensor and the plain version on a CPU tensor.  Every
constructor takes an explicit ``device``.

The limb layout and the kernels are Stark252's, so only 256-bit-R fields
with that modulus are accepted (the other fields are ROADMAP queue 1
item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from .element import FieldElement
from .params import FieldParams
from ..ops import limbs


class PrimeField:
    """A prime field F_p with batched tensor arithmetic.

    Device representation: ``(8, *batch)`` int32 limbs of x*R mod p,
    R = 2^256.  Host representation: Python ints via :class:`FieldElement`.
    """

    def __init__(self, params: FieldParams):
        if params.p != limbs.P or params.r != limbs.R:
            raise NotImplementedError(
                f"{params.name}: the port has Stark252 limb kernels only "
                "(other fields: ROADMAP queue 1 item 8)")
        self.params = params

    # -- identity ---------------------------------------------------------
    @property
    def name(self):
        return self.params.name

    @property
    def p(self):
        return self.params.p

    def __repr__(self):
        return f"PrimeField({self.params.name})"

    def __eq__(self, other):
        return isinstance(other, PrimeField) and other.params.p == self.params.p

    def __hash__(self):
        return hash((self.params.name, self.params.p))

    # -- host elements ------------------------------------------------------
    def __call__(self, value) -> FieldElement:
        """Construct a host element from int / hex string / FieldElement."""
        if isinstance(value, FieldElement):
            if value.field is not self and value.field.p != self.p:
                raise ValueError("element from a different field")
            return FieldElement(self, value.value)
        if isinstance(value, str):
            value = int(value, 16)
        return FieldElement(self, int(value) % self.params.p)

    def zero(self) -> FieldElement:
        return FieldElement(self, 0)

    def one(self) -> FieldElement:
        return FieldElement(self, 1)

    # host-level ops used by FieldElement
    host_add = property(lambda self: self.params.add)
    host_sub = property(lambda self: self.params.sub)
    host_mul = property(lambda self: self.params.mul)
    host_neg = property(lambda self: self.params.neg)
    host_inv = property(lambda self: self.params.inv)
    host_pow = property(lambda self: self.params.pow)

    # -- tensor constructors --------------------------------------------------
    def array(self, values, device) -> torch.Tensor:
        """Host values (ints / FieldElements, nested lists ok) to a limb
        tensor in Montgomery form on ``device``."""
        vals = _as_int_array(values)
        return limbs.to_mont(limbs.ints_to_limbs(vals, device))

    def to_ints(self, arr: torch.Tensor) -> np.ndarray:
        """Montgomery limb tensor -> object ndarray of canonical Python ints."""
        return limbs.limbs_to_ints(limbs.from_mont(arr))

    def constant(self, value, batch_shape, device) -> torch.Tensor:
        """Montgomery-form constant broadcast over a batch shape (a view)."""
        if isinstance(value, FieldElement):
            value = value.value
        mont = (int(value) * self.params.r) % self.params.p
        return limbs.const_limbs(mont, batch_shape, device)

    def zeros(self, batch_shape, device) -> torch.Tensor:
        return torch.zeros((limbs.LIMBS,) + tuple(batch_shape), dtype=torch.int32,
                           device=device)

    def ones(self, batch_shape, device) -> torch.Tensor:
        return self.constant(1, batch_shape, device).contiguous()

    # -- tensor arithmetic ----------------------------------------------------
    def add(self, a, b):
        return limbs.add(a, b)

    def sub(self, a, b):
        return limbs.sub(a, b)

    def neg(self, a):
        return limbs.neg(a)

    def mul(self, a, b):
        return limbs.mont_mul(a, b)

    def square(self, a):
        return limbs.square(a)

    def pow(self, a, exponent: int):
        return limbs.mont_pow(a, int(exponent))

    def inv(self, a):
        return limbs.mont_inv(a)

    def batch_inverse(self, a):
        return limbs.batch_inverse(a)

    def is_zero(self, a):
        return limbs.is_zero(a)

    def equal(self, a, b):
        return limbs.equal(a, b)

    def select(self, cond, a, b):
        return limbs.select(cond, a, b)

    # -- FFT data -------------------------------------------------------------
    @property
    def two_adicity(self):
        return self.params.two_adicity

    def primitive_root_of_unity(self, order: int) -> FieldElement:
        return FieldElement(self, self.params.primitive_root_of_unity(order))


def _as_int_array(values):
    """Normalize nested lists of ints/FieldElements to an object ndarray."""
    def conv(v):
        if isinstance(v, FieldElement):
            return v.value
        return int(v)

    arr = np.asarray(values, dtype=object)
    return np.vectorize(conv, otypes=[object])(arr) if arr.size else arr
