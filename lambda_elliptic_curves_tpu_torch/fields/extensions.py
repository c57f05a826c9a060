"""Quadratic field extensions and towers of them: the host tower and the
batched tensor tower.

Counterpart of ``lambda_elliptic_curves_tpu/fields/extensions.py``
(``ExtensionField`` :25, ``DeviceQuadraticField`` :333; parity
``QuadraticExtensionField``, ``math/src/field/extensions/quadratic.rs:12``,
and the BabyBear quartic ``fft_friendly/quartic_babybear.rs``).  The host
tower also takes cubic extensions (``degree=3``), as BN254's Fp6 needs.

Host representation: an extension element is a tuple of base-field values
(recursively: ints at the leaves).  Tensor representation: a batch of a
degree-D tower over a prime field with L-limb values is one ``(D L,
*batch)`` int32 tensor, components depth-first (component 0's limbs
first), so axis 0 stays "the limbs" as for a :class:`PrimeField`.

On a CUDA tensor every op of a tower that kernel 6 carries (Goldilocks or
BabyBear at the bottom, level-2 non-residue u) is one launch of
``csrc/small_field.cu``: product, square, power and inverse of E included.
A tower that no kernel carries, such as a quadratic extension of a dense
field (BN254 Fq, BLS12-377 Fq: the G2 coordinates; ``tower_kernel`` of the
field's arithmetic says which), composes its base field's ops on any device, as the JAX
package's ``DeviceQuadraticField`` (``fields/extensions.py:333``) does, so on
a card each of them is a launch of kernel 8 (``csrc/dense_field.cu``) or 9:
an E product is one base product over the three Karatsuba operands at
once, the two sums before it, two differences, the non-residue's product
and a sum (7 launches). On a CPU tensor the ops compose the base field's
plain ops.
"""

from __future__ import annotations

import torch

from ..ops.small import _OP_ADD, _OP_INV, _OP_MUL, _OP_NEG, _OP_POW, _OP_SQUARE, _OP_SUB
from ..utils.errors import ZeroInverseError
from .element import FieldElement


def flat_components(value, degree: int) -> list:
    """Nested component tuple (or int) -> flat list of D base ints,
    depth-first, as the flat tensor layout."""
    if degree == 1:
        return [int(value)]
    if not isinstance(value, tuple):
        return [int(value)] + [0] * (degree - 1)
    half = degree // 2
    return flat_components(value[0], half) + flat_components(value[1], half)


def nest_components(flat, degree: int):
    """Flat list of D base ints -> nested tuple for the host tower."""
    if degree == 1:
        return flat[0]
    half = degree // 2
    return (nest_components(flat[:half], half), nest_components(flat[half:], half))


class ExtensionField:
    """Host extension field of degree 2 or 3 over ``base`` (a PrimeField or
    an ExtensionField) with defining polynomial x^degree = non_residue (a
    value of ``base``)."""

    def __init__(self, name, base, non_residue, degree: int = 2):
        if degree not in (2, 3):
            raise ValueError("extensions of degree 2 or 3 only")
        self.name = name
        self.base = base
        self.non_residue = non_residue
        self.degree = degree

    @property
    def p(self):
        return self.base.p

    def __repr__(self):
        return f"ExtensionField({self.name})"

    # -- construction -------------------------------------------------------
    def __call__(self, value) -> FieldElement:
        return FieldElement(self, self._coerce(value))

    def _base_coerce(self, v):
        if isinstance(self.base, ExtensionField):
            return self.base._coerce(v)
        return int(v) % self.base.p

    def _coerce(self, value):
        if isinstance(value, FieldElement):
            value = value.value
        if isinstance(value, tuple) and len(value) == self.degree:
            return tuple(self._base_coerce(v) for v in value)
        zero = self._base_coerce(0)
        return (self._base_coerce(value),) + (zero,) * (self.degree - 1)  # from the base

    # -- host ops used by FieldElement ---------------------------------------
    def _bres(self, a):
        """a times the non-residue"""
        return self.base.host_mul(self.non_residue, a)

    def host_add(self, a, b):
        return tuple(self.base.host_add(x, y) for x, y in zip(a, b))

    def host_sub(self, a, b):
        return tuple(self.base.host_sub(x, y) for x, y in zip(a, b))

    def host_neg(self, a):
        return tuple(self.base.host_neg(x) for x in a)

    def host_mul(self, a, b):
        bf = self.base
        if self.degree == 3:
            return self._host_mul3(a, b)
        (a0, a1), (b0, b1) = a, b
        t0, t1 = bf.host_mul(a0, b0), bf.host_mul(a1, b1)
        mid = bf.host_mul(bf.host_add(a0, a1), bf.host_add(b0, b1))  # Karatsuba
        mid = bf.host_sub(bf.host_sub(mid, t0), t1)
        return (bf.host_add(t0, self._bres(t1)), mid)

    def _host_mul3(self, a, b):
        """Karatsuba-style product in base[x]/(x^3 - non_residue)."""
        add, sub, mul = self.base.host_add, self.base.host_sub, self.base.host_mul
        (a0, a1, a2), (b0, b1, b2) = a, b
        v0, v1, v2 = mul(a0, b0), mul(a1, b1), mul(a2, b2)
        c0 = add(v0, self._bres(sub(sub(mul(add(a1, a2), add(b1, b2)), v1), v2)))
        c1 = add(sub(sub(mul(add(a0, a1), add(b0, b1)), v0), v1), self._bres(v2))
        c2 = add(sub(sub(mul(add(a0, a2), add(b0, b2)), v0), v2), v1)
        return (c0, c1, c2)

    def _host_inv3(self, a):
        add, sub, mul = self.base.host_add, self.base.host_sub, self.base.host_mul
        a0, a1, a2 = a
        t0 = sub(mul(a0, a0), self._bres(mul(a1, a2)))
        t1 = sub(self._bres(mul(a2, a2)), mul(a0, a1))
        t2 = sub(mul(a1, a1), mul(a0, a2))
        norm = add(mul(a0, t0), self._bres(add(mul(a2, t1), mul(a1, t2))))
        ninv = self.base.host_inv(norm)
        return (mul(t0, ninv), mul(t1, ninv), mul(t2, ninv))

    def host_inv(self, a):
        if self._is_bzero(a):
            raise ZeroInverseError(f"inverse of zero in {self.name}")
        if self.degree == 3:
            return self._host_inv3(a)
        bf = self.base
        a0, a1 = a
        # 1/(a0 + a1 x) = (a0 - a1 x) / (a0^2 - r a1^2)
        norm = bf.host_sub(bf.host_mul(a0, a0), self._bres(bf.host_mul(a1, a1)))
        ninv = bf.host_inv(norm)
        return (bf.host_mul(a0, ninv), bf.host_mul(bf.host_neg(a1), ninv))

    def host_pow(self, a, e: int):
        result, acc, e = self._coerce(1), a, int(e)
        while e:
            if e & 1:
                result = self.host_mul(result, acc)
            acc = self.host_mul(acc, acc)
            e >>= 1
        return result

    def _is_bzero(self, x):
        if isinstance(x, tuple):
            return all(self._is_bzero(y) for y in x)
        return x == 0


class DeviceQuadraticField:
    """Batched quadratic extension E = B[u]/(u^2 - non_residue) over a
    tensor base field B: a :class:`PrimeField`, or another
    ``DeviceQuadraticField`` (the quartic tower, with non_residue (0, 1)).
    With ``plain`` its ops are the plain composition on any device.
    """

    degree = 2

    def __init__(self, base, non_residue, name=None, plain=False):
        self.base = base
        self._plain = plain
        nested = isinstance(base, DeviceQuadraticField)
        self.non_residue = non_residue if nested else int(non_residue) % base.p
        self.name = name or f"{base.name}_x2"
        self.p = base.p
        self.prime = base.prime if nested else getattr(base, "_field", base)
        self.degree_over_prime = 2 * (base.degree_over_prime if nested else 1)
        # kernel 6 carries a tower over its fields (Goldilocks, BabyBear)
        # whose level 2 is u; any other tower composes the base field's ops
        # (over a dense field: kernel 8)
        arith = self.prime.ops
        self._kernel = (arith if getattr(arith, "tower_kernel", False)
                        and (not nested or (tuple(non_residue) == (0, 1)
                                            and not isinstance(base.base, DeviceQuadraticField)))
                        else None)
        self._nr1 = base.non_residue if nested else self.non_residue

    def __repr__(self):
        return f"DeviceQuadraticField({self.name})"

    def plain(self) -> "DeviceQuadraticField":
        """The same tower with every op the plain version, composed of the
        base field's plain ops on any device: the CPU route, which kernel 6
        is held against on the card."""
        return DeviceQuadraticField(self.base.plain(), self.non_residue, self.name, plain=True)

    # -- layout -----------------------------------------------------------------
    @property
    def num_limbs(self) -> int:
        return 2 * self.base.num_limbs

    def split(self, a):
        k = self.base.num_limbs
        return a[:k], a[k:2 * k]

    @staticmethod
    def join(*comps):
        return torch.cat(comps, dim=0)

    def _components(self, value):
        """An int / tuple / FieldElement as a pair of base values."""
        if isinstance(value, FieldElement):
            value = value.value
        if isinstance(value, tuple) and len(value) == 2:
            return value
        zero = self.base._components(0) if isinstance(self.base, DeviceQuadraticField) else 0
        return (value, zero)

    # -- host <-> tensor --------------------------------------------------------
    def array(self, values, device) -> torch.Tensor:
        """A flat list of (nested) tuples / ints / host elements ->
        ``(D L, B)`` tensor on ``device``."""
        groups = [self._components(v) for v in values]
        return self.join(*(self.base.array([g[i] for g in groups], device) for i in range(2)))

    def to_tuples(self, arr) -> list:
        """``(D L, B)`` tensor -> list of component tuples (ints at the
        leaves): one conversion out of Montgomery form for all components
        (on a card one launch) and one transfer."""
        D, L = self.degree_over_prime, self.prime.num_limbs
        ints = self.prime.to_ints(arr.reshape(D, L, -1).transpose(0, 1))  # (D, B)
        return [nest_components([int(c) for c in ints[:, i]], D) for i in range(ints.shape[1])]

    def constant(self, value, batch_shape, device) -> torch.Tensor:
        """One value broadcast over a batch shape (a view of one column)."""
        ones = (1,) * len(batch_shape)
        col = self.join(*(self.base.constant(c, ones, device) for c in self._components(value)))
        return col.expand((self.num_limbs,) + tuple(batch_shape))

    def zeros(self, batch_shape, device) -> torch.Tensor:
        return torch.zeros((self.num_limbs,) + tuple(batch_shape), dtype=torch.int32,
                           device=device)

    def ones(self, batch_shape, device) -> torch.Tensor:
        return self.join(self.base.ones(batch_shape, device), self.base.zeros(batch_shape, device))

    def embed(self, base_arr) -> torch.Tensor:
        """A base-field tensor (Lb, *batch) lifted into the extension."""
        return torch.cat([base_arr, torch.zeros_like(base_arr)], dim=0)

    # -- kernel 6 on a card ------------------------------------------------------
    def _on_card(self, *xs) -> bool:
        return not (self._plain or self._kernel is None
                    or all(x.device.type == "cpu" for x in xs))

    def _launch(self, op, a, b=None, exponent=0):
        return self._kernel.op_cuda(op, a, b, degree=self.degree_over_prime, nr=self._nr1,
                                    exponent=exponent)

    # -- ops ------------------------------------------------------------------------
    def add(self, a, b):
        if self._on_card(a, b):
            return self._launch(_OP_ADD, a, b)
        return self.join(*(self.base.add(x, y) for x, y in zip(self.split(a), self.split(b))))

    def sub(self, a, b):
        if self._on_card(a, b):
            return self._launch(_OP_SUB, a, b)
        return self.join(*(self.base.sub(x, y) for x, y in zip(self.split(a), self.split(b))))

    def neg(self, a):
        if self._on_card(a):
            return self._launch(_OP_NEG, a)
        return self.join(*(self.base.neg(x) for x in self.split(a)))

    def _mul_res(self, v):
        """A base-field value times this extension's non-residue."""
        r, f = self.non_residue, self.base
        if isinstance(f, DeviceQuadraticField):
            if tuple(r) == (0, 1):  # (v0 + v1 u) u = nr v1 + v0 u
                v0, v1 = f.split(v)
                return f.join(f._mul_res(v1), v0)
            return f.mul(f.constant(r, v.shape[1:], v.device), v)
        return f.mul(f.constant(r, (1,) * (v.dim() - 1), v.device), v)

    def mul(self, a, b):
        if self._on_card(a, b):
            return self._launch(_OP_MUL, a, b)
        f = self.base
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = self.split(a)
        b0, b1 = self.split(b)
        # the three Karatsuba products in one base product, over a new axis 1
        t = f.mul(torch.stack([a0, a1, f.add(a0, a1)], dim=1),
                  torch.stack([b0, b1, f.add(b0, b1)], dim=1))
        t0, t1 = t[:, 0], t[:, 1]
        mid = f.sub(f.sub(t[:, 2], t0), t1)
        return self.join(f.add(t0, self._mul_res(t1)), mid)

    def square(self, a):
        return self._launch(_OP_SQUARE, a) if self._on_card(a) else self.mul(a, a)

    def pow(self, a, e: int):
        e = int(e)
        if e < 0:
            raise ValueError("negative exponent; invert first")
        if self._on_card(a):
            order = self.p ** self.degree_over_prime - 1
            if e > order:
                e = (e - 1) % order + 1
            return self._launch(_OP_POW, a, exponent=e)
        result, acc = None, a
        while e:
            if e & 1:
                result = acc if result is None else self.mul(result, acc)
            e >>= 1
            if e:
                acc = self.mul(acc, acc)
        return self.ones(a.shape[1:], a.device) if result is None else result

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    @staticmethod
    def select(cond, a, b):
        """Elementwise over the batch: cond ? a : b."""
        return torch.where(cond.unsqueeze(0), a, b)

    def batch_inverse(self, a):
        """Elementwise inverse, zeros mapping to zero: through the norm, one
        base-field batch inversion (on a card one launch of kernel 6's
        inversion, which takes each norm, inverts them by Montgomery's trick
        inside each block and lifts them; or kernel 9 over a dense base)."""
        if self._on_card(a):
            return self._launch(_OP_INV, a)
        f = self.base
        a0, a1 = self.split(a)
        ninv = f.batch_inverse(f.sub(f.mul(a0, a0), self._mul_res(f.mul(a1, a1))))
        return self.join(f.mul(a0, ninv), f.mul(f.neg(a1), ninv))
