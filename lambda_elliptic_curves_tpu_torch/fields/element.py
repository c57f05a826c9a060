"""Host-side field elements (exact Python-int arithmetic).

These are the protocol-glue values: transcript samples, challenge powers,
pairing operands, small polynomial manipulations.  Bulk data never lives in
this form — it lives in digit arrays on device (see ``field.py``).

Parity: ``FieldElement<F>`` operator surface, ``math/src/field/element.rs:40``.
Serialization matches lambdaworks' ``ByteConversion`` (canonical
representative, fixed width = 64-bit-limb padded; ``math/src/traits.rs:10``).
"""

from __future__ import annotations


def _deep_is_zero(v):
    if isinstance(v, tuple):
        return all(_deep_is_zero(c) for c in v)
    return v == 0


class FieldElement:
    """An element of a prime field or extension, wrapping an exact value.

    For prime fields ``value`` is an int in [0, p); for extensions it is a
    tuple of component values (see ``extensions.py``).
    """

    __slots__ = ("field", "value")

    def __init__(self, field, value):
        self.field = field
        self.value = value

    # -- arithmetic -----------------------------------------------------
    def _coerce(self, other):
        """Coerce to a same-field element, or None for foreign types so the
        operator returns NotImplemented and Python dispatches to the other
        operand (e.g. ``felt * Polynomial`` -> ``Polynomial.__rmul__``)."""
        if isinstance(other, FieldElement):
            if other.field.p != self.field.p:
                return other  # let extension logic lift
            return other
        if isinstance(other, (int, str)):
            return self.field(other)
        return None

    def __add__(self, other):
        other = self._coerce(other)
        if other is None:
            return NotImplemented
        return FieldElement(self.field, self.field.host_add(self.value, other.value))

    __radd__ = __add__

    def __sub__(self, other):
        other = self._coerce(other)
        if other is None:
            return NotImplemented
        return FieldElement(self.field, self.field.host_sub(self.value, other.value))

    def __rsub__(self, other):
        return self.field(other) - self

    def __mul__(self, other):
        other = self._coerce(other)
        if other is None:
            return NotImplemented
        return FieldElement(self.field, self.field.host_mul(self.value, other.value))

    __rmul__ = __mul__

    def __neg__(self):
        return FieldElement(self.field, self.field.host_neg(self.value))

    def __truediv__(self, other):
        other = self._coerce(other)
        if other is None:
            return NotImplemented
        return self * other.inv()

    def __rtruediv__(self, other):
        return self.field(other) / self

    def __pow__(self, exponent):
        if isinstance(exponent, FieldElement):
            exponent = exponent.value
        if exponent < 0:
            return self.inv() ** (-exponent)
        return FieldElement(self.field, self.field.host_pow(self.value, exponent))

    def inv(self):
        return FieldElement(self.field, self.field.host_inv(self.value))

    def square(self):
        return self * self

    def double(self):
        return self + self

    # -- predicates ------------------------------------------------------
    def is_zero(self):
        return _deep_is_zero(self.value)

    def __eq__(self, other):
        if isinstance(other, FieldElement):
            return self.field.p == other.field.p and self.value == other.value
        if isinstance(other, int):
            return self.value == other % self.field.p
        return NotImplemented

    def __hash__(self):
        return hash((self.field.p, self.value))

    def __repr__(self):
        if isinstance(self.value, tuple):
            return f"FE({self.value})"
        return f"FE({hex(self.value)})"

    def __int__(self):
        return int(self.value)

    # -- sqrt / legendre ---------------------------------------------------
    def sqrt(self):
        """Both square roots (r, -r) or None, mirroring
        ``IsPrimeField``-level sqrt (``math/src/field/traits.rs:234``)."""
        r = self.field.params.sqrt(self.value)
        if r is None:
            return None
        r1 = FieldElement(self.field, r)
        return (r1, -r1)

    def legendre_symbol(self):
        return self.field.params.legendre(self.value)

    # -- serialization (ByteConversion parity) ------------------------------
    def to_bytes_be(self) -> bytes:
        return self.value.to_bytes(self.field.params.num_bytes, "big")

    def as_bytes(self) -> bytes:
        """``AsBytes`` parity: the reference serializes the raw Montgomery
        limb value x * R mod p for Montgomery-backed fields
        (``montgomery_backed_prime_fields.rs:371``), the canonical value
        for plain-backend fields."""
        fp = self.field.params
        return (self.value * fp.serialization_r % fp.p).to_bytes(
            fp.num_bytes, "big"
        )

    def to_bytes_le(self) -> bytes:
        return self.value.to_bytes(self.field.params.num_bytes, "little")

    @classmethod
    def from_bytes_be(cls, field, data: bytes):
        return field(int.from_bytes(data, "big"))

    @classmethod
    def from_bytes_le(cls, field, data: bytes):
        return field(int.from_bytes(data, "little"))

    def to_hex(self) -> str:
        """Canonical hex without leading zeros, like the reference's
        ``IsPrimeField::to_hex`` representation."""
        return format(self.value, "X")
