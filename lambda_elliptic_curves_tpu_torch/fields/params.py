"""Prime-field parameter records.

TPU-native counterpart of lambdaworks' trait lattice
(``IsField``/``IsPrimeField``/``IsFFTField``,
``math/src/field/traits.rs:71-288`` and the Montgomery backend
``math/src/field/fields/montgomery_backed_prime_fields.rs:34``): instead of
trait objects, a field is a frozen *parameter record* (modulus digits,
Montgomery constants, two-adic data) that drives one shared set of batched
digit kernels.  All derived constants are computed here at Python level with
exact integers — nothing is hardcoded except the public protocol parameters
(modulus, two-adic generator), which are standard published values.

Digit layout: an element is a little-endian vector of ``num_digits`` digits
of ``digit_bits`` bits each, held in ``uint32`` lanes; batched arrays are
digit-major, i.e. shape ``(num_digits, *batch)``, so each digit plane is a
contiguous batch vector that tiles onto the TPU VPU (8x128 lanes) with full
utilisation.

Digit width is chosen per field: 16-bit digits give the fewest planes, but
every 16x16 product must be split into lo/hi halves before the column sums
(two extra ops per product).  With 13-bit digits the raw 26-bit products
accumulate directly — column sums of up to K products stay below 2^32 for
K <= 63 — removing the split entirely; the convolution needs ~25% more
multiplies (more digits) but ~45% fewer total ops.  Fields >= 128 bits
therefore default to the widest split-free width whose column sums fit in
uint32; small fields (<= 4 digits) keep 16-bit digits, where the plane
count dominates.
"""

from __future__ import annotations

import dataclasses
import functools

DIGIT_BITS = 16
DIGIT_MASK = (1 << DIGIT_BITS) - 1


def _auto_digit_bits(nbits: int) -> int:
    """Default digit width.

    16-bit (split-product) mode everywhere: measured on the target TPU
    backend, a 252-bit Montgomery multiply at 13-bit digits (no lo/hi
    split, fewer total vector ops but ~56% more uint32 multiplies) runs
    1.8x SLOWER than 16-bit (51 ms vs 28.5 ms per 2^21-lane multiply) —
    the u32 multiply lowers to several hardware ops, so multiply count,
    not total op count, is the cost model.  Narrow widths (13/12-bit,
    see :func:`narrow_digit_bits`) stay selectable per field via the
    ``digit_bits`` parameter for hardware where the ratio differs.
    """
    return 16


def narrow_digit_bits(nbits: int) -> int:
    """Widest split-free digit width whose schoolbook column sums are exact
    in uint32 (13 for <= ~310-bit fields, 12 up to ~700 bits)."""
    for d in (13, 12, 11):
        k = -(-nbits // d)
        # conv column sum bound: K raw products, plus the same again from
        # the q*p columns of an SOS reduction, plus fold headroom
        if 2 * k * (2**d - 1) ** 2 + (1 << 22) < 1 << 32:
            return d
    return 16


def int_to_digits(value: int, num_digits: int,
                  bits: int = DIGIT_BITS) -> tuple[int, ...]:
    """Little-endian ``bits``-wide digits of ``value``."""
    if value < 0:
        raise ValueError("value must be non-negative")
    mask = (1 << bits) - 1
    digits = []
    for _ in range(num_digits):
        digits.append(value & mask)
        value >>= bits
    if value:
        raise ValueError("value does not fit in the given number of digits")
    return tuple(digits)


def digits_to_int(digits, bits: int = DIGIT_BITS) -> int:
    """Inverse of :func:`int_to_digits` (accepts any iterable of ints)."""
    value = 0
    for i, d in enumerate(digits):
        value |= int(d) << (bits * i)
    return value


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Static description of a prime field F_p.

    Only ``name``, ``p`` and (for FFT fields) ``two_adicity`` /
    ``two_adic_root`` are inputs; everything else is derived exactly.

    ``two_adic_root`` is a generator of the order-``2**two_adicity``
    multiplicative subgroup, matching the reference's
    ``TWO_ADIC_PRIMITVE_ROOT_OF_UNITY`` so that NTT domains (and therefore
    every committed polynomial evaluation) agree bit-for-bit with
    lambdaworks (``math/src/field/traits.rs:71-95``).
    """

    name: str
    p: int
    two_adicity: int = 0
    two_adic_root: int = 0
    digit_bits: int = 0  # 0 = auto (see _auto_digit_bits)
    # lambdaworks' AsBytes serializes the raw Montgomery-limb value
    # (``montgomery_backed_prime_fields.rs:371``: value().to_bytes_be()),
    # so byte-exact interop (Merkle leaves, Stone proofs) must use
    # x * 2^(64*limbs) mod p.  Fields whose reference backend is a plain
    # u32/u64 field (Goldilocks, Mersenne31) set this False.
    serialization_montgomery: bool = True

    def __post_init__(self):
        if self.p < 3 or self.p % 2 == 0:
            raise ValueError("modulus must be an odd prime > 2")
        if self.digit_bits == 0:
            object.__setattr__(
                self, "digit_bits", _auto_digit_bits(self.p.bit_length())
            )
        if not 8 <= self.digit_bits <= 16:
            raise ValueError("digit_bits must be in [8, 16]")
        if self.two_adicity:
            root = self.two_adic_root
            if pow(root, 1 << self.two_adicity, self.p) != 1:
                raise ValueError(f"{self.name}: two_adic_root has wrong order")
            if pow(root, 1 << (self.two_adicity - 1), self.p) == 1:
                raise ValueError(f"{self.name}: two_adic_root is not primitive")

    # ---- derived sizes -------------------------------------------------
    @functools.cached_property
    def nbits(self) -> int:
        return self.p.bit_length()

    @functools.cached_property
    def digit_mask(self) -> int:
        return (1 << self.digit_bits) - 1

    @functools.cached_property
    def split_products(self) -> bool:
        """True when digit products exceed 32 bits minus column headroom and
        must be split into lo/hi halves before accumulation (16-bit mode)."""
        return 2 * self.digit_bits + max(1, self.num_digits).bit_length() > 32

    @functools.cached_property
    def num_digits(self) -> int:
        """Number of digits (K)."""
        return -(-self.nbits // self.digit_bits)

    @functools.cached_property
    def num_bytes(self) -> int:
        """Serialized size: matches lambdaworks' limb-padded width (the
        reference serializes the full 64-bit-limb representation, e.g.
        32 bytes for Stark252, 48 for BLS12-381 base field —
        ``math/src/traits.rs:10``)."""
        limbs64 = -(-self.nbits // 64)
        return limbs64 * 8

    # ---- Montgomery constants (R = 2^(digit_bits*K)) --------------------
    @functools.cached_property
    def r(self) -> int:
        return pow(2, self.digit_bits * self.num_digits, self.p)

    @functools.cached_property
    def r2(self) -> int:
        return (self.r * self.r) % self.p

    @functools.cached_property
    def r_inv(self) -> int:
        return pow(self.r, self.p - 2, self.p)

    @functools.cached_property
    def mu_digit(self) -> int:
        """-p^{-1} mod 2^digit_bits (digit-serial Montgomery quotient
        constant; the per-digit analogue of CIOS' m, cf.
        ``math/src/unsigned_integer/montgomery.rs:12``)."""
        return (-pow(self.p, -1, 1 << self.digit_bits)) % (1 << self.digit_bits)

    # kept under the historical name for callers written against 16-bit mode
    mu16 = property(lambda self: self.mu_digit)

    @functools.cached_property
    def serialization_r(self) -> int:
        """The factor lambdaworks' AsBytes bakes into serialized bytes:
        2^(64 * limbs) mod p for Montgomery-backed reference fields
        (their 64-bit-limb Montgomery R), 1 for plain-backend fields."""
        if not self.serialization_montgomery:
            return 1
        return pow(2, 8 * self.num_bytes, self.p)

    @functools.cached_property
    def p_digits(self) -> tuple[int, ...]:
        return int_to_digits(self.p, self.num_digits, self.digit_bits)

    @functools.cached_property
    def p_nonzero_digit_idx(self) -> tuple[int, ...]:
        """Indices of nonzero digits of p.  The Montgomery reduction loop
        statically skips zero digits, which makes sparse moduli (Stark252:
        3 nonzero digits out of 16; Goldilocks: 3 of 4) dramatically
        cheaper than dense ones — the TPU analogue of the reference's
        spare-bit-optimised CIOS (``math/src/unsigned_integer/montgomery.rs``).
        """
        return tuple(i for i, d in enumerate(self.p_digits) if d)

    # ---- roots of unity -------------------------------------------------
    def primitive_root_of_unity(self, order: int) -> int:
        """Generator of the 2^order subgroup, derived by repeated squaring
        exactly like ``IsFFTField::get_primitive_root_of_unity``
        (``math/src/field/traits.rs:82-94``)."""
        from ..utils.errors import RootOfUnityError

        if order == 0:
            return 1
        if not self.two_adicity or order > self.two_adicity:
            raise RootOfUnityError(
                f"{self.name} has no 2^{order} root of unity "
                f"(two-adicity {self.two_adicity})"
            )
        return pow(self.two_adic_root, 1 << (self.two_adicity - order), self.p)

    # ---- scalar host arithmetic (exact oracle path) ---------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        from ..utils.errors import ZeroInverseError

        if a % self.p == 0:
            raise ZeroInverseError(f"inverse of zero in {self.name}")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def legendre(self, a: int) -> int:
        """Legendre symbol in {-1, 0, 1} (cf. ``IsPrimeField::legendre_symbol``,
        ``math/src/field/traits.rs:214``)."""
        s = pow(a % self.p, (self.p - 1) // 2, self.p)
        return -1 if s == self.p - 1 else int(s)

    def sqrt(self, a: int):
        """Tonelli–Shanks square root; returns ``None`` for non-residues
        (cf. ``IsPrimeField::sqrt``, ``math/src/field/traits.rs:234``)."""
        a %= self.p
        if a == 0:
            return 0
        if self.legendre(a) != 1:
            return None
        p = self.p
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # factor p-1 = q * 2^s
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        # find a non-residue z
        z = 2
        while self.legendre(z) != -1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            t2, i = t, 0
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
                if i == m:
                    return None
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r = r * b % p
        return r
