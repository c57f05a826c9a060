"""The concrete prime fields of the port: Stark252 only so far (the rest
of ``lambda_elliptic_curves_tpu/fields/zoo.py`` is ROADMAP queue 1 item 8).

The modulus and the pinned two-adic generator are the reference's
(``fft_friendly/stark_252_prime_field.rs:20-24``), so NTT domains agree
bit for bit with the JAX package.
"""

from __future__ import annotations

from .params import FieldParams
from .field import PrimeField

STARK252_PRIME = (2**251) + 17 * (2**192) + 1

Stark252 = PrimeField(FieldParams(
    name="stark252",
    p=STARK252_PRIME,
    two_adicity=192,
    two_adic_root=int(
        "5282db87529cfa3f0464519c8b0fa5ad187148e11a61616070024f42f8ef94", 16
    ),
))
