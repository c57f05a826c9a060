"""Proof options and security presets.

Parity: ``ProofOptions`` (``provers/stark/src/proof/options.rs:24``) with the
``SecurityLevel`` presets (:38) and the conjecturable/provable security
checks (:80-130), same constants.
"""

from __future__ import annotations

import dataclasses
import enum

from ...utils.errors import ProvingError


class SecurityLevel(enum.Enum):
    CONJECTURABLE_80 = "conjecturable_80"
    CONJECTURABLE_100 = "conjecturable_100"
    CONJECTURABLE_128 = "conjecturable_128"
    PROVABLE_80 = "provable_80"
    PROVABLE_100 = "provable_100"
    PROVABLE_128 = "provable_128"


_PRESETS = {
    SecurityLevel.CONJECTURABLE_80: (4, 31, 20),
    SecurityLevel.CONJECTURABLE_100: (4, 41, 20),
    SecurityLevel.CONJECTURABLE_128: (4, 55, 20),
    SecurityLevel.PROVABLE_80: (4, 80, 20),
    SecurityLevel.PROVABLE_100: (4, 104, 20),
    SecurityLevel.PROVABLE_128: (4, 140, 20),
}


@dataclasses.dataclass(frozen=True)
class ProofOptions:
    blowup_factor: int = 4
    fri_number_of_queries: int = 3
    coset_offset: int = 3
    grinding_factor: int = 0

    @classmethod
    def default_test_options(cls):
        """Matches the reference's test options (blowup 4, 3 queries,
        offset 3, no grinding)."""
        return cls(4, 3, 3, 0)

    @classmethod
    def new_secure(cls, level: SecurityLevel, coset_offset: int = 3):
        blowup, queries, grinding = _PRESETS[level]
        return cls(blowup, queries, coset_offset, grinding)

    @classmethod
    def new_with_checked_security(cls, field, blowup_factor, fri_number_of_queries,
                                  coset_offset, grinding_factor, security_target):
        """Conjecturable security check (options.rs:80):
        target < grinding + log2(blowup) * queries - 1."""
        if field.params.nbits < 2 * security_target + 40:  # NUM_BITS_MAX_DOMAIN_SIZE
            raise ProvingError("field too small for target security")
        nbits_blowup = (blowup_factor & -blowup_factor).bit_length() - 1
        if security_target >= grinding_factor + nbits_blowup * fri_number_of_queries - 1:
            raise ProvingError("insecure options: too few security bits")
        return cls(blowup_factor, fri_number_of_queries, coset_offset, grinding_factor)
