"""Challenge-field bundle: the (F, E) pair the STARK protocol runs over.

Counterpart of ``lambda_elliptic_curves_tpu/provers/stark/extension.py`` at
degree 1, where the challenge field is the trace field itself and every
method degenerates to the base field.  Extension degrees 2 and 4 (and the
E-valued RAP traces they bring) are ROADMAP queue 1 item 7.
"""

from __future__ import annotations

from ...fields.element import FieldElement
from ...poly import ntt
from ...poly.polynomial import field_sum

_DEGREE_GT_1 = ("challenge-field extensions of degree > 1 are not ported yet "
                "(ROADMAP queue 1 item 7)")


class ChallengeBundle:
    """``f``: base PrimeField (trace field).  ``fd``: tensor challenge field
    (== ``f``).  ``host``: host constructor for challenge values."""

    def __init__(self, field, degree: int = 1):
        if degree != 1:
            raise NotImplementedError(_DEGREE_GT_1)
        self.f = field
        self.degree = 1
        self.fd = field
        self.host = field

    # -- host/tensor element plumbing ---------------------------------------
    def value_of(self, elem):
        """FieldElement -> storable int."""
        return elem.value if isinstance(elem, FieldElement) else elem

    def flat(self, value) -> list:
        """Proof/transcript component order for a challenge value."""
        if isinstance(value, FieldElement):
            value = value.value
        return [int(value)]

    def host_value(self, arr) -> int:
        """Single-element tensor (8,) or (8, 1) -> canonical int."""
        return int(self.f.to_ints(arr.reshape(-1, 1)).ravel()[0])

    def host_values(self, arr) -> list:
        """Tensor (8, Q) -> list of Q ints, one transfer for the batch."""
        return [int(v) for v in self.f.to_ints(arr).ravel()]

    def unflatten_leaf(self, vals, count: int) -> list:
        """Flat leaf ints -> host E elements (the first ``count``)."""
        return [self.host(v) for v in vals[:count]]

    # -- embedding (identity at degree 1) ------------------------------------
    def as_base_columns(self, arr):
        return arr

    # -- transcript ---------------------------------------------------------
    def sample(self, transcript) -> FieldElement:
        return transcript.sample_field_element()

    def append(self, transcript, elem):
        for c in self.flat(elem):
            transcript.append_field_element(self.f(c))

    def sample_z_ood(self, transcript, lde_coset_offset, lde_size: int,
                     trace_root_order: int) -> FieldElement:
        """z outside the LDE coset and trace domain (``is_transcript.rs:21``)."""
        return transcript.sample_z_ood(lde_coset_offset, lde_size, trace_root_order)

    # -- NTTs ---------------------------------------------------------------
    def interpolate_offset_fft(self, evals, offset: int):
        return ntt.interpolate_offset_fft(self.f, evals, offset)

    def interpolate_fft(self, evals):
        return ntt.interpolate_fft(self.f, evals)

    def evaluate_offset_fft(self, coeffs, blowup_factor=1, domain_size=None,
                            offset=1):
        return ntt.evaluate_offset_fft(self.f, coeffs, blowup_factor,
                                       domain_size, offset)

    # -- evaluation at a challenge point ------------------------------------
    def powers_of(self, elem, count: int, device):
        """(8, count) tensor [1, x, x^2, ...]."""
        return ntt.powers(self.f, int(self.value_of(elem)) % self.f.p, count,
                          device=device, cache=False)

    def evaluate_coeffs_at(self, coeffs, elem):
        """Evaluate coefficient tensors (8, ..., n) at a challenge point:
        dot with the powers ladder + modular tree reduction."""
        n = coeffs.shape[-1]
        pows = self.powers_of(elem, n, coeffs.device)
        pows = pows.reshape((pows.shape[0],) + (1,) * (coeffs.dim() - 2) + (n,))
        return field_sum(self.fd, self.fd.mul(coeffs, pows), axis=-1)
