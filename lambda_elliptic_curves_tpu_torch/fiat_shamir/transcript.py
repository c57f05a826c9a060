"""Fiat–Shamir transcripts (host, byte-exact with the reference).

Parity: ``IsTranscript`` (``crypto/src/fiat_shamir/is_transcript.rs:10``)
and ``DefaultTranscript`` (``default_transcript.rs:9``): a running
Keccak-256 absorber whose ``sample`` finalizes, **reverses** the digest,
re-appends the reversed digest, and returns it; ``sample_u64`` reads the
current state non-destructively.  These quirks are protocol-visible, so we
reproduce them bit-for-bit (KATs from the reference test suite).

Transcripts are inherently sequential byte protocols — they live on the
host and mark the device-to-host synchronisation points of the prover.
"""

from __future__ import annotations

from ..hashes.keccak import keccak256
from ..fields.element import FieldElement


class DefaultTranscript:
    """Keccak-256 transcript over a given field."""

    def __init__(self, field, init_bytes: bytes = b""):
        self.field = field
        self._buffer = b""
        self.append_bytes(init_bytes)

    # the Rust version keeps an incremental hasher; we keep the absorbed
    # bytes (same digests, protocol sizes are tiny).
    def append_bytes(self, new_bytes: bytes):
        self._buffer += bytes(new_bytes)

    def append_field_element(self, element):
        if isinstance(element, FieldElement):
            self.append_bytes(element.to_bytes_be())
        else:
            self.append_bytes(self.field(element).to_bytes_be())

    def state(self) -> bytes:
        return keccak256(self._buffer)

    def sample(self) -> bytes:
        out = bytes(reversed(keccak256(self._buffer)))
        self._buffer = out  # reset absorber, re-feed reversed digest
        return out

    def sample_field_element(self) -> FieldElement:
        return self.field(int.from_bytes(self.sample(), "big"))

    def sample_u64(self, upper_bound: int) -> int:
        return int.from_bytes(self.state()[:8], "big") % upper_bound

    def sample_z_ood(self, lde_coset_offset, lde_size: int,
                     trace_root_order: int):
        """Sample z outside both the LDE coset and the trace domain
        (``is_transcript.rs:21``).  Membership is checked algebraically
        (z^n == offset^n  <=>  z in offset*<w_n>) instead of scanning the
        domain, which is equivalent and O(log n)."""
        f = self.field
        offset_pow = f(lde_coset_offset) ** lde_size
        trace_size = 1 << trace_root_order
        while True:
            z = self.sample_field_element()
            if (z**lde_size) != offset_pow and (z**trace_size) != f(1):
                return z
