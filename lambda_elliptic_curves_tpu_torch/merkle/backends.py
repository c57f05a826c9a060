"""Keccak Merkle hashing backends (parity: ``crypto/src/merkle_tree/
backends/*``), counterpart of ``lambda_elliptic_curves_tpu/merkle/
backends.py`` (the Poseidon, RPO and generic-digest backends are ROADMAP
queue 1 item 9).

* :class:`KeccakFieldBackend` — leaf = Keccak256(element bytes BE),
  parent = Keccak256(left||right) (``FieldElementBackend`` +
  ``Keccak256Backend``, ``backends/field_element.rs:15``).
* :class:`KeccakBatchBackend` — leaf = Keccak256 of a whole row of
  elements, for trace-row commitments (``field_element_vector.rs``).

Leaf and parent levels hash in one batched call each (the Keccak kernel
on a card); single-node host helpers back proof verification.
"""

from __future__ import annotations

import torch

from ..fields.field import PrimeField
from ..hashes import keccak
from ..ops import limbs
from .tree import MerkleBackend


def _to_wire_form(field: PrimeField, leaves):
    """Montgomery limbs -> the limbs of the ``AsBytes`` wire value.

    lambdaworks' ``AsBytes`` serializes the raw 64-bit-limb Montgomery
    value x * R_ref mod p (``montgomery_backed_prime_fields.rs:371``); the
    internal form is x * R.  One Montgomery product by the plain constant
    R_ref maps one to the other, and when R_ref == R (Stark252: both 2^256)
    the internal limbs already are the wire value and nothing runs."""
    fp = field.params
    if fp.serialization_r == fp.r:
        return leaves
    c = limbs.const_limbs(fp.serialization_r, (1,) * (leaves.dim() - 1), leaves.device)
    return limbs.mont_mul(leaves, c)


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00) | ((x & 0xFF00) << 8)
            | (x << 24))


def _felt_to_le_words_be_bytes(field: PrimeField, arr):
    """(8, *B) limbs -> (8, *B) int32 little-endian words of the 32-byte
    big-endian serialization: word w holds bytes 4w..4w+3, which are limb
    7 - w with its bytes reversed."""
    if field.params.num_bytes != 4 * limbs.LIMBS:
        raise NotImplementedError("32-byte elements only")
    return _bswap32(arr.flip(0))


class KeccakFieldBackend(MerkleBackend):
    """Keccak256 over big-endian element wire bytes; nodes are 32-byte
    digests (tensor form: (8, B) int32 little-endian words)."""

    def __init__(self, field: PrimeField):
        self.field = field

    def hash_leaves(self, leaves):
        wire = _to_wire_form(self.field, leaves)
        words = _felt_to_le_words_be_bytes(self.field, wire)
        return keccak.keccak256_words(words, self.field.params.num_bytes)

    def hash_parents(self, level):
        # parent input = left || right: (16, n/2) words, left child first
        n = level.shape[-1]
        words = level.reshape(8, n // 2, 2).permute(2, 0, 1).reshape(16, n // 2)
        return keccak.keccak256_words(words, 64)

    def pad_to_power_of_two(self, nodes):
        n = nodes.shape[-1]
        target = 1 << (n - 1).bit_length() if n > 1 else 1
        if target == n:
            return nodes
        reps = nodes[..., -1:].expand(nodes.shape[:-1] + (target - n,))
        return torch.cat([nodes, reps], dim=-1)

    def count(self, nodes):
        return nodes.shape[-1]

    def to_host(self, nodes):
        return keccak.digest_words_to_bytes(nodes)

    def hash_leaf_host(self, value):
        return keccak.keccak256(self.field(value).as_bytes())

    def hash_parent_host(self, left: bytes, right: bytes):
        return keccak.keccak256(left + right)


class KeccakBatchBackend(KeccakFieldBackend):
    """Leaf = Keccak256 of a full row of elements (trace-row commitments,
    parity with ``BatchedMerkleTreeBackend``, ``field_element_vector.rs``)."""

    def hash_leaves(self, leaves):
        """``leaves``: (8, ncols, B) Montgomery limbs; row b serializes as
        col0||col1||... in big-endian wire bytes."""
        ncols = leaves.shape[1]
        wire = _to_wire_form(self.field, leaves)
        words = _felt_to_le_words_be_bytes(self.field, wire)  # (8, C, B)
        words = words.transpose(0, 1).reshape((8 * ncols,) + tuple(leaves.shape[2:]))
        return keccak.keccak256_words(words, self.field.params.num_bytes * ncols)

    def hash_leaf_host(self, row):
        data = b"".join(self.field(v).as_bytes() for v in row)
        return keccak.keccak256(data)
