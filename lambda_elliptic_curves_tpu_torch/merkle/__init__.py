"""Merkle trees: batched device hashing, host proofs."""

from .tree import MerkleTree, Proof, MerkleBackend  # noqa: F401
from .backends import KeccakFieldBackend, KeccakBatchBackend  # noqa: F401
