"""The port's Keccak Merkle trees held against the JAX package's
``merkle.MerkleTree`` with ``KeccakBatchBackend``.

Leaf values come from ``numpy.random.default_rng``.  The JAX side hashes
the leaves of every tree size in one batched call (one compile per column
count) and builds each tree from its slice of the digests.  Tolerance:
exact equality of roots and sibling paths.
"""

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu.fields import Stark252 as JStark252
from lambda_elliptic_curves_tpu.merkle import KeccakBatchBackend as JKeccakBatchBackend
from lambda_elliptic_curves_tpu.merkle import MerkleTree as JMerkleTree
from lambda_elliptic_curves_tpu_torch.fields import Stark252
from lambda_elliptic_curves_tpu_torch.merkle import (
    KeccakBatchBackend, KeccakFieldBackend, MerkleTree,
)

torch.set_num_threads(1)

#: 2^4 .. 2^10 leaves, and one count that is padded to a power of two
SIZES = [1 << k for k in range(4, 11)] + [100]


def _values(rng, ncols, n):
    return [[int.from_bytes(rng.bytes(32), "little") % Stark252.p for _ in range(n)]
            for _ in range(ncols)]


@pytest.mark.parametrize("ncols", [1, 3])
def test_batch_backend_roots_and_paths_equal_jax(ncols):
    rng = np.random.default_rng(ncols)
    cases = [_values(rng, ncols, n) for n in SIZES]
    jb = JKeccakBatchBackend(JStark252)
    every_leaf = [sum((vals[c] for vals in cases), []) for c in range(ncols)]
    jdigests = jb.hash_leaves(JStark252.array(every_leaf))
    backend = KeccakBatchBackend(Stark252)
    start = 0
    for n, vals in zip(SIZES, cases):
        jtree = JMerkleTree.from_leaf_digests(jb, jdigests[:, start:start + n])
        start += n
        tree = MerkleTree.build(backend, Stark252.array(vals, "cpu"))
        assert tree.root == jtree.root, n
        positions = [0, n - 1] + [int(i) for i in rng.integers(0, n, 6)]
        proofs = tree.gather_proofs(positions)
        assert [p.merkle_path for p in proofs] == \
            [p.merkle_path for p in jtree.gather_proofs(positions)], n
        assert tree.get_proof_by_pos(positions[2]).merkle_path == proofs[2].merkle_path
        for pos, proof in zip(positions, proofs):
            row = [vals[c][pos] for c in range(ncols)]
            assert proof.verify(backend, tree.root, pos, row)
            tampered = [row[0] + 1] + row[1:]
            assert not proof.verify(backend, tree.root, pos, tampered)


def test_field_backend_equals_one_column_batch_backend():
    """One element per leaf: both backends hash the 32 big-endian bytes."""
    vals = _values(np.random.default_rng(5), 1, 64)
    field_tree = MerkleTree.build(KeccakFieldBackend(Stark252),
                                  Stark252.array(vals[0], "cpu"))
    batch_tree = MerkleTree.build(KeccakBatchBackend(Stark252),
                                  Stark252.array(vals, "cpu"))
    assert field_tree.root == batch_tree.root
    assert field_tree.gather_proofs([3, 40]) == batch_tree.gather_proofs([3, 40])
    assert field_tree.get_proof_by_pos(7).verify(
        KeccakFieldBackend(Stark252), field_tree.root, 7, vals[0][7])
