"""Merkle trees with batched device hashing.

Counterpart of ``lambda_elliptic_curves_tpu/merkle/tree.py``; parity with
``MerkleTree::build`` / ``get_proof_by_pos`` / ``Proof::verify``
(``crypto/src/merkle_tree/merkle.rs:33,58``, ``proof.rs:20``).

Every level, the parents included, is one batched hash call on the
tensors' device (the Keccak kernel on a card), and all levels stay there:
the root and the sibling paths that proofs need are gathered and moved to
the host in one transfer.  Unbalanced inputs are padded by repeating the
last leaf (the reference's ``complete_until_power_of_two``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class MerkleBackend:
    """A hashing backend: how to hash leaf data and how to merge nodes."""

    def hash_leaves(self, leaves):
        raise NotImplementedError

    def hash_parents(self, level):
        raise NotImplementedError

    def to_host(self, nodes) -> list:
        raise NotImplementedError


@dataclasses.dataclass
class Proof:
    """Inclusion proof: sibling path bottom-up (``proof.rs:15``)."""

    merkle_path: list

    def verify(self, backend: MerkleBackend, root, index: int, value) -> bool:
        """Rebuild the root walking the sibling path (``proof.rs:20``)."""
        node = backend.hash_leaf_host(value)
        for sibling in self.merkle_path:
            if index % 2 == 0:
                node = backend.hash_parent_host(node, sibling)
            else:
                node = backend.hash_parent_host(sibling, node)
            index //= 2
        return node == root


class MerkleTree:
    """``levels[0]`` = leaf digests, ``levels[-1]`` = the root, each a
    ``(node_words, count)`` tensor on the device that hashed it."""

    def __init__(self, backend: MerkleBackend, levels: list):
        self.backend = backend
        self.levels = levels
        self._root = None

    @classmethod
    def build(cls, backend: MerkleBackend, leaves):
        """``leaves``: backend-specific batched tensor; one leaf-hash call,
        then the parent levels."""
        return cls.from_leaf_digests(backend, backend.hash_leaves(leaves))

    @classmethod
    def from_leaf_digests(cls, backend: MerkleBackend, hashed):
        """Build from already-hashed leaves: log2(n) parent-hash calls."""
        levels = [backend.pad_to_power_of_two(hashed)]
        while backend.count(levels[-1]) > 1:
            levels.append(backend.hash_parents(levels[-1]))
        return cls(backend, levels)

    @property
    def root(self):
        if self._root is None:
            self._root = self.backend.to_host(self.levels[-1])[0]
        return self._root

    def get_proof_by_pos(self, pos: int) -> Proof:
        """Sibling path for leaf ``pos`` (``merkle.rs:58``)."""
        return self.gather_proofs([pos])[0]

    def gather_proofs(self, positions) -> list:
        """Sibling paths for many leaves with one device-to-host transfer:
        the sibling indices of every level are computed on the host, each
        level is gathered with one ``index_select``, and the packed
        ``(node_words, L*Q)`` result moves once."""
        positions = [int(p) for p in positions]
        Q = len(positions)
        L = len(self.levels) - 1
        if Q == 0:
            return []
        if L == 0:
            return [Proof(merkle_path=[]) for _ in positions]
        picks, idx = [], positions
        for lvl in self.levels[:-1]:
            n = self.backend.count(lvl)
            rows = torch.from_numpy(
                np.asarray([min(i ^ 1, n - 1) for i in idx], np.int64)).to(lvl.device)
            picks.append(torch.index_select(lvl, -1, rows))
            idx = [i >> 1 for i in idx]
        nodes = self.backend.to_host(torch.cat(picks, dim=-1))
        return [Proof(merkle_path=[nodes[lv * Q + q] for lv in range(L)])
                for q in range(Q)]
