"""STARK proof objects (parity: ``StarkProof``, ``provers/stark/src/proof/
stark.rs:43`` and the opening structs :25-41).

All values are host-side (ints for field elements, bytes for commitments) —
a proof is protocol data, not bulk data.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PolynomialOpenings:
    """Openings at a query index and its symmetric point
    (``PolynomialOpenings``, ``proof/stark.rs:25``)."""

    proof: object  # merkle.Proof
    proof_sym: object
    evaluations: list  # ints
    evaluations_sym: list


@dataclasses.dataclass
class DeepPolynomialOpening:
    composition_poly: PolynomialOpenings
    main_trace_polys: PolynomialOpenings
    aux_trace_polys: object = None  # PolynomialOpenings | None


@dataclasses.dataclass
class FriDecommitment:
    """Per-query FRI openings (``fri/fri_decommit.rs:8``)."""

    layers_auth_paths: list  # merkle.Proof per layer
    layers_evaluations_sym: list  # ints


@dataclasses.dataclass
class StarkProof:
    trace_length: int
    lde_trace_main_merkle_root: bytes
    lde_trace_aux_merkle_root: object  # bytes | None
    trace_ood_evaluations: list  # [offset_idx][col] ints
    composition_poly_root: bytes
    composition_poly_parts_ood_evaluation: list  # ints
    fri_layers_merkle_roots: list  # bytes
    fri_last_value: int
    query_list: list  # FriDecommitment
    deep_poly_openings: list  # DeepPolynomialOpening
    nonce: object  # int | None
