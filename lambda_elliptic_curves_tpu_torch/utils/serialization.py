"""Proof serialization, counterpart of ``lambda_elliptic_curves_tpu/utils/
serialization.py``: a deterministic JSON-with-hex encoding, byte-equal to
the JAX package's for equal proofs, and its decoder (so that either
package's verifier reads the other's proofs)."""

from __future__ import annotations

import json

_PROOF_TYPES = ("StarkProof", "PolynomialOpenings", "DeepPolynomialOpening",
                "FriDecommitment")


def _encode(obj):
    from ..merkle.tree import Proof as MerkleProof
    from ..provers.stark.proof import (
        DeepPolynomialOpening, FriDecommitment, PolynomialOpenings, StarkProof,
    )

    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if isinstance(obj, int):
        return obj if abs(obj) < (1 << 53) else {"__int__": hex(obj)}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if isinstance(obj, MerkleProof):
        return {"__merkle_proof__": _encode(obj.merkle_path)}
    if isinstance(obj, (StarkProof, PolynomialOpenings, DeepPolynomialOpening,
                        FriDecommitment)):
        return {
            "__type__": type(obj).__name__,
            "fields": {k: _encode(v) for k, v in vars(obj).items()},
        }
    if obj is None:
        return None
    raise TypeError(f"cannot serialize {type(obj)}")


def _decode(obj):
    from ..merkle.tree import Proof as MerkleProof
    from ..provers.stark import proof as stark_proof

    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    if obj is None or isinstance(obj, int):
        return obj
    if not isinstance(obj, dict):
        raise ValueError(f"unexpected leaf of type {type(obj).__name__}")
    if "__bytes__" in obj:
        return bytes.fromhex(obj["__bytes__"])
    if "__int__" in obj:
        return int(obj["__int__"], 16)
    if "__merkle_proof__" in obj:
        path = _decode(obj["__merkle_proof__"])
        if not isinstance(path, list) or not all(isinstance(x, bytes) for x in path):
            raise ValueError("merkle path must be a list of byte nodes")
        return MerkleProof(merkle_path=path)
    # only the proof dataclasses are constructible from the wire
    name = obj.get("__type__")
    if name not in _PROOF_TYPES or not isinstance(obj.get("fields"), dict):
        raise ValueError(f"unknown tagged object {name!r} in proof stream")
    return getattr(stark_proof, name)(
        **{k: _decode(v) for k, v in obj["fields"].items()})


def serialize_proof(proof) -> bytes:
    """StarkProof -> bytes (deterministic)."""
    return json.dumps(_encode(proof), sort_keys=True).encode()


def deserialize_proof(data: bytes):
    """bytes -> StarkProof; raises ``DeserializationError`` on malformed
    input."""
    from .errors import DeserializationError

    try:
        return _decode(json.loads(data.decode()))
    except (ValueError, KeyError, TypeError, AttributeError, RecursionError,
            UnicodeDecodeError) as exc:
        raise DeserializationError(str(exc)[:500]) from exc
