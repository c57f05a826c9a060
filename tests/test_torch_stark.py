"""The port's Fibonacci STARK proofs held against the JAX package's, byte
for byte.

The JAX proofs are ``tests/fixtures/jax_fib_{64,256,1024}_proof.json``,
written by ``tests/fixtures/make_torch_fib_proof.py`` with the JAX
package's prover and ``serialize_proof`` (the JAX prover compiles for
minutes on a CPU, so it does not run here).  Tolerance: equal bytes.
"""

import pathlib

import pytest
import torch

from lambda_elliptic_curves_tpu_torch.fields import Stark252
from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions, prove, verify
from lambda_elliptic_curves_tpu_torch.provers.stark.examples.fibonacci import (
    FibonacciPublicInputs, fibonacci_air_for, fibonacci_trace,
)
from lambda_elliptic_curves_tpu_torch.utils.errors import DeserializationError
from lambda_elliptic_curves_tpu_torch.utils.serialization import (
    deserialize_proof, serialize_proof,
)

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

#: rows -> the options the fixture was proved with
OPTIONS = {
    1 << 6: ProofOptions.default_test_options(),
    1 << 8: ProofOptions(4, 4, 3, 0),
    1 << 10: ProofOptions(4, 32, 3, 0),
}

AIR = fibonacci_air_for(Stark252)
PUB = FibonacciPublicInputs(a0=1, a1=1)


def _jax_proof_bytes(rows: int) -> bytes:
    return (FIXTURES / f"jax_fib_{rows}_proof.json").read_bytes()


def _prove(rows: int, options=None, device="cpu"):
    return prove(AIR, fibonacci_trace(Stark252, [1, 1], rows, device), PUB,
                 options or OPTIONS[rows], DefaultTranscript(Stark252), device=device)


def _verify(proof, rows: int) -> bool:
    return verify(AIR, proof, PUB, OPTIONS[rows], DefaultTranscript(Stark252))


@pytest.mark.parametrize("rows", sorted(OPTIONS))
def test_proof_bytes_equal_jax(rows):
    proof = _prove(rows)
    assert serialize_proof(proof) == _jax_proof_bytes(rows)
    assert _verify(proof, rows)


@pytest.mark.parametrize("rows", [1 << 6, 1 << 8])
def test_verifier_accepts_jax_proof(rows):
    jax_proof = deserialize_proof(_jax_proof_bytes(rows))
    assert serialize_proof(jax_proof) == _jax_proof_bytes(rows)
    assert _verify(jax_proof, rows)


@pytest.mark.parametrize("tamper", [
    "fri_last_value", "main_root", "trace_ood", "parts_ood", "opening", "fri_sym",
])
def test_tampered_proof_is_rejected(tamper):
    rows = 1 << 6
    proof = deserialize_proof(_jax_proof_bytes(rows))
    p = Stark252.p
    if tamper == "fri_last_value":
        proof.fri_last_value = (proof.fri_last_value + 1) % p
    elif tamper == "main_root":
        root = proof.lde_trace_main_merkle_root
        proof.lde_trace_main_merkle_root = bytes([root[0] ^ 1]) + root[1:]
    elif tamper == "trace_ood":
        proof.trace_ood_evaluations[1][0] = (proof.trace_ood_evaluations[1][0] + 1) % p
    elif tamper == "parts_ood":
        parts = proof.composition_poly_parts_ood_evaluation
        parts[0] = (parts[0] + 1) % p
    elif tamper == "opening":
        ev = proof.deep_poly_openings[0].main_trace_polys.evaluations
        ev[0] = (ev[0] + 1) % p
    else:
        sym = proof.query_list[0].layers_evaluations_sym
        sym[0] = (sym[0] + 1) % p
    assert not _verify(proof, rows)


def test_malformed_proof_bytes_raise():
    with pytest.raises(DeserializationError):
        deserialize_proof(b'{"__type__": "os.system", "fields": {}}')
    with pytest.raises(DeserializationError):
        deserialize_proof(b"not json")


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="grinding"):
        _prove(1 << 6, ProofOptions(4, 3, 3, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        prove(fibonacci_air_for(Stark252, extension_degree=2),
              fibonacci_trace(Stark252, [1, 1], 1 << 6, "cpu"), PUB,
              OPTIONS[1 << 6], DefaultTranscript(Stark252), device="cpu")
