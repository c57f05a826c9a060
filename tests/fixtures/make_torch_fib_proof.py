"""Regenerate the JAX package's Fibonacci STARK proofs that the PyTorch
port's proofs are held against byte for byte.

Fibonacci AIR over Stark252, ``a0 = a1 = 1``, Keccak ``DefaultTranscript``,
serialized with the JAX package's ``serialize_proof``.  Each proof is
checked with the JAX verifier before it is written:

* ``jax_fib_64_proof.json``: 2^6 rows, ``ProofOptions.default_test_options()``
  (blowup 4, 3 queries, coset offset 3, no grinding);
* ``jax_fib_256_proof.json``: 2^8 rows, ``ProofOptions(4, 4, 3, 0)``;
* ``jax_fib_1024_proof.json``: 2^10 rows, ``ProofOptions(4, 32, 3, 0)``.

Run from the repo root: ``python tests/fixtures/make_torch_fib_proof.py
[ROWS ...]`` (default: all three).  The JAX prover compiles for minutes on
a CPU, which is why the port's tests read these files instead of proving
with JAX themselves.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from lambda_elliptic_curves_tpu.fields import Stark252  # noqa: E402
from lambda_elliptic_curves_tpu.fiat_shamir import DefaultTranscript  # noqa: E402
from lambda_elliptic_curves_tpu.provers.stark import (  # noqa: E402
    ProofOptions, prove, verify,
)
from lambda_elliptic_curves_tpu.provers.stark.examples.fibonacci import (  # noqa: E402
    FibonacciPublicInputs, fibonacci_air_for, fibonacci_trace,
)
from lambda_elliptic_curves_tpu.utils.serialization import (  # noqa: E402
    serialize_proof,
)

#: rows -> (blowup, queries, coset offset, grinding)
CASES = {
    1 << 6: (4, 3, 3, 0),
    1 << 8: (4, 4, 3, 0),
    1 << 10: (4, 32, 3, 0),
}


def write(rows: int) -> None:
    f = Stark252
    air_cls = fibonacci_air_for(f)
    trace = fibonacci_trace(f, [1, 1], rows)
    pub = FibonacciPublicInputs(a0=1, a1=1)
    opts = ProofOptions(*CASES[rows])
    proof = prove(air_cls, trace, pub, opts, DefaultTranscript(f))
    assert verify(air_cls, proof, pub, opts, DefaultTranscript(f))
    out = pathlib.Path(__file__).parent / f"jax_fib_{rows}_proof.json"
    out.write_bytes(serialize_proof(proof))
    print(f"wrote {out} ({out.stat().st_size} bytes)", flush=True)


if __name__ == "__main__":
    for rows in [int(a) for a in sys.argv[1:]] or sorted(CASES):
        write(rows)
