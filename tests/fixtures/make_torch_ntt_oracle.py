"""Regenerate jax_ntt_oracle.json: the JAX package's NTT outputs that
``tests/test_torch_ntt.py`` holds the PyTorch port's NTT against.

For every size n = 2^1 .. 2^12 the input is a (2, n) batch of Stark252
values made by :func:`values` from the seed ``100 + log2(n)``; the file
records, for ``ntt.fft``, ``ntt.ifft``, ``ntt.evaluate_offset_fft(f, x, 2,
None, 3)`` and ``ntt.interpolate_offset_fft(f, x, 3)``, the SHA-256 of the
output's Montgomery digits (the JAX layout ``(16, 2, m)`` as little-endian
uint32), and the SHA-256 of the input, so that a test can tell a changed
input recipe from a wrong transform.

Run from the repo root: ``python tests/fixtures/make_torch_ntt_oracle.py``.
Cold, the JAX NTT compiles for tens of seconds per size on a CPU, which is
why the port's tests read this file instead of calling the JAX NTT at
every size.
"""

import hashlib
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from lambda_elliptic_curves_tpu.fields import Stark252  # noqa: E402
from lambda_elliptic_curves_tpu.poly import ntt  # noqa: E402

LOG_SIZES = range(1, 13)
TRANSFORMS = {
    "fft": lambda f, x: ntt.fft(x, f),
    "ifft": lambda f, x: ntt.ifft(x, f),
    "evaluate_offset_fft": lambda f, x: ntt.evaluate_offset_fft(f, x, 2, None, 3),
    "interpolate_offset_fft": lambda f, x: ntt.interpolate_offset_fft(f, x, 3),
}


def values(seed: int, shape) -> np.ndarray:
    """Canonical Stark252 ints, as an object array of ``shape``."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return np.array([int.from_bytes(rng.bytes(32), "little") % Stark252.p
                     for _ in range(n)], dtype=object).reshape(shape)


def digest(digits) -> str:
    return hashlib.sha256(np.asarray(digits).astype("<u4").tobytes()).hexdigest()


def main() -> None:
    cases = {}
    for log_n in LOG_SIZES:
        seed = 100 + log_n
        x = Stark252.array(values(seed, (2, 1 << log_n)))
        cases[str(log_n)] = {
            "seed": seed,
            "input": digest(x),
            **{name: digest(fn(Stark252, x)) for name, fn in TRANSFORMS.items()},
        }
        print(f"n = 2^{log_n} done", flush=True)
    out = pathlib.Path(__file__).parent / "jax_ntt_oracle.json"
    out.write_text(json.dumps(cases, indent=1, sort_keys=True) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
