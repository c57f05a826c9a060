"""Hash functions: Keccak-256 (the rest of the JAX package's ``hashes`` is
ROADMAP queue 1 item 9)."""

from . import keccak  # noqa: F401
