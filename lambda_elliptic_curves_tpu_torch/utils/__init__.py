"""Shared utilities: errors, proof serialization."""

from . import errors  # noqa: F401
