"""Fiat–Shamir transcripts (host only)."""

from .transcript import DefaultTranscript  # noqa: F401
