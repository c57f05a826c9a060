"""Provers."""
