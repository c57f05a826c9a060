"""Finite fields: parameter records, limb-tensor arithmetic, host elements."""

from .params import FieldParams
from .element import FieldElement
from .field import PrimeField
from .zoo import STARK252_PRIME, Stark252  # noqa: F401

__all__ = ["FieldParams", "FieldElement", "PrimeField", "Stark252",
           "STARK252_PRIME"]
