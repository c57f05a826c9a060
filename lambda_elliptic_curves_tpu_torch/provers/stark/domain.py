"""Evaluation domains (parity: ``provers/stark/src/domain.rs:8``).

Host integers describe the domains (roots, offsets, orders); the LDE
points are built on the device, as a ``powers`` tensor, when needed.
"""

from __future__ import annotations

from ...poly import ntt


class Domain:
    def __init__(self, air):
        field = air.field
        self.field = field
        self.blowup_factor = air.options.blowup_factor
        self.trace_length = air.trace_length * air.step_size
        self.root_order = self.trace_length.bit_length() - 1
        self.interpolation_domain_size = self.trace_length
        self.lde_size = self.trace_length * self.blowup_factor
        self.lde_root_order = self.lde_size.bit_length() - 1
        self.coset_offset = int(air.options.coset_offset)
        # generators (host ints)
        self.trace_primitive_root = field.params.primitive_root_of_unity(
            self.root_order
        )
        self.lde_primitive_root = field.params.primitive_root_of_unity(
            self.lde_root_order
        )

    def lde_points(self, device):
        """(8, lde_size) limbs: offset * w_lde^i in natural order."""
        return ntt.powers(
            self.field, self.lde_primitive_root, self.lde_size,
            offset_int=self.coset_offset, device=device,
        )
