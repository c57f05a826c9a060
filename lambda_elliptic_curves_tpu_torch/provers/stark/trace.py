"""Execution traces (parity: ``TraceTable``, ``provers/stark/src/trace.rs:20``).

A trace is a ``(8, num_columns, num_rows)`` limb tensor in Montgomery form
on an explicit device; all later work (interpolation, LDE, constraint
evaluation) is columnwise tensor math.  An AIR with a trace interaction
builds its auxiliary columns in the prover (``AIR.build_auxiliary_trace``).
"""

from __future__ import annotations


class TraceTable:
    def __init__(self, field, columns):
        """``columns``: (8, C, n) limb tensor (or (8, n) for one column)."""
        self.field = field
        if columns.dim() == 2:
            columns = columns[:, None, :]
        self.columns = columns

    @classmethod
    def from_columns(cls, field, cols, device):
        """``cols``: list of columns, each a list of ints/elements."""
        return cls(field, field.array(cols, device))

    @property
    def num_rows(self) -> int:
        return self.columns.shape[-1]

    def to(self, device) -> "TraceTable":
        """The same trace with its tensors on ``device``."""
        return TraceTable(self.field, self.columns.to(device))
