"""Fibonacci AIR (parity: ``provers/stark/src/examples/simple_fibonacci.rs``).

One column; constraint a(x g^2) - a(x g) - a(x) = 0 with 2 end exemptions;
boundary a(1)=a0, a(g)=a1; composition degree bound = trace length.
"""

from __future__ import annotations

import dataclasses

from ..air import AIR, BoundaryConstraint, TransitionConstraint
from ..trace import TraceTable


class FibConstraint(TransitionConstraint):
    constraint_idx = 0
    end_exemptions = 2

    def evaluate(self, ctx, frame, periodic_values, rap_challenges):
        a0 = frame.get(0, 0)
        a1 = frame.get(1, 0)
        a2 = frame.get(2, 0)
        return ctx.sub(ctx.sub(a2, a1), a0)


@dataclasses.dataclass
class FibonacciPublicInputs:
    a0: int = 1
    a1: int = 1


class FibonacciAIR(AIR):
    trace_columns = 1
    transition_offsets = [0, 1, 2]

    def __init__(self, trace_length, pub_inputs, proof_options, field=None):
        super().__init__(trace_length, pub_inputs, proof_options)
        if field is not None:
            self.field = field
        self._constraints = [FibConstraint()]

    def transition_constraints(self):
        return self._constraints

    def boundary_constraints(self, rap_challenges):
        return [
            BoundaryConstraint(col=0, step=0, value=self.pub_inputs.a0),
            BoundaryConstraint(col=0, step=1, value=self.pub_inputs.a1),
        ]

    def composition_poly_degree_bound(self):
        return self.trace_length


def fibonacci_air_for(field, extension_degree: int = 1):
    """Bind the AIR to a field (the reference is generic over IsFFTField).
    ``extension_degree`` > 1, challenges in a tower over the field
    (``traits.rs:75-80``), is not ported yet: the prover raises for it."""

    class BoundFibonacciAIR(FibonacciAIR):
        pass

    BoundFibonacciAIR.field = field
    BoundFibonacciAIR.extension_degree = extension_degree
    return BoundFibonacciAIR


def fibonacci_trace(field, initial_values, trace_length, device):
    """``fibonacci_trace`` (simple_fibonacci.rs:163), on ``device``."""
    a, b = int(initial_values[0]), int(initial_values[1])
    col = [a, b]
    for _ in range(2, trace_length):
        col.append((col[-1] + col[-2]) % field.p)
    return TraceTable.from_columns(field, [col], device)
