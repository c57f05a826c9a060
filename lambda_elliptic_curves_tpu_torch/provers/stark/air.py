"""AIR (algebraic intermediate representation) abstraction.

Parity: the ``AIR`` trait (``provers/stark/src/traits.rs:75``),
``TransitionConstraint`` (``constraints/transition.rs``) and
``BoundaryConstraint(s)`` (``constraints/boundary.rs:63``).

Constraints are evaluated **columnwise over the whole evaluation domain at
once**.  ``compute_transition`` receives a :class:`Frame` whose
``get(offset_idx, col)`` returns either a full-domain limb tensor (prover
path — one vector expression per constraint) or
a single host field element (verifier path at the out-of-domain point), and
an ops context ``ctx`` so the same constraint code runs on both.  This
replaces the reference's per-row closure evaluated LDE-size times.
"""

from __future__ import annotations

import dataclasses

import torch


# ---------------------------------------------------------------------------
# evaluation contexts (one constraint definition, two execution paths)
# ---------------------------------------------------------------------------

class DeviceCtx:
    """Vectorised ops over (8, n) Montgomery limb tensors on ``device``."""

    def __init__(self, field, domain_size, device):
        self.field = field
        self.domain_size = domain_size
        self.device = device

    def add(self, a, b):
        return self.field.add(a, b)

    def sub(self, a, b):
        return self.field.sub(a, b)

    def mul(self, a, b):
        return self.field.mul(a, b)

    def neg(self, a):
        return self.field.neg(a)

    def constant(self, value):
        return self.field.constant(value, (self.domain_size,), self.device)

    def one(self):
        return self.constant(1)


class HostCtx:
    """Exact ops over host FieldElements (verifier at the OOD point)."""

    def __init__(self, field):
        self.field = field

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def mul(self, a, b):
        return a * b

    def neg(self, a):
        return -a

    def constant(self, value):
        return self.field(value)

    def one(self):
        return self.field(1)


class Frame:
    """Access to trace values at the transition offsets.

    Parity: ``Frame::read_from_lde`` (``provers/stark/src/frame.rs:26``) —
    but holding whole shifted columns (device) or the OOD row values (host).
    """

    def __init__(self, getter):
        self._getter = getter

    def get(self, offset_idx: int, col: int):
        return self._getter(offset_idx, col)


def device_frame(lde_columns, offsets, blowup, step_size=1):
    """Build a prover frame: value of column ``col`` at x*g^offset over the
    whole LDE coset is the LDE column rolled by -offset*blowup positions
    (w_lde^blowup = g)."""
    cache = {}

    def getter(offset_idx, col):
        offset = offsets[offset_idx]
        key = (offset, col)
        if key not in cache:
            cache[key] = torch.roll(
                lde_columns[:, col], -offset * blowup * step_size, dims=-1
            )
        return cache[key]

    return Frame(getter)


def host_frame(ood_table):
    """Verifier frame from the proof's OOD evaluations:
    ``ood_table[offset_idx][col]`` host elements."""
    return Frame(lambda offset_idx, col: ood_table[offset_idx][col])


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------

class TransitionConstraint:
    """One transition constraint with its zerofier data
    (``constraints/transition.rs``): holds period/offset/exemptions, and
    ``evaluate(ctx, frame, periodic_values, rap_challenges)``.
    """

    constraint_idx = 0
    period = 1
    offset = 0
    end_exemptions = 1
    exemptions_period = None
    periodic_exemptions_offset = None

    def degree(self) -> int:
        return 1

    def evaluate(self, ctx, frame, periodic_values, rap_challenges):
        raise NotImplementedError

    # -- zerofier (inverse) -------------------------------------------------
    def zerofier_key(self):
        return (self.period, self.offset, self.exemptions_period,
                self.periodic_exemptions_offset, self.end_exemptions)

    def end_exemptions_points(self, g: int, trace_length: int, p: int):
        """Roots of the end-exemptions polynomial: g^(n - e*period)
        (``transition.rs:88``)."""
        return [pow(g, trace_length - e * self.period, p)
                for e in range(1, self.end_exemptions + 1)]

    def evaluate_zerofier_host(self, z, g, trace_length: int):
        """1/Z(z) * exemptions(z) at a host point (``transition.rs:210``)."""
        f = z.field
        n = trace_length
        exemptions = f(1)
        for r in self.end_exemptions_points(g.value, n, f.p):
            exemptions = exemptions * (z - f(r))
        if self.exemptions_period is not None:
            off_exp = n * self.periodic_exemptions_offset // self.exemptions_period
            num = z ** (n // self.exemptions_period) - g ** off_exp
            den = z ** (n // self.period) - g ** (self.offset * n // self.period)
            return num / den * exemptions
        den = z ** (n // self.period) - g ** (self.offset * n // self.period)
        return den.inv() * exemptions


@dataclasses.dataclass
class BoundaryConstraint:
    """t_col(g^step) == value (``constraints/boundary.rs``)."""

    col: int
    step: int
    value: object  # int or FieldElement
    is_aux: bool = False


# ---------------------------------------------------------------------------
# the AIR itself
# ---------------------------------------------------------------------------

class AIR:
    """Base class for AIRs.  Subclasses set:

    * ``field`` — the PrimeField (must be FFT-friendly)
    * ``trace_columns`` / ``aux_columns`` — column counts
    * ``transition_offsets`` — e.g. [0, 1, 2]
    * ``transition_constraints()`` — list of TransitionConstraint
    * ``boundary_constraints(rap_challenges)`` — list of BoundaryConstraint
    * ``composition_poly_degree_bound()``
    * optionally RAP hooks (``build_auxiliary_trace`` / ``build_rap_challenges``,
      ``traits.rs:88,97``) and ``get_periodic_column_values()``.
    """

    field = None
    step_size = 1
    trace_columns = 1
    aux_columns = 0
    transition_offsets = [0, 1]
    #: challenge-field extension degree (``traits.rs:75-80``); only 1 is
    #: ported, the prover and verifier raise for 2 and 4.
    extension_degree = 1

    def __init__(self, trace_length: int, pub_inputs, proof_options):
        self.trace_length = trace_length
        self.pub_inputs = pub_inputs
        self.options = proof_options

    # -- to override ------------------------------------------------------
    def transition_constraints(self) -> list:
        raise NotImplementedError

    def boundary_constraints(self, rap_challenges) -> list:
        raise NotImplementedError

    def composition_poly_degree_bound(self) -> int:
        return 2 * self.trace_length

    def get_periodic_column_values(self) -> list:
        """List of periodic columns, each a list of ints (one period)."""
        return []

    # RAP (two-phase traces); default = no interaction
    has_trace_interaction = False

    def build_rap_challenges(self, transcript) -> list:
        return []

    def build_auxiliary_trace(self, main_trace, rap_challenges):
        return None

    # -- derived ------------------------------------------------------------
    @property
    def num_transition_constraints(self) -> int:
        return len(self.transition_constraints())

    def compute_transition(self, ctx, frame, periodic_values, rap_challenges):
        """Evaluate every transition constraint (ordered by constraint_idx)."""
        constraints = self.transition_constraints()
        out = [None] * len(constraints)
        for c in constraints:
            out[c.constraint_idx] = c.evaluate(ctx, frame, periodic_values,
                                               rap_challenges)
        return out

    def trace_primitive_root(self) -> int:
        order = (self.trace_length * self.step_size).bit_length() - 1
        return self.field.params.primitive_root_of_unity(order)
