"""STARK prover/verifier (stark-platinum parity) over limb tensors."""

from .air import (  # noqa: F401
    AIR, BoundaryConstraint, TransitionConstraint, DeviceCtx, HostCtx,
)
from .domain import Domain  # noqa: F401
from .options import ProofOptions, SecurityLevel  # noqa: F401
from .proof import StarkProof  # noqa: F401
from .prover import Prover, prove  # noqa: F401
from .trace import TraceTable  # noqa: F401
from .verifier import Verifier, verify  # noqa: F401
