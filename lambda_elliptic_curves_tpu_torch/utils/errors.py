"""Error types for the framework.

Parity: lambdaworks ``math/src/errors.rs``, ``math/src/field/errors.rs``,
``math/src/fft/errors.rs`` — collapsed into a small Python hierarchy.
"""


class LambdaTPUError(Exception):
    """Base class for all framework errors."""


class CreationError(LambdaTPUError):
    """Invalid input when constructing a value (e.g. bad hex string)."""


class ByteConversionError(LambdaTPUError):
    """Raised when bytes cannot be converted to/from a value."""


class DeserializationError(LambdaTPUError):
    """Raised when a serialized blob cannot be parsed."""


class FieldError(LambdaTPUError):
    """Field arithmetic error (zero inverse, missing root of unity...)."""


class RootOfUnityError(FieldError):
    """Requested a 2^order root of unity beyond the field's two-adicity."""


class ZeroInverseError(FieldError):
    """Attempted to invert zero."""


class FFTError(LambdaTPUError):
    """FFT/NTT domain errors."""


class PairingError(LambdaTPUError):
    """Pairing over points not in the proper subgroup."""


class ProvingError(LambdaTPUError):
    """Prover-side protocol failure (e.g. wrong trace shape)."""


class VerificationError(LambdaTPUError):
    """Verifier-side protocol failure."""
