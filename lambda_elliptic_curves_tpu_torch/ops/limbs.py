"""Batched Stark252 arithmetic on 32-bit limb planes.

Layout (decided here for the whole port): a batch of Stark252 elements is
a ``(8, *batch)`` ``torch.int32`` tensor; entry ``[k, ...]`` holds the bit
pattern of u32 limb ``k`` of the value, least significant limb first.
Values live in Montgomery form with R = 2^256, the JAX package's R
(sixteen 16-bit digits there), so a port value and a JAX value have the
same bits: :func:`from_jax_digits` / :func:`to_jax_digits` carry state
across, and the Merkle wire form needs no multiply.

Every public operation dispatches on the device of its operands: a CUDA
tensor goes to the elementwise field kernel (``csrc/field.cu``, which
replaces the XLA digit code of ``lambda_elliptic_curves_tpu/ops/limbs.py``)
or to the batch-inversion kernel (``csrc/batch_inverse.cu``), or raises;
a CPU tensor goes to the plain PyTorch version beside it.  The plain
versions compute on 16-bit digits held in ``int64``: torch's CPU
``uint32`` has no ``+``, shifts or comparisons, and a 32x32-bit product
overflows a signed ``int64``.  They accept tensors on any device, so the
kernel can be held against them on the card.

p = 2^251 + 17*2^192 + 1: u32 limbs ``[1, 0, 0, 0, 0, 0, 17, 0x08000000]``,
-p^-1 mod 2^32 = 0xFFFFFFFF.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

LIMBS = 8
P = 2**251 + 17 * 2**192 + 1
R = pow(2, 256, P)            # Montgomery one
R2 = R * R % P                # to-Montgomery factor
P_LIMBS = (1, 0, 0, 0, 0, 0, 17, 0x08000000)

_DIGITS = 16
_MASK16 = 0xFFFF
_P_DIGITS = tuple((P >> (16 * k)) & _MASK16 for k in range(_DIGITS))
_MU16 = (-pow(P, -1, 1 << 16)) % (1 << 16)

_OP_ADD, _OP_SUB, _OP_MUL, _OP_NEG, _OP_SQUARE = range(5)


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def ints_to_limbs(values, device) -> torch.Tensor:
    """Python ints (any nested list / array) -> ``(8, *shape)`` int32 limbs
    of the canonical representatives (not Montgomery form)."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    buf = b"".join((int(v) % P).to_bytes(32, "little") for v in flat)
    mat = np.frombuffer(buf, dtype="<u4").reshape(flat.size, LIMBS).T
    out = np.array(mat, order="C").view(np.int32).reshape((LIMBS,) + arr.shape)
    return torch.from_numpy(out).to(device)


def limbs_to_ints(t: torch.Tensor) -> np.ndarray:
    """``(8, *batch)`` limbs -> object ndarray of Python ints (the integers
    the limbs spell, no Montgomery conversion)."""
    a = t.detach().to("cpu").numpy()
    batch = a.shape[1:]
    buf = np.ascontiguousarray(a.reshape(LIMBS, -1).T).astype("<i4").tobytes()
    n = len(buf) // 32
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = int.from_bytes(buf[32 * i:32 * i + 32], "little")
    return out.reshape(batch)


def from_jax_digits(digits) -> torch.Tensor:
    """JAX package layout ``(16, *B)`` uint32 16-bit digits -> ``(8, *B)``
    int32 limbs with the same value (Montgomery form is kept)."""
    d = np.asarray(digits, dtype=np.uint32)
    limbs = d[0::2] | (d[1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(limbs).view(np.int32))


def to_jax_digits(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`from_jax_digits`."""
    a = np.ascontiguousarray(t.detach().to("cpu").numpy()).view(np.uint32)
    out = np.empty((2 * LIMBS,) + a.shape[1:], np.uint32)
    out[0::2] = a & np.uint32(_MASK16)
    out[1::2] = a >> np.uint32(16)
    return out


def const_limbs(value: int, batch_shape, device) -> torch.Tensor:
    """One value (< 2^256, no reduction) broadcast to ``(8, *batch)``: an
    expanded view, not a copy."""
    col = torch.tensor([(int(value) >> (32 * k)) & 0xFFFFFFFF for k in range(LIMBS)],
                       dtype=torch.int64).to(torch.int32)
    col = col.reshape((LIMBS,) + (1,) * len(batch_shape)).to(device)
    return col.expand((LIMBS,) + tuple(batch_shape))


# ---------------------------------------------------------------------------
# plain versions (16-bit digits in int64), any device
# ---------------------------------------------------------------------------

def _digits(x: torch.Tensor) -> torch.Tensor:
    """(8, *B) int32 limbs -> (16, *B) int64 16-bit digits."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & _MASK16, u >> 16], dim=1).reshape((_DIGITS,) + x.shape[1:])


def _from_digits(d: torch.Tensor) -> torch.Tensor:
    return (d[0::2] | (d[1::2] << 16)).to(torch.int32)


def _p_digits(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_P_DIGITS, dtype=torch.int64, device=like.device).reshape(
        (_DIGITS,) + (1,) * (like.dim() - 1))


def _norm(t: torch.Tensor) -> torch.Tensor:
    """Resolve signed carries: every digit but the last ends in [0, 2^16),
    the last keeps the sign and the excess.  Passes run until no carry is
    left (at most one per digit)."""
    t = t.clone()
    while True:
        c = t[:-1] >> 16  # floor division: -1 for a negative digit
        if not bool(c.any()):
            return t
        t[:-1] &= _MASK16
        t[1:] += c


def _reduce_once(d: torch.Tensor) -> torch.Tensor:
    """d - p if d >= p else d, for normalised digits of a value < 2p."""
    t = _norm(d - _p_digits(d))
    return torch.where(t[-1] >= 0, t, d)


def add_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return _from_digits(_reduce_once(_norm(_digits(a) + _digits(b))))


def sub_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    t = _norm(_digits(a) - _digits(b))
    # a < b leaves a negative top digit: add p back
    return _from_digits(_norm(t + _p_digits(t) * (t[-1] < 0)))


def neg_plain(a):
    return sub_plain(torch.zeros_like(a), a)


_P_NONZERO = [(k, d) for k, d in enumerate(_P_DIGITS) if d]


def mont_mul_plain(a, b):
    """Montgomery product a*b*2^-256 mod p: schoolbook columns, then one
    digit-serial Montgomery reduction (16 steps of a 16-bit quotient)."""
    a, b = torch.broadcast_tensors(a, b)
    x, y = _digits(a), _digits(b)
    cols = torch.zeros((2 * _DIGITS + 1,) + x.shape[1:], dtype=torch.int64,
                       device=x.device)
    for i in range(_DIGITS):  # columns of x*y: each < 16 * 2^32
        cols[i:i + _DIGITS] += x[i] * y
    for i in range(_DIGITS):
        q = ((cols[i] & _MASK16) * _MU16) & _MASK16
        for k, pk in _P_NONZERO:
            cols[i + k] += q * pk
        cols[i + 1] += cols[i] >> 16
    u = _norm(cols[_DIGITS:])  # value < 2p < 2^256: the top column ends 0
    return _from_digits(_reduce_once(u[:_DIGITS]))


def square_plain(a):
    return mont_mul_plain(a, a)


def _exponent(e: int) -> int:
    """An exponent that fits 256 bits and gives the same power (x^0 stays 1
    and 0^e stays 0 for e > 0, as Fermat's little theorem allows)."""
    if e < 0:
        raise ValueError("negative exponent; invert first")
    if e >= 1 << 256:
        e = (e - 1) % (P - 1) + 1
    return e


def mont_pow_plain(a, exponent: int):
    e = _exponent(int(exponent))
    acc = const_limbs(R, a.shape[1:], a.device).contiguous()
    for bit in bin(e)[2:] if e else "":
        acc = mont_mul_plain(acc, acc)
        if bit == "1":
            acc = mont_mul_plain(acc, a)
    return acc


def _scan_mul(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the last axis (log-depth scan)."""
    d = 1
    while d < x.shape[-1]:
        x = torch.cat([x[:, :d], mont_mul_plain(x[:, d:], x[:, :-d])], dim=1)
        d *= 2
    return x


def batch_inverse_plain(a):
    """Elementwise inverse, zeros mapping to zero, by Montgomery's trick:
    prefix and suffix products (log-depth scans over the flattened batch)
    and one inversion of the total, on the host."""
    flat = a.reshape(LIMBS, -1)
    n = flat.shape[1]
    if n == 0:
        return a.clone()
    zero = is_zero(flat)
    one = const_limbs(R, (n,), a.device)
    x = torch.where(zero.unsqueeze(0), one, flat)
    pre = _scan_mul(x)
    suf = _scan_mul(x.flip(-1)).flip(-1)
    m = int(limbs_to_ints(pre[:, -1:])[0])  # total * R
    total_inv = const_limbs(pow(m, -1, P) * R2 % P, (1,), a.device)
    left = torch.cat([one[:, :1], pre[:, :-1]], dim=1)
    right = torch.cat([suf[:, 1:], one[:, :1]], dim=1)
    out = mont_mul_plain(mont_mul_plain(left, right), total_inv)
    return torch.where(zero.unsqueeze(0), torch.zeros_like(out), out).reshape(a.shape)


# ---------------------------------------------------------------------------
# kernel 3 and 4 wrappers (csrc/field.cu, csrc/batch_inverse.cu)
# ---------------------------------------------------------------------------

def _operand(x: torch.Tensor, batch: tuple, n: int):
    """(tensor, limb stride, element stride) for the kernel: one value
    broadcast over the batch is read with element stride 0, anything else
    as a contiguous (8, n) plane set."""
    if x.dtype != torch.int32 or not x.is_cuda or x.shape[0] != LIMBS:
        raise TypeError("field kernel takes (8, *batch) int32 CUDA tensors")
    if n > 1 and x[0].numel() == 1:
        return x, x.stride(0), 0
    x = x.expand((LIMBS,) + batch).contiguous()
    return x, n, 1


def _field_op_cuda(op: int, a, b=None):
    shape = a.shape if b is None else torch.broadcast_shapes(a.shape, b.shape)
    batch = tuple(shape[1:])
    n = int(np.prod(batch)) if batch else 1
    out = torch.empty((LIMBS,) + batch, dtype=torch.int32, device=a.device)
    a_t, a_ls, a_es = _operand(a, batch, n)
    b_t, b_ls, b_es = (a_t, a_ls, a_es) if b is None else _operand(b, batch, n)
    if b_t.device != a_t.device:
        raise ValueError("operands on different devices")
    if n == 0:
        return out
    native.launch("field", "lw_field_op", op, a_t.data_ptr(), a_ls, a_es,
                  b_t.data_ptr(), b_ls, b_es, out.data_ptr(), n)
    return out


def _field_pow_cuda(a, exponent: int):
    import ctypes

    e = _exponent(int(exponent))
    batch = tuple(a.shape[1:])
    n = int(np.prod(batch)) if batch else 1
    out = torch.empty((LIMBS,) + batch, dtype=torch.int32, device=a.device)
    a_t, a_ls, a_es = _operand(a, batch, n)
    words = (ctypes.c_uint32 * LIMBS)(
        *[(e >> (32 * k)) & 0xFFFFFFFF for k in range(LIMBS)])
    if n == 0:
        return out
    native.launch("field_pow", "lw_field_pow", a_t.data_ptr(), a_ls, a_es,
                  out.data_ptr(), n, words, e.bit_length())
    return out


def _batch_inverse_cuda(a):
    """Kernel 4 (``csrc/batch_inverse.cu``): a tiled Montgomery trick over
    the flattened batch, 2 levels - 1 launches, the levels above the first
    in a scratch tensor (``lw_field_batch_inverse_plan`` gives both)."""
    import ctypes

    if a.dtype != torch.int32 or not a.is_cuda or a.dim() < 1 or a.shape[0] != LIMBS:
        raise TypeError("batch inversion takes (8, *batch) int32 CUDA tensors")
    flat = a.reshape(LIMBS, -1).contiguous()
    out = torch.empty_like(flat)
    n = flat.shape[1]
    if n:
        words = ctypes.c_long()
        launches = native.cuda_lib().lw_field_batch_inverse_plan(n, ctypes.byref(words))
        scratch = torch.empty(max(words.value, 1), dtype=torch.int32, device=a.device)
        native.launch("field_inv", "lw_field_batch_inverse", flat.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), n, count=launches)
    return out.reshape(a.shape)


# ---------------------------------------------------------------------------
# public ops: CPU tensor -> plain version, CUDA tensor -> kernel
# ---------------------------------------------------------------------------

def _on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def add(a, b):
    """Modular addition of canonical values (either domain)."""
    return add_plain(a, b) if _on_cpu(a, b) else _field_op_cuda(_OP_ADD, a, b)


def sub(a, b):
    return sub_plain(a, b) if _on_cpu(a, b) else _field_op_cuda(_OP_SUB, a, b)


def neg(a):
    return neg_plain(a) if _on_cpu(a) else _field_op_cuda(_OP_NEG, a)


def mont_mul(a, b):
    """Montgomery product a*b*R^-1 mod p (R = 2^256)."""
    return mont_mul_plain(a, b) if _on_cpu(a, b) else _field_op_cuda(_OP_MUL, a, b)


def square(a):
    return square_plain(a) if _on_cpu(a) else _field_op_cuda(_OP_SQUARE, a)


def mont_pow(a, exponent: int):
    """a^exponent in the Montgomery domain, for a host exponent."""
    return mont_pow_plain(a, exponent) if _on_cpu(a) else _field_pow_cuda(a, exponent)


def batch_inverse(a):
    """Elementwise inverse, zeros mapping to zero, by Montgomery's trick: on
    the card kernel 4 (one inversion per call), on the CPU the plain
    version."""
    return batch_inverse_plain(a) if _on_cpu(a) else _batch_inverse_cuda(a)


mont_inv = batch_inverse


def to_mont(a):
    """Canonical limbs -> Montgomery form (multiply by R^2)."""
    return mont_mul(a, const_limbs(R2, (1,) * (a.dim() - 1), a.device))


def from_mont(a):
    """Montgomery form -> canonical limbs (multiply by 1)."""
    return mont_mul(a, const_limbs(1, (1,) * (a.dim() - 1), a.device))


def is_zero(a):
    return (a == 0).all(dim=0)


def equal(a, b):
    return (a == b).all(dim=0)


def select(cond, a, b):
    """Elementwise over the batch: cond ? a : b."""
    return torch.where(cond.unsqueeze(0), a, b)
