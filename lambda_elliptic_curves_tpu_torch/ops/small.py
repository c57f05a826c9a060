"""Batched arithmetic over the prime fields below 2^64 (Goldilocks,
BabyBear) and their quadratic and quartic towers, on 32-bit limb planes.

The sibling of :mod:`.limbs` (Stark252).  Layout: a batch of base values
is a ``(L, *batch)`` ``torch.int32`` tensor of x * R mod p, least
significant limb first, with R = 2^(32 L): L = 2 and R = 2^64 for
Goldilocks, L = 1 and R = 2^32 for BabyBear.  That is the JAX package's R
(``K = 2 L`` sixteen-bit digits there), so a port value and a JAX value
have the same bits: :meth:`SmallField.from_jax_digits` /
:meth:`SmallField.to_jax_digits` carry state across.  A batch of values of
the degree-D tower (``fields/extensions.py``) is a ``(D L, *batch)``
tensor, components depth-first.

Every public operation dispatches on the device of its operands: a CUDA
tensor goes to kernel 6 (``csrc/small_field.cu``, one launch per op,
whatever the degree; batch inversion on a kernel of its own, Montgomery's
trick inside each block), or raises; a CPU tensor goes to the plain PyTorch
version, which computes on 16-bit digits held in ``int64`` (a 32x32-bit
product overflows a signed ``int64``) and composes tower ops from base
ops as the JAX package does.  The plain versions take tensors on any
device, so the kernel can be held against them on the card.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import native

_MASK16 = 0xFFFF

_OP_ADD, _OP_SUB, _OP_MUL, _OP_NEG, _OP_SQUARE, _OP_POW, _OP_INV = range(7)
_NO_EXPONENT = (ctypes.c_uint32 * 8)()


class SmallField:
    """The arithmetic of one prime field p < 2^64 on ``(L, *batch)`` int32
    limbs (``kernel_id``: the field's number in ``csrc/small_field.cu``)."""

    #: kernel 6 also carries the quadratic and quartic towers over the field
    #: (``fields.extensions.DeviceQuadraticField`` launches it for a tower op)
    tower_kernel = True

    def __init__(self, name: str, p: int, limbs: int, kernel_id: int):
        self.name = name
        self.P = p
        self.LIMBS = limbs
        self.kernel_id = kernel_id
        self.K = 2 * limbs                       # 16-bit digits
        self.R = pow(2, 32 * limbs, p)           # Montgomery one
        self.R2 = self.R * self.R % p            # to-Montgomery factor
        self._p_digits = tuple((p >> (16 * k)) & _MASK16 for k in range(self.K))
        self._mu16 = (-pow(p, -1, 1 << 16)) % (1 << 16)

    def __repr__(self):
        return f"SmallField({self.name})"

    # -- host conversions ------------------------------------------------------
    def ints_to_limbs(self, values, device) -> torch.Tensor:
        """Python ints (any nested list / array) -> ``(L, *shape)`` int32
        limbs of the canonical representatives (not Montgomery form)."""
        arr = np.asarray(values, dtype=object)
        flat = np.array([int(v) % self.P for v in arr.reshape(-1)], dtype=np.uint64)
        mat = np.stack([(flat >> np.uint64(32 * k)) & np.uint64(0xFFFFFFFF)
                        for k in range(self.LIMBS)]).astype(np.uint32)
        out = mat.view(np.int32).reshape((self.LIMBS,) + arr.shape)
        return torch.from_numpy(np.ascontiguousarray(out)).to(device)

    def limbs_to_ints(self, t: torch.Tensor) -> np.ndarray:
        """``(L, *batch)`` limbs -> object ndarray of the Python ints they
        spell (no Montgomery conversion)."""
        a = np.ascontiguousarray(t.detach().to("cpu").numpy()).view(np.uint32)
        acc = np.zeros(a.shape[1:], dtype=np.uint64)
        for k in range(self.LIMBS):
            acc |= a[k].astype(np.uint64) << np.uint64(32 * k)
        return np.array([int(v) for v in acc.reshape(-1)], dtype=object).reshape(acc.shape)

    def from_jax_digits(self, digits) -> torch.Tensor:
        """JAX package layout ``(K, *B)`` uint32 16-bit digits -> ``(L, *B)``
        int32 limbs with the same value (Montgomery form is kept); a tower
        array ``(D K, *B)`` maps to ``(D L, *B)`` in the same way."""
        d = np.asarray(digits, dtype=np.uint32)
        limbs = d[0::2] | (d[1::2] << np.uint32(16))
        return torch.from_numpy(np.ascontiguousarray(limbs).view(np.int32))

    def to_jax_digits(self, t: torch.Tensor) -> np.ndarray:
        """Inverse of :meth:`from_jax_digits`."""
        a = np.ascontiguousarray(t.detach().to("cpu").numpy()).view(np.uint32)
        out = np.empty((2 * a.shape[0],) + a.shape[1:], np.uint32)
        out[0::2] = a & np.uint32(_MASK16)
        out[1::2] = a >> np.uint32(16)
        return out

    def const_limbs(self, value: int, batch_shape, device) -> torch.Tensor:
        """One value (< 2^(32 L), no reduction) broadcast to ``(L, *batch)``:
        an expanded view, not a copy."""
        col = torch.tensor([(int(value) >> (32 * k)) & 0xFFFFFFFF for k in range(self.LIMBS)],
                           dtype=torch.int64).to(torch.int32)
        col = col.reshape((self.LIMBS,) + (1,) * len(batch_shape)).to(device)
        return col.expand((self.LIMBS,) + tuple(batch_shape))

    # -- plain versions (16-bit digits in int64), any device -------------------
    def _digits(self, x: torch.Tensor) -> torch.Tensor:
        """(L, *B) int32 limbs -> (K, *B) int64 16-bit digits."""
        u = x.to(torch.int64) & 0xFFFFFFFF
        return torch.stack([u & _MASK16, u >> 16], dim=1).reshape((self.K,) + x.shape[1:])

    @staticmethod
    def _from_digits(d: torch.Tensor) -> torch.Tensor:
        return (d[0::2] | (d[1::2] << 16)).to(torch.int32)

    def _p_col(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self._p_digits, dtype=torch.int64, device=like.device).reshape(
            (self.K,) + (1,) * (like.dim() - 1))

    @staticmethod
    def _norm(t: torch.Tensor) -> torch.Tensor:
        """Resolve signed carries: every digit but the last ends in
        [0, 2^16), the last keeps the sign and the excess."""
        t = t.clone()
        while True:
            c = t[:-1] >> 16  # floor division: -1 for a negative digit
            if not bool(c.any()):
                return t
            t[:-1] &= _MASK16
            t[1:] += c

    def _reduce_once(self, d: torch.Tensor) -> torch.Tensor:
        """d - p if d >= p else d, for normalised digits of a value < 2p
        (the last digit may exceed 16 bits)."""
        t = self._norm(d - self._p_col(d))
        return torch.where(t[-1] >= 0, t, d)

    def add_plain(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return self._from_digits(self._reduce_once(self._norm(self._digits(a) + self._digits(b))))

    def sub_plain(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        t = self._norm(self._digits(a) - self._digits(b))
        return self._from_digits(self._norm(t + self._p_col(t) * (t[-1] < 0)))

    def neg_plain(self, a):
        return self.sub_plain(torch.zeros_like(a), a)

    def mont_mul_plain(self, a, b):
        """Montgomery product a*b*R^-1 mod p: schoolbook columns, then a
        digit-serial Montgomery reduction, each of its K steps adding q*p
        (a 16-bit quotient) to K columns at once."""
        a, b = torch.broadcast_tensors(a, b)
        K = self.K
        x, y = self._digits(a), self._digits(b)
        cols = torch.zeros((2 * K + 1,) + x.shape[1:], dtype=torch.int64, device=x.device)
        for i in range(K):  # columns of x*y: each < K * 2^32
            cols[i:i + K] += x[i] * y
        p_col = self._p_col(x)
        for i in range(K):
            q = ((cols[i] & _MASK16) * self._mu16) & _MASK16
            cols[i:i + K] += q * p_col
            cols[i + 1] += cols[i] >> 16
        u = self._norm(cols[K:])  # K + 1 digits of a value < 2p
        u[K - 1] += u[K] << 16    # 2p may pass 2^(16 K): fold the top digit in
        return self._from_digits(self._reduce_once(u[:K]))

    def square_plain(self, a):
        return self.mont_mul_plain(a, a)

    def _exponent(self, e: int) -> int:
        """An exponent below p that gives the same power (x^0 stays 1 and
        0^e stays 0 for e > 0, as Fermat's little theorem allows)."""
        if e < 0:
            raise ValueError("negative exponent; invert first")
        if e >= self.P:
            e = (e - 1) % (self.P - 1) + 1
        return e

    def mont_pow_plain(self, a, exponent: int):
        e = self._exponent(int(exponent))
        acc = self.const_limbs(self.R, a.shape[1:], a.device).contiguous()
        for bit in bin(e)[2:] if e else "":
            acc = self.mont_mul_plain(acc, acc)
            if bit == "1":
                acc = self.mont_mul_plain(acc, a)
        return acc

    def _scan_mul(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive prefix products along the last axis (log-depth scan)."""
        d = 1
        while d < x.shape[-1]:
            x = torch.cat([x[:, :d], self.mont_mul_plain(x[:, d:], x[:, :-d])], dim=1)
            d *= 2
        return x

    def batch_inverse_plain(self, a):
        """Elementwise inverse, zeros mapping to zero, by Montgomery's trick:
        prefix and suffix products (log-depth scans over the flattened
        batch) and one inversion of the total, on the host."""
        flat = a.reshape(self.LIMBS, -1)
        n = flat.shape[1]
        if n == 0:
            return a.clone()
        zero = self.is_zero(flat)
        one = self.const_limbs(self.R, (n,), a.device)
        x = torch.where(zero.unsqueeze(0), one, flat)
        pre = self._scan_mul(x)
        suf = self._scan_mul(x.flip(-1)).flip(-1)
        m = int(self.limbs_to_ints(pre[:, -1:])[0])  # total * R
        total_inv = self.const_limbs(pow(m, -1, self.P) * self.R2 % self.P, (1,), a.device)
        left = torch.cat([one[:, :1], pre[:, :-1]], dim=1)
        right = torch.cat([suf[:, 1:], one[:, :1]], dim=1)
        out = self.mont_mul_plain(self.mont_mul_plain(left, right), total_inv)
        return torch.where(zero.unsqueeze(0), torch.zeros_like(out), out).reshape(a.shape)

    # -- kernel 6 wrapper (csrc/small_field.cu) ---------------------------------
    def _operand(self, x: torch.Tensor, rows: int, batch: tuple, n: int):
        """(tensor, limb stride, element stride) for the kernel: one value
        broadcast over the batch (a batch of one, or an expanded view whose
        batch strides are all 0) is read with element stride 0, a batch
        whose dimensions merge into one stride (a contiguous tensor, or a
        row of a ``(rows, k, n)`` tensor) in place, anything else as a
        contiguous (rows, n) plane set."""
        if x.dtype != torch.int32 or not x.is_cuda or x.shape[0] != rows:
            raise TypeError(f"{self.name} kernel takes ({rows}, *batch) int32 CUDA tensors")
        if n > 1 and (x[0].numel() == 1 or not any(x.stride()[1:])):
            return x, x.stride(0), 0
        if tuple(x.shape[1:]) == batch:
            try:
                v = x.view(rows, n)
            except RuntimeError:  # dimensions that do not merge
                v = None
            if v is not None:
                return v, v.stride(0), v.stride(1)
        x = x.expand((rows,) + batch).contiguous()
        return x, n, 1

    def op_cuda(self, op: int, a, b=None, *, degree: int = 1, nr: int = 0,
                exponent: int = 0) -> torch.Tensor:
        """One launch of kernel 6: ``op`` over the degree-``degree`` tower
        (level-1 non-residue ``nr``, a canonical int) on CUDA tensors
        ``(degree L, *batch)``."""
        rows = degree * self.LIMBS
        shape = a.shape if b is None else torch.broadcast_shapes(a.shape, b.shape)
        batch = tuple(shape[1:])
        n = math.prod(batch)
        out = torch.empty((rows,) + batch, dtype=torch.int32, device=a.device)
        a_t, a_ls, a_es = self._operand(a, rows, batch, n)
        b_t, b_ls, b_es = (a_t, a_ls, a_es) if b is None else self._operand(b, rows, batch, n)
        if b_t.device != a_t.device:
            raise ValueError("operands on different devices")
        if exponent < 0 or exponent >= 1 << 256:
            raise ValueError("kernel 6 takes exponents below 2^256")
        words = (ctypes.c_uint32 * 8)(*[(exponent >> (32 * k)) & 0xFFFFFFFF for k in range(8)]) \
            if exponent else _NO_EXPONENT
        if n == 0:
            return out
        native.launch("small_field", "lw_small_field_op", self.kernel_id, degree, op,
                      a_t.data_ptr(), a_ls, a_es, b_t.data_ptr(), b_ls, b_es, out.data_ptr(),
                      n, int(nr) * self.R % self.P, words, exponent.bit_length())
        return out

    # -- public ops: CPU tensor -> plain version, CUDA tensor -> kernel ----------
    @staticmethod
    def _on_cpu(*xs) -> bool:
        return all(x.device.type == "cpu" for x in xs)

    def add(self, a, b):
        return self.add_plain(a, b) if self._on_cpu(a, b) else self.op_cuda(_OP_ADD, a, b)

    def sub(self, a, b):
        return self.sub_plain(a, b) if self._on_cpu(a, b) else self.op_cuda(_OP_SUB, a, b)

    def neg(self, a):
        return self.neg_plain(a) if self._on_cpu(a) else self.op_cuda(_OP_NEG, a)

    def mont_mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p."""
        return self.mont_mul_plain(a, b) if self._on_cpu(a, b) else self.op_cuda(_OP_MUL, a, b)

    def square(self, a):
        return self.square_plain(a) if self._on_cpu(a) else self.op_cuda(_OP_SQUARE, a)

    def mont_pow(self, a, exponent: int):
        """a^exponent in the Montgomery domain, for a host exponent."""
        if self._on_cpu(a):
            return self.mont_pow_plain(a, exponent)
        return self.op_cuda(_OP_POW, a, exponent=self._exponent(int(exponent)))

    def batch_inverse(self, a):
        """Elementwise inverse, zeros mapping to zero: on the card one
        launch of kernel 6's inversion (Montgomery's trick inside each
        block, one Fermat power a block), on the CPU the plain version
        (Montgomery's trick over the whole batch)."""
        return self.batch_inverse_plain(a) if self._on_cpu(a) else self.op_cuda(_OP_INV, a)

    mont_inv = batch_inverse

    def to_mont(self, a):
        """Canonical limbs -> Montgomery form (multiply by R^2)."""
        return self.mont_mul(a, self.const_limbs(self.R2, (1,) * (a.dim() - 1), a.device))

    def from_mont(self, a):
        """Montgomery form -> canonical limbs (multiply by 1)."""
        return self.mont_mul(a, self.const_limbs(1, (1,) * (a.dim() - 1), a.device))

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=0)

    @staticmethod
    def equal(a, b):
        return (a == b).all(dim=0)

    @staticmethod
    def select(cond, a, b):
        """Elementwise over the batch: cond ? a : b."""
        return torch.where(cond.unsqueeze(0), a, b)


GOLDILOCKS = SmallField("goldilocks", 2**64 - 2**32 + 1, 2, 0)
BABYBEAR = SmallField("babybear", 2**31 - 2**27 + 1, 1, 1)

#: modulus -> arithmetic, for the fields that this module carries
BY_MODULUS = {f.P: f for f in (GOLDILOCKS, BABYBEAR)}
