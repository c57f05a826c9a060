"""Batched arithmetic over the dense prime fields on 32-bit limb planes:
BN254 Fr and Fq and BLS12-377 Fr on four 64-bit words, BLS12-377 Fq on six.

Counterpart of the generic path of ``lambda_elliptic_curves_tpu/ops/
limbs.py`` for these moduli (the Stark252 module :mod:`.limbs` keeps its
own code, so nothing on the STARK path changes).  Layout: a batch is an
``(L, *batch)`` ``torch.int32`` tensor of x * R mod p, least significant
limb first, with L = 2 W limbs and R = 2^(64 W): L = 8 and R = 2^256 for
the 4-word fields, L = 12 and R = 2^384 for BLS12-377 Fq.  That is the JAX
package's R (sixteen or twenty-four 16-bit digits there), so a port value
and a JAX value have the same bits (:meth:`DenseField.from_jax_digits` /
:meth:`DenseField.to_jax_digits`).

The plain versions are :class:`.small.SmallField`'s, which hold for any
number of 16-bit digits: schoolbook columns and a digit-serial Montgomery
reduction in ``int64``, here over all 2 L digits of p.  Every public
operation dispatches on the device of its operands: a CUDA tensor goes to
kernel 8 (``csrc/dense_field.cu``, one launch an op) or kernel 9
(``csrc/batch_inverse.cu``'s dense entry, batch inversion), or raises; a
CPU tensor goes to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import native
from .small import SmallField


#: exponent words that ``lw_dense_field_op`` takes (``LW_DENSE_MAX_LIMBS``)
MAX_LIMBS = 12


class DenseField(SmallField):
    """The arithmetic of one dense prime field p < 2^(64 W - 2) on
    ``(2 W, *batch)`` int32 limbs (``kernel_id``: the field's number in
    ``csrc/dense.cuh``; ``words``: its W, 4 or 6).  Its launches count in
    ``native.launches`` under ``dense_field``, ``dense_inv`` and
    ``dense_ntt``, followed by ``counter_suffix`` (the curve's instances of
    the kernels count apart)."""

    #: no kernel carries a tower over a dense field: its extensions compose
    #: its ops (kernel 8)
    tower_kernel = False

    def __init__(self, name: str, p: int, kernel_id: int, words: int = 4,
                 counter_suffix: str = ""):
        if words not in (4, 6) or p.bit_length() > 64 * words - 2:
            raise ValueError("the dense kernels take moduli below 2^254 on 4 words "
                             "or below 2^382 on 6")
        super().__init__(name, p, 2 * words, kernel_id)
        self.WORDS = words
        self.counter_suffix = counter_suffix
        self.field_counter = "dense_field" + counter_suffix
        self.inv_counter = "dense_inv" + counter_suffix
        self.ntt_counter = "dense_ntt" + counter_suffix

    def __repr__(self):
        return f"DenseField({self.name})"

    # -- host conversions ------------------------------------------------------
    def ints_to_limbs(self, values, device) -> torch.Tensor:
        """Python ints (any nested list / array) -> ``(L, *shape)`` int32
        limbs of the canonical representatives (not Montgomery form)."""
        arr = np.asarray(values, dtype=object)
        flat = arr.reshape(-1)
        L, nb = self.LIMBS, 4 * self.LIMBS
        buf = b"".join((int(v) % self.P).to_bytes(nb, "little") for v in flat)
        mat = np.frombuffer(buf, dtype="<u4").reshape(flat.size, L).T
        out = np.array(mat, order="C").view(np.int32).reshape((L,) + arr.shape)
        return torch.from_numpy(out).to(device)

    def limbs_to_ints(self, t: torch.Tensor) -> np.ndarray:
        """``(L, *batch)`` limbs -> object ndarray of the Python ints they
        spell (no Montgomery conversion)."""
        a = t.detach().to("cpu").numpy()
        L, nb = self.LIMBS, 4 * self.LIMBS
        buf = np.ascontiguousarray(a.reshape(L, -1).T).astype("<i4").tobytes()
        out = np.array([int.from_bytes(buf[nb * i:nb * i + nb], "little")
                        for i in range(len(buf) // nb)] or [], dtype=object)
        return out.reshape(a.shape[1:])

    # -- kernel 8 and 9 wrappers (csrc/dense_field.cu, csrc/batch_inverse.cu) --
    def op_cuda(self, op: int, a, b=None, *, exponent: int = 0, **_) -> torch.Tensor:
        """One launch of kernel 8: ``op`` on CUDA tensors ``(L, *batch)``."""
        L = self.LIMBS
        shape = a.shape if b is None else torch.broadcast_shapes(a.shape, b.shape)
        batch = tuple(shape[1:])
        n = math.prod(batch)
        out = torch.empty((L,) + batch, dtype=torch.int32, device=a.device)
        a_t, a_ls, a_es = self._operand(a, L, batch, n)
        b_t, b_ls, b_es = (a_t, a_ls, a_es) if b is None else self._operand(b, L, batch, n)
        if b_t.device != a_t.device:
            raise ValueError("operands on different devices")
        if exponent < 0 or exponent >= 1 << (32 * L):
            raise ValueError(f"kernel 8 takes exponents below 2^{32 * L} for {self.name}")
        words = (ctypes.c_uint32 * MAX_LIMBS)(
            *[(exponent >> (32 * k)) & 0xFFFFFFFF for k in range(MAX_LIMBS)])
        if n == 0:
            return out
        native.launch(self.field_counter, "lw_dense_field_op", self.kernel_id, op, a_t.data_ptr(),
                      a_ls, a_es, b_t.data_ptr(), b_ls, b_es, out.data_ptr(), n, words,
                      exponent.bit_length())
        return out

    def batch_inverse_cuda(self, a) -> torch.Tensor:
        """Kernel 9: the tiled Montgomery trick of ``csrc/batch_inverse.cuh``
        on the dense product, over the flattened batch (2 levels - 1
        launches, one inversion per call, zeros to zero)."""
        L = self.LIMBS
        if a.dtype != torch.int32 or not a.is_cuda or a.dim() < 1 or a.shape[0] != L:
            raise TypeError(f"batch inversion takes ({L}, *batch) int32 CUDA tensors")
        flat = a.reshape(L, -1).contiguous()
        out = torch.empty_like(flat)
        n = flat.shape[1]
        if n:
            words = ctypes.c_long()
            launches = native.cuda_lib().lw_dense_batch_inverse_plan(self.kernel_id, n,
                                                                    ctypes.byref(words))
            scratch = torch.empty(max(words.value, 1), dtype=torch.int32, device=a.device)
            native.launch(self.inv_counter, "lw_dense_batch_inverse", self.kernel_id,
                          flat.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
                          count=launches)
        return out.reshape(a.shape)

    def batch_inverse(self, a):
        """Elementwise inverse, zeros mapping to zero, by Montgomery's trick:
        on the card kernel 9, on the CPU the plain version."""
        return self.batch_inverse_plain(a) if self._on_cpu(a) else self.batch_inverse_cuda(a)

    mont_inv = batch_inverse


BN254_FR = DenseField(
    "bn254_scalar", 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001, 0)
BN254_FQ = DenseField(
    "bn254_base", 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47, 1)
BLS12_377_FR = DenseField(
    "bls12_377_scalar", 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001, 2,
    counter_suffix="_bls12_377")
BLS12_377_FQ = DenseField(
    "bls12_377_base", int("1AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B"
                          "5D44300000008508C00000000001", 16), 3, words=6,
    counter_suffix="_bls12_377")

#: modulus -> arithmetic, for the fields that this module carries
BY_MODULUS = {f.P: f for f in (BN254_FR, BN254_FQ, BLS12_377_FR, BLS12_377_FQ)}
