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
(``csrc/dense_inverse.cu``, batch inversion, one launch a call), or raises;
a CPU tensor goes to the plain version.

A chain of ops can run as one launch of kernel 8's program entry:
:meth:`DenseField.program` takes the steps as data, and :class:`Chain`
records them from calls that read like the field's own ops.  Its plain
version, :meth:`DenseField.program_plain`, runs the same steps through the
plain ops in the same order.
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

#: a program's step ops (``csrc/dense_field.cuh``'s ``LW_DN_*``), and its
#: most inputs, steps and live values (``LW_DN_PROG_INPUTS``, ``_STEPS``,
#: ``_SLOTS``)
STEP_OPS = {"add": 0, "sub": 1, "mul": 2, "neg": 3, "square": 4}
PROGRAM_INPUTS, PROGRAM_STEPS, PROGRAM_SLOTS = 32, 64, 16


def _schedule(steps, n_inputs: int):
    """Kernel 8's encoding of ``steps`` (see :meth:`DenseField.program`):
    (ops, destination slots, operands a, operands b, the output's slot).  A
    step's value takes a slot that no live value holds; a slot is free
    again after its value's last use, so that at most ``PROGRAM_SLOTS``
    values are live at once.  A kernel operand names input k as k and slot
    j as ``n_inputs + j``."""
    if not 1 <= len(steps) <= PROGRAM_STEPS or not 0 <= n_inputs <= PROGRAM_INPUTS:
        raise ValueError(f"a program takes 1 to {PROGRAM_STEPS} steps and at most "
                         f"{PROGRAM_INPUTS} inputs")
    last_use = {}
    for s, (op, a, b) in enumerate(steps):
        if op not in STEP_OPS:
            raise ValueError(f"no program step {op!r}")
        for k in (a,) if op in ("neg", "square") else (a, b):
            if not 0 <= k < n_inputs + s:
                raise ValueError(f"step {s} reads operand {k}, which is not yet computed")
            last_use[k] = s
    free, slot_of = list(range(PROGRAM_SLOTS)), {}
    enc = ([], [], [], [])
    for s, (op, a, b) in enumerate(steps):
        srcs = (a,) if op in ("neg", "square") else (a, b)
        codes = [k if k < n_inputs else n_inputs + slot_of[k] for k in srcs]
        for k in set(srcs):
            if k >= n_inputs and last_use[k] == s:
                free.append(slot_of.pop(k))
        if not free:
            raise ValueError(f"a program holds at most {PROGRAM_SLOTS} values at once")
        free.sort()
        slot = slot_of[n_inputs + s] = free.pop(0)
        if n_inputs + s not in last_use and s < len(steps) - 1:
            free.append(slot_of.pop(n_inputs + s))  # a value that nothing reads
        for lst, v in zip(enc, (STEP_OPS[op], slot, codes[0], codes[-1])):
            lst.append(v)
    return enc + (slot_of[n_inputs + len(steps) - 1],)


class Chain:
    """A straight-line program over one dense field, recorded from calls:
    ``add``, ``sub``, ``mul``, ``neg`` and ``square`` (the names of the
    field's own ops) take and return handles, and :meth:`input` makes a
    tensor one.  :meth:`run` computes the last step: one launch of kernel
    8's program entry on CUDA tensors, the plain ops on CPU ones.  An
    expression written against a field's ops runs unchanged on a chain."""

    def __init__(self, ops: "DenseField"):
        self.ops = ops
        self.inputs, self.steps = [], []

    def input(self, t: torch.Tensor):
        self.inputs.append(t)
        return ("in", len(self.inputs) - 1)

    def _step(self, op: str, a, b=None):
        self.steps.append((op, a, b))
        return ("step", len(self.steps) - 1)

    def add(self, a, b):
        return self._step("add", a, b)

    def sub(self, a, b):
        return self._step("sub", a, b)

    def mul(self, a, b):
        return self._step("mul", a, b)

    def neg(self, a):
        return self._step("neg", a)

    def square(self, a):
        return self._step("square", a)

    def steps_encoded(self) -> list:
        """The steps as :meth:`DenseField.program` takes them."""
        k = len(self.inputs)
        enc = lambda h: None if h is None else h[1] + (k if h[0] == "step" else 0)  # noqa
        return [(op, enc(a), enc(b)) for op, a, b in self.steps]

    def run(self, out) -> torch.Tensor:
        """The value of handle ``out``, the chain's last step."""
        if out != ("step", len(self.steps) - 1):
            raise ValueError("a chain computes its last step")
        return self.ops.program(self.steps_encoded(), self.inputs)


class DenseField(SmallField):
    """The arithmetic of one dense prime field p < 2^(64 W - 2) on
    ``(2 W, *batch)`` int32 limbs (``kernel_id``: the field's number in
    ``csrc/dense.cuh``; ``words``: its W, 4 or 6).  Its launches count in
    ``native.launches`` under ``dense_field`` (kernel 8's ops),
    ``dense_program`` (its programs), ``dense_inv`` and ``dense_ntt``,
    followed by ``counter_suffix`` (the curve's instances of the kernels
    count apart)."""

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
        self.program_counter = "dense_program" + counter_suffix
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

    # -- kernel 8 and 9 wrappers (csrc/dense_field.cu, csrc/dense_inverse.cu) --
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
        """Kernel 9: Montgomery's trick inside each block of
        ``csrc/dense_inverse.cu`` over the flattened batch, one launch a
        call, zeros to zero."""
        L = self.LIMBS
        if a.dtype != torch.int32 or not a.is_cuda or a.dim() < 1 or a.shape[0] != L:
            raise TypeError(f"batch inversion takes ({L}, *batch) int32 CUDA tensors")
        flat = a.reshape(L, -1).contiguous()
        out = torch.empty_like(flat)
        n = flat.shape[1]
        if n:
            native.launch(self.inv_counter, "lw_dense_inverse", self.kernel_id, flat.data_ptr(),
                          out.data_ptr(), n)
        return out.reshape(a.shape)

    def program_cuda(self, steps, inputs) -> torch.Tensor:
        """One launch of kernel 8's program entry: ``steps`` over CUDA
        tensors ``inputs`` (see :meth:`program`)."""
        L = self.LIMBS
        for t in inputs:
            if t.dtype != torch.int32 or not t.is_cuda or t.shape[0] != L:
                raise TypeError(f"a program takes ({L}, *batch) int32 CUDA tensors")
        if len({t.device for t in inputs}) > 1:
            raise ValueError("operands on different devices")
        batch = tuple(torch.broadcast_shapes(*(t.shape for t in inputs))[1:])
        n = math.prod(batch)
        ops, dst, src_a, src_b, out_slot = _schedule(steps, len(inputs))
        operands = [self._operand(t, L, batch, n) for t in inputs]
        out = torch.empty((L,) + batch, dtype=torch.int32, device=inputs[0].device)
        if n == 0:
            return out
        k, m = len(operands), len(ops)
        u8 = lambda v: (ctypes.c_uint8 * m)(*v)  # noqa: E731
        native.launch(self.program_counter, "lw_dense_field_program", self.kernel_id, k,
                      (ctypes.c_void_p * k)(*[t.data_ptr() for t, _, _ in operands]),
                      (ctypes.c_long * k)(*[ls for _, ls, _ in operands]),
                      (ctypes.c_long * k)(*[es for _, _, es in operands]), m, u8(ops),
                      u8(dst), u8(src_a), u8(src_b), out_slot, out.data_ptr(), n)
        return out

    def program_plain(self, steps, inputs) -> torch.Tensor:
        """The plain version of :meth:`program`: the same steps through the
        plain ops in the same order, on any device."""
        _schedule(steps, len(inputs))  # the same checks as the kernel's
        plain = {"add": self.add_plain, "sub": self.sub_plain, "mul": self.mont_mul_plain,
                 "neg": self.neg_plain, "square": self.square_plain}
        vals = list(inputs)
        for op, a, b in steps:
            vals.append(plain[op](vals[a]) if op in ("neg", "square")
                        else plain[op](vals[a], vals[b]))
        shape = torch.broadcast_shapes(*(t.shape for t in inputs))
        return vals[-1].expand(shape).contiguous()

    def program(self, steps, inputs) -> torch.Tensor:
        """A straight-line program of field ops over ``inputs``, ``(L,
        *batch)`` tensors that broadcast together: ``steps`` is a list of
        (op, a, b), op one of ``STEP_OPS`` (b unused by neg and square), an
        operand k naming input k below ``len(inputs)`` and step k -
        len(inputs)'s value above; the last step's value is returned.  On
        CUDA tensors one launch of kernel 8 (at most ``PROGRAM_INPUTS``
        inputs, ``PROGRAM_STEPS`` steps and ``PROGRAM_SLOTS`` live values),
        on CPU ones :meth:`program_plain`."""
        if self._on_cpu(*inputs):
            return self.program_plain(steps, inputs)
        return self.program_cuda(steps, inputs)

    def chain(self) -> Chain:
        """An empty :class:`Chain` over this field."""
        return Chain(self)

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
