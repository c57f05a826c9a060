"""Kernels 8 and 9 over the four dense fields (BN254 Fr and Fq, BLS12-377
Fr and Fq), built for the host with ``g++`` and held against Python ints
and the plain versions, and kernel 8's programs held against the JAX
package's op chain.

* kernel 8's element function (``csrc/dense_field.cuh``'s
  ``lw_dn_op_elements``): every op at 1, 2 and 4 elements a thread, on
  random values and on the edge values each against each, and with a
  broadcast operand (element stride 0);
* kernel 8's program entry (``lw_dn_program_element``) on Plonk's round-3
  quotient and Groth16's h, scheduled by ``ops.dense._schedule``, against
  ``DenseField.program_plain``; the schedule's checks;
* kernel 9's block (``csrc/dense_inverse.cuh``'s ``lw_dn_inv_block``) in
  one round and in three on zero patterns: ragged sizes, a whole block of
  zeros, a zero last, all zeros, one element;
* ``program_plain`` of the quotient against the same expression through
  the JAX package's ``ops/limbs`` ops, over BN254 Fr at 2^6 values.

The host tests skip without ``g++``.  On the host the block runs its
threads one after another (tid = 0, nt = 1).  Tolerance: exact equality
(every value is an integer).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu.fields import BN254Fr as JaxFr
from lambda_elliptic_curves_tpu_torch import native
from lambda_elliptic_curves_tpu_torch.fields import (
    BLS12377Field, BLS12377Fr, BN254Field, BN254Fr,
)
from lambda_elliptic_curves_tpu_torch.ops import dense
from lambda_elliptic_curves_tpu_torch.provers.plonk.prover import quotient_evaluations

torch.set_num_threads(1)

FIELDS = {"bn254_fr": BN254Fr, "bn254_fq": BN254Field, "bls12_377_fr": BLS12377Fr,
          "bls12_377_fq": BLS12377Field}
#: the quotient's evaluations and constants (provers/plonk/prover.py)
QUOTIENT_EVALS = ("a", "b", "c", "ql", "qr", "qm", "qo", "qc", "pi", "x", "z", "zw", "s1",
                  "s2", "s3", "l1", "zh_inv")
QUOTIENT_CONSTS = ("beta", "gamma", "k1", "k2", "alpha", "one")

_HOST_SRC = """
#include <vector>
#include "dense_field.cuh"
#include "dense_inverse.cuh"

#define BY_FIELD(field, CALL)                                            \\
    switch (field) {                                                     \\
        case LW_DENSE_BN254_FR: { typedef LwBn254Fr32 F; return CALL; }    \\
        case LW_DENSE_BN254_FQ: { typedef LwBn254Fq32 F; return CALL; }    \\
        case LW_DENSE_BLS12_377_FR: { typedef LwBls12377Fr32 F; return CALL; } \\
        default: { typedef LwBls12377Fq32 F; return CALL; }             \\
    }

// kernel 8's op over n elements: every block of T threads, E elements each
template <class F, int E>
static int op_blocks(int op, LwDnOperand a, LwDnOperand b, int32_t* out, long n, int T,
                     const uint32_t* e, int nbits) {
    for (long i0 = 0; i0 < n; i0 += (long)T * E) {
        for (int t = 0; t < T; t++) {
            const long i = i0 + t;
            if (op == LW_DN_ADD)
                lw_dn_op_elements<F, LW_DN_ADD, E>(a, b, out, n, i, T, e, nbits);
            else if (op == LW_DN_SUB)
                lw_dn_op_elements<F, LW_DN_SUB, E>(a, b, out, n, i, T, e, nbits);
            else if (op == LW_DN_MUL)
                lw_dn_op_elements<F, LW_DN_MUL, E>(a, b, out, n, i, T, e, nbits);
            else if (op == LW_DN_NEG)
                lw_dn_op_elements<F, LW_DN_NEG, E>(a, b, out, n, i, T, e, nbits);
            else if (op == LW_DN_SQUARE)
                lw_dn_op_elements<F, LW_DN_SQUARE, E>(a, b, out, n, i, T, e, nbits);
            else
                lw_dn_op_elements<F, LW_DN_POW, E>(a, b, out, n, i, T, e, nbits);
        }
    }
    return 0;
}

template <class F>
static int op_e(int op, int E, LwDnOperand a, LwDnOperand b, int32_t* out, long n, int T,
                const uint32_t* e, int nbits) {
    switch (E) {
        case 1: return op_blocks<F, 1>(op, a, b, out, n, T, e, nbits);
        case 2: return op_blocks<F, 2>(op, a, b, out, n, T, e, nbits);
        case 4: return op_blocks<F, 4>(op, a, b, out, n, T, e, nbits);
        default: return -1;
    }
}

extern "C" int kernel8_op(int field, int op, int E, int T, const int32_t* a, long a_ls,
                          long a_es, const int32_t* b, long b_ls, long b_es, int32_t* out,
                          long n, const uint32_t* e, int nbits) {
    const LwDnOperand x = {a, a_ls, a_es}, y = {b, b_ls, b_es};
    BY_FIELD(field, op_e<F>(op, E, x, y, out, n, T, e, nbits))
}

// the slots laid out as a block of 4 threads' in shared memory, filled
// with garbage first
template <class F>
static int program_elements(const LwDnProgram& P, int32_t* out, long n) {
    std::vector<uint32_t> slots(4 * P.slots * F::LIMBS, 0xA5A5A5A5u);
    for (long i = 0; i < n; i++) lw_dn_program_element<F>(P, out, n, i, slots.data() + i % 4, 4);
    return 0;
}

// kernel 8's program entry, element by element; -1 for a malformed program
extern "C" int kernel8_program(int field, int n_inputs, const int32_t* const* inputs,
                               const long* ls, const long* es, int steps, const uint8_t* op,
                               const uint8_t* dst, const uint8_t* a, const uint8_t* b,
                               int out_slot, int32_t* out, long n) {
    LwDnProgram P = {};
    if (!lw_dn_program_make(P, n_inputs, inputs, ls, es, steps, op, dst, a, b, out_slot))
        return -1;
    BY_FIELD(field, program_elements<F>(P, out, n))
}

template <class F, int K>
static int inverse_blocks(const int32_t* x, int32_t* out, long n, int T, int R) {
    std::vector<uint32_t> tree(lw_di_smem_words(T, F::LIMBS), 0xA5A5A5A5u);
    int blocks = 0;
    for (long b = 0; b * T * K * R < n; b++, blocks++)
        lw_dn_inv_block<F, K, 256>(x, out, n, b, T, R, 0, 1, tree.data());
    return blocks;
}

template <class F>
static int inverse_k(const int32_t* x, int32_t* out, long n, int T, int K, int R) {
    if (T < 1 || T > 256 || (T & (T - 1)) || R < 1) return -1;
    switch (K) {
        case 1: return inverse_blocks<F, 1>(x, out, n, T, R);
        case 2: return inverse_blocks<F, 2>(x, out, n, T, R);
        case 4: return inverse_blocks<F, 4>(x, out, n, T, R);
        case 8: return inverse_blocks<F, 8>(x, out, n, T, R);
        default: return -1;
    }
}

// kernel 9 over n elements at T threads and R rounds of K elements a
// thread; its blocks
extern "C" int kernel9(int field, const int32_t* x, int32_t* out, long n, int T, int K, int R) {
    BY_FIELD(field, inverse_k<F>(x, out, n, T, K, R))
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """ctypes handle of kernels 8 and 9's headers built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the dense kernels' code for the host")
    d = tmp_path_factory.mktemp("dense_kernels")
    src, so = d / "kernels.cpp", d / "libkernels.so"
    src.write_text(_HOST_SRC)
    r = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", native.CSRC_DIR,
                        "-o", str(so), str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.kernel8_op.argtypes = [I, I, I, I, P, L, L, P, L, L, P, L, P, I]
    lib.kernel8_program.argtypes = [I, I, P, P, P, I, P, P, P, P, I, P, L]
    lib.kernel9.argtypes = [I, P, P, L, I, I, I]
    for fn in (lib.kernel8_op, lib.kernel8_program, lib.kernel9):
        fn.restype = I
    return lib


def _vals(p, n, seed):
    rng = np.random.default_rng(seed)
    nb = (p.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nb), "little") % p for _ in range(n)]


def _edges(f):
    """The products' edge values as Montgomery forms: 0, 1, p - 1, p - 2,
    R mod p, and 2^k - 1, 2^k - 2 (mod p) for k the bit length of p, one
    less, and 32 L - 2."""
    p, L = f.p, f.num_limbs
    R, k = 1 << (32 * L), p.bit_length()
    rinv = pow(R, -1, p)
    return [v * rinv % p for v in [0, 1, p - 1, p - 2, R % p] + [
        ((1 << j) - d) % p for j in (k, k - 1, 32 * L - 2) for d in (1, 2)]]


def _ints(f, t):
    return [int(v) for v in f.to_ints(t)]


@pytest.mark.parametrize("elements", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_host_kernel8_ops_equal_python_ints(host, name, elements):
    """Every op of kernel 8's element function (``dense32.cuh``'s product
    and carry-chain sums) at E elements a thread and 4 threads a block, on
    random values and the edge values each against each (a ragged last
    block), and with a broadcast operand, against Python ints."""
    f = FIELDS[name]
    p, kid, L = f.p, f.ops.kernel_id, f.num_limbs
    edge = _edges(f)
    a = _vals(p, 61, 1) + [u for u in edge for _ in edge]
    b = _vals(p, 61, 2) + [v for _ in edge for v in edge]
    n = len(a)
    x, y = f.array(a, "cpu"), f.array(b, "cpu")
    c = y[:, 7:8].contiguous()
    e = p - 2 if name.endswith("fq") else 2**200 + 12345
    ew = np.array([(e >> (32 * k)) & 0xFFFFFFFF for k in range(12)], np.uint32)
    want = {
        dense.STEP_OPS["add"]: [(u + v) % p for u, v in zip(a, b)],
        dense.STEP_OPS["sub"]: [(u - v) % p for u, v in zip(a, b)],
        dense.STEP_OPS["mul"]: [u * v % p for u, v in zip(a, b)],
        dense.STEP_OPS["neg"]: [-u % p for u in a],
        dense.STEP_OPS["square"]: [u * u % p for u in a],
        5: [pow(u, e, p) for u in a],
    }
    for op, expect in want.items():
        for bt, b_es, bv in ((y, 1, b), (c, 0, [b[7]] * n)):
            out = torch.full_like(x, 0x5A5A5A5A)  # the blocks must write every element
            assert host.kernel8_op(kid, op, elements, 4, x.data_ptr(), n, 1, bt.data_ptr(),
                                   bt.shape[1], b_es, out.data_ptr(), n, ew.ctypes.data,
                                   e.bit_length()) == 0
            if op in (0, 1, 2) and b_es == 0:
                expect = [(u + v) % p if op == 0 else (u - v) % p if op == 1 else u * v % p
                          for u, v in zip(a, bv)]
            assert _ints(f, out) == expect, (op, b_es)
            if op not in (0, 1, 2):
                break  # b is unread


def _quotient_inputs(f, n, seed, device="cpu"):
    """The quotient's inputs: 17 (L, n) evaluation planes and 6 constants
    (L, 1), from one seed."""
    rng = np.random.default_rng(seed)
    draw = lambda m: [int(v) for v in rng.integers(0, 2**62, m)]  # noqa: E731
    ev = {k: f.array([(v << 190) % f.p for v in draw(n)], device) for k in QUOTIENT_EVALS}
    cs = {k: f.constant(v, (1,), device) for k, v in zip(QUOTIENT_CONSTS, draw(5) + [1])}
    return ev, cs


def _quotient_program(f, ev, cs):
    ch = f.ops.chain()
    e = {k: ch.input(v) for k, v in ev.items()}
    c = {k: ch.input(v) for k, v in cs.items()}
    quotient_evaluations(ch, e, c)
    return ch


def _host_program(lib, f, steps, inputs):
    """Kernel 8's program element by element on the host."""
    L = f.num_limbs
    batch = tuple(torch.broadcast_shapes(*(t.shape for t in inputs))[1:])
    n = int(np.prod(batch))
    ops, dst, a, b, out_slot = dense._schedule(steps, len(inputs))
    ptrs, ls, es = [], [], []
    for t in inputs:
        if t.shape[1:] == batch:
            t = t.reshape(L, n)
            ptrs.append(t.data_ptr()), ls.append(t.stride(0)), es.append(t.stride(1))
        else:  # a broadcast constant
            ptrs.append(t.data_ptr()), ls.append(t.stride(0)), es.append(0)
    out = torch.full((L,) + batch, 0x5A5A5A5A, dtype=torch.int32)
    m, k = len(ops), len(inputs)
    u8 = lambda v: (ctypes.c_uint8 * m)(*v)  # noqa: E731
    assert lib.kernel8_program(f.ops.kernel_id, k, (ctypes.c_void_p * k)(*ptrs),
                               (ctypes.c_long * k)(*ls), (ctypes.c_long * k)(*es), m, u8(ops),
                               u8(dst), u8(a), u8(b), out_slot, out.data_ptr(), n) == 0
    return out


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_host_kernel8_program_equals_plain(host, name):
    """Kernel 8's program entry on Plonk's round-3 quotient (17 planes and 6
    constants, three of the planes rows of a 3-row tensor), on Groth16's h
    and on a program of neg and square steps, against ``program_plain`` and
    the same expressions through the field's own plain ops."""
    f = FIELDS[name]
    ev, cs = _quotient_inputs(f, 37, 3)
    three = torch.stack([ev["a"], ev["b"], ev["c"]], dim=1)  # (L, 3, n): rows as views
    ev["a"], ev["b"], ev["c"] = three[:, 0], three[:, 1], three[:, 2]
    ch = _quotient_program(f, ev, cs)
    want = quotient_evaluations(f, ev, cs)
    assert torch.equal(f.ops.program_plain(ch.steps_encoded(), ch.inputs), want)
    assert torch.equal(_host_program(host, f, ch.steps_encoded(), ch.inputs), want)
    ch = f.ops.chain()
    h = ch.mul(ch.sub(ch.mul(ch.input(ev["a"]), ch.input(ev["b"])), ch.input(ev["c"])),
               ch.input(ev["zh_inv"]))
    assert h == ("step", 2)
    want = f.mul(f.sub(f.mul(ev["a"], ev["b"]), ev["c"]), ev["zh_inv"])
    assert torch.equal(_host_program(host, f, ch.steps_encoded(), ch.inputs), want)
    assert torch.equal(ch.run(h), want)
    # neg and square, and a step on constants alone
    ch = f.ops.chain()
    x, c = ch.input(ev["a"]), ch.input(cs["beta"])
    out = ch.sub(ch.square(ch.add(ch.neg(x), c)), ch.mul(c, ch.neg(c)))
    want = f.sub(f.square(f.add(f.neg(ev["a"]), cs["beta"])),
                 f.mul(cs["beta"], f.neg(cs["beta"])))
    assert torch.equal(_host_program(host, f, ch.steps_encoded(), ch.inputs), want)
    assert torch.equal(ch.run(out), want)


def test_program_schedule_reuses_slots_and_refuses_bad_programs():
    """The quotient's 42 steps fit the kernel's 16 slots; a program that
    reads a value before it is computed, a step op the kernel lacks, and a
    program that holds 17 values at once are refused."""
    f = BN254Fr
    ev, cs = _quotient_inputs(f, 4, 5)
    ch = _quotient_program(f, ev, cs)
    steps = ch.steps_encoded()
    ops, dst, _, _, _ = dense._schedule(steps, len(ch.inputs))
    assert len(steps) == 42 and len(ch.inputs) == 23 and max(dst) < dense.PROGRAM_SLOTS
    with pytest.raises(ValueError):
        dense._schedule([("add", 0, 2)], 2)
    with pytest.raises(ValueError):
        dense._schedule([("pow", 0, 1)], 2)
    wide = [("add", 0, 1)] * 17 + [("add", 2 + k, 2 + k + 1) for k in range(16)]
    with pytest.raises(ValueError):
        dense._schedule(wide, 2)
    assert dense._schedule(wide[:16] + [("add", 2 + k, 2 + k + 1) for k in range(15)], 2)


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("case", ["ragged", "zero_block", "zero_last", "all_zero", "one"])
def test_host_dense_inverse_block_zero_patterns(host, name, case):
    """Kernel 9's block at 8 threads x 4 elements (32 a block) in one round
    and in three, and at the field's own K with 64 threads: n not a
    multiple of a block, a whole block of zeros, a zero as the last
    element, all zeros, one element; zeros map to zero, the rest equal the
    plain version."""
    f = FIELDS[name]
    n = {"ragged": 1001, "zero_block": 160, "zero_last": 97, "all_zero": 70, "one": 1}[case]
    vals = _vals(f.p, n, n)
    if case == "zero_block":
        vals[32:64] = [0] * 32
    elif case in ("zero_last", "ragged"):
        vals[-1] = 0
    elif case == "all_zero":
        vals = [0] * n
    a = f.array(vals, "cpu")
    for T, K, R in ((8, 4, 1), (8, 4, 3), (64, 4, 1)):
        out = torch.full_like(a, 0x5A5A5A5A)
        assert host.kernel9(f.ops.kernel_id, a.data_ptr(), out.data_ptr(), n, T, K, R) \
            == -(-n // (T * K * R))
        assert torch.equal(out, f.ops.batch_inverse_plain(a)), (T, K, R)
    assert _ints(f, out) == [pow(v, -1, f.p) if v else 0 for v in vals]


def test_program_plain_equals_jax_op_chain():
    """Plonk's round-3 quotient over BN254 Fr at 2^6 values from one seed:
    ``program_plain`` of the port's program and the same expression
    through the JAX package's ``ops/limbs`` ops (``PrimeField.add`` / ``sub``
    / ``mul``), bit for bit."""
    f = BN254Fr
    ev, cs = _quotient_inputs(f, 64, 7)
    ch = _quotient_program(f, ev, cs)
    got = f.ops.program_plain(ch.steps_encoded(), ch.inputs)
    je = {k: f.ops.to_jax_digits(v) for k, v in ev.items()}
    jc = {k: f.ops.to_jax_digits(v) for k, v in cs.items()}
    want = quotient_evaluations(JaxFr, je, jc)
    assert torch.equal(got, f.ops.from_jax_digits(np.asarray(want)))
