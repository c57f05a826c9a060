"""Goldilocks and BabyBear, their quadratic and quartic towers and the
challenge bundle of the port, held against Python ints and the JAX
package; kernels 6 and 7 built for the host with ``g++``.

* ``ops/small.py``'s plain ops of both fields against Python ints (edge
  values 0, 1, p - 1, p - 2 and values from ``numpy.random.default_rng``)
  and against the JAX package's ``ops/limbs`` on the same Montgomery
  digits, carried across by ``from_jax_digits``;
* the host towers and the tensor towers' plain ops against the JAX
  package's host ``ExtensionField`` (its ``_tower``);
* the port copies of the ``ChallengeBundle`` unit tests of
  ``tests/test_stark_extension.py``;
* ``csrc/small_field.cuh``'s per-element op (every op, both fields,
  degrees 1, 2 and 4, a broadcast operand among them), its batch-inversion
  block (``lw_sf_inv_block``: both fields, degrees 1, 2 and 4, at several
  threads a block and elements a thread, over random values, the edge
  values and zero patterns laid on the block's own chunks, ragged sizes
  and an operand read with element stride 0) and ``csrc/small_ntt.cuh``'s
  pass block (every pass of sizes 2^1 .. 2^12 at 1 to 4 rows, under the
  fft's plan and at radices of at most 2^1 and 2^3, forward and inverse
  root, at several tile widths), compiled with ``g++`` and held against
  the plain versions.  The arithmetic there is plain C++ (no carry-chain
  instructions), so the host build runs what the card runs.  Skips
  without ``g++``.

Tolerance: exact equality everywhere.
"""

import ctypes
import random
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu.fields import BabyBear as JaxBabyBear
from lambda_elliptic_curves_tpu.fields import Goldilocks as JaxGoldilocks
from lambda_elliptic_curves_tpu.ops import limbs as jax_limbs
from lambda_elliptic_curves_tpu.provers.stark import extension as jax_extension
from lambda_elliptic_curves_tpu_torch import native
from lambda_elliptic_curves_tpu_torch.fields import BabyBear, Goldilocks
from lambda_elliptic_curves_tpu_torch.ops import small
from lambda_elliptic_curves_tpu_torch.poly import ntt
from lambda_elliptic_curves_tpu_torch.provers.stark.extension import ChallengeBundle

torch.set_num_threads(1)

FIELDS = {"goldilocks": (Goldilocks, JaxGoldilocks, small.GOLDILOCKS),
          "babybear": (BabyBear, JaxBabyBear, small.BABYBEAR)}


def _values(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(0, p, size=n, dtype=np.uint64)]
    edge = [0, 1, p - 1, p - 2][:n]
    vals[:len(edge)] = edge
    return vals


# ---------------------------------------------------------------------------
# base fields
# ---------------------------------------------------------------------------

def test_montgomery_constants_equal_jax():
    for F, JF, S in FIELDS.values():
        for key in ("r", "r2", "serialization_r", "num_bytes", "two_adicity"):
            assert getattr(F.params, key) == getattr(JF.params, key), (F.name, key)
        assert F.params.primitive_root_of_unity(10) == JF.params.primitive_root_of_unity(10)
        assert S.R == F.params.r == pow(2, 32 * S.LIMBS, F.p)
        assert F.num_limbs == S.LIMBS and 2 * S.LIMBS == JF.params.num_digits


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_plain_ops_equal_python_ints(name):
    F, _, S = FIELDS[name]
    p = F.p
    a, b = _values(p, 64, 1), _values(p, 64, 2)[::-1]
    ta, tb = F.array(a, "cpu"), F.array(b, "cpu")
    assert [int(v) for v in F.to_ints(ta)] == a
    assert list(F.to_ints(F.add(ta, tb))) == [(x + y) % p for x, y in zip(a, b)]
    assert list(F.to_ints(F.sub(ta, tb))) == [(x - y) % p for x, y in zip(a, b)]
    assert list(F.to_ints(F.neg(ta))) == [(-x) % p for x in a]
    assert list(F.to_ints(F.mul(ta, tb))) == [x * y % p for x, y in zip(a, b)]
    assert list(F.to_ints(F.square(ta))) == [x * x % p for x in a]
    for e in (0, 1, 5, p - 2, p + 3, 3 * p):
        assert list(F.to_ints(F.pow(ta, e))) == [pow(x, e, p) for x in a], e
    assert list(F.to_ints(F.batch_inverse(ta))) == [pow(x, p - 2, p) for x in a]
    assert list(F.to_ints(F.batch_inverse(ta.reshape(-1, 4, 16)).reshape(-1, 64))) == \
        [pow(x, p - 2, p) for x in a]
    assert F.is_zero(ta).tolist() == [x == 0 for x in a]
    assert F.equal(ta, tb).tolist() == [x == y for x, y in zip(a, b)]
    cond = torch.tensor([i % 3 == 0 for i in range(64)])
    assert list(F.to_ints(F.select(cond, ta, tb))) == \
        [x if i % 3 == 0 else y for i, (x, y) in enumerate(zip(a, b))]
    assert list(F.to_ints(F.mul(ta, F.constant(7, (1,), "cpu")))) == [7 * x % p for x in a]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_plain_ops_equal_jax_limbs(name):
    F, JF, S = FIELDS[name]
    fp = JF.params
    a, b = _values(F.p, 32, 3), _values(F.p, 32, 4)
    ja = jax_limbs.to_mont(jnp.asarray(jax_limbs.ints_to_digits_np(a, fp)), fp)
    jb = jax_limbs.to_mont(jnp.asarray(jax_limbs.ints_to_digits_np(b, fp)), fp)
    ta, tb = S.from_jax_digits(np.asarray(ja)), S.from_jax_digits(np.asarray(jb))
    assert torch.equal(ta, F.array(a, "cpu"))
    cases = [
        (jax_limbs.add(ja, jb, fp), F.add(ta, tb)),
        (jax_limbs.sub(ja, jb, fp), F.sub(ta, tb)),
        (jax_limbs.neg(ja, fp), F.neg(ta)),
        (jax_limbs.mont_mul(ja, jb, fp), F.mul(ta, tb)),
        (jax_limbs.mont_square(ja, fp), F.square(ta)),
        (jax_limbs.mont_pow(ja, 12345678901, fp), F.pow(ta, 12345678901)),
        (jax_limbs.from_mont(ja, fp), S.from_mont(ta)),
    ]
    for i, (want, got) in enumerate(cases):
        assert np.array_equal(S.to_jax_digits(got), np.asarray(want)), i


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

def _ext_value(rng, p, degree):
    if degree == 1:
        return rng.randrange(p)
    return (_ext_value(rng, p, degree // 2), _ext_value(rng, p, degree // 2))


TOWERS = [("goldilocks", 2), ("goldilocks", 4), ("babybear", 2), ("babybear", 4)]


@pytest.mark.parametrize("name, degree", TOWERS)
def test_towers_equal_jax_host_tower(name, degree):
    """The port's host and tensor towers (plain ops) against the JAX
    package's host ``ExtensionField`` from its ``_tower``."""
    F, JF, _ = FIELDS[name]
    fd, host = ChallengeBundle(F, degree).fd, ChallengeBundle(F, degree).host
    jhost = jax_extension._tower(JF, degree)[1]
    assert fd.num_limbs == degree * F.num_limbs
    rng = random.Random(degree)
    xs = [_ext_value(rng, F.p, degree) for _ in range(12)]
    ys = [_ext_value(rng, F.p, degree) for _ in range(12)]
    xs[0] = _ext_value(random.Random(0), 1, degree)  # zero
    for x, y in zip(xs, ys):
        assert (host(x) * host(y)).value == (jhost(x) * jhost(y)).value
        assert (host(x) ** 77).value == (jhost(x) ** 77).value
        if host(x).is_zero():
            continue
        assert host(x).inv().value == jhost(x).inv().value
    tx, ty = fd.array(xs, "cpu"), fd.array(ys, "cpu")
    assert fd.to_tuples(tx) == xs
    assert fd.to_tuples(fd.mul(tx, ty)) == [(jhost(x) * jhost(y)).value for x, y in zip(xs, ys)]
    assert fd.to_tuples(fd.add(tx, ty)) == [(jhost(x) + jhost(y)).value for x, y in zip(xs, ys)]
    assert fd.to_tuples(fd.sub(tx, ty)) == [(jhost(x) - jhost(y)).value for x, y in zip(xs, ys)]
    assert fd.to_tuples(fd.neg(tx)) == [(-jhost(x)).value for x in xs]
    assert fd.to_tuples(fd.square(tx)) == [(jhost(x) * jhost(x)).value for x in xs]
    assert fd.to_tuples(fd.pow(tx, 1000003)) == [(jhost(x) ** 1000003).value for x in xs]
    zero = jhost(0).value
    assert fd.to_tuples(fd.batch_inverse(tx)) == \
        [zero] + [jhost(x).inv().value for x in xs[1:]]
    c = fd.constant(ys[1], (12,), "cpu")
    assert fd.to_tuples(fd.mul(tx, c)) == [(jhost(x) * jhost(ys[1])).value for x in xs]


def test_tower_tensor_ops_equal_jax_device_tower():
    """Goldilocks Fp2 and BabyBear Fp4: the port's tensor product against
    the JAX ``DeviceQuadraticField``'s on the same Montgomery digits, and
    its batch inversion against the JAX host tower's inverses (the JAX
    tensor batch inversion compiles for over 30 s on a CPU)."""
    for name, degree in (("goldilocks", 2), ("babybear", 4)):
        F, JF, S = FIELDS[name]
        rng = random.Random(5)
        xs = [_ext_value(rng, F.p, degree) for _ in range(16)]
        ys = [_ext_value(rng, F.p, degree) for _ in range(16)]
        jfd = jax_extension._tower(JF, degree)[0]
        jx, jy = jfd.array(xs), jfd.array(ys)
        fd = ChallengeBundle(F, degree).fd
        tx, ty = S.from_jax_digits(np.asarray(jx)), S.from_jax_digits(np.asarray(jy))
        assert torch.equal(tx, fd.array(xs, "cpu"))
        assert np.array_equal(S.to_jax_digits(fd.mul(tx, ty)), np.asarray(jfd.mul(jx, jy)))
        jhost = jax_extension._tower(JF, degree)[1]
        assert fd.to_tuples(fd.batch_inverse(tx)) == [jhost(x).inv().value for x in xs]


# ---------------------------------------------------------------------------
# ChallengeBundle (port copies of tests/test_stark_extension.py)
# ---------------------------------------------------------------------------

def _nest(flat, degree):
    if degree == 1:
        return flat[0]
    half = degree // 2
    return (_nest(flat[:half], half), _nest(flat[half:], half))


BUNDLES = [(Goldilocks, 2), (BabyBear, 4)]


@pytest.mark.parametrize("field,degree", BUNDLES, ids=["goldilocks_fp2", "babybear_fp4"])
def test_bundle_host_device_roundtrip(field, degree):
    ext = ChallengeBundle(field, degree)
    rng = random.Random(7)
    elems = [ext.host(_ext_value(rng, field.p, degree)) for _ in range(5)]
    for e in elems:
        flat = ext.flat(e)
        assert len(flat) == degree
        assert ext.host(_nest(flat, degree)) == e
    for e in elems:
        arr = ext.fd.constant(e.value, (1,), "cpu")
        assert ext.host(ext.host_value(arr)) == e
    # a leaf of E values: component-major base ints, as the tensor leaves
    leaf = ext.leaf_base_values(elems)
    assert ext.unflatten_leaf(leaf, len(elems)) == elems
    cols = ext.as_base_columns(ext.fd.array(elems, "cpu").reshape(-1, 1, len(elems)))
    assert [int(v) for v in field.to_ints(cols.reshape(field.num_limbs, -1))] == leaf


@pytest.mark.parametrize("field,degree", BUNDLES, ids=["goldilocks_fp2", "babybear_fp4"])
def test_bundle_evaluate_base_coeffs_at_ext_point(field, degree):
    """evaluate_coeffs_at == Horner in the host tower."""
    ext = ChallengeBundle(field, degree)
    rng = random.Random(11)
    coeffs = [rng.randrange(field.p) for _ in range(8)]
    z = ext.host(_ext_value(rng, field.p, degree))
    got = ext.host(ext.host_value(ext.evaluate_coeffs_at(field.array(coeffs, "cpu"), z)))
    want = ext.host(0)
    for c in reversed(coeffs):
        want = want * z + ext.host(c)
    assert got == want


@pytest.mark.parametrize("field,degree", BUNDLES, ids=["goldilocks_fp2", "babybear_fp4"])
def test_bundle_componentwise_ntt_roundtrip(field, degree):
    ext = ChallengeBundle(field, degree)
    rng = random.Random(13)
    vals = [_ext_value(rng, field.p, degree) for _ in range(16)]
    arr = ext.fd.array(vals, "cpu")
    evals = ext.evaluate_offset_fft(arr, 1, None, 1)
    assert ext.fd.to_tuples(ext.interpolate_fft(evals)) == vals
    # component c of the E transform is the base transform of component c
    L = field.num_limbs
    for c in range(degree):
        assert torch.equal(evals[c * L:(c + 1) * L], ntt.fft(arr[c * L:(c + 1) * L], field))


def test_bundle_scale_base_matches_host():
    field = Goldilocks
    ext = ChallengeBundle(field, 2)
    rng = random.Random(17)
    base_vals = [rng.randrange(field.p) for _ in range(6)]
    e = ext.host(_ext_value(rng, field.p, 2))
    got = ext.fd.to_tuples(ext.scale_base(field.array(base_vals, "cpu"), e))
    assert got == [(ext.host(v) * e).value for v in base_vals]


def test_bundle_degree1_is_base_field():
    ext = ChallengeBundle(Goldilocks, 1)
    assert ext.fd is Goldilocks
    assert ext.host is Goldilocks
    assert ext.flat(Goldilocks(5)) == [5]


# ---------------------------------------------------------------------------
# kernels 6 and 7 built for the host
# ---------------------------------------------------------------------------

_HOST_SRC = """
#include <vector>
#include "small_ntt.cuh"

template <class F>
static void ops(int degree, int op, const int32_t* a, long a_ls, long a_es, const int32_t* b,
                long b_ls, long b_es, int32_t* out, long n, uint64_t nr, const uint32_t* w,
                int nbits) {
    LwSfExponent e;
    for (int k = 0; k < 8; k++) e.w[k] = w[k];
    for (long i = 0; i < n; i++) {
        if (degree == 1)
            lw_sf_op_element<F, 1>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, i, nr, e, nbits);
        else if (degree == 2)
            lw_sf_op_element<F, 2>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, i, nr, e, nbits);
        else
            lw_sf_op_element<F, 4>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, i, nr, e, nbits);
    }
}

extern "C" void field_op(int field, int degree, int op, const int32_t* a, long a_ls, long a_es,
                         const int32_t* b, long b_ls, long b_es, int32_t* out, long n,
                         uint64_t nr, const uint32_t* w, int nbits) {
    if (field == 0)
        ops<LwGoldilocks>(degree, op, a, a_ls, a_es, b, b_ls, b_es, out, n, nr, w, nbits);
    else
        ops<LwBabyBear>(degree, op, a, a_ls, a_es, b, b_ls, b_es, out, n, nr, w, nbits);
}

template <class F, int D, int K, int THREADS>
static void inv_blocks(const int32_t* a, long a_ls, long a_es, int32_t* out, long n,
                       uint64_t nr) {
    // the tree starts as garbage, as shared memory does
    std::vector<typename F::T> tree(2 * THREADS, (typename F::T)0x5A5A5A5A5A5A5A5Aull);
    const long per_block = (long)THREADS * K;
    for (long b = 0; b < (n + per_block - 1) / per_block; b++)
        lw_sf_inv_block<F, D, K, THREADS>(a, a_ls, a_es, out, n, (typename F::T)nr, b, THREADS,
                                          0, 1, tree.data());
}

template <class F, int D>
static int inv_degree(int shape, const int32_t* a, long a_ls, long a_es, int32_t* out, long n,
                      uint64_t nr) {
    switch (shape) {  // (threads, elements a thread)
        case 0: inv_blocks<F, D, 1, 1>(a, a_ls, a_es, out, n, nr); return 0;
        case 1: inv_blocks<F, D, 3, 4>(a, a_ls, a_es, out, n, nr); return 0;
        case 2: inv_blocks<F, D, 4, 32>(a, a_ls, a_es, out, n, nr); return 0;
        case 3: inv_blocks<F, D, (D == 1 ? 8 : 16 / D), 128>(a, a_ls, a_es, out, n, nr); return 0;
        default: return 1;
    }
}

extern "C" int field_inv(int field, int degree, int shape, const int32_t* a, long a_ls,
                         long a_es, int32_t* out, long n, uint64_t nr) {
    if (field == 0) {
        if (degree == 1) return inv_degree<LwGoldilocks, 1>(shape, a, a_ls, a_es, out, n, nr);
        if (degree == 2) return inv_degree<LwGoldilocks, 2>(shape, a, a_ls, a_es, out, n, nr);
        return inv_degree<LwGoldilocks, 4>(shape, a, a_ls, a_es, out, n, nr);
    }
    if (degree == 1) return inv_degree<LwBabyBear, 1>(shape, a, a_ls, a_es, out, n, nr);
    if (degree == 2) return inv_degree<LwBabyBear, 2>(shape, a, a_ls, a_es, out, n, nr);
    return inv_degree<LwBabyBear, 4>(shape, a, a_ls, a_es, out, n, nr);
}

template <class F>
static void pass(const LwSmallNttPass& P) {
    long cols = P.rows << (P.log_n - P.s);
    for (long b = 0; b < (cols + (1L << P.log_c) - 1) >> P.log_c; b++) {
        // the tile starts as garbage, as shared memory does
        std::vector<typename F::T> sm(lw_sntt_smem_values(P.s, P.log_c),
                                      (typename F::T)0x5A5A5A5A5A5A5A5Aull);
        lw_sntt_pass_block<F>(P, b, 0, 1, sm.data());
    }
}

extern "C" void ntt_pass(int field, const int32_t* x, int32_t* out, const int32_t* t_lo,
                         const int32_t* t_hi, const int32_t* dft, long rows, int log_n,
                         int ns_log, int s, int log_c, int dft_log) {
    LwSmallNttPass P = {x, out, t_lo, t_hi, dft, rows, log_n, ns_log, s, log_c, dft_log};
    if (field == 0) pass<LwGoldilocks>(P); else pass<LwBabyBear>(P);
}
"""

#: (threads a block, elements a thread) of the host builds of the
#: inversion block: ``inv_degree``'s shapes 0-3 (3: the card's)
_INV_SHAPES = ((1, 1), (4, 3), (32, 4), (128, None))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """ctypes handle of kernel 6's element op and kernel 7's pass block
    built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the small-field kernels' code for the host")
    d = tmp_path_factory.mktemp("small_kernels")
    src, so = d / "small.cpp", d / "libsmall.so"
    src.write_text(_HOST_SRC)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", native.CSRC_DIR,
                        "-o", str(so), str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    P, L, I, U = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint64
    lib.field_op.argtypes = [I, I, I, P, L, L, P, L, L, P, L, U, P, I]
    lib.field_op.restype = None
    lib.field_inv.argtypes = [I, I, I, P, L, L, P, L, U]
    lib.field_inv.restype = I
    lib.ntt_pass.argtypes = [I, P, P, P, P, P, L, I, I, I, I, I]
    lib.ntt_pass.restype = None
    return lib


def _host_op(lib, S, degree, op, a, b=None, nr=0, exponent=0, b_scalar=False):
    """Kernel 6's element op over (D L, n) CPU tensors, b read with element
    stride 0 when ``b_scalar`` (b is then (D L, 1))."""
    an = np.ascontiguousarray(a.numpy())
    n = an.shape[1]
    bn = an if b is None else np.ascontiguousarray(b.numpy())
    out = np.full_like(an, 0x5A5A5A5A)
    words = (ctypes.c_uint32 * 8)(*[(exponent >> (32 * k)) & 0xFFFFFFFF for k in range(8)])
    b_ls, b_es = (1, 0) if b_scalar else (n, 1)
    lib.field_op(S.kernel_id, degree, op, an.ctypes.data, n, 1, bn.ctypes.data, b_ls, b_es,
                 out.ctypes.data, n, int(nr) * S.R % S.P, words, exponent.bit_length())
    return torch.from_numpy(out)


@pytest.mark.parametrize("name, degree", [(n, d) for n in sorted(FIELDS) for d in (1, 2, 4)])
def test_host_field_op_equals_plain(host_lib, name, degree):
    F, _, S = FIELDS[name]
    fd = F if degree == 1 else ChallengeBundle(F, degree).fd
    nr = 0 if degree == 1 else (fd.non_residue if degree == 2 else fd.base.non_residue)
    rng = random.Random(31 * degree + S.kernel_id)
    n = 96
    xs = [_ext_value(rng, F.p, degree) for _ in range(n)]
    ys = [_ext_value(rng, F.p, degree) for _ in range(n)]
    edge = [0, 1, F.p - 1, F.p - 2]
    for i, v in enumerate(edge):  # base edge values in every component
        xs[i] = _nest([v] * degree, degree) if degree > 1 else v
        ys[-1 - i] = _nest([v] * degree, degree) if degree > 1 else v
    a, b = fd.array(xs, "cpu"), fd.array(ys, "cpu")
    op = lambda *args, **kw: _host_op(host_lib, S, degree, *args, nr=nr, **kw)  # noqa: E731
    order = F.p ** degree - 1
    assert torch.equal(op(small._OP_ADD, a, b), fd.add(a, b))
    assert torch.equal(op(small._OP_SUB, a, b), fd.sub(a, b))
    assert torch.equal(op(small._OP_NEG, a), fd.neg(a))
    assert torch.equal(op(small._OP_MUL, a, b), fd.mul(a, b))
    assert torch.equal(op(small._OP_SQUARE, a), fd.square(a))
    for e in (0, 1, 2, 65537, F.p + 11) + ((order - 1,) if degree == 1 else ()):
        assert torch.equal(op(small._OP_POW, a, exponent=e), fd.pow(a, e)), e
    # an inversion is no element op: the card runs it as the inversion block
    assert torch.equal(_host_inv(host_lib, S, degree, 3, a, nr), fd.batch_inverse(a))
    c = b[:, 7:8].contiguous()
    assert torch.equal(op(small._OP_MUL, a, c, b_scalar=True), fd.mul(a, c))
    assert torch.equal(op(small._OP_SUB, a, c, b_scalar=True), fd.sub(a, c))


def _host_inv(lib, S, degree, shape, a, nr, stride0=False):
    """The inversion block over (D L, n) CPU tensor ``a``, block by block;
    with ``stride0`` a (D L, 1) ``a`` read with element stride 0 for
    ``stride0`` elements."""
    an = np.ascontiguousarray(a.numpy())
    n = stride0 or an.shape[1]
    out = np.full((an.shape[0], n), 0x5A5A5A5A, dtype=np.int32)
    ls, es = (1, 0) if stride0 else (n, 1)
    assert lib.field_inv(S.kernel_id, degree, shape, an.ctypes.data, ls, es, out.ctypes.data,
                         n, int(nr) * S.R % S.P) == 0
    return torch.from_numpy(out)


def _zero_patterns(n: int, threads: int, k: int) -> dict:
    """Boolean masks of the elements set to zero, laid on the inversion
    block's chunks (a block takes threads * k elements; thread t takes
    t, t + threads, ...)."""
    per_block = threads * k
    first = np.zeros(n, bool)  # thread 1 of block 0: a zero at each of its first k positions
    for j in range(k):
        first[min(1 + j * threads, n - 1)] = True
    block = np.zeros(n, bool)  # the whole second block (or the first, when there is one)
    b0 = per_block if n > per_block else 0
    block[b0:b0 + per_block] = True
    sparse = np.zeros(n, bool)
    sparse[::7] = True
    return {"first k of a thread": first, "a whole block": block, "every seventh": sparse,
            "all": np.ones(n, bool)}


@pytest.mark.parametrize("name, degree", [(n, d) for n in sorted(FIELDS) for d in (1, 2, 4)])
def test_host_inverse_block_equals_plain(host_lib, name, degree):
    """Kernel 6's inversion block (Montgomery's trick inside a block)
    against ``batch_inverse_plain`` composed through the tower: random
    values with the edge values 0, 1, p - 1, p - 2 in every component, the
    zero patterns of ``_zero_patterns``, sizes that are not a multiple of a
    block's elements, at four (threads, elements a thread) shapes, and an
    operand read with element stride 0."""
    F, _, S = FIELDS[name]
    fd = F if degree == 1 else ChallengeBundle(F, degree).fd
    nr = 0 if degree == 1 else (fd.non_residue if degree == 2 else fd.base.non_residue)
    rng = random.Random(71 * degree + S.kernel_id)
    for shape, (threads, k) in enumerate(_INV_SHAPES):
        k = k or (8 if degree == 1 else 16 // degree)
        per_block = threads * k
        for n in sorted({1, max(per_block - 1, 2), 2 * per_block + 3, 700}):
            xs = [_ext_value(rng, F.p, degree) for _ in range(n)]
            for i, v in enumerate([0, 1, F.p - 1, F.p - 2][:n]):
                xs[i] = _nest([v] * degree, degree) if degree > 1 else v
            a = fd.array(xs, "cpu")
            assert torch.equal(_host_inv(host_lib, S, degree, shape, a, nr),
                               fd.batch_inverse(a)), (shape, n)
            for what, mask in _zero_patterns(n, threads, k).items():
                z = a.clone()
                z[:, torch.from_numpy(mask)] = 0
                assert torch.equal(_host_inv(host_lib, S, degree, shape, z, nr),
                                   fd.batch_inverse(z)), (shape, n, what)
        c = a[:, 5:6].contiguous()  # one value, read with element stride 0
        assert torch.equal(_host_inv(host_lib, S, degree, shape, c, nr, stride0=per_block + 9),
                           fd.batch_inverse(c.expand(-1, per_block + 9).contiguous()))


def _host_pass(lib, S, x, tables, ns_log, s, log_c):
    xn = np.ascontiguousarray(x.numpy())
    out = np.full_like(xn, 0x5A5A5A5A)  # the block must write every point
    lo, hi, dft = tables.lo_rows.numpy(), tables.hi_rows.numpy(), tables.dft.numpy()
    lib.ntt_pass(S.kernel_id, xn.ctypes.data, out.ctypes.data, lo.ctypes.data, hi.ctypes.data,
                 dft.ctypes.data, x.shape[1], x.shape[2].bit_length() - 1, ns_log, s, log_c,
                 dft.shape[0].bit_length() - 1)
    return torch.from_numpy(out)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_host_ntt_block_equals_ntt_pass_plain(host_lib, name, rows):
    F, _, S = FIELDS[name]
    for log_n in range(1, 11):
        vals = _values(F.p, rows << log_n, 100 * log_n + rows)
        x = F.array(np.array(vals, dtype=object).reshape(rows, 1 << log_n), "cpu")
        root = F.params.primitive_root_of_unity(log_n)
        tables = ntt.twiddle_tables(F, root, log_n, "cpu")
        for max_pass_log, log_c in ((1, 4), (3, 0), (4, 2), (8, 3), (8, 5)):
            cur, ns_log = x, 0
            for s in ntt.pass_plan(log_n, max_pass_log):
                got = _host_pass(host_lib, S, cur, tables, ns_log, s, log_c)
                assert torch.equal(got, ntt.ntt_pass_plain(cur, tables, ns_log, s)), \
                    (log_n, max_pass_log, log_c, s, ns_log)
                cur, ns_log = got, ns_log + s
            assert torch.equal(cur, ntt.fft_with_root(x, F, root, max_pass_log))


@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_host_ntt_block_fft_plan_both_roots(host_lib, name, rows):
    """Every pass of 2^1 .. 2^12 at 2 and 4 rows under the fft's own plan
    (``plan_for``) on the columns a card of 132 SMs (an H100) or of 2 SMs
    would take (``small_cols_log``), and at radices of at most 2^3, with
    the forward and the inverse root."""
    F, _, S = FIELDS[name]
    for log_n in range(1, 13):
        vals = _values(F.p, rows << log_n, 300 * log_n + rows)
        x = F.array(np.array(vals, dtype=object).reshape(rows, 1 << log_n), "cpu")
        w = F.params.primitive_root_of_unity(log_n)
        for root in (w, pow(w, F.p - 2, F.p)):
            tables = ntt.twiddle_tables(F, root, log_n, "cpu")
            for max_pass_log, sms in ((ntt.MAX_PASS_LOG, 132), (ntt.MAX_PASS_LOG, 2), (3, 2)):
                cur, ns_log = x, 0
                for s in ntt.plan_for(F, log_n, max_pass_log):
                    log_c = ntt.small_cols_log(rows, log_n, s, sms)
                    got = _host_pass(host_lib, S, cur, tables, ns_log, s, log_c)
                    assert torch.equal(got, ntt.ntt_pass_plain(cur, tables, ns_log, s)), \
                        (log_n, max_pass_log, log_c, s, ns_log)
                    cur, ns_log = got, ns_log + s
                assert torch.equal(cur, ntt.fft_with_root(x, F, root, max_pass_log))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_fft_equals_jax_and_naive_dft(name):
    """The plain transform over a small field against a naive DFT and the
    JAX package's ``ntt.fft`` (``_fft_pease``) on the same digits."""
    from lambda_elliptic_curves_tpu.poly import ntt as jax_ntt

    F, JF, S = FIELDS[name]
    vals = _values(F.p, 64, 9)
    x = F.array(vals, "cpu")
    got = ntt.fft(x, F)
    w = F.params.primitive_root_of_unity(6)
    want = [sum(v * pow(w, i * k, F.p) for i, v in enumerate(vals)) % F.p for k in range(64)]
    assert [int(v) for v in F.to_ints(got)] == want
    jx = JF.array(vals)
    assert np.array_equal(S.to_jax_digits(got), np.asarray(jax_ntt.fft(jx, JF)))
    assert torch.equal(ntt.ifft(got, F), x)
