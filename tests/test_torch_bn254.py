"""BN254 Fr and Fq in the PyTorch port: the plain versions of kernels 8
(field ops) and 9 (batch inversion), and kernel 1's NTT over Fr, held
against Python ints and the JAX package.

* the dense field ops against Python ints and the JAX ``ops/limbs`` ops at
  one shape (0, 1 and p - 1 among the values), Montgomery bits crossing
  with ``from_jax_digits``;
* batch inversion with zeros;
* the plain NTT against the JAX ``ntt.fft`` at 2^1 .. 2^12 and against the
  Pallas kernel in interpret mode at (2, 256) and (1, 1024), both read from
  ``fixtures/jax_bn254_fft.json`` / ``jax_bn254_pallas.json``
  (``fixtures/make_torch_plonk.py`` writes them: interpret mode alone takes
  minutes on a CPU);
* ``csrc/dense.cuh``'s product, square, power and inversion, ``dense32.cuh``'s
  product and butterfly, the dense NTT pass
  block over BN254 Fr (``ntt_dense.cuh``) and kernel 9's blocks
  (``dense_inverse.cuh``), built with ``g++`` (plain
  C++, or ``mont.cuh``'s emulated carry flag for ``dense32.cuh``) and held
  against Python ints and the plain versions; they skip without ``g++``;
* the dense passes' grids at the provers' sizes (``ntt.dense_cols_log``).

Tolerance: exact equality (every value is an integer).
"""

import ctypes
import json
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu.fields import BN254Field as JaxFq, BN254Fr as JaxFr
from lambda_elliptic_curves_tpu_torch import native
from lambda_elliptic_curves_tpu_torch.fields import BN254Field, BN254Fr
from lambda_elliptic_curves_tpu_torch.poly import ntt

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FIELDS = {"fr": (BN254Fr, JaxFr), "fq": (BN254Field, JaxFq)}
R = 1 << 256
#: an H100's multiprocessors: the card the dense passes' grids are sized for
H100_SMS = 132


def _vals(p, n, seed):
    rng = np.random.default_rng(seed)
    return [0, 1, p - 1, p - 2] + [int.from_bytes(rng.bytes(32), "little") % p
                                   for _ in range(n - 4)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_dense_plain_ops_equal_python_ints(name):
    f, _ = FIELDS[name]
    p = f.p
    a, b = _vals(p, 64, 1), _vals(p, 64, 2)[::-1]
    x, y = f.array(a, "cpu"), f.array(b, "cpu")
    ints = lambda t: [int(v) for v in f.to_ints(t)]  # noqa: E731
    assert ints(f.add(x, y)) == [(u + v) % p for u, v in zip(a, b)]
    assert ints(f.sub(x, y)) == [(u - v) % p for u, v in zip(a, b)]
    assert ints(f.mul(x, y)) == [u * v % p for u, v in zip(a, b)]
    assert ints(f.neg(x)) == [-u % p for u in a]
    assert ints(f.square(x)) == [u * u % p for u in a]
    assert ints(f.pow(x, p + 3)) == [pow(u, p + 3, p) for u in a]
    # Montgomery form is x * 2^256 mod p: the JAX package's R
    assert [int(v) for v in f.ops.limbs_to_ints(x)] == [u * R % p for u in a]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_dense_plain_ops_equal_jax_limbs(name):
    """The same bits as the JAX ``ops/limbs`` ops, at one shape."""
    f, jf = FIELDS[name]
    a, b = _vals(f.p, 32, 3), _vals(f.p, 32, 4)[::-1]
    ja, jb = jf.array(a), jf.array(b)
    x, y = f.ops.from_jax_digits(np.asarray(ja)), f.ops.from_jax_digits(np.asarray(jb))
    assert torch.equal(x, f.array(a, "cpu"))
    for port, jax_fn in ((f.add, jf.add), (f.sub, jf.sub), (f.mul, jf.mul)):
        assert torch.equal(port(x, y), f.ops.from_jax_digits(np.asarray(jax_fn(ja, jb))))
    assert np.array_equal(f.ops.to_jax_digits(f.neg(x)), np.asarray(jf.neg(ja)))
    assert np.array_equal(f.ops.to_jax_digits(f.square(x)), np.asarray(jf.square(ja)))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_dense_batch_inverse_plain_maps_zeros_to_zero(name):
    f, _ = FIELDS[name]
    vals = _vals(f.p, 200, 5)
    vals[17] = vals[-1] = 0
    got = [int(v) for v in f.to_ints(f.batch_inverse(f.array(vals, "cpu").reshape(8, 8, 25)
                                                     .reshape(8, 200)))]
    assert got == [pow(v, -1, f.p) if v else 0 for v in vals]


def _fixture(name):
    return json.loads((FIXTURES / f"jax_bn254_{name}.json").read_text())


@pytest.mark.parametrize("case", range(12))
def test_plain_fft_equals_jax_fft(case):
    data = _fixture("fft")["cases"][case]
    x = BN254Fr.array([int(v, 16) for v in data["input"]], "cpu")
    want = [int(v, 16) for v in data["output"]]
    assert [int(v) for v in BN254Fr.to_ints(ntt.fft(x, BN254Fr))] == want
    # a radix of at most 2^3 gives every size several passes
    assert [int(v) for v in BN254Fr.to_ints(ntt.fft(x, BN254Fr, max_pass_log=3))] == want
    assert torch.equal(ntt.ifft(ntt.fft(x, BN254Fr), BN254Fr), x)


@pytest.mark.parametrize("case", range(2))
def test_plain_fft_equals_jax_pallas_kernel(case):
    """The port's transform against the Pallas kernel's output
    (``poly/ntt_pallas.py``, interpret mode)."""
    data = _fixture("pallas")["cases"][case]
    vals = np.array([int(v, 16) for v in data["input"]], dtype=object)
    x = BN254Fr.array(vals.reshape(data["rows"], data["n"]), "cpu")
    got = BN254Fr.to_ints(ntt.fft(x, BN254Fr)).reshape(-1)
    assert [int(v) for v in got] == [int(v, 16) for v in data["output"]]


def test_wrappers_refuse_cpu_tensors_for_the_kernels():
    """No fallback: the kernel wrappers take CUDA tensors only."""
    x = BN254Fr.array([1, 2, 3], "cpu")
    with pytest.raises(TypeError):
        BN254Fr.ops.op_cuda(2, x, x)
    with pytest.raises(TypeError):
        BN254Fr.ops.batch_inverse_cuda(x)
    tables = ntt.twiddle_tables(BN254Fr, BN254Fr.params.primitive_root_of_unity(2), 2, "cpu")
    x4 = BN254Fr.array([[1, 2, 3, 4]], "cpu")
    with pytest.raises(ValueError):
        ntt.ntt_pass(x4, torch.empty_like(x4), tables, 0, 2)


# -- host builds of the CUDA sources ---------------------------------------------

_HOST_SRC = """
#include <vector>
#include "dense.cuh"
#include "ntt_dense.cuh"
#include "dense_inverse.cuh"

template <class Q, class F = LwDense<Q>>
static void elementwise(int op, const uint32_t* a, const uint32_t* b, uint32_t* r, long n,
                        const uint32_t* e, int nbits) {
    for (long i = 0; i < n; i++) {
        if (op == 0) F::mul(a + 8 * i, b + 8 * i, r + 8 * i);
        else if (op == 1) F::add(a + 8 * i, b + 8 * i, r + 8 * i);
        else if (op == 2) F::sub(a + 8 * i, b + 8 * i, r + 8 * i);
        else if (op == 3) F::neg(a + 8 * i, r + 8 * i);
        else if (op == 4) F::inv(a + 8 * i, r + 8 * i);
        else if (op == 5) F::pow(a + 8 * i, e, nbits, r + 8 * i);
        else if (op == 6) lw_d32_mul<Q>(a + 8 * i, b + 8 * i, r + 8 * i);
        else {  // 7, 8: dense32.cuh's butterfly, u + v and u - v
            uint32_t u[8], v[8];
            for (int k = 0; k < 8; k++) u[k] = a[8 * i + k], v[k] = b[8 * i + k];
            lw_d32_butterfly<Q>(u, v);
            for (int k = 0; k < 8; k++) r[8 * i + k] = op == 7 ? u[k] : v[k];
        }
    }
}

extern "C" void dense_op(int field, int op, const uint32_t* a, const uint32_t* b, uint32_t* r,
                         long n, const uint32_t* e, int nbits) {
    if (field == LW_DENSE_BN254_FR) elementwise<LwBn254FrParams>(op, a, b, r, n, e, nbits);
    else elementwise<LwBn254FqParams>(op, a, b, r, n, e, nbits);
}

// kernel 1's dense pass, block by block with tid = 0, nt = 1
extern "C" void ntt_pass(const int32_t* x, int32_t* out, const int32_t* pw, long rows,
                         int log_n, int ns_log, int s, int log_c) {
    LwDenseNttPass P = {(const uint32_t*)x, (uint32_t*)out, (const uint32_t*)pw, rows, log_n,
                        ns_log, s, log_c};
    std::vector<uint32_t> sm(lw_dense_ntt_smem_words(s, log_c), 0xA5A5A5A5u);
    long cols = rows << (log_n - s);
    for (long b = 0; b < (cols + (1L << log_c) - 1) >> log_c; b++)
        lw_dense_ntt_pass_block<LwBn254Fr32>(P, b, 0, 1, sm.data());
}

// one batch inversion by kernel 9's blocks (dense_inverse.cuh), block by
// block with tid = 0, nt = 1, at T threads and R rounds of K elements a
// thread
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

// a batch inversion by kernel 9's blocks; the number of blocks
extern "C" int batch_inverse(int field, const int32_t* x, int32_t* out, long n, int T, int K,
                             int R) {
    if (field == LW_DENSE_BN254_FR) return inverse_k<LwBn254Fr32>(x, out, n, T, K, R);
    return inverse_k<LwBn254Fq32>(x, out, n, T, K, R);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """ctypes handle of the dense sources built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the dense kernels' code for the host")
    d = tmp_path_factory.mktemp("dense")
    src, so = d / "dense.cpp", d / "libdense.so"
    src.write_text(_HOST_SRC)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", native.CSRC_DIR,
                        "-o", str(so), str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.dense_op.argtypes = [I, I, P, P, P, L, P, I]
    lib.dense_op.restype = None
    lib.ntt_pass.argtypes = [P, P, P, L, I, I, I, I]
    lib.ntt_pass.restype = None
    lib.batch_inverse.argtypes = [I, P, P, L, I, I, I]
    lib.batch_inverse.restype = I
    return lib


def _words(vals):
    """Python ints -> (n, 8) uint32 little-endian words."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), 8).copy()


def _ints_of(words):
    return [int.from_bytes(row.astype("<u4").tobytes(), "little") for row in words]


def _edges(p):
    """The product's edge values as Montgomery forms: 0, 1, p - 1, p - 2,
    R mod p, and 2^254 - 1, 2^253 - 1, 2^253 (mod p)."""
    return [0, 1, p - 1, p - 2, R % p] + [((1 << k) - d) % p for k, d in
                                          ((254, 1), (254, 2), (253, 1), (253, 0))]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_host_dense_ops_equal_python_ints(host, name):
    """dense.cuh's product, sum, difference, negation, inversion and power,
    and dense32.cuh's product and its butterfly, on
    Montgomery values (x R mod p) against Python ints, random and the edge
    values each against each."""
    f, _ = FIELDS[name]
    p, kid = f.p, f.ops.kernel_id
    rinv = pow(R, -1, p)
    edge = [v * rinv % p for v in _edges(p)]  # Montgomery forms are the edges
    a = _vals(p, 500, 6) + [u for u in edge for _ in edge]
    b = _vals(p, 500, 7)[::-1] + [v for _ in edge for v in edge]
    n = len(a)
    am, bm = [v * R % p for v in a], [v * R % p for v in b]
    wa, wb, out = _words(am), _words(bm), np.zeros((n, 8), np.uint32)
    e = 2**200 + 12345
    ew = np.array([(e >> (32 * k)) & 0xFFFFFFFF for k in range(8)], np.uint32)
    want = {
        0: [u * v * R % p for u, v in zip(a, b)],
        1: [(u + v) * R % p for u, v in zip(a, b)],
        2: [(u - v) * R % p for u, v in zip(a, b)],
        3: [-u * R % p for u in a],
        4: [pow(u, -1, p) * R % p if u else 0 for u in a],
        5: [pow(u, e, p) * R % p for u in a],
    }
    want[6] = want[0]
    want[7], want[8] = want[1], want[2]
    for op, expect in want.items():
        host.dense_op(kid, op, wa.ctypes.data, wb.ctypes.data, out.ctypes.data, n,
                      ew.ctypes.data, e.bit_length())
        assert _ints_of(out) == expect, op


def host_pass(lib, x, tables, ns_log, s, log_c):
    """One dense pass of the g++ build, every block of it (the output
    filled with garbage first: the blocks must write every point)."""
    xn = np.ascontiguousarray(x.numpy())
    out = np.full_like(xn, 0x5A5A5A5A)
    pw = np.ascontiguousarray(ntt.power_rows(tables).numpy())
    lib.ntt_pass(xn.ctypes.data, out.ctypes.data, pw.ctypes.data, x.shape[1],
                 x.shape[2].bit_length() - 1, ns_log, s, log_c)
    return torch.from_numpy(out)


def host_passes_equal_plain(lib, f, log_n, rows, seed):
    """Every pass of a transform of 2^log_n points over ``rows`` rows, both
    roots, under the fft's plan and at max_pass_log 3 (and 1 up to 2^10),
    each at the port's columns per block on an H100 (``dense_cols_log``)
    and at 2^0 and 2^3 (2^4 at the one-stage plan), held against
    ntt_pass_plain; the last output against the plain fft."""
    vals = np.array(_vals(f.p, rows << log_n, seed) if rows << log_n >= 4
                    else [5, 7][:rows << log_n], dtype=object)
    x = f.array(vals.reshape(rows, 1 << log_n), "cpu")
    w = f.params.primitive_root_of_unity(log_n)
    for root in (w, pow(w, f.p - 2, f.p)):
        tables = ntt.twiddle_tables(f, root, log_n, "cpu")
        for max_pass_log in (ntt.MAX_PASS_LOG, 3, 1)[:3 if log_n <= 10 else 2]:
            cur, ns_log = x, 0
            for s in ntt.dense_pass_plan(log_n, max_pass_log):
                want = ntt.ntt_pass_plain(cur, tables, ns_log, s)
                widths = {ntt.dense_cols_log(rows, log_n, s, H100_SMS), 0,
                          4 if max_pass_log == 1 else 3}
                for log_c in sorted(widths):
                    assert torch.equal(host_pass(lib, cur, tables, ns_log, s, log_c), want), \
                        (log_n, rows, max_pass_log, s, ns_log, log_c)
                cur, ns_log = want, ns_log + s
            assert torch.equal(cur, ntt.fft_with_root(x, f, root, max_pass_log))


@pytest.mark.parametrize("log_n", [1, 3, 6, 9, 10, 2, 4, 5, 7, 8, 11, 12])
def test_host_ntt_pass_block_equals_plain(host, log_n):
    """Kernel 1's dense block over BN254 Fr (``ntt_dense.cuh``), pass by
    pass, against ntt_pass_plain: 1-3 rows, both roots, several radices and
    tile widths (one row above 2^10: the plain passes take the time)."""
    for rows in (1, 2, 3)[:3 if log_n <= 10 else 1]:
        host_passes_equal_plain(host, BN254Fr, log_n, rows, log_n + rows)


def test_dense_passes_fill_the_card():
    """At the provers' sizes (2^16 .. 2^18, one row; Groth16's 3 rows at
    2^16 and 2^17) every pass of a dense transform runs on at least 132
    blocks, one for each SM of an H100."""
    for log_n, rows in ((16, 1), (17, 1), (18, 1), (16, 3), (17, 3)):
        for s in ntt.dense_pass_plan(log_n):
            blocks = -(-(rows << (log_n - s)) >> ntt.dense_cols_log(rows, log_n, s, H100_SMS))
            assert blocks >= 132, (log_n, rows, s, blocks)


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("n, tile", [(100, (4, 2, 3)), (700, (8, 4, 2)), (3000, (256, 8, 1))])
def test_host_batch_inverse_levels_equal_plain(host, name, n, tile):
    """Kernel 9's blocks (``dense_inverse.cuh``) at T threads and R rounds
    of K elements a thread, every block of a call (one to a dozen), zeros
    included, against the plain version."""
    f, _ = FIELDS[name]
    vals = _vals(f.p, n, n)
    for i in range(0, n, 37):
        vals[i] = 0
    vals[-1] = 0
    a = f.array(vals, "cpu")
    x = np.ascontiguousarray(a.numpy())
    out = np.full_like(x, 0x5A5A5A5A)  # the launches must write every element
    assert host.batch_inverse(f.ops.kernel_id, x.ctypes.data, out.ctypes.data, n, *tile) >= 1
    assert torch.equal(torch.from_numpy(out), f.ops.batch_inverse_plain(a))
