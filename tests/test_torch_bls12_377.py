"""BLS12-377 in the PyTorch port: Fq at the 6-word (384-bit) width of
kernels 8 and 9, Fr on kernel 1, G1 and G2 (the twist's batched group law
over Fp2), the MSM routes, the fixed-base comb and the pairing, held
against Python ints, the port's host arithmetic and the JAX package.

* the dense plain ops against Python ints, and against the JAX
  ``ops/limbs`` ops at one shape (24 digits for Fq, 16 for Fr; 0, 1,
  p - 1 and p - 2 among the values) read from
  ``fixtures/jax_bls12_377_ops.json``; batch inversion with zeros;
* the plain NTT over Fr against the JAX ``ntt.fft`` at 2^1 .. 2^10
  (``jax_bls12_377_fft.json``) and the Pallas kernel in interpret mode at
  (2, 256) and (1, 1024) (``jax_bls12_377_pallas.json``);
* ``csrc/dense.cuh``'s 6-word and 4-word products, sums, inversion and
  power, ``dense32.cuh``'s product and butterfly at 12 and 8 limbs,
  ``ntt_dense.cuh``'s pass block over BLS12-377 Fr and
  kernel 9's blocks (``dense_inverse.cuh``) at 12 and 8 limbs, built with ``g++``
  (plain C++, or ``mont.cuh``'s emulated carry flag for ``dense32.cuh``)
  and held against Python ints and the plain versions; they skip without
  ``g++``;
* G2's ``TwistJacobianOps`` against the host affine arithmetic, the comb
  against host scalar multiplications, the G1 Pippenger MSM against the
  JAX device MSM at 128 points (``jax_bls12_377_curves.json``), the G2
  routes against ``msm_g2_naive_host`` (at a 16-bit order: the full 253
  bits of G2 double-and-add take minutes of plain ops on a CPU; the card
  tests hold every route at full width against the fixture), and the
  pairing against the JAX values, with bilinearity.

Tolerance: exact equality (every value is an integer).
"""

import ctypes
import dataclasses
import json
import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu_torch import native
from lambda_elliptic_curves_tpu_torch.curves import msm as M
from lambda_elliptic_curves_tpu_torch.curves.pairings import BLS12377Pairing, pairing
from lambda_elliptic_curves_tpu_torch.curves.twists import (
    TwistJacobianOps, bls12_377_twist, bn254_twist, msm_g2_naive_host,
)
from lambda_elliptic_curves_tpu_torch.curves.zoo import BLS12377Curve
from lambda_elliptic_curves_tpu_torch.fields import BLS12377Field, BLS12377Fr
from lambda_elliptic_curves_tpu_torch.poly import ntt

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FIELDS = {"fr": BLS12377Fr, "fq": BLS12377Field}
#: an H100's multiprocessors: the card the dense passes' grids are sized for
H100_SMS = 132


def _fixture(name):
    return json.loads((FIXTURES / f"jax_bls12_377_{name}.json").read_text())


def _vals(p, n, seed):
    rng = np.random.default_rng(seed)
    return [0, 1, p - 1, p - 2] + [int.from_bytes(rng.bytes(48), "little") % p
                                   for _ in range(n - 4)]


def _ints(f, t):
    return [int(v) for v in f.to_ints(t).reshape(-1)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_dense_plain_ops_equal_python_ints(name):
    f = FIELDS[name]
    p, R = f.p, 1 << (32 * f.num_limbs)
    a, b = _vals(p, 64, 1), _vals(p, 64, 2)[::-1]
    x, y = f.array(a, "cpu"), f.array(b, "cpu")
    assert _ints(f, f.add(x, y)) == [(u + v) % p for u, v in zip(a, b)]
    assert _ints(f, f.sub(x, y)) == [(u - v) % p for u, v in zip(a, b)]
    assert _ints(f, f.mul(x, y)) == [u * v % p for u, v in zip(a, b)]
    assert _ints(f, f.neg(x)) == [-u % p for u in a]
    assert _ints(f, f.square(x)) == [u * u % p for u in a]
    assert _ints(f, f.pow(x, p + 3)) == [pow(u, p + 3, p) for u in a]
    # Montgomery form is x * R mod p with the JAX package's R
    assert R == 1 << (384 if name == "fq" else 256)
    assert [int(v) for v in f.ops.limbs_to_ints(x)] == [u * R % p for u in a]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_dense_plain_ops_equal_jax_limbs(name):
    """The same bits as the JAX ``ops/limbs`` ops (24 digits for Fq)."""
    f, data = FIELDS[name], _fixture("ops")[name]
    assert data["num_digits"] == 2 * f.num_limbs
    dig = lambda key: f.ops.from_jax_digits(np.asarray(data[key], dtype=np.uint32))  # noqa: E731
    x, y = dig("a_digits"), dig("b_digits")
    assert torch.equal(x, f.array([int(v, 16) for v in data["a"]], "cpu"))
    assert torch.equal(y, f.array([int(v, 16) for v in data["b"]], "cpu"))
    assert torch.equal(f.add(x, y), dig("add"))
    assert torch.equal(f.sub(x, y), dig("sub"))
    assert torch.equal(f.mul(x, y), dig("mul"))
    assert torch.equal(f.neg(x), dig("neg"))
    assert torch.equal(f.square(x), dig("square"))
    assert np.array_equal(f.ops.to_jax_digits(f.mul(x, y)), np.asarray(data["mul"], np.uint32))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_dense_batch_inverse_plain_maps_zeros_to_zero(name):
    f = FIELDS[name]
    vals = _vals(f.p, 120, 5)
    vals[17] = vals[-1] = 0
    got = _ints(f, f.batch_inverse(f.array(vals, "cpu").reshape(f.num_limbs, 6, 20)))
    assert got == [pow(v, -1, f.p) if v else 0 for v in vals]


@pytest.mark.parametrize("case", range(10))
def test_plain_fft_equals_jax_fft(case):
    f = BLS12377Fr
    data = _fixture("fft")["cases"][case]
    x = f.array([int(v, 16) for v in data["input"]], "cpu")
    want = [int(v, 16) for v in data["output"]]
    assert _ints(f, ntt.fft(x, f)) == want
    assert _ints(f, ntt.fft(x, f, max_pass_log=3)) == want
    assert torch.equal(ntt.ifft(ntt.fft(x, f), f), x)


@pytest.mark.parametrize("case", range(2))
def test_plain_fft_equals_jax_pallas_kernel(case):
    """The port's transform against the Pallas kernel's output
    (``poly/ntt_pallas.py``, interpret mode)."""
    f = BLS12377Fr
    data = _fixture("pallas")["cases"][case]
    vals = np.array([int(v, 16) for v in data["input"]], dtype=object)
    got = f.to_ints(ntt.fft(f.array(vals.reshape(data["rows"], data["n"]), "cpu"), f))
    assert [int(v) for v in got.reshape(-1)] == [int(v, 16) for v in data["output"]]


def test_fr_roots_reach_two_adicity_47():
    f = BLS12377Fr
    w = f.params.primitive_root_of_unity(47)
    assert pow(w, 1 << 47, f.p) == 1 and pow(w, 1 << 46, f.p) != 1
    with pytest.raises(Exception):
        ntt._check(f, 1 << 48)


def test_wrappers_refuse_cpu_tensors_for_the_kernels():
    """No fallback: the kernel wrappers take CUDA tensors only."""
    for f in (BLS12377Fr, BLS12377Field):
        x = f.array([1, 2, 3], "cpu")
        with pytest.raises(TypeError):
            f.ops.op_cuda(2, x, x)
        with pytest.raises(TypeError):
            f.ops.batch_inverse_cuda(x)
    f = BLS12377Fr
    tables = ntt.twiddle_tables(f, f.params.primitive_root_of_unity(2), 2, "cpu")
    x4 = f.array([[1, 2, 3, 4]], "cpu")
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
    const int L = F::LIMBS;
    for (long i = 0; i < n; i++) {
        if (op == 0) F::mul(a + L * i, b + L * i, r + L * i);
        else if (op == 1) F::add(a + L * i, b + L * i, r + L * i);
        else if (op == 2) F::sub(a + L * i, b + L * i, r + L * i);
        else if (op == 3) F::neg(a + L * i, r + L * i);
        else if (op == 4) F::inv(a + L * i, r + L * i);
        else if (op == 5) F::pow(a + L * i, e, nbits, r + L * i);
        else if (op == 6) lw_d32_mul<Q>(a + L * i, b + L * i, r + L * i);
        else {  // 7, 8: dense32.cuh's butterfly, u + v and u - v
            uint32_t u[12], v[12];
            for (int k = 0; k < L; k++) u[k] = a[L * i + k], v[k] = b[L * i + k];
            lw_d32_butterfly<Q>(u, v);
            for (int k = 0; k < L; k++) r[L * i + k] = op == 7 ? u[k] : v[k];
        }
    }
}

extern "C" void dense_op(int field, int op, const uint32_t* a, const uint32_t* b, uint32_t* r,
                         long n, const uint32_t* e, int nbits) {
    if (field == LW_DENSE_BLS12_377_FR)
        elementwise<LwBls12377FrParams>(op, a, b, r, n, e, nbits);
    else elementwise<LwBls12377FqParams>(op, a, b, r, n, e, nbits);
}

// kernel 1's dense pass, block by block with tid = 0, nt = 1
extern "C" void ntt_pass(const int32_t* x, int32_t* out, const int32_t* pw, long rows,
                         int log_n, int ns_log, int s, int log_c) {
    LwDenseNttPass P = {(const uint32_t*)x, (uint32_t*)out, (const uint32_t*)pw, rows, log_n,
                        ns_log, s, log_c};
    std::vector<uint32_t> sm(lw_dense_ntt_smem_words(s, log_c), 0xA5A5A5A5u);
    long cols = rows << (log_n - s);
    for (long b = 0; b < (cols + (1L << log_c) - 1) >> log_c; b++)
        lw_dense_ntt_pass_block<LwBls12377Fr32>(P, b, 0, 1, sm.data());
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
    if (field == LW_DENSE_BLS12_377_FR) return inverse_k<LwBls12377Fr32>(x, out, n, T, K, R);
    return inverse_k<LwBls12377Fq32>(x, out, n, T, K, R);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """ctypes handle of the dense sources built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the dense kernels' code for the host")
    d = tmp_path_factory.mktemp("bls12_377")
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


def _words(vals, limbs):
    buf = b"".join(v.to_bytes(4 * limbs, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), limbs).copy()


def _ints_of(words):
    return [int.from_bytes(row.astype("<u4").tobytes(), "little") for row in words]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_host_dense_ops_equal_python_ints(host, name):
    """dense.cuh's product (CIOS on 6 words for Fq, 4 for Fr), sum,
    difference, negation, inversion and power, and dense32.cuh's product
    and its butterfly, on Montgomery values (x R mod p)
    against Python ints, random and the edge values each against each (0,
    1, p - 1, p - 2, R mod p, 2^k - 1, 2^k - 2 mod p for k the bit length
    of p, one less, and 32 L - 2)."""
    f = FIELDS[name]
    p, kid, L = f.p, f.ops.kernel_id, f.num_limbs
    R = 1 << (32 * L)
    rinv, k = pow(R, -1, p), p.bit_length()
    edge = [v * rinv % p for v in [0, 1, p - 1, p - 2, R % p] + [
        ((1 << j) - d) % p for j in (k, k - 1, 32 * L - 2) for d in (1, 2)]]
    a, b = _vals(p, 500, 6), _vals(p, 500, 7)[::-1]
    b[5] = a[5]  # a square
    a += [u for u in edge for _ in edge]
    b += [v for _ in edge for v in edge]
    n = len(a)
    wa, wb = _words([v * R % p for v in a], L), _words([v * R % p for v in b], L)
    out = np.zeros((n, L), np.uint32)
    e = 2**370 + 12345 if name == "fq" else 2**250 + 777
    ew = np.array([(e >> (32 * k)) & 0xFFFFFFFF for k in range(12)], np.uint32)
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


def test_host_fq_product_equals_plain_version(host):
    """The card's 6-word product and the plain version give the same bits
    on (12, n) limb planes."""
    f = BLS12377Field
    a, b = f.array(_vals(f.p, 256, 8), "cpu"), f.array(_vals(f.p, 256, 9)[::-1], "cpu")
    wa = np.ascontiguousarray(a.numpy().T).view(np.uint32)
    wb = np.ascontiguousarray(b.numpy().T).view(np.uint32)
    out = np.zeros_like(wa)
    ew = np.zeros(12, np.uint32)
    host.dense_op(f.ops.kernel_id, 0, wa.ctypes.data, wb.ctypes.data, out.ctypes.data, 256,
                  ew.ctypes.data, 0)
    assert torch.equal(torch.from_numpy(np.ascontiguousarray(out.T).view(np.int32)),
                       f.mul(a, b))


def _host_pass(lib, x, tables, ns_log, s, log_c):
    xn = np.ascontiguousarray(x.numpy())
    out = np.full_like(xn, 0x5A5A5A5A)  # the block must write every point
    pw = np.ascontiguousarray(ntt.power_rows(tables).numpy())
    lib.ntt_pass(xn.ctypes.data, out.ctypes.data, pw.ctypes.data, x.shape[1],
                 x.shape[2].bit_length() - 1, ns_log, s, log_c)
    return torch.from_numpy(out)


@pytest.mark.parametrize("log_n", [1, 3, 6, 9, 10, 2, 4, 5, 7, 8, 11, 12])
def test_host_ntt_pass_block_equals_plain(host, log_n):
    """Kernel 1's dense block over BLS12-377 Fr (``ntt_dense.cuh``), pass by
    pass, against ntt_pass_plain: 1-3 rows (3: the QAP's; one row above
    2^10), both roots, the fft's plan and max_pass_log 3 (and 1 up to
    2^10), each at the port's columns per block on an H100 and at 2^0 and
    2^3 (2^4 at the one-stage plan); the last output against the plain
    fft."""
    f = BLS12377Fr
    for rows in (1, 2, 3)[:3 if log_n <= 10 else 1]:
        vals = np.array(_vals(f.p, rows << log_n, log_n) if rows << log_n >= 4
                        else [5, 7][:rows << log_n], dtype=object)
        x = f.array(vals.reshape(rows, 1 << log_n), "cpu")
        w = f.params.primitive_root_of_unity(log_n)
        for root in (w, pow(w, f.p - 2, f.p)):
            tables = ntt.twiddle_tables(f, root, log_n, "cpu")
            for max_pass_log in (ntt.MAX_PASS_LOG, 3, 1)[:3 if log_n <= 10 else 2]:
                cur, ns_log = x, 0
                for s in ntt.dense_pass_plan(log_n, max_pass_log):
                    want = ntt.ntt_pass_plain(cur, tables, ns_log, s)
                    for log_c in sorted({ntt.dense_cols_log(rows, log_n, s, H100_SMS), 0,
                                         4 if max_pass_log == 1 else 3}):
                        got = _host_pass(host, cur, tables, ns_log, s, log_c)
                        assert torch.equal(got, want), (rows, max_pass_log, s, ns_log, log_c)
                    cur, ns_log = want, ns_log + s
                assert torch.equal(cur, ntt.fft_with_root(x, f, root, max_pass_log))


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("n, tile", [(100, (4, 2, 3)), (700, (8, 4, 2)), (3000, (256, 8, 1))])
def test_host_batch_inverse_levels_equal_plain(host, name, n, tile):
    """Kernel 9's blocks (``dense_inverse.cuh``) at 12 limbs (Fq) and 8
    (Fr), T threads and R rounds of K elements a thread, every block of a
    call, zeros included, against the plain version."""
    f = FIELDS[name]
    vals = _vals(f.p, n, n)
    for i in range(0, n, 37):
        vals[i] = 0
    vals[-1] = 0
    a = f.array(vals, "cpu")
    x = np.ascontiguousarray(a.numpy())
    out = np.full_like(x, 0x5A5A5A5A)  # the launches must write every element
    assert host.batch_inverse(f.ops.kernel_id, x.ctypes.data, out.ctypes.data, n, *tile) >= 1
    assert torch.equal(torch.from_numpy(out), f.ops.batch_inverse_plain(a))


# -- curves -----------------------------------------------------------------------

@pytest.mark.parametrize("twist", [bls12_377_twist, bn254_twist])
def test_twist_jacobian_ops_equal_host_affine(twist):
    """G2's batched group law (Fp2 composed of base ops) against the host
    affine arithmetic: generic sums, doublings, P + P, P + (-P) and
    infinity on either side."""
    tw = twist()
    ops = TwistJacobianOps(tw)
    g = tw.generator()
    pts = [g.mul(k) for k in (1, 2, 3, 5)] + [tw.neutral(), g.mul(7)]
    other = [g.mul(9), g.mul(2), g.mul(3).neg(), tw.neutral(), g.mul(4), tw.neutral()]
    P, Q = ops.from_host(pts, "cpu"), ops.from_host(other, "cpu")
    want = [a + b for a, b in zip(pts, other)]
    assert ops.to_host(ops.add(P, Q)) == want
    assert ops.to_host(ops.add_mixed(P, Q)) == want
    assert ops.to_host(ops.double(P)) == [a.double() for a in pts]
    assert ops.to_host(ops.add(ops.double(P), P)) == [a.mul(3) for a in pts]
    assert all(tw.defining_equation(q.x.value, q.y.value) for q in ops.to_host(P)[:4])


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_fixed_base_multiples_equal_host(curve):
    """The comb of Groth16's setup against host scalar multiplications:
    0, 1, r - 1 and random scalars."""
    c = BLS12377Curve if curve == "g1" else bls12_377_twist()
    ops = M.make_ops(c)
    g = c.generator()
    rng = random.Random(5)
    scalars = [0, 1, c.order - 1, 2**252] + [rng.randrange(c.order) for _ in range(4)]
    out = M.fixed_base_multiples(c, M.scalars_to_digits(c, scalars, "cpu"), g, ops)
    mul = g.operate_with_self if curve == "g1" else g.mul
    assert ops.to_host(out) == [mul(s) for s in scalars]
    assert ops.to_host(ops.affine_points(out)) == ops.to_host(out)


def _g1(v):
    return None if v is None else (int(v[0], 16), int(v[1], 16))


def test_g1_msm_pippenger_equals_jax_device_msm():
    """Pippenger over 128 BLS12-377 G1 points (above the host threshold)
    against the JAX device MSM by both routes; the window is 5 bits here
    (the card tests run the default window and double-and-add)."""
    data = _fixture("curves")["msm"]
    g = BLS12377Curve.generator()
    points = [g.operate_with_self(int(k, 16)) for k in data["point_scalars"]]
    scalars = [int(s, 16) for s in data["scalars"]]
    got = M.msm(BLS12377Curve, scalars, points, window_size=5, device="cpu").to_affine()
    assert (got.x, got.y) == _g1(data["g1_pippenger"]) == _g1(data["g1_naive"])


def test_g2_msm_routes_equal_host_msm():
    """Both device routes over G2 (Pippenger's buckets and windows, the
    batched double-and-add) against ``msm_g2_naive_host``, at a 16-bit
    order so that double-and-add takes 16 steps on the CPU's plain ops."""
    tw = dataclasses.replace(bls12_377_twist(), order=(1 << 16) + 1)
    ops = TwistJacobianOps(tw)
    g = tw.generator()
    rng = random.Random(3)
    points = [g.mul(rng.randrange(1, 1000)) for _ in range(70)] + [tw.neutral()]
    scalars = [rng.randrange(1 << 16) for _ in range(len(points))]
    scalars[3] = 0
    want = msm_g2_naive_host(scalars, points)
    assert M.msm(tw, scalars, points, window_size=4, device="cpu") == want
    assert M.msm(tw, scalars, points, method="naive", device="cpu") == want
    assert M.msm(tw, scalars[:5], points[:5], device="cpu") == msm_g2_naive_host(scalars[:5],
                                                                                points[:5])
    d = M.scalars_to_digits(tw, scalars, "cpu")
    assert ops.to_host(M.msm_double_and_add(tw, d, ops.from_host(points, "cpu"), ops)) == [want]


def _skewed_scalars(case, n, order, c, seed):
    """Scalars whose window ids pile up: all equal; mostly 0 and 1 (a
    circom-style witness); all below 2^c (every id of the other windows 0)."""
    rng = np.random.default_rng(seed)
    rand = lambda: int.from_bytes(rng.bytes(32), "little") % order  # noqa: E731
    if case == "all_equal":
        return [rand()] * n
    if case == "mostly_0_and_1":
        return [0 if u < 0.45 else 1 if u < 0.9 else rand() for u in rng.random(n)]
    return [int(v) for v in rng.integers(0, 1 << c, n)]


@pytest.mark.parametrize("case, log_n", [("all_equal", 6), ("mostly_0_and_1", 7),
                                         ("below_2^c", 6)])
def test_g1_pippenger_skewed_scalars_equal_host_msm(case, log_n):
    """The chunked bucket phase (kernel 11's plain version) over BLS12-377
    G1 where the ids are skewed (2^6-2^7 points, 3-bit windows), against
    msm_naive_host."""
    n = 1 << log_n
    g = BLS12377Curve.generator()
    rng = random.Random(13)
    points = [g.operate_with_self(rng.randrange(1, BLS12377Curve.order)) for _ in range(n)]
    scalars = _skewed_scalars(case, n, BLS12377Curve.order, 3, 14)
    ops = M.make_ops(BLS12377Curve)
    digits = M.scalars_to_digits(BLS12377Curve, scalars, "cpu")
    got = M.msm_pippenger(BLS12377Curve, digits, ops.from_host(points, "cpu"), window_size=3,
                          ops=ops)
    assert got == M.msm_naive_host(scalars, points)


@pytest.mark.parametrize("case, log_n", [("all_equal", 6), ("mostly_0_and_1", 7),
                                         ("below_2^c", 6)])
def test_g2_pippenger_skewed_scalars_equal_host_msm(case, log_n):
    """The same over G2, at a 16-bit order and 2-bit windows (the CPU's
    plain G2 additions are the slowest), against msm_g2_naive_host."""
    tw = dataclasses.replace(bls12_377_twist(), order=(1 << 16) + 1)
    n = 1 << log_n
    g = tw.generator()
    rng = random.Random(15)
    points = [g.mul(rng.randrange(1, 1000)) for _ in range(n)]
    scalars = _skewed_scalars(case, n, tw.order, 2, 16)
    ops = TwistJacobianOps(tw)
    digits = M.scalars_to_digits(tw, scalars, "cpu")
    got = M.msm_pippenger(tw, digits, ops.from_host(points, "cpu"), window_size=2, ops=ops)
    assert got == msm_g2_naive_host(scalars, points)


def _fp12(cfg, v):
    def nest(x):
        return tuple(nest(c) for c in x) if isinstance(x, list) else int(x, 16)
    return cfg.fp12(nest(v))


def test_pairing_equals_jax_and_is_bilinear():
    cfg = BLS12377Pairing
    g, g2 = BLS12377Curve.generator(), cfg.g2_generator()
    for case in _fixture("curves")["pairings"]:
        a, b = int(case["a"], 16), int(case["b"], 16)
        got = pairing(cfg, g.operate_with_self(a), g2.mul(b))
        assert got == _fp12(cfg, case["value"])
    e = pairing(cfg, g, g2)
    assert pairing(cfg, g.operate_with_self(6), g2) == pairing(cfg, g.operate_with_self(2),
                                                               g2.mul(3)) == e ** 6
    assert e != cfg.fp12(1)
