"""Kernels 10 and 11's device code built for the host with ``g++`` and held
bitwise against their plain versions, for the four curve groups (BN254 G1
and G2, BLS12-377 G1 and G2).

``csrc/curve.cuh``'s group law runs lane by lane as kernel 10 runs it
(``lw_curve_op_lane``), and ``csrc/msm_bucket.cuh``'s chunk functions chunk
by chunk as kernel 11's threads run them, driven level by level by the
port's own level loop (``curves/msm.py``).  Both are plain C++ (no carry-flag
instructions), so the host build computes what the card computes.  The
plain versions are :class:`JacobianOps` / :class:`TwistJacobianOps`'s ops
on CPU tensors and the bucket phase's PyTorch version.  Inputs: points k G
from seeded numpy scalars, in Jacobian form with random z.  Tolerance:
bitwise equality.  Skips without ``g++``.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu_torch import native
from lambda_elliptic_curves_tpu_torch.curves import msm as M
from lambda_elliptic_curves_tpu_torch.curves.twists import bls12_377_twist, bn254_twist
from lambda_elliptic_curves_tpu_torch.curves.zoo import BLS12377Curve, BN254Curve

torch.set_num_threads(1)

GROUPS = {"bn254_g1": BN254Curve, "bn254_g2": bn254_twist(),
          "bls12_377_g1": BLS12377Curve, "bls12_377_g2": bls12_377_twist()}

_HOST_SRC = r"""
#include "msm_bucket.cuh"

template <class G>
static void lanes(int op, const long* args, int32_t* ox, int32_t* oy, int32_t* oz, long n) {
    const LwPoints a = lw_points_arg(args), b = lw_points_arg(args + 9);
    int32_t* const out[3] = {ox, oy, oz};
    for (long i = 0; i < n; i++) lw_curve_op_lane<G>(op, a, b, out, n, i);
}

template <class G>
static void accumulate(int mixed, const long* args) {
    const LwBucketAcc a = lw_bucket_acc_arg(args);
    for (long w = 0; w < a.W; w++)
        for (long k = 0; k < a.K; k++) {
            if (mixed) lw_bucket_accumulate_chunk<G, true>(a, w, k);
            else lw_bucket_accumulate_chunk<G, false>(a, w, k);
        }
}

template <class G>
static void reduce(const long* args) {
    const LwBucketReduce a = lw_bucket_reduce_arg(args);
    for (long w = 0; w < a.W; w++)
        for (long k = 0; k < a.K; k++) lw_bucket_reduce_chunk<G>(a, w, k);
}

extern "C" void curve_op(int group, int op, const long* args, int32_t* ox, int32_t* oy,
                         int32_t* oz, long n) {
    switch (group) {
        case LW_CURVE_BN254_G1: lanes<LwBn254G1>(op, args, ox, oy, oz, n); break;
        case LW_CURVE_BN254_G2: lanes<LwBn254G2>(op, args, ox, oy, oz, n); break;
        case LW_CURVE_BLS12_377_G1: lanes<LwBls12377G1>(op, args, ox, oy, oz, n); break;
        default: lanes<LwBls12377G2>(op, args, ox, oy, oz, n); break;
    }
}

extern "C" void bucket_accumulate(int group, int mixed, const long* args) {
    switch (group) {
        case LW_CURVE_BN254_G1: accumulate<LwBn254G1>(mixed, args); break;
        case LW_CURVE_BN254_G2: accumulate<LwBn254G2>(mixed, args); break;
        case LW_CURVE_BLS12_377_G1: accumulate<LwBls12377G1>(mixed, args); break;
        default: accumulate<LwBls12377G2>(mixed, args); break;
    }
}

extern "C" void bucket_reduce(int group, const long* args) {
    switch (group) {
        case LW_CURVE_BN254_G1: reduce<LwBn254G1>(args); break;
        case LW_CURVE_BN254_G2: reduce<LwBn254G2>(args); break;
        case LW_CURVE_BLS12_377_G1: reduce<LwBls12377G1>(args); break;
        default: reduce<LwBls12377G2>(args); break;
    }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """ctypes handle of curve.cuh and msm_bucket.cuh built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the curve kernels' code for the host")
    d = tmp_path_factory.mktemp("curve")
    src, so = d / "curve.cpp", d / "libcurve.so"
    src.write_text(_HOST_SRC)
    r = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", native.CSRC_DIR,
                        "-o", str(so), str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.curve_op.argtypes = [I, I, P, P, P, P, L]
    lib.bucket_accumulate.argtypes = [I, I, P]
    lib.bucket_reduce.argtypes = [I, P]
    for fn in (lib.curve_op, lib.bucket_accumulate, lib.bucket_reduce):
        fn.restype = None
    return lib


def _scalars(seed, n, order):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % order for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _host_points(group, seed, n):
    """n points k G of the group, k from the seed (host arithmetic)."""
    curve = GROUPS[group]
    g = curve.generator()
    return [g.mul(k) if hasattr(g, "mul") else g.operate_with_self(k)
            for k in _scalars(seed, n, curve.order)]


def _jacobian(ops, affine, seed):
    """The affine points (z = 1) as Jacobian triples (x z^2, y z^3, z), z
    drawn from the seed: other representatives of the same points."""
    f, n = ops.f, affine[0].shape[-1]
    p = f.p
    rng = np.random.default_rng(seed)
    zs = [(int.from_bytes(rng.bytes(48), "little") % (p - 1) + 1,
           int.from_bytes(rng.bytes(48), "little") % p) for _ in range(n)]
    z = f.array([zz if f.num_limbs > 12 else zz[0] for zz in zs], "cpu")
    z2 = f.mul(z, z)
    return f.mul(affine[0], z2), f.mul(affine[1], f.mul(z2, z)), z


def _neg(ops, pt):
    return pt[0], ops.f.sub(ops.f.zeros(pt[1].shape[1:], "cpu"), pt[1]), pt[2]


def _cat(*pts):
    return tuple(torch.cat(cs, dim=-1) for cs in zip(*pts))


def _lanes(group, ops, n_rand=6, seed=1):
    """(a, b) Jacobian lanes with every case of the complete addition, and
    the affine b lanes of the mixed one: random pairs, P + P (the same
    triple, and two representatives), P + (-P), an operand at infinity,
    both at infinity."""
    pts = ops.from_host(_host_points(group, seed, 2 * n_rand), "cpu")
    first = tuple(c[:, :n_rand] for c in pts)
    second = tuple(c[:, n_rand:] for c in pts)
    ja, ja2, jb = _jacobian(ops, first, seed + 1), _jacobian(ops, first, seed + 2), \
        _jacobian(ops, second, seed + 3)
    inf = ops.neutral((2,), "cpu")
    two = lambda pt: tuple(c[:, :2] for c in pt)  # noqa: E731
    a = _cat(ja, ja, ja, ja, inf, two(ja), inf)
    b = _cat(jb, ja, ja2, _neg(ops, ja2), two(jb), inf, inf)
    a_mixed = _cat(ja, ja, ja, inf, two(ja), inf)
    b_mixed = _cat(second, first, _neg(ops, first), two(second), inf, inf)
    return a, b, a_mixed, b_mixed


def _args(ops, *pts):
    n = max(c.shape[-1] for pt in pts for c in pt)
    out, keep = [], []
    for pt in pts:
        arg, k = ops.points_arg(pt, (n,), n, "cpu")
        out += arg
        keep += k
    return (ctypes.c_long * len(out))(*out), keep, n


def _host_op(host, ops, op, p1, p2=None):
    args, keep, n = _args(ops, p1, p2 or p1)
    L = ops.f.num_limbs
    out = [torch.full((L, n), 0x5A5A5A5A, dtype=torch.int32) for _ in range(3)]
    host.curve_op(ops.curve.kernel_group, op, args, *(o.data_ptr() for o in out), n)
    return tuple(out)


def _equal(got, want):
    return all(torch.equal(g, w.reshape(g.shape)) for g, w in zip(got, want))


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("op", ["add", "add_mixed", "double"])
def test_host_curve_op_equals_plain(host, group, op):
    """curve.cuh's addition, mixed addition and doubling, lane by lane,
    against the plain ops: random pairs, P + P, P + (-P), infinity."""
    ops = M.make_ops(GROUPS[group])
    a, b, a_mixed, b_mixed = _lanes(group, ops)
    if op == "add":
        got, want = _host_op(host, ops, 0, a, b), ops.add_plain(a, b)
    elif op == "add_mixed":
        got, want = _host_op(host, ops, 1, a_mixed, b_mixed), ops.add_mixed_plain(a_mixed,
                                                                                b_mixed)
    else:
        got, want = _host_op(host, ops, 2, a), ops.double_plain(a)
    assert _equal(got, want)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_host_curve_op_broadcast_operand(host, group):
    """One point read with element stride 0 over every lane, as
    scalar_multiples adds its base point; the sums are the host's."""
    ops = M.make_ops(GROUPS[group])
    a, _, _, _ = _lanes(group, ops, n_rand=4, seed=5)
    g = ops.from_host([ops.curve.generator()], "cpu")  # (L, 1)
    got = _host_op(host, ops, 1, a, g)
    assert _equal(got, ops.add_mixed_plain(a, g))
    got = _host_op(host, ops, 0, g, a)
    assert _equal(got, ops.add_plain(g, a))
    gen = ops.curve.generator()
    assert ops.to_host(got) == [gen + q for q in ops.to_host(a)]


def _ids(seed, nbuckets, S):
    """Three windows: ids without repeats, one bucket for all, half zeros."""
    rng = np.random.default_rng(seed)
    distinct = rng.permutation(nbuckets)[:S]
    same = np.full(S, rng.integers(1, nbuckets))
    half = np.where(rng.random(S) < 0.5, 0, rng.integers(1, nbuckets, S))
    return torch.from_numpy(np.stack([distinct, same, half]).astype(np.int64))


@pytest.mark.parametrize("group, chunk, reduce_chunk",
                         [(g, 4, 4) for g in ("bls12_377_g2", "bn254_g2")]
                         + [(g, c, m) for g in ("bls12_377_g1", "bn254_g1")
                            for c, m in ((4, 2), (16, 4))])
def test_host_bucket_phase_equals_plain(host, group, chunk, reduce_chunk):
    """msm_bucket.cuh's accumulate and reduce, chunk by chunk through the
    port's level loop, against the plain bucket phase at the same
    chunks, bitwise (at 4, the least chunk that shrinks the levels, over
    every group; at the default 16 and the reduce's least chunk, 2, over
    G1, whose plain additions are the cheaper); the buckets' sums are the
    host's."""
    ops = M.make_ops(GROUPS[group])
    nbuckets, S = 16, 16
    host_pts = _host_points(group, 7, S)
    pts = ops.from_host(host_pts, "cpu")
    ids = _ids(8, nbuckets, S)
    gid = ops.curve.kernel_group
    level = functools.partial(M._accumulate_level_native, ops,
                              lambda args, mixed: host.bucket_accumulate(gid, int(mixed), args))
    got = M._bucket_sums(ops, level, ids, pts, nbuckets, chunk)
    want = M.bucket_sums(ops, ids, pts, nbuckets, chunk)
    assert _equal(got, want)
    table = ops.to_host(tuple(c[:, 1] for c in got))  # the one-bucket window
    j = int(ids[1, 0])
    total = functools.reduce(lambda u, v: u + v, host_pts)
    assert table[j] == total and all(t == ops.curve.neutral() for i, t in enumerate(table)
                                     if i != j)
    level = functools.partial(M._reduce_level_native, ops, lambda args: host.bucket_reduce(gid,
                                                                                         args))
    got_w = M._weighted_bucket_sums(level, got, reduce_chunk)
    assert _equal(got_w, M.weighted_bucket_sums(ops, want, reduce_chunk))
    weighted = total.mul(j) if hasattr(total, "mul") else total.operate_with_self(j)
    assert ops.to_host(tuple(c[:, 1] for c in got_w))[0] == weighted


def test_chunks_that_cannot_shrink_are_refused():
    """An accumulate chunk below 4 positions, or a reduce chunk that is no
    power of two, would leave the level sequence as long as it was."""
    ops = M.make_ops(BN254Curve)
    pts = ops.from_host([BN254Curve.generator()] * 8, "cpu")
    ids = torch.arange(8, dtype=torch.int64).reshape(1, 8)
    with pytest.raises(ValueError):
        M.bucket_sums(ops, ids, pts, 8, chunk=3)
    with pytest.raises(ValueError):
        M.weighted_bucket_sums(ops, ops.neutral((1, 8), "cpu"), chunk=3)
