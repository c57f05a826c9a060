"""Kernels 10 and 11's device code built for the host with ``g++`` and held
bitwise against their plain versions, for the four curve groups (BN254 G1
and G2, BLS12-377 G1 and G2).

``csrc/curve.cuh``'s group law runs lane by lane as kernel 10 runs it
(``lw_curve_op_lane``; the comb entry's ``lw_curve_comb_lane``, driven by
``curves/msm.py``'s ``_comb_native``), and ``csrc/msm_bucket.cuh``'s
blocks block by block (``lw_bucket_*_block_seq``: every thread's step
before the next step, as kernel 11's barriers order them, the tile in host
memory filled with garbage first), driven level by level by the port's
own level loop (``curves/msm.py``).  The group law runs on
``csrc/dense32.cuh``'s product and sums, whose carry-flag instructions
``csrc/mont.cuh`` emulates on the host, so the host build computes what
the card computes (the card's own check, ``tests/test_torch_cuda.py``,
is the one that shows the card's carry flag doing the same).  The plain
versions are :class:`JacobianOps` / :class:`TwistJacobianOps`'s ops on
CPU tensors, the bucket phase's PyTorch version and the comb's loop of
mixed additions.  Inputs: points k G from seeded numpy scalars, in
Jacobian form with random z.  Tolerance: bitwise equality.  Skips without
``g++``.
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
#include <stdlib.h>
#include <string.h>

#include "msm_bucket.cuh"

template <class G>
static void lanes(int op, const long* args, int32_t* ox, int32_t* oy, int32_t* oz, long n) {
    const LwPoints a = lw_points_arg(args), b = lw_points_arg(args + 9);
    int32_t* const out[3] = {ox, oy, oz};
    for (long i = 0; i < n; i++) lw_curve_op_lane<G>(op, a, b, out, n, i);
}

template <class G>
static void comb_lanes(const long* args, int32_t* ox, int32_t* oy, int32_t* oz, long n) {
    const LwComb a = lw_comb_arg(args);
    int32_t* const out[3] = {ox, oy, oz};
    for (long i = 0; i < n; i++) lw_curve_comb_lane<G>(a, out, n, i);
}

static void* tile_mem(size_t bytes) {  // unset shared memory: garbage
    void* mem = malloc(bytes);
    memset(mem, 0x5A, bytes);
    return mem;
}

template <class G>
static void accumulate(int mixed, const long* args) {
    const LwBucketAcc a = lw_bucket_acc_arg(args);
    for (long blk = 0; blk < a.W * a.K; blk++) {
        void* mem = tile_mem(lw_acc_tile_bytes<G>(a.P));
        if (mixed) lw_bucket_acc_block_seq<G, true>(a, mem, blk);
        else lw_bucket_acc_block_seq<G, false>(a, mem, blk);
        free(mem);
    }
}

template <class G>
static void reduce(const long* args) {
    const LwBucketReduce a = lw_bucket_reduce_arg(args);
    for (long blk = 0; blk < a.W * a.K; blk++) {
        void* mem = tile_mem(lw_reduce_tile_bytes<G>(a.P));
        lw_bucket_reduce_block_seq<G>(a, mem, blk);
        free(mem);
    }
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

extern "C" void curve_comb(int group, const long* args, int32_t* ox, int32_t* oy, int32_t* oz,
                           long n) {
    switch (group) {
        case LW_CURVE_BN254_G1: comb_lanes<LwBn254G1>(args, ox, oy, oz, n); break;
        case LW_CURVE_BN254_G2: comb_lanes<LwBn254G2>(args, ox, oy, oz, n); break;
        case LW_CURVE_BLS12_377_G1: comb_lanes<LwBls12377G1>(args, ox, oy, oz, n); break;
        default: comb_lanes<LwBls12377G2>(args, ox, oy, oz, n); break;
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
    lib.curve_comb.argtypes = [I, P, P, P, P, L]
    lib.bucket_accumulate.argtypes = [I, I, P]
    lib.bucket_reduce.argtypes = [I, P]
    for fn in (lib.curve_op, lib.curve_comb, lib.bucket_accumulate, lib.bucket_reduce):
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


def _comb_scalars(group, seed, n):
    """n scalars: 0, 1, r - 1, scalars with zero windows (a power of two,
    one set byte, every other byte zero), a run of equal scalars, then
    random ones from the seed."""
    r = GROUPS[group].order
    rng = np.random.default_rng(seed)
    edge = [0, 1, r - 1, 1 << 252, 0xFF << 128, int("00FF" * 15, 16), 5 << 200]
    same = [int.from_bytes(rng.bytes(32), "little") % r] * 8
    rand = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n - len(edge) - 8)]
    return edge + same + rand


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("c", [4, 8])
def test_host_comb_equals_plain(host, group, c):
    """Kernel 10's comb entry, lane by lane through ``_comb_native``, against
    the plain comb (``fixed_base_multiples`` on CPU tensors: a window at a
    time, one mixed addition over every lane), bitwise, the window ids
    taken from the digits in the lane; 64 lanes of scalars 0, 1, r - 1,
    with zero windows, equal and random, at 4- and 8-bit windows.  Its
    points are the host's scalar multiplications."""
    curve = GROUPS[group]
    ops = M.make_ops(curve)
    scalars = _comb_scalars(group, 11 + c, 64)
    digits = M.scalars_to_digits(curve, scalars, "cpu")
    want = M.fixed_base_multiples(curve, digits, curve.generator(), ops, window=c)
    windows = -(-curve.order.bit_length() // c)
    table = M._comb_table(ops, curve.generator(), c, windows, "cpu")
    gid = curve.kernel_group
    got = M._comb_native(ops, lambda args, out, n: host.curve_comb(
        gid, args, *(o.data_ptr() for o in out), n), table, digits, c, windows)
    assert _equal(got, want)
    g = curve.generator()
    mul = g.mul if hasattr(g, "mul") else g.operate_with_self
    assert ops.to_host(tuple(x[:, :12] for x in want)) == [mul(k) for k in scalars[:12]]


def _ids(seed, nbuckets, S):
    """Three windows: ids without repeats, one bucket for all, half zeros."""
    rng = np.random.default_rng(seed)
    distinct = rng.permutation(nbuckets)[:S]
    same = np.full(S, rng.integers(1, nbuckets))
    half = np.where(rng.random(S) < 0.5, 0, rng.integers(1, nbuckets, S))
    return torch.from_numpy(np.stack([distinct, same, half]).astype(np.int64))


def _host_bucket_phase(host, ops, ids, pts, nbuckets, chunk, reduce_chunk, tile):
    """msm_bucket.cuh's accumulate and reduce levels built for the host,
    block by block through the port's level loop, and the plain bucket
    phase at the same leaves and tiles: (got table, got sums, plain table,
    plain sums)."""
    gid = ops.curve.kernel_group
    level = functools.partial(M._accumulate_level_native, ops,
                              lambda args, mixed: host.bucket_accumulate(gid, int(mixed), args))
    got = M._bucket_sums(ops, level, ids, pts, nbuckets, chunk, tile)
    want = M._bucket_sums(ops, functools.partial(M._accumulate_level_plain, ops), ids, pts,
                          nbuckets, chunk, tile)
    level = functools.partial(M._reduce_level_native, ops, lambda args: host.bucket_reduce(gid,
                                                                                         args))
    got_w = M._weighted_bucket_sums(level, got, reduce_chunk, tile)
    want_w = M._weighted_bucket_sums(functools.partial(M._reduce_level_plain, ops), want,
                                     reduce_chunk, tile)
    return got, got_w, want, want_w


def _weighted(pt, j):
    return pt.mul(j) if hasattr(pt, "mul") else pt.operate_with_self(j)


@pytest.mark.parametrize("group, chunk, reduce_chunk",
                         [(g, 4, 4) for g in ("bls12_377_g2", "bn254_g2")]
                         + [(g, c, m) for g in ("bls12_377_g1", "bn254_g1")
                            for c, m in ((4, 2), (16, 4))])
def test_host_bucket_phase_equals_plain(host, group, chunk, reduce_chunk):
    """msm_bucket.cuh's accumulate and reduce, block by block through the
    port's level loop, against the plain bucket phase at the same leaves,
    bitwise, in tiles of 2 leaves (so that the 16 positions take two or
    three accumulate levels); the buckets' sums are the host's."""
    ops = M.make_ops(GROUPS[group])
    nbuckets, S = 16, 16
    host_pts = _host_points(group, 7, S)
    pts = ops.from_host(host_pts, "cpu")
    ids = _ids(8, nbuckets, S)
    got, got_w, want, want_w = _host_bucket_phase(host, ops, ids, pts, nbuckets, chunk,
                                                  reduce_chunk, 2)
    assert _equal(got, want)
    assert _equal(got, M.bucket_sums(ops, ids, pts, nbuckets, chunk))  # the tile is no term
    table = ops.to_host(tuple(c[:, 1] for c in got))  # the one-bucket window
    j = int(ids[1, 0])
    total = functools.reduce(lambda u, v: u + v, host_pts)
    assert table[j] == total and all(t == ops.curve.neutral() for i, t in enumerate(table)
                                     if i != j)
    assert _equal(got_w, want_w)
    assert ops.to_host(tuple(c[:, 1] for c in got_w))[0] == _weighted(total, j)


def _skewed_ids(seed, nbuckets, S):
    """Four windows: every id equal, half zeros, a single nonzero id, and
    mostly 0 and 1 (a circom-style witness)."""
    rng = np.random.default_rng(seed)
    same = np.full(S, rng.integers(1, nbuckets))
    half = np.where(rng.random(S) < 0.5, 0, rng.integers(1, nbuckets, S))
    single = np.zeros(S, np.int64)
    single[rng.integers(S)] = rng.integers(1, nbuckets)
    mostly = rng.choice([0, 1, 2, nbuckets - 1], S, p=[0.45, 0.45, 0.05, 0.05])
    return torch.from_numpy(np.stack([same, half, single, mostly]).astype(np.int64))


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("chunk, reduce_chunk, tile", [(3, 2, 2), (16, 16, 128)])
def test_host_bucket_phase_skewed_ids(host, group, chunk, reduce_chunk, tile):
    """The blocks over skewed ids, bitwise against the plain bucket phase,
    and every bucket and window sum against host arithmetic: every id
    equal, half zeros, a single nonzero id, mostly 0 and 1; at leaves of 3
    positions or 2 buckets in tiles of 2 (deep trees: three accumulate
    levels, three reduce levels) and at the defaults, where the 12
    positions and the 16 buckets are shorter than one tile."""
    ops = M.make_ops(GROUPS[group])
    nbuckets, S = 16, 12
    host_pts = _host_points(group, 9, S)
    pts = ops.from_host(host_pts, "cpu")
    ids = _skewed_ids(10, nbuckets, S)
    got, got_w, want, want_w = _host_bucket_phase(host, ops, ids, pts, nbuckets, chunk,
                                                  reduce_chunk, tile)
    assert _equal(got, want) and _equal(got_w, want_w)
    table = ops.to_host(tuple(c.reshape(c.shape[0], -1) for c in got))
    sums = ops.to_host(tuple(c.reshape(c.shape[0], -1) for c in got_w))
    zero = ops.curve.neutral()
    for w in range(ids.shape[0]):
        buckets = [zero] * nbuckets
        for i in range(S):
            if int(ids[w, i]):
                buckets[int(ids[w, i])] = buckets[int(ids[w, i])] + host_pts[i]
        assert table[w * nbuckets:(w + 1) * nbuckets] == buckets
        assert sums[w] == functools.reduce(lambda u, v: u + v, (
            _weighted(b, j) for j, b in enumerate(buckets) if j), zero)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_first_level_leaves_fill_one_wave(group):
    """An MSM of 2^16 points at c = 15 (17 windows): the accumulate's
    first leaves grow until the windows' tiles take one wave of the card's
    blocks (``WAVE_BLOCKS``), and not a position longer; small MSMs keep
    the least leaves."""
    ops = M.make_ops(GROUPS[group])
    waves, least, tile = M.WAVE_BLOCKS[ops.curve.kernel_group], M.BUCKET_CHUNK, M.BUCKET_TILE
    for n in (1 << 16, 65539):
        leaf = M._leaf_length(least, n, 17, tile, ops)
        tiles = lambda t: 17 * -(-(-(-n // t)) // tile)  # noqa: E731
        assert tiles(leaf) <= waves and (leaf == least or tiles(leaf - 1) > waves)
    assert M._leaf_length(least, 1 << 12, 20, tile, ops) == least


def test_chunks_that_cannot_shrink_are_refused():
    """An accumulate leaf of no position, a reduce leaf that is no power of
    two (its running sum is scaled by doublings), and a tile of one leaf
    (two slots a tile of merges: the level sequence as long as it was), of
    a size that is no power of two, or of more than the kernel's block, are
    refused."""
    ops = M.make_ops(BN254Curve)
    pts = ops.from_host([BN254Curve.generator()] * 8, "cpu")
    ids = torch.arange(8, dtype=torch.int64).reshape(1, 8)
    plain = functools.partial(M._accumulate_level_plain, ops)
    with pytest.raises(ValueError):
        M.bucket_sums(ops, ids, pts, 8, chunk=0)
    for tile in (1, 3, 2 * M.TILE_MAX):
        with pytest.raises(ValueError):
            M._bucket_sums(ops, plain, ids, pts, 8, 4, tile)
    with pytest.raises(ValueError):
        M.weighted_bucket_sums(ops, ops.neutral((1, 8), "cpu"), chunk=3)
