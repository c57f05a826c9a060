"""The batch-inversion kernel's work on the host, without a card.

``csrc/batch_inverse.cuh`` holds the work of one thread block of
``csrc/batch_inverse.cu`` at each level of the tiled Montgomery trick
(forward walks, the tree of thread totals, the one inversion at the top,
the walks back) and the schedule of launches.  Each of its loops over
threads runs ``t = tid; t < T; t += nt`` over iterations that touch
distinct shared-memory words, so the header compiled as plain C++ with
``g++`` and called with tid = 0, nt = 1 for every block of every launch in
turn runs the card's addressing and sequence of products.  The card's
carry-chain instructions are emulated with a host carry flag (see
``tests/test_torch_ntt_pass.py``), so the kernel itself is held against the
plain version on the card too (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2b2).  Here the host build is held bit for bit
against the plain PyTorch version (``limbs.batch_inverse_plain``), Python's
``pow(x, -1, p)`` and the JAX package's ``batch_inverse``, at the kernel's
own tile (T = 256 threads, L = 8 elements each below 2^19 elements) and
at small tiles that reach deeper levels at small n; and the product, the squaring and the
inversion of ``csrc/mont.cuh`` against Python ints.  Inputs come from
``numpy.random.default_rng``; tolerance: exact equality.  Skips without
``g++``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu.fields import Stark252 as JStark252
from lambda_elliptic_curves_tpu_torch import native
from lambda_elliptic_curves_tpu_torch.fields import Stark252
from lambda_elliptic_curves_tpu_torch.ops import limbs

P = Stark252.p
R = 1 << 256

_HOST_SRC = """
#include <vector>
#include "batch_inverse.cuh"

extern "C" void kernel_shape(long n, int* T, int* L) {
    *T = LW_INV_THREADS;
    *L = lw_inv_walk(n);
}

extern "C" int plan(long n, int T, int L, long* m, long* scratch_words) {
    LwInvPlan P = lw_inv_plan(n, T, L);
    for (int k = 0; k < P.levels; k++) m[k] = P.m[k];
    *scratch_words = P.scratch_words;
    return P.launches;
}

// every launch of the call, block by block with tid = 0, nt = 1
extern "C" int batch_inverse(const int32_t* x, int32_t* out, long n, int T, int L) {
    if (!lw_inv_shape_ok(T, L)) return -1;
    LwInvPlan P = lw_inv_plan(n, T, L);
    std::vector<int32_t> scratch(P.scratch_words + 1, 0x5A5A5A5A);
    std::vector<uint32_t> sm(lw_inv_smem_words(T), 0xA5A5A5A5u);
    for (int i = 0; i < P.launches; i++) {
        LwInvLaunch l = lw_inv_launch(P, i, x, out, scratch.data(), T, L);
        for (long b = 0; b < l.lev.tiles; b++) lw_inv_block(l.lev, l.mode, b, 0, 1, sm.data());
    }
    return P.launches;
}

// op 0: a*b/R, 1: a*a/R, 2: a^-1 (Montgomery), element by element
extern "C" void mont(int op, const uint32_t* a, const uint32_t* b, uint32_t* r, long n) {
    for (long i = 0; i < n; i++) {
        if (op == 0) lw_mont_mul(a + 8 * i, b + 8 * i, r + 8 * i);
        else if (op == 1) lw_mont_sqr(a + 8 * i, r + 8 * i);
        else lw_mont_inv(a + 8 * i, r + 8 * i);
    }
}
"""


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """ctypes handle of the kernel's levels built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the batch-inversion levels for the host")
    d = tmp_path_factory.mktemp("batch_inverse")
    src, so = d / "walk.cpp", d / "libwalk.so"
    src.write_text(_HOST_SRC)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", native.CSRC_DIR,
                        "-o", str(so), str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    V, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.kernel_shape.argtypes = [L, V, V]
    lib.kernel_shape.restype = None
    lib.plan.argtypes = [L, I, I, V, V]
    lib.plan.restype = I
    lib.batch_inverse.argtypes = [V, V, L, I, I]
    lib.batch_inverse.restype = I
    lib.mont.argtypes = [I, V, V, V, L]
    lib.mont.restype = None
    return lib


def _kernel_shape(lib, n):
    t, l_ = ctypes.c_int(), ctypes.c_int()
    lib.kernel_shape(n, ctypes.byref(t), ctypes.byref(l_))
    return t.value, l_.value


def _run(lib, a: torch.Tensor, shape=None) -> torch.Tensor:
    """Every launch over the flattened (8, n) planes of ``a``, with the
    kernel's tile or ``shape`` = (T, L)."""
    x = np.ascontiguousarray(a.reshape(8, -1).numpy())
    n = x.shape[1]
    out = np.full_like(x, 0x5A5A5A5A)  # the launches must write every element
    t, l_ = shape or _kernel_shape(lib, n)
    assert lib.batch_inverse(x.ctypes.data, out.ctypes.data, n, t, l_) >= 0
    return torch.from_numpy(out).reshape(a.shape)


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _with_zeros(vals, where):
    return [0 if i in where else v for i, v in enumerate(vals)]


def _ends(n, t, l_):
    """First and last element of every tile of T x L and of every thread's
    walk in it."""
    tile, ends = t * l_, set()
    for base in range(0, n, tile):
        ends |= {base, min(base + tile, n) - 1}
        for th in range(t):
            walk = [i for i in range(base + th, min(base + tile, n), t)]
            ends |= {walk[0], walk[-1]} if walk else set()
    return ends


# (n, (T, L) or None for the kernel's own tile, positions that hold zero)
_CASES = {
    "empty": (0, None, set()),
    "one": (1, None, set()),
    "one_zero": (1, None, {0}),
    "two": (2, None, {1}),
    "tile-1": (2047, None, {0, 2046}),
    "tile": (2048, None, {255, 256}),
    "tile+1": (2049, None, {2048}),
    "random, own tile": (300, None, {17, 299}),
    "three levels, T=4 L=2": (513, (4, 2), {0, 512}),
    "five levels, T=2 L=2": (259, (2, 2), {3, 4, 258}),
    "all zeros": (40, (4, 2), set(range(40))),
    "zero tiles": (64, (4, 2), set(range(8, 16)) | set(range(40, 48))),
    "zeros at tile and walk ends": (50, (4, 4), _ends(50, 4, 4)),
    "one thread a block": (37, (1, 3), {5}),
    "256 threads, one element each": (700, (256, 1), {0, 255, 256, 699}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_chunk_walk_matches_plain_and_python_ints(walk, case):
    n, shape, zeros = _CASES[case]
    vals = _with_zeros(_ints(n, n), zeros)
    a = Stark252.array(vals, "cpu")
    got = _run(walk, a, shape)
    assert torch.equal(got, limbs.batch_inverse_plain(a))
    want = [0 if v == 0 else pow(v, -1, P) for v in vals]
    assert [int(v) for v in Stark252.to_ints(got)] == want


def test_chunk_walk_keeps_the_batch_shape(walk):
    vals = _with_zeros(_ints(11, 3 * 4 * 5), {0, 7, 59})
    a = Stark252.array(np.array(vals, dtype=object).reshape(3, 4, 5), "cpu")
    got = _run(walk, a, (4, 2))
    assert got.shape == (8, 3, 4, 5)
    assert torch.equal(got, limbs.batch_inverse_plain(a))


def test_chunk_walk_matches_jax_batch_inverse(walk):
    """The (4, 8) grid that ``test_torch_fields.py`` already runs through
    the JAX package, with zeros, over three levels of 2 x 2 tiles."""
    vals = _with_zeros(_ints(4, 32), {0, 9, 31})
    grid = np.array(vals, dtype=object).reshape(4, 8)
    want = np.asarray(JStark252.batch_inverse(JStark252.array(grid)))
    got = _run(walk, Stark252.array(grid, "cpu"), (2, 2))
    assert np.array_equal(limbs.to_jax_digits(got), want)


@pytest.mark.parametrize("terms", [2, 4])
def test_prover_shapes(walk, terms):
    """The prover's boundary (8, 2, N) and DEEP (8, 4, N) denominators,
    LDE points minus a few points, at N = 2^10 with the kernel's tile (two
    levels); one point lies on the domain, so its row holds a zero."""
    n = 1 << 10
    f = Stark252
    pts = _ints(terms, n)
    lde = f.array(pts, "cpu")
    at = f.array(_ints(terms + 1, terms - 1) + [pts[5]], "cpu")
    den = f.sub(lde[:, None, :], at[..., None])
    got = _run(walk, den)
    assert got.shape == (8, terms, n)
    assert torch.equal(got, limbs.batch_inverse_plain(den))
    assert int(f.to_ints(got[:, -1, 5:6])[0]) == 0


def _plan(lib, n, shape):
    m = (ctypes.c_long * 64)()
    words = ctypes.c_long()
    launches = lib.plan(n, *shape, m, ctypes.byref(words))
    return launches, list(m[:(launches + 1) // 2 or 1]), words.value


@pytest.mark.parametrize("n, length, levels", [
    (0, 8, [0]), (1, 8, [1]), (2048, 8, [2048]), (2049, 8, [2049, 2]),
    (1 << 18, 8, [1 << 18, 128]), (1 << 19, 16, [1 << 19, 128]), (1 << 20, 16, [1 << 20, 256]),
    (1 << 21, 32, [1 << 21, 256]), (1 << 22, 64, [1 << 22, 256]),
    ((1 << 22) + 1, 64, [(1 << 22) + 1, 257]), (1 << 23, 128, [1 << 23, 256]),
    (1 << 24, 128, [1 << 24, 512]), ((1 << 30) + 1, 128, [(1 << 30) + 1, 32769, 2])])
def test_tile_plan_follows_the_batch_size(walk, n, length, levels):
    """256 threads a tile, each walking 8 elements below 2^19, doubling to
    128 from 2^23 (the sweep's fastest lengths); 1 launch up to a tile, 3 up
    to a tile of tiles (every prover call), 5 beyond; each level above the
    first takes 2 x 32 bytes per element of scratch."""
    assert _kernel_shape(walk, n) == (256, length)
    launches, m, words = _plan(walk, n, (256, length))
    assert launches == (2 * len(levels) - 1 if n else 0)
    assert m == levels
    assert words == 16 * sum(levels[1:])


def _limbs(xs):
    return np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs), dtype="<u4").copy()


def _from_limbs(w):
    return [int.from_bytes(w[8 * i:8 * i + 8].tobytes(), "little") for i in range(len(w) // 8)]


@pytest.mark.parametrize("op", ["mul", "sqr", "inv"])
def test_mont_ops_equal_python_ints(walk, op):
    """``lw_mont_mul``, ``lw_mont_sqr`` and ``lw_mont_inv`` on Montgomery
    limbs v: v w / R, v^2 / R and R^2 / v mod p, for 1, p - 1, R mod p,
    2^k (k < 252), values with zero low limbs, and random values."""
    rng = np.random.default_rng(5)
    vals = [1, 2, P - 1, P - 2, R % P, (R * R) % P, 17 << 192, P - (1 << 64)]
    vals += [1 << k for k in range(252)]
    vals += [int.from_bytes(rng.bytes(32), "little") % P for _ in range(100)]
    other = vals[::-1]
    a, b = _limbs(vals), _limbs(other)
    out = np.zeros_like(a)
    walk.mont({"mul": 0, "sqr": 1, "inv": 2}[op], a.ctypes.data, b.ctypes.data,
              out.ctypes.data, len(vals))
    r_inv = pow(R, -1, P)
    want = {"mul": [v * w * r_inv % P for v, w in zip(vals, other)],
            "sqr": [v * v * r_inv % P for v in vals],
            "inv": [pow(v, -1, P) * R * R % P for v in vals]}[op]
    assert _from_limbs(out) == want


def test_cuda_wrapper_refuses_a_cpu_tensor():
    """On the CPU ``batch_inverse`` takes the plain version; the kernel's
    wrapper itself raises rather than fall back."""
    a = Stark252.array([3, 5], "cpu")
    assert torch.equal(limbs.batch_inverse(a), limbs.batch_inverse_plain(a))
    with pytest.raises(TypeError):
        limbs._batch_inverse_cuda(a)
