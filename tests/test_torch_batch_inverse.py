"""The batch-inversion kernel's arithmetic on the host, without a card.

``csrc/batch_inverse.cuh`` holds the walk that each thread of
``csrc/batch_inverse.cu`` runs over its chunk (forward prefix products,
one Fermat inversion of the chunk total, backward pass).  Here it is
compiled as plain C++ with ``g++`` into a temporary directory, called
through ctypes over every chunk of a batch, and held bit for bit against
the plain PyTorch version (``limbs.batch_inverse_plain``), Python's
``pow(x, -1, p)`` and the JAX package's ``batch_inverse``.  Inputs come
from ``numpy.random.default_rng``; tolerance: exact equality.
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

_HOST_SRC = """
#include "batch_inverse.cuh"

extern "C" long chunks_for(long n) { return lw_batch_inverse_chunks(n); }

extern "C" void batch_inverse(const int32_t* x, int32_t* out, long n, long chunks) {
    for (long c = 0; c < chunks; c++) lw_batch_inverse_chunk(x, out, n, c, chunks);
}
"""


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """ctypes handle of the chunk walk built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the chunk walk for the host")
    d = tmp_path_factory.mktemp("batch_inverse")
    src, so = d / "walk.cpp", d / "libwalk.so"
    src.write_text(_HOST_SRC)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", native.CSRC_DIR,
                        "-o", str(so), str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    lib.chunks_for.argtypes = [ctypes.c_long]
    lib.chunks_for.restype = ctypes.c_long
    lib.batch_inverse.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_long]
    lib.batch_inverse.restype = None
    return lib


def _run(lib, a: torch.Tensor, chunks=None) -> torch.Tensor:
    """Every chunk of the flattened (8, n) planes of ``a`` through the walk."""
    x = np.ascontiguousarray(a.reshape(8, -1).numpy())
    n = x.shape[1]
    out = np.full_like(x, 0x5A5A5A5A)  # the walk must write every element
    if chunks is None:
        chunks = lib.chunks_for(n) if n else 1
    lib.batch_inverse(x.ctypes.data, out.ctypes.data, n, chunks)
    return torch.from_numpy(out).reshape(a.shape)


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _with_zeros(vals, where):
    return [0 if i in where else v for i, v in enumerate(vals)]


def _ends(n, chunks, which):
    """Positions of the first and last element of each chunk in ``which``."""
    return {i for c in which for i in (c, c + ((n - 1 - c) // chunks) * chunks)}


# (n, chunks or None for the kernel's own choice, positions that hold zero)
_CASES = {
    "empty": (0, None, set()),
    "one": (1, None, set()),
    "one_zero": (1, None, {0}),
    "L-1": (15, None, set()),
    "L": (16, None, set()),
    "L+1, two ragged chunks": (17, None, {16}),
    "ragged, own chunks": (16 * 5 + 7, None, {0, 86}),
    "ragged, 8 chunks": (8 * 25 + 3, 8, set()),
    "all zeros": (40, 3, set(range(40))),
    "zeros at chunk ends": (50, 7, _ends(50, 7, range(4)) | set(range(5, 50, 7))),
    "random, own chunks": (300, None, {17, 299}),
    "random, 16 chunks": (300, 16, set()),
    "more chunks than needed": (9, 9, {0, 8}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_chunk_walk_matches_plain_and_python_ints(walk, case):
    n, chunks, zeros = _CASES[case]
    vals = _with_zeros(_ints(n, n), zeros)
    a = Stark252.array(vals, "cpu")
    got = _run(walk, a, chunks)
    assert torch.equal(got, limbs.batch_inverse_plain(a))
    want = [0 if v == 0 else pow(v, -1, P) for v in vals]
    assert [int(v) for v in Stark252.to_ints(got)] == want


def test_chunk_walk_keeps_the_batch_shape(walk):
    vals = _with_zeros(_ints(11, 3 * 4 * 5), {0, 7, 59})
    a = Stark252.array(np.array(vals, dtype=object).reshape(3, 4, 5), "cpu")
    got = _run(walk, a, 6)
    assert got.shape == (8, 3, 4, 5)
    assert torch.equal(got, limbs.batch_inverse_plain(a))


def test_chunk_walk_matches_jax_batch_inverse(walk):
    """The (4, 8) grid that ``test_torch_fields.py`` already runs through
    the JAX package, with zeros, over three chunks."""
    vals = _with_zeros(_ints(4, 32), {0, 9, 31})
    grid = np.array(vals, dtype=object).reshape(4, 8)
    want = np.asarray(JStark252.batch_inverse(JStark252.array(grid)))
    got = _run(walk, Stark252.array(grid, "cpu"), 3)
    assert np.array_equal(limbs.to_jax_digits(got), want)


@pytest.mark.parametrize("n, length", [
    (1, 16), (15, 16), (17, 16), (1 << 18, 16), ((1 << 19) + 1, 32), (1 << 20, 64),
    (1 << 21, 64), (1 << 22, 128), (1 << 23, 256), (1 << 24, 256), (1 << 26, 256)])
def test_chunk_length_follows_the_batch_size(walk, n, length):
    """16 elements per thread up to 2^19, doubling to 256 from 2^23."""
    assert walk.chunks_for(n) == -(-n // length)


def test_cuda_wrapper_refuses_a_cpu_tensor():
    """On the CPU ``batch_inverse`` takes the plain version; the kernel's
    wrapper itself raises rather than fall back."""
    a = Stark252.array([3, 5], "cpu")
    assert torch.equal(limbs.batch_inverse(a), limbs.batch_inverse_plain(a))
    with pytest.raises(TypeError):
        limbs._batch_inverse_cuda(a)
