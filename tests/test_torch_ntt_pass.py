"""The NTT pass kernel's block on the host, without a card.

``csrc/ntt.cuh`` holds the work of one thread block of ``csrc/ntt.cu``
(tables, load and twist, radix-4 stages, store).  Each of its loops runs
``idx = tid; idx < count; idx += nt`` over iterations that touch distinct
shared-memory words, so the function compiled as plain C++ with ``g++``
and called with tid = 0, nt = 1 for every block in turn runs the card's
addressing and sequence of operations.  The card's carry-chain
instructions are emulated with a host carry flag, which does not show
that the card's carry flag behaves the same: a product built from
subtract-with-borrow chains once passed here and failed on the card
(PERF.md, open questions), so the kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 2c).  Here the host build is held bit for bit against
``ntt_pass_plain``, pass by pass, at every size 2^1 .. 2^10, with radices
up to 2^7, 1 to 16 columns per block (so that the last block of a pass is
partly empty), and batches of 1, 2 and 3 rows; and the chain of passes
against ``fft_with_root``.  Inputs come from ``numpy.random.default_rng``;
tolerance: exact equality.  Skips without ``g++``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu_torch import native
from lambda_elliptic_curves_tpu_torch.fields import Stark252
from lambda_elliptic_curves_tpu_torch.poly import ntt

_HOST_SRC = """
#include <vector>
#include "ntt.cuh"

extern "C" long smem_words(int s, int log_c) { return lw_ntt_pass_smem_words(s, log_c); }

extern "C" void mul(const uint32_t* a, const uint32_t* b, uint32_t* r, long n) {
    for (long i = 0; i < n; i++) lw_mont_mul(a + 8 * i, b + 8 * i, r + 8 * i);
}

extern "C" void ntt_pass(const int32_t* x, int32_t* out, const int32_t* t_lo,
                         const int32_t* t_hi, long rows, int log_n, int ns_log, int s,
                         int log_c) {
    LwNttPass P = {(const uint32_t*)x, (uint32_t*)out, (const uint32_t*)t_lo,
                   (const uint32_t*)t_hi, rows, log_n, ns_log, s, log_c};
    std::vector<uint32_t> sm(lw_ntt_pass_smem_words(s, log_c), 0xA5A5A5A5u);
    long cols = rows << (log_n - s);
    for (long b = 0; b < (cols + (1L << log_c) - 1) >> log_c; b++)
        lw_ntt_pass_block(P, b, 0, 1, sm.data());
}
"""


def _build(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the NTT pass block for the host")
    d = tmp_path_factory.mktemp("ntt_pass")
    src, so = d / "block.cpp", d / "libblock.so"
    src.write_text(_HOST_SRC)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", native.CSRC_DIR,
                        "-o", str(so), str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    lib.mul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
    lib.mul.restype = None
    return lib


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    """ctypes handle of the pass block built for the host."""
    lib = _build(tmp_path_factory)
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.ntt_pass.argtypes = [P, P, P, P, L, I, I, I, I]
    lib.ntt_pass.restype = None
    lib.smem_words.argtypes = [I, I]
    lib.smem_words.restype = L
    return lib


def _host_pass(lib, x: torch.Tensor, tables, ns_log: int, s: int, log_c: int):
    xn = np.ascontiguousarray(x.numpy())
    out = np.full_like(xn, 0x5A5A5A5A)  # the block must write every point
    lo, hi = tables.lo_rows.numpy(), tables.hi_rows.numpy()
    lib.ntt_pass(xn.ctypes.data, out.ctypes.data, lo.ctypes.data, hi.ctypes.data,
                 x.shape[1], x.shape[2].bit_length() - 1, ns_log, s, log_c)
    return torch.from_numpy(out)


def _input(log_n: int, rows: int) -> torch.Tensor:
    rng = np.random.default_rng(1000 * log_n + rows)
    vals = [int.from_bytes(rng.bytes(32), "little") % Stark252.p
            for _ in range(rows << log_n)]
    vals[:4] = [0, 1, Stark252.p - 1, Stark252.p - 2][:len(vals)]
    return Stark252.array(np.array(vals, dtype=object).reshape(rows, 1 << log_n), "cpu")


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("log_n", range(1, 11))
def test_host_block_equals_ntt_pass_plain(block, log_n, rows):
    x = _input(log_n, rows)
    root = Stark252.params.primitive_root_of_unity(log_n)
    tables = ntt.twiddle_tables(Stark252, root, log_n, "cpu")
    for max_pass_log, log_c in ((1, 4), (3, 0), (4, 2), (7, 4)):
        cur, ns_log = x, 0
        for s in ntt.pass_plan(log_n, max_pass_log):
            got = _host_pass(block, cur, tables, ns_log, s, log_c)
            assert torch.equal(got, ntt.ntt_pass_plain(cur, tables, ns_log, s)), \
                (max_pass_log, log_c, s, ns_log)
            cur, ns_log = got, ns_log + s
        assert torch.equal(cur, ntt.fft_with_root(x, Stark252, root, max_pass_log))


@pytest.mark.parametrize("seed", [0, 1])
def test_products_equal_host_ints(block, seed):
    """lw_mont_mul (``mont.cuh``, the pass's product) against a*b*2^-256
    mod p, with edge values (0, 1, p - 1, p - 2, values with zero low
    limbs) and random values from ``seed``."""
    lib = block
    p = Stark252.p
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, p - 1, p - 2, 1 << 192, (1 << 251) - 1, p - (1 << 64), 17 << 192]
    vals = edge + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(400)]
    a = [x for x in vals for _ in vals[:12]]
    b = [y for _ in vals for y in vals[:12]]

    def limbs(xs):
        return np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs),
                             dtype="<u4").copy()

    la, lb = limbs(a), limbs(b)
    out = np.zeros_like(la)
    lib.mul(la.ctypes.data, lb.ctypes.data, out.ctypes.data, len(a))
    got = [int.from_bytes(out[8 * i:8 * i + 8].tobytes(), "little") for i in range(len(a))]
    r_inv = pow(2, -256, p)
    assert got == [x * y * r_inv % p for x, y in zip(a, b)]


def test_smem_words_match_the_sweep_formula(block):
    from lambda_elliptic_curves_tpu_torch.tools import sweep_ntt

    for s in range(1, 10):
        for log_c in range(0, 6):
            assert 4 * block.smem_words(s, log_c) == sweep_ntt.smem_bytes(s, log_c)
