"""The port's NTT held against the JAX package's ``poly.ntt`` and its
Pallas local kernel, and its pieces (the pass plan, the two-table root
powers, one Stockham pass) against Python integers.

* The Pallas kernel runs here in interpret mode, as
  ``tests/test_ntt_pallas.py`` runs it; its lazy (< 4p) output is
  canonicalised by ``_local_fft(canonical=True)`` before comparing.
* The CPU path runs the same passes as the card (``ntt_pass_plain``), so
  forcing small radices (``max_pass_log``) puts up to 12 passes under the
  oracle at 2^12.
* The JAX transforms at every size 2^1 .. 2^12 compile for tens of seconds
  each on a CPU, so their outputs come from ``fixtures/jax_ntt_oracle.json``
  (written by ``fixtures/make_torch_ntt_oracle.py`` with the JAX package):
  a SHA-256 of the JAX output digits per transform and size, for an input
  made from a recorded seed.

Inputs come from ``numpy.random.default_rng``.  Tolerance: exact equality
of the canonical Montgomery values.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu.fields import Stark252 as JStark252
from lambda_elliptic_curves_tpu.poly import ntt as jntt
from lambda_elliptic_curves_tpu.poly import ntt_pallas
from lambda_elliptic_curves_tpu_torch.fields import Stark252
from lambda_elliptic_curves_tpu_torch.ops import limbs
from lambda_elliptic_curves_tpu_torch.poly import ntt

torch.set_num_threads(1)

ORACLE = json.loads(
    (pathlib.Path(__file__).parent / "fixtures" / "jax_ntt_oracle.json").read_text())


def _values(seed, shape):
    """The recipe of ``fixtures/make_torch_ntt_oracle.py``."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return np.array([int.from_bytes(rng.bytes(32), "little") % Stark252.p
                     for _ in range(n)], dtype=object).reshape(shape)


def _digest(port: torch.Tensor) -> str:
    return hashlib.sha256(limbs.to_jax_digits(port).astype("<u4").tobytes()).hexdigest()


def _oracle_input(log_n):
    case = ORACLE[str(log_n)]
    x = Stark252.array(_values(case["seed"], (2, 1 << log_n)), "cpu")
    assert _digest(x) == case["input"], "input recipe differs from the oracle's"
    return case, x


def _same(port, jax_arr):
    return np.array_equal(limbs.to_jax_digits(port), np.asarray(jax_arr))


@pytest.mark.parametrize("n", [256, 512])
def test_plain_local_ntt_equals_pallas_kernel(monkeypatch, n):
    """The CPU path's passes ([8] at 2^8, [5, 4] at 2^9) against the
    Pallas kernel's whole local transform."""
    monkeypatch.setenv("LWT_NTT_PALLAS", "interpret")
    vals = _values(n, (2, n))
    root = JStark252.params.primitive_root_of_unity(n.bit_length() - 1)
    want = ntt_pallas._local_fft(JStark252.array(vals), JStark252, root, canonical=True)
    assert _same(ntt.fft_with_root(Stark252.array(vals, "cpu"), Stark252, root), want)


@pytest.mark.parametrize("log_n", range(1, 13))
def test_transforms_equal_jax(log_n):
    case, x = _oracle_input(log_n)
    f = Stark252
    assert _digest(ntt.fft(x, f)) == case["fft"]
    assert _digest(ntt.ifft(x, f)) == case["ifft"]
    assert _digest(ntt.evaluate_offset_fft(f, x, 2, None, 3)) == case["evaluate_offset_fft"]
    assert _digest(ntt.interpolate_offset_fft(f, x, 3)) == case["interpolate_offset_fft"]


@pytest.mark.parametrize("log_n", range(1, 13))
@pytest.mark.parametrize("max_pass_log", [1, 2, 3, 5])
def test_forced_passes_equal_jax(max_pass_log, log_n):
    """fft / ifft through ceil(log_n / max_pass_log) passes (12 at 2^12 with
    radix 2), against the JAX oracle; ifft(fft(x)) == x."""
    case, x = _oracle_input(log_n)
    y = ntt.fft(x, Stark252, max_pass_log)
    assert _digest(y) == case["fft"]
    assert _digest(ntt.ifft(x, Stark252, max_pass_log)) == case["ifft"]
    assert torch.equal(ntt.ifft(y, Stark252, max_pass_log), x)


@pytest.mark.parametrize("log_n,max_pass_log", [(1, 7), (12, 1), (12, 5), (22, 7), (22, 8),
                                                (13, 7), (7, 7)])
def test_pass_plan(log_n, max_pass_log):
    plan = ntt.pass_plan(log_n, max_pass_log)
    assert sum(plan) == log_n and max(plan) <= max_pass_log
    assert len(plan) == -(-log_n // max_pass_log) and max(plan) - min(plan) <= 1
    assert plan == sorted(plan, reverse=True)


@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_tables_equal_host_pow(inverse):
    """root^e = T_hi[e >> 6] * T_lo[e mod 2^6] for every e < 2^12."""
    p, log_n = Stark252.p, 12
    root = Stark252.params.primitive_root_of_unity(log_n)
    root = pow(root, p - 2, p) if inverse else root
    tables = ntt.twiddle_tables(Stark252, root, log_n, "cpu")
    assert tables.lo.shape == (8, 64) and tables.hi.shape == (8, 64)
    assert torch.equal(tables.lo_rows, tables.lo.t()) and torch.equal(tables.hi_rows, tables.hi.t())
    got = Stark252.to_ints(ntt.twiddle_plain(tables, torch.arange(1 << log_n)))
    assert [int(v) for v in got] == [pow(root, e, p) for e in range(1 << log_n)]


@pytest.mark.parametrize("log_n,ns_log,s", [(5, 0, 5), (6, 2, 3), (7, 3, 4), (6, 5, 1),
                                            (6, 0, 2)])
def test_ntt_pass_plain_equals_host_dft(log_n, ns_log, s):
    """One pass against Python integers: column j of each row takes
    x[j + t*N/r], twisted by w^((j mod Ns) t N / (Ns r)), through a DFT of r
    points, point k written to (j div Ns) Ns r + (j mod Ns) + k Ns."""
    p, n, r, ns = Stark252.p, 1 << log_n, 1 << s, 1 << ns_log
    cols = n // r
    vals = _values(100 + log_n, (2, n))
    w = Stark252.params.primitive_root_of_unity(log_n)
    tables = ntt.twiddle_tables(Stark252, w, log_n, "cpu")
    got = Stark252.to_ints(ntt.ntt_pass_plain(Stark252.array(vals, "cpu"), tables, ns_log, s))
    w_r = pow(w, cols, p)
    for row in range(2):
        for j in range(cols):
            g, i = divmod(j, ns)
            v = [int(vals[row, j + t * cols]) * pow(w, i * t * (n // (ns * r)), p) % p
                 for t in range(r)]
            for k in range(r):
                want = sum(v[t] * pow(w_r, t * k, p) for t in range(r)) % p
                assert int(got[row, g * ns * r + i + k * ns]) == want


@pytest.mark.parametrize("log_n", [0, 1, 5, 12])
def test_bitrev_indices_equal_host(log_n):
    want = [int(format(i, f"0{log_n}b")[::-1], 2) if log_n else 0 for i in range(1 << log_n)]
    assert ntt._bitrev_indices(1 << log_n).tolist() == want


def test_helpers_equal_jax():
    f, jf = Stark252, JStark252
    assert _same(ntt.powers(f, 5, 37, offset_int=3, device="cpu"),
                 jntt.powers(jf, 5, 37, offset_int=3))
    for config in ("natural", "bit_reverse", "bit_reverse_inversed"):
        assert _same(ntt.get_twiddles(f, 5, config, device="cpu"),
                     jntt.get_twiddles(jf, 5, config))
    vals = _values(3, (2, 16))
    assert _same(ntt.bit_reverse_permute(Stark252.array(vals, "cpu")),
                 jntt.bit_reverse_permute(JStark252.array(vals)))
