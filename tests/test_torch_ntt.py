"""The port's NTT held against the JAX package's ``poly.ntt`` and its
Pallas local kernel.

* The Pallas kernel runs here in interpret mode, as
  ``tests/test_ntt_pallas.py`` runs it; its lazy (< 4p) output is
  canonicalised by ``_local_fft(canonical=True)`` before comparing.
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
    monkeypatch.setenv("LWT_NTT_PALLAS", "interpret")
    vals = _values(n, (2, n))
    root = JStark252.params.primitive_root_of_unity(n.bit_length() - 1)
    want = ntt_pallas._local_fft(JStark252.array(vals), JStark252, root, canonical=True)
    assert _same(ntt.local_ntt(Stark252.array(vals, "cpu"), Stark252, root), want)


@pytest.mark.parametrize("log_n", range(1, 13))
def test_transforms_equal_jax(log_n):
    case, x = _oracle_input(log_n)
    f = Stark252
    assert _digest(ntt.fft(x, f)) == case["fft"]
    assert _digest(ntt.ifft(x, f)) == case["ifft"]
    assert _digest(ntt.evaluate_offset_fft(f, x, 2, None, 3)) == case["evaluate_offset_fft"]
    assert _digest(ntt.interpolate_offset_fft(f, x, 3)) == case["interpolate_offset_fft"]


def test_four_step_split_with_small_local_size():
    """max_local=8 forces two levels of four-step splitting at n = 2^10
    (32 x 32, each 32-point leg split again as 8 x 4)."""
    case, x = _oracle_input(10)
    root = Stark252.params.primitive_root_of_unity(10)
    assert _digest(ntt.fft_with_root(x, Stark252, root, max_local=8)) == case["fft"]
    assert _digest(ntt.fft_with_root_plain(x, Stark252, root, max_local=8)) == case["fft"]
    back = ntt.ifft(ntt.fft(x, Stark252, max_local=8), Stark252, max_local=8)
    assert torch.equal(back, x)


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
