"""The port's Keccak-256 held against the JAX package's ``hashes.keccak``
and its Pallas keccak-f kernel (run in interpret mode, as
``tests/test_keccak_pallas.py`` runs it), plus the host known answers and
the transcript KAT.

Inputs come from ``numpy.random.default_rng``; the JAX side runs on the
CPU.  Tolerance: exact equality of every word and digest.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambda_elliptic_curves_tpu.hashes import keccak as jkeccak
from lambda_elliptic_curves_tpu.hashes import keccak_pallas
from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
from lambda_elliptic_curves_tpu_torch.fields import Stark252
from lambda_elliptic_curves_tpu_torch.hashes import keccak

torch.set_num_threads(1)


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _port(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("LWT_KECCAK_PALLAS", "interpret")
    monkeypatch.setenv("LWT_KECCAK_PALLAS_TILE", "128")
    # the probe and the permute-function cache keep env-derived values
    keccak_pallas._probe.cache_clear()
    keccak_pallas._permute_fn.cache_clear()
    yield
    keccak_pallas._probe.cache_clear()
    keccak_pallas._permute_fn.cache_clear()


def test_plain_keccak_f_equals_pallas_kernel(pallas_interpret):
    # 200 states: two 128-state tiles, the second one padded
    st = _words(np.random.default_rng(1), (25, 2, 200))
    assert keccak_pallas.available((200,))
    want = np.asarray(keccak_pallas.keccak_f(jnp.asarray(st)))
    assert np.array_equal(_np(keccak.keccak_f_plain(_port(st))), want)
    assert np.array_equal(_np(keccak.keccak_f(_port(st))), want)


@pytest.mark.parametrize("msg_bytes", [32, 64, 200])
def test_keccak256_words_equal_jax(msg_bytes):
    """One and two sponge blocks (the rate is 136 B), with two batch dims."""
    words = _words(np.random.default_rng(msg_bytes), (msg_bytes // 4, 3, 5))
    want = np.asarray(jkeccak.keccak256_words(jnp.asarray(words), msg_bytes))
    got = keccak.keccak256_words(_port(words), msg_bytes)
    assert got.shape == (8, 3, 5)
    assert np.array_equal(_np(got), want)
    first = words[:, 0, 0].astype("<u4").tobytes()
    assert keccak.digest_words_to_bytes(got[:, 0, :1]) == [keccak.keccak256(first)]


def test_host_keccak_known_answers():
    # the Ethereum KATs (Keccak, not SHA3: the pad byte is 0x01)
    assert keccak.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    # the native C hash against the pure-Python sponge, across block edges
    rng = np.random.default_rng(2)
    for n in (0, 1, 31, 32, 135, 136, 137, 271, 272, 300):
        msg = rng.bytes(n)
        assert keccak.keccak256(msg) == keccak._keccak256_py(msg)
        assert keccak.keccak256(msg) == jkeccak.keccak256(msg)


def test_plain_permutation_equals_host_permutation():
    st = _words(np.random.default_rng(3), (25, 2, 4))
    got = _np(keccak.keccak_f_plain(_port(st)))
    for b in range(4):
        lanes = [int(st[i, 0, b]) | int(st[i, 1, b]) << 32 for i in range(25)]
        out = [int(got[i, 0, b]) | int(got[i, 1, b]) << 32 for i in range(25)]
        assert out == keccak._keccak_f_host(lanes)


def test_transcript_known_answers():
    """``basic_challenge`` of ``default_transcript.rs``."""
    t = DefaultTranscript(Stark252)
    t.append_bytes(bytes([0xFF, 0xAB]))
    t.append_bytes(bytes([0xDD, 0x8C, 0x9D]))
    assert t.sample().hex() == (
        "0c2bd8cf2d71e00acea3bd5dc79f4f93ed5742d023bd47c904c2679dbcfa7ca7")
    t.append_bytes(bytes([0xFF, 0xAB]))
    t.append_bytes(bytes([0xDD, 0x8C, 0x9D]))
    assert t.sample().hex() == (
        "816151c57ecb45d5171a3c2e38045dfb3a3d338a22aff86085b9543ff83232bc")
