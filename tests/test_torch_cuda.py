"""The port's CUDA kernels held against their plain PyTorch versions on an
NVIDIA card.  Every test here carries the ``cuda`` marker and skips
without a card.  The file imports no JAX, so that it runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up the JAX CPU platform.)
Inputs come from ``numpy.random.default_rng``.  Tolerance: bitwise
equality (field values and digests are exact).
"""

import pathlib

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu_torch import native
from lambda_elliptic_curves_tpu_torch.fields import Stark252
from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
from lambda_elliptic_curves_tpu_torch.hashes import keccak
from lambda_elliptic_curves_tpu_torch.merkle import KeccakBatchBackend, MerkleTree
from lambda_elliptic_curves_tpu_torch.ops import limbs
from lambda_elliptic_curves_tpu_torch.poly import ntt
from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions, prove, verify
from lambda_elliptic_curves_tpu_torch.provers.stark.examples.fibonacci import (
    FibonacciPublicInputs, fibonacci_air_for, fibonacci_trace,
)
from lambda_elliptic_curves_tpu_torch.utils.serialization import serialize_proof

pytestmark = pytest.mark.cuda

P = Stark252.p
FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ints(seed, n, zeros=0):
    rng = np.random.default_rng(seed)
    edge = [0, 1, P - 1, P - 2, (1 << 255) % P, (1 << 256) % P]
    return [0] * zeros + edge + [int.from_bytes(rng.bytes(32), "little") % P
                                 for _ in range(n)]


def _words(seed, shape) -> torch.Tensor:
    w = np.random.default_rng(seed).integers(0, 1 << 32, shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32))


def _on_card(fn, *args):
    out = fn(*args)
    torch.cuda.synchronize()
    return out.cpu()


_FIELD_CASES = {
    "add": (Stark252.add, limbs.add_plain),
    "sub": (Stark252.sub, limbs.sub_plain),
    "mul": (Stark252.mul, limbs.mont_mul_plain),
    "square": (lambda x, y: Stark252.square(x), lambda x, y: limbs.square_plain(x)),
    "neg": (lambda x, y: Stark252.neg(x), lambda x, y: limbs.neg_plain(x)),
    "inv": (lambda x, y: Stark252.batch_inverse(x),
            lambda x, y: limbs.batch_inverse_plain(x)),
    "pow": (lambda x, y: Stark252.pow(x, 2**70 + 11),
            lambda x, y: limbs.mont_pow_plain(x, 2**70 + 11)),
}


@pytest.mark.parametrize("op", sorted(_FIELD_CASES))
def test_field_kernel_matches_plain(dev, op):
    vals = _ints(7, 4090, zeros=4)
    a, b = Stark252.array(vals, "cpu"), Stark252.array(vals[::-1], "cpu")
    kernel, plain = _FIELD_CASES[op]
    assert torch.equal(_on_card(kernel, a.to(dev), b.to(dev)), plain(a, b))


# (shape, field_inv launches): tiles of 256 threads x L elements, L = 8
# below 2^19 elements (2048 a tile), 16 below 2^21, 32, 64 from 2^22 and
# 128 from 2^23; one launch up to a tile, 3 up to a tile of tiles
_INV_SHAPES = [((3, 7, 1001), 3), ((4, (1 << 17) + 3), 3), ((2047,), 1), ((2048,), 1),
               ((2049,), 3), (((1 << 19) + 1,), 3), ((2, 1 << 18), 3), ((4, 1 << 18), 3),
               (((1 << 22) + 1,), 3)]


@pytest.mark.parametrize("shape, launches", _INV_SHAPES)
def test_batch_inverse_kernel_ragged_zeros_batched(dev, shape, launches):
    """Ragged sizes across tile boundaries and levels, the prover's (8, 2, N)
    and (8, 4, N) at N = 2^18, a 3-D batch; zeros scattered, in a run and
    at both ends (so whole tiles and walks hold zeros); bitwise against the
    plain version on the card, and the exact launches of the call."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1 << 32, (8, n), dtype=np.uint32)
    vals[7] &= 0x07FFFFFF  # below 2^251 < p
    vals[:, ::97] = 0
    vals[:, 1000:3100] = 0
    vals[:, [0, -1]] = 0
    a = torch.from_numpy(vals.view(np.int32)).reshape((8,) + shape).to(dev)
    native.launches["field_inv"] = 0
    got = Stark252.batch_inverse(a)
    assert native.launches["field_inv"] == launches
    assert torch.equal(got, limbs.batch_inverse_plain(a))
    assert not got.reshape(8, -1)[:, [0, -1]].any()


def test_field_kernel_broadcast_operand(dev):
    """One value over the batch is read with element stride 0."""
    a = Stark252.array(_ints(8, 100), "cpu").reshape(8, 2, 53)
    c = Stark252.constant(12345, (1, 1), "cpu")
    assert torch.equal(_on_card(Stark252.mul, a.to(dev), c.to(dev)),
                       limbs.mont_mul_plain(a, c))


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_ntt_pass_kernel_matches_plain(dev, rows):
    """Every pass of every transform 2^1 .. 2^14 (passes of radix up to
    2^7, and up to 2^3 so that each size takes several), bitwise against
    ``ntt_pass_plain`` on the same input; the prover's batches."""
    for log_n in range(1, 15):
        n = 1 << log_n
        vals = _ints(log_n, max(rows * n - 6, 0))[:rows * n]
        x = Stark252.array(vals, "cpu").reshape(8, rows, n).to(dev)
        root = Stark252.params.primitive_root_of_unity(log_n)
        tables = ntt.twiddle_tables(Stark252, root, log_n, dev)
        for max_pass_log in (3, ntt.MAX_PASS_LOG):
            cur, ns_log = x, 0
            for s in ntt.pass_plan(log_n, max_pass_log):
                got = ntt.ntt_pass(cur, torch.empty_like(cur), tables, ns_log, s)
                assert torch.equal(got, ntt.ntt_pass_plain(cur, tables, ns_log, s)), \
                    (log_n, max_pass_log, s)
                cur, ns_log = got, ns_log + s
            assert torch.equal(cur, ntt.fft_with_root(x, Stark252, root, max_pass_log))


def test_fft_on_card_matches_cpu(dev):
    x = Stark252.array(_ints(99, (1 << 13) - 6), "cpu")
    for max_pass_log in (2, 5, ntt.MAX_PASS_LOG):
        got = _on_card(ntt.fft, x.to(dev), Stark252, max_pass_log)
        assert torch.equal(got, ntt.fft(x, Stark252, max_pass_log))
        assert torch.equal(_on_card(ntt.ifft, got.to(dev), Stark252, max_pass_log), x)


def test_fft_launches_only_the_pass_kernel(dev):
    """A warm fft on the card is one pass-kernel launch per pass and no
    other device work (no transposes, gathers or twiddle multiplies); the
    ifft adds one field launch for 1/n."""
    from lambda_elliptic_curves_tpu_torch.tools._timing import traced_kernels

    x = Stark252.array(_ints(3, (1 << 13) - 6), "cpu").to(dev)
    passes = len(ntt.pass_plan(13))
    ntt.ifft(ntt.fft(x, Stark252), Stark252)  # warm: tables built
    torch.cuda.synchronize()
    for fn, field_launches in ((ntt.fft, 0), (ntt.ifft, 1)):
        def counted():
            native.launches.update({k: 0 for k in native.launches})
            fn(x, Stark252)
            assert native.launches["ntt"] == passes
            assert native.launches["field"] == field_launches

        traces = traced_kernels(counted, passes + field_launches)
        for names in traces:
            assert all("ntt_pass_kernel" in k or "field_op_kernel" in k for k in names), names
        names = traces[-1]
        assert sum("ntt_pass_kernel" in k for k in names) == passes, traces
        assert sum("field_op_kernel" in k for k in names) == field_launches, traces


def test_ntt_pass_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = Stark252.array(_ints(5, 58), "cpu").reshape(8, 1, 64).to(dev)
    tables = ntt.twiddle_tables(Stark252, Stark252.params.primitive_root_of_unity(6), 6, dev)
    bad = [(x.cpu(), torch.empty_like(x.cpu())), (x, x),
           (x.to(torch.int64), torch.empty_like(x, dtype=torch.int64)),
           (x.transpose(1, 2), torch.empty(8, 64, 1, dtype=torch.int32, device=dev))]
    for a, b in bad:
        with pytest.raises(ValueError):
            ntt.ntt_pass(a, b, tables, 0, 6)
    with pytest.raises(ValueError):
        ntt.ntt_pass(x, torch.empty_like(x), tables, 2, 6)  # radices beyond 2^6


def test_keccak_kernels_match_plain(dev):
    st = _words(4, (25, 2, 1000))
    assert torch.equal(_on_card(keccak.keccak_f, st.to(dev)), keccak.keccak_f_plain(st))
    for msg_bytes in (32, 64, 96, 200):
        words = _words(msg_bytes, (msg_bytes // 4, 1000))
        assert torch.equal(_on_card(keccak.keccak256_words, words.to(dev), msg_bytes),
                           keccak.keccak256_words_plain(words, msg_bytes))


def test_merkle_tree_on_card_matches_cpu(dev):
    vals = np.array(_ints(6, 2994), dtype=object).reshape(3, 1000).tolist()
    backend = KeccakBatchBackend(Stark252)
    cpu_tree = MerkleTree.build(backend, Stark252.array(vals, "cpu"))
    card_tree = MerkleTree.build(backend, Stark252.array(vals, dev))
    assert card_tree.root == cpu_tree.root
    assert card_tree.gather_proofs([0, 5, 999]) == cpu_tree.gather_proofs([0, 5, 999])


def test_every_kernel_counts_its_launches(dev):
    native.launches.update({k: 0 for k in native.launches})
    x = Stark252.array(_ints(9, 58), "cpu").to(dev)
    Stark252.mul(x, x)
    ntt.fft(x, Stark252)
    keccak.keccak256_words(_words(1, (8, 64)).to(dev), 32)
    Stark252.batch_inverse(x)
    Stark252.pow(x, 5)
    torch.cuda.synchronize()
    assert native.launches["keccak"] == 1
    assert native.launches["ntt"] == 1
    assert native.launches["field"] >= 1
    assert native.launches["field_inv"] == 1  # 64 elements: one tile
    assert native.launches["field_pow"] == 1
    Stark252.batch_inverse(Stark252.array(_ints(10, 2043), "cpu").to(dev))  # 2049: two levels
    torch.cuda.synchronize()
    assert native.launches["field_inv"] == 1 + 3


def test_prove_inverts_with_the_batch_inverse_kernel(dev):
    """A 2^16-row prove launches the Montgomery-trick kernel, never Fermat:
    two calls, (8, 2, 2^18) and (8, 4, 2^18), of 3 launches each."""
    rows = 1 << 16
    air, pub, opts = fibonacci_air_for(Stark252), FibonacciPublicInputs(1, 1), \
        ProofOptions(4, 32, 3, 0)
    trace = fibonacci_trace(Stark252, [1, 1], rows, dev)
    native.launches.update({k: 0 for k in native.launches})
    proof = prove(air, trace, pub, opts, DefaultTranscript(Stark252), device=dev)
    torch.cuda.synchronize()
    counts = dict(native.launches)
    assert counts["field_inv"] == 6 and counts["field_pow"] == 0, counts
    assert verify(air, proof, pub, opts, DefaultTranscript(Stark252))


def test_proof_on_card_equals_jax_fixture(dev):
    rows = 1 << 10
    air, pub, opts = fibonacci_air_for(Stark252), FibonacciPublicInputs(1, 1), \
        ProofOptions(4, 32, 3, 0)
    proof = prove(air, fibonacci_trace(Stark252, [1, 1], rows, dev), pub, opts,
                  DefaultTranscript(Stark252), device=dev)
    assert serialize_proof(proof) == (FIXTURES / "jax_fib_1024_proof.json").read_bytes()
    assert verify(air, proof, pub, opts, DefaultTranscript(Stark252))
