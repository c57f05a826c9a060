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
from lambda_elliptic_curves_tpu_torch.fields import BabyBear, Goldilocks, Stark252
from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
from lambda_elliptic_curves_tpu_torch.hashes import keccak
from lambda_elliptic_curves_tpu_torch.merkle import KeccakBatchBackend, MerkleTree
from lambda_elliptic_curves_tpu_torch.ops import limbs, small
from lambda_elliptic_curves_tpu_torch.poly import ntt
from lambda_elliptic_curves_tpu_torch.fiat_shamir import StoneProverTranscript
from lambda_elliptic_curves_tpu_torch.provers.stark import (
    ProofOptions, SecurityLevel, grinding, prove, verify,
)
from lambda_elliptic_curves_tpu_torch.provers.stark.examples.catalog import (
    CASES, EXTENSION_CASES, stone_case,
)
from lambda_elliptic_curves_tpu_torch.provers.stark.extension import ChallengeBundle
from lambda_elliptic_curves_tpu_torch.provers.stark.examples.fibonacci import (
    FibonacciPublicInputs, fibonacci_air_for, fibonacci_trace,
)
from lambda_elliptic_curves_tpu_torch.provers.stark.stone_serializer import serialize_proof_stone
from lambda_elliptic_curves_tpu_torch.provers.stark.verifier import grinding_seed
from lambda_elliptic_curves_tpu_torch.utils.serialization import (
    deserialize_proof, serialize_proof,
)

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


# (seed, factor): the nonce search at factors 8-20, in the prover's batches
_GRIND_CASES = [(0, 8), (1, 9), (2, 10), (3, 12), (4, 14), (5, 16), (6, 18), (7, 20), (8, 20)]


@pytest.mark.parametrize("seed, factor", _GRIND_CASES)
def test_grind_kernel_matches_plain_and_host_loop(dev, seed, factor):
    """The least nonce from the kernel, from its plain version on the card
    and from the host loop; one launch per batch up to the hit."""
    s = np.random.default_rng(seed).bytes(32)
    batch = grinding.GRIND_BATCH
    native.launches["grind"] = 0
    got = grinding.search_nonce_device(s, factor, batch, grinding.MAX_TRIES // batch, dev)
    assert native.launches["grind"] == got // batch + 1
    assert got == grinding.search_nonce_plain(s, factor, 1 << 18, 1 << 14, dev)
    assert got == grinding.generate_nonce(s, factor)


def test_grind_kernel_first_hit_in_a_later_batch(dev):
    s = np.random.default_rng(100).bytes(32)
    native.launches["grind"] = 0
    got = grinding.search_nonce_device(s, 16, 1 << 10, 1 << 22, dev)
    assert got >= 1 << 10 and native.launches["grind"] == (got >> 10) + 1
    assert got == grinding.generate_nonce(s, 16)
    inner = grinding._inner_hash(s, 16)
    assert grinding.grind_batch(inner, 16, 0, got, dev) is None
    assert grinding.grind_batch(inner, 16, got, 1, dev) == got


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_proofs_on_card_equal_jax_fixtures(dev, case):
    air, trace, pub, opts = CASES[case](dev)
    native.launches["grind"] = 0
    proof = prove(air, trace, pub, opts, DefaultTranscript(Stark252), device=dev)
    assert serialize_proof(proof) == (FIXTURES / f"jax_stark_{case}_proof.json").read_bytes()
    assert verify(air, proof, pub, opts, DefaultTranscript(Stark252))
    assert (native.launches["grind"] > 0) == (opts.grinding_factor > 0)


@pytest.mark.parametrize("case", [1, 2])
def test_stone_cases_on_card_equal_jax_bytes(dev, case):
    air, trace, pub, opts, seed = stone_case(case, dev)
    proof = prove(air, trace, pub, opts, StoneProverTranscript(seed), device=dev)
    assert serialize_proof_stone(air, proof, pub, opts, seed) == (
        FIXTURES / f"jax_stone_case{case}.bin").read_bytes()
    assert verify(air, proof, pub, opts, StoneProverTranscript(seed))


@pytest.mark.parametrize("rows, level", [(1 << 6, level) for level in SecurityLevel]
                         + [(1 << 20, SecurityLevel.CONJECTURABLE_128)])
def test_secure_preset_proves_on_card_with_the_least_nonce(dev, rows, level):
    air, pub, opts = fibonacci_air_for(Stark252), FibonacciPublicInputs(1, 1), \
        ProofOptions.new_secure(level)
    native.launches["grind"] = 0
    proof = prove(air, fibonacci_trace(Stark252, [1, 1], rows, dev), pub, opts,
                  DefaultTranscript(Stark252), device=dev)
    assert native.launches["grind"] >= 1
    assert verify(air, proof, pub, opts, DefaultTranscript(Stark252))
    seed = grinding_seed(air, proof, pub, opts, DefaultTranscript(Stark252))
    inner = grinding._inner_hash(seed, opts.grinding_factor)
    assert native.grind(inner, opts.grinding_factor, 0, proof.nonce) == -1
    assert grinding.is_valid_nonce(seed, proof.nonce, opts.grinding_factor)


@pytest.mark.parametrize("rows, blowup", [(1 << 12, 4), (1 << 14, 8)])
def test_proof_on_card_equals_cpu_proof_above_2_10_rows(dev, rows, blowup):
    """Sizes whose LDEs (2^14, and 2^17) take the two- and three-pass NTTs
    (``ntt.pass_plan``) on the card; the CPU path runs the plain passes."""
    assert len(ntt.pass_plan((rows * blowup).bit_length() - 1)) == (2 if rows < 1 << 14 else 3)
    air, pub, opts = fibonacci_air_for(Stark252), FibonacciPublicInputs(1, 1), \
        ProofOptions(blowup, 3, 3, 0)
    proofs = [serialize_proof(prove(air, fibonacci_trace(Stark252, [1, 1], rows, d), pub, opts,
                                    DefaultTranscript(Stark252), device=d))
              for d in (dev, "cpu")]
    assert proofs[0] == proofs[1]


# ---------------------------------------------------------------------------
# Goldilocks and BabyBear: kernels 6 (small_field.cu) and 7 (small_ntt.cu)
# ---------------------------------------------------------------------------

_SMALL = {"goldilocks": (Goldilocks, small.GOLDILOCKS), "babybear": (BabyBear, small.BABYBEAR)}


def _small_values(field, n, seed, degree=1):
    """(degree L, n) Montgomery limbs on the CPU: values from ``seed`` with
    0, 1, p - 1 and p - 2 in every component first."""
    rng = np.random.default_rng(seed)
    p = field.p
    comps = [([0, 1, p - 1, p - 2]
              + [int(v) for v in rng.integers(0, p, n, dtype=np.uint64)])[:n]
             for _ in range(degree)]
    return torch.cat([field.array(c, "cpu") for c in comps], dim=0)


def _tower(field, degree):
    return field if degree == 1 else ChallengeBundle(field, degree).fd


@pytest.mark.parametrize("name, degree", [(n, d) for n in sorted(_SMALL) for d in (1, 2, 4)])
def test_small_field_kernel_matches_plain(dev, name, degree):
    """Every op of kernel 6 on the card, bitwise against the plain version
    (the tower's ops composed of plain base ops) on the CPU."""
    field, arith = _SMALL[name]
    fd = _tower(field, degree)
    a, b = _small_values(field, 4099, 1, degree), _small_values(field, 4099, 2, degree).flip(1)
    c = b[:, 17:18].contiguous()
    cases = [
        (lambda x, y: fd.add(x, y), (a, b)), (lambda x, y: fd.sub(x, y), (a, b)),
        (lambda x, y: fd.mul(x, y), (a, b)), (lambda x, y: fd.mul(x, y), (a, c)),
        (lambda x: fd.neg(x), (a,)), (lambda x: fd.square(x), (a,)),
        (lambda x: fd.pow(x, 65537), (a,)), (lambda x: fd.pow(x, field.p + 5), (a,)),
        (lambda x: fd.batch_inverse(x), (a,)),
    ]
    native.launches.update({k: 0 for k in native.launches})
    for i, (fn, args) in enumerate(cases):
        got = _on_card(fn, *(t.to(dev) for t in args))
        assert torch.equal(got, fn(*args)), i
    assert native.launches["small_field"] == len(cases)  # one launch per op, any degree
    assert sum(native.launches.values()) == len(cases)


def _small_inverse_geometry(arith, degree):
    """(threads, elements) of a block of kernel 6's inversion kernel."""
    import ctypes

    info = (ctypes.c_int * 5)()
    assert native.cuda_lib().lw_small_field_info(arith.kernel_id, degree, 1, info) == 0
    return info[0], info[4]


@pytest.mark.parametrize("name, degree", [(n, d) for n in sorted(_SMALL) for d in (1, 2, 4)])
def test_small_batch_inverse_kernel_zero_patterns(dev, name, degree):
    """Kernel 6's batch inversion at 2^20 elements, one launch a call,
    bitwise against the plain version (Montgomery's trick over the whole
    batch, composed through the tower): random values, zeros laid on the
    kernel's blocks (each of a thread's positions, a whole block, every
    element), a size that is no multiple of a block's elements, and one
    value read with element stride 0."""
    field, arith = _SMALL[name]
    fd = _tower(field, degree)
    plain = fd.plain()
    threads, per_block = _small_inverse_geometry(arith, degree)
    n = 1 << 20
    a = _small_values(field, n, 5, degree).to(dev)
    first = torch.zeros(n, dtype=torch.bool)
    first[per_block + 3 + threads * torch.arange(per_block // threads)] = True
    block = torch.zeros(n, dtype=torch.bool)
    block[2 * per_block:3 * per_block] = True
    cases = [a, a[:, 7:].contiguous(), a[:, 9:10].expand(-1, n)]
    for mask in (first, block, torch.ones(n, dtype=torch.bool)):
        z = a.clone()
        z[:, mask.to(dev)] = 0
        cases.append(z)
    for i, x in enumerate(cases):
        native.launches.update({k: 0 for k in native.launches})
        got = fd.batch_inverse(x)
        assert native.launches["small_field"] == 1
        assert torch.equal(got, plain.batch_inverse(x.contiguous())), i


@pytest.mark.parametrize("name", sorted(_SMALL))
def test_small_ntt_pass_kernel_matches_plain(dev, name):
    field, _ = _SMALL[name]
    for log_n in (1, 5, 8, 9, 12, 14):
        root = field.params.primitive_root_of_unity(log_n)
        tables = ntt.twiddle_tables(field, root, log_n, dev)
        for rows in (1, 3):
            x = _small_values(field, rows << log_n, log_n).reshape(field.num_limbs, rows, -1)
            x = x.to(dev)
            # the fft's plan, radix-2^8 passes (the kernel's largest), radix <= 2^3
            for plan in (ntt.plan_for(field, log_n), ntt.pass_plan(log_n, ntt.SMALL_DFT_LOG),
                         ntt.pass_plan(log_n, 3)):
                cur, ns_log = x, 0
                for s in plan:
                    got = ntt.ntt_pass(cur, torch.empty_like(cur), tables, ns_log, s)
                    assert torch.equal(got, ntt.ntt_pass_plain(cur, tables, ns_log, s))
                    cur, ns_log = got, ns_log + s
                assert torch.equal(cur.cpu(), ntt.fft_with_root(x.cpu(), field, root))


@pytest.mark.parametrize("name", sorted(_SMALL))
def test_small_fft_round_trip_and_launches(dev, name):
    field, _ = _SMALL[name]
    x = _small_values(field, 1 << 16, 3).to(dev)
    native.launches.update({k: 0 for k in native.launches})
    y = ntt.fft(x, field)
    torch.cuda.synchronize()
    assert native.launches["small_ntt"] == len(ntt.plan_for(field, 16)) == 3
    assert sum(native.launches.values()) == native.launches["small_ntt"]
    assert torch.equal(ntt.ifft(y, field), x)


@pytest.mark.parametrize("case", sorted(EXTENSION_CASES))
def test_extension_proofs_on_card_equal_jax_fixtures(dev, case):
    air, trace, pub, opts, field = EXTENSION_CASES[case](dev)
    proof = prove(air, trace, pub, opts, DefaultTranscript(field), device=dev)
    want = (FIXTURES / f"jax_stark_ext_{case}_proof.json").read_bytes()
    assert serialize_proof(proof) == want
    assert verify(air, proof, pub, opts, DefaultTranscript(field))
    assert verify(air, deserialize_proof(want), pub, opts, DefaultTranscript(field))


@pytest.mark.parametrize("field, degree", [(Goldilocks, 2), (BabyBear, 4)])
def test_extension_proof_on_card_equals_cpu_proof_at_2_12_rows(dev, field, degree):
    """2^12 rows, LDE 2^14 (two passes of kernel 7): the card's proof
    against the CPU path's, and only the small-field kernels and Keccak
    ran."""
    air, pub = fibonacci_air_for(field, degree), FibonacciPublicInputs(1, 1)
    opts = ProofOptions(4, 3, 3, 0)
    native.launches.update({k: 0 for k in native.launches})
    proofs = [serialize_proof(prove(air, fibonacci_trace(field, [1, 1], 1 << 12, d), pub, opts,
                                    DefaultTranscript(field), device=d))
              for d in (dev, "cpu")]
    assert proofs[0] == proofs[1]
    counts = dict(native.launches)
    assert counts["small_field"] > 0 and counts["small_ntt"] > 0 and counts["keccak"] > 0
    assert all(v == 0 for k, v in counts.items() if k not in ("small_field", "small_ntt",
                                                               "keccak"))


# -- BN254: kernel 1 over Fr, kernels 8 and 9, MSM and Plonk on the card ------

def _bn254():
    from lambda_elliptic_curves_tpu_torch.fields import BN254Field, BN254Fr

    return {"fr": BN254Fr, "fq": BN254Field}


def _dense_values(field, n, seed, zeros=0):
    rng = np.random.default_rng(seed)
    p = field.p
    edge = [0, 1, p - 1, p - 2, (1 << 253) % p, (1 << 256) % p]
    vals = [0] * zeros + edge + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    return field.array(vals, "cpu")


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_dense_field_kernel_matches_plain(dev, name):
    """Every op of kernel 8 on the card, bitwise against the plain version on
    the CPU, a broadcast operand among them; one launch an op."""
    f = _bn254()[name]
    a = _dense_values(f, 4093, 1, zeros=3)
    b = _dense_values(f, 4093, 2, zeros=3).flip(1)
    c = b[:, 17:18].contiguous()
    cases = [
        (f.add, (a, b)), (f.sub, (a, b)), (f.mul, (a, b)), (f.mul, (a, c)),
        (f.neg, (a,)), (f.square, (a,)), (lambda x: f.pow(x, 65537), (a,)),
        (lambda x: f.pow(x, f.p - 2), (a,)),
    ]
    native.launches.update({k: 0 for k in native.launches})
    for i, (fn, args) in enumerate(cases):
        got = _on_card(fn, *(t.to(dev) for t in args))
        assert torch.equal(got, fn(*args)), i
    assert native.launches["dense_field"] == len(cases)
    assert sum(native.launches.values()) == len(cases)


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("shape, launches", [((3, 7, 1001), 1), ((2047,), 1), ((2049,), 1),
                                             ((1 << 18,), 1)])
def test_dense_batch_inverse_kernel_matches_plain(dev, name, shape, launches):
    """Kernel 9 with zeros scattered and at both ends, bitwise against the
    plain version, with its exact launches (one a call)."""
    f = _bn254()[name]
    n = int(np.prod(shape))
    a = _dense_values(f, n, n)[:, :n].clone()
    a[:, ::97] = 0
    a[:, [0, -1]] = 0
    a = a.reshape((8,) + shape)
    native.launches["dense_inv"] = 0
    got = _on_card(f.batch_inverse, a.to(dev))
    assert native.launches["dense_inv"] == launches
    assert torch.equal(got, f.ops.batch_inverse_plain(a.to(dev)).cpu())


def _dense_fields_all():
    return {"bn254_" + k: v for k, v in _bn254().items()} | {
        "bls12_377_" + k: v for k, v in _bls().items()}


@pytest.mark.parametrize("name", ["bn254_fr", "bn254_fq", "bls12_377_fr", "bls12_377_fq"])
def test_dense_field_kernel_elements_and_broadcasts(dev, name):
    """Kernel 8 at its elements a thread over ragged sizes (1, 2 and 4 short
    of a block's elements and past it), with a broadcast operand on either
    side and a row of a 3-row tensor as an operand, bitwise against plain."""
    f = _dense_fields_all()[name]
    values = _dense_values if name.startswith("bn254") else _bls_values
    for n in (1, 511, 513, 1023, 1025, 4096):
        a = values(f, n, n, zeros=2)[:, :n].contiguous()
        b = values(f, n, n + 1)[:, :n].flip(1).contiguous()
        c = b[:, n // 2:n // 2 + 1].contiguous()
        rows = torch.stack([b, a, b], dim=1)
        for fn, args in ((f.mul, (a, b)), (f.mul, (c, a)), (f.add, (a, c)), (f.sub, (c, a)),
                         (f.mul, (rows[:, 1], b)), (f.square, (a,)), (f.neg, (a,))):
            assert torch.equal(_on_card(fn, *(t.to(dev) for t in args)), fn(*args)), n


@pytest.mark.parametrize("name", ["bn254_fr", "bn254_fq", "bls12_377_fr", "bls12_377_fq"])
@pytest.mark.parametrize("log_n", [12, 17, 18])
def test_dense_programs_match_plain(dev, name, log_n):
    """Kernel 8's program entry on Plonk's round-3 quotient and on Groth16's
    h (its three operands rows of one tensor), bitwise against
    ``program_plain``, one launch each."""
    from lambda_elliptic_curves_tpu_torch.provers.plonk.prover import quotient_evaluations

    f = _dense_fields_all()[name]
    n = 1 << log_n
    gen = torch.Generator(device=dev).manual_seed(log_n)
    top = f.p >> (32 * (f.num_limbs - 1))

    def rand(m):  # canonical: the top limb below p's
        x = torch.randint(0, 1 << 31, (f.num_limbs, m), generator=gen, device=dev,
                          dtype=torch.int32)
        x[-1] %= top
        return x
    names = ("a", "b", "c", "ql", "qr", "qm", "qo", "qc", "pi", "x", "z", "zw", "s1", "s2",
             "s3", "l1", "zh_inv")
    ch = f.ops.chain()
    e = {k: ch.input(rand(n)) for k in names}
    c = {k: ch.input(rand(1)) for k in ("beta", "gamma", "k1", "k2", "alpha", "one")}
    out = quotient_evaluations(ch, e, c)
    native.launches.update({k: 0 for k in native.launches})
    got = ch.run(out)
    assert native.launches[f.ops.program_counter] == 1
    assert sum(native.launches.values()) == 1
    assert torch.equal(got, f.ops.program_plain(ch.steps_encoded(), ch.inputs))
    lrc = rand(3 * n).reshape(f.num_limbs, n, 3).transpose(1, 2).contiguous()
    ch = f.ops.chain()
    h = ch.mul(ch.sub(ch.mul(ch.input(lrc[:, 0]), ch.input(lrc[:, 1])), ch.input(lrc[:, 2])),
               ch.input(rand(n)))
    native.launches[f.ops.program_counter] = 0
    got = ch.run(h)
    assert native.launches[f.ops.program_counter] == 1
    assert torch.equal(got, f.ops.program_plain(ch.steps_encoded(), ch.inputs))


@pytest.mark.parametrize("field", [0, 2, 3])
def test_dense32_product_equals_cios_on_card(dev, field):
    """dense32.cuh's product (kernel 1's over the dense fields) equals
    dense.cuh's CIOS product bit for bit on the card: 2^20 random pairs and the edge values each against each, over
    BN254 Fr, BLS12-377 Fr (8 limbs) and BLS12-377 Fq (12)."""
    from lambda_elliptic_curves_tpu_torch.tools import dense_mul

    got = dense_mul.check(field)
    assert got["pairs"] > 1 << 20
    assert all(v == 0 for k, v in got.items() if k != "pairs"), got


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_dense_ntt_pass_kernel_matches_plain(dev, rows):
    """Every pass of every BN254 Fr transform 2^1 .. 2^14 at radix up to
    2^8 and up to 2^3, forward and inverse root, bitwise against
    ntt_pass_plain on the card, each pass one launch of the dense entry
    (on ``ntt.dense_cols_log`` columns a block); the fft is exactly its
    plan's passes."""
    f = _bn254()["fr"]
    for log_n in range(1, 15):
        x = _dense_values(f, rows << log_n, log_n)[:, :rows << log_n].reshape(8, rows, -1)
        x = x.contiguous().to(dev)
        w = f.params.primitive_root_of_unity(log_n)
        for root in (w, pow(w, f.p - 2, f.p)):
            tables = ntt.twiddle_tables(f, root, log_n, dev)
            for max_pass_log in (ntt.MAX_PASS_LOG, 3):
                cur, ns_log = x, 0
                for s in ntt.dense_pass_plan(log_n, max_pass_log):
                    native.launches["dense_ntt"] = 0
                    got = ntt.ntt_pass(cur, torch.empty_like(cur), tables, ns_log, s)
                    assert native.launches["dense_ntt"] == 1
                    assert torch.equal(got, ntt.ntt_pass_plain(cur, tables, ns_log, s)), \
                        (log_n, s, ns_log)
                    cur, ns_log = got, ns_log + s
                native.launches["dense_ntt"] = 0
                assert torch.equal(ntt.fft_with_root(x, f, root, max_pass_log), cur)
                assert native.launches["dense_ntt"] == len(ntt.dense_pass_plan(log_n, max_pass_log))


def test_bn254_fft_on_card_matches_cpu(dev):
    """fft and ifft at 2^12 and at Plonk's 2^16 and 2^18 against the CPU's
    plain passes, each exactly its plan's launches of the dense entry."""
    f = _bn254()["fr"]
    for log_n in (12, 16, 18):
        x = _dense_values(f, 1 << log_n, log_n)[:, :1 << log_n].contiguous()
        ntt.twiddle_tables(f, f.params.primitive_root_of_unity(log_n), log_n, dev)
        native.launches["dense_ntt"] = 0
        got = _on_card(ntt.fft, x.to(dev), f)
        assert native.launches["dense_ntt"] == len(ntt.dense_pass_plan(log_n))
        assert torch.equal(got, ntt.fft(x, f) if log_n == 12 else ntt.fft_with_root_plain(
            x.to(dev), f, f.params.primitive_root_of_unity(log_n)).cpu())
        assert torch.equal(_on_card(ntt.ifft, got.to(dev), f), x)


def test_msm_routes_agree_on_card(dev):
    """Pippenger, the device double-and-add and the host MSM at 2^10 points."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.zoo import BN254Curve

    rng = np.random.default_rng(5)
    r = BN254Curve.order
    g = BN254Curve.generator()
    points = [g.operate_with_self(int.from_bytes(rng.bytes(32), "little") % r)
              for _ in range(1 << 10)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(1 << 10)]
    want = M.msm_naive_host(scalars, points)
    native.launches.update({k: 0 for k in native.launches})
    assert M.msm(BN254Curve, scalars, points, device=dev) == want
    # the bucket phase on kernel 11; the window sums go affine on the host,
    # so no batch inversion (kernel 9) runs
    assert native.launches["dense_field"] > 0 and native.launches["dense_inv"] == 0
    assert native.launches["msm_bucket"] > 0
    assert M.msm(BN254Curve, scalars, points, method="naive", device=dev) == want


_CURVE_GROUPS = ("bn254_g1", "bn254_g2", "bls12_377_g1", "bls12_377_g2")


def _curve(group):
    from lambda_elliptic_curves_tpu_torch.curves.twists import bls12_377_twist, bn254_twist
    from lambda_elliptic_curves_tpu_torch.curves.zoo import BLS12377Curve, BN254Curve

    return {"bn254_g1": BN254Curve, "bn254_g2": bn254_twist(),
            "bls12_377_g1": BLS12377Curve, "bls12_377_g2": bls12_377_twist()}[group]


def _random_triples(ops, n, seed, dev, affine=False):
    """n Jacobian triples of random field values on the card (z nonzero; z =
    1 when ``affine``): off the curve, which the formulas do not need."""
    f = ops.f
    rng = np.random.default_rng(seed)
    g2 = f.num_limbs > 12

    def vals(lo=0):
        out = [int.from_bytes(rng.bytes(48), "little") % (f.p - lo) + lo
               for _ in range(2 * n if g2 else n)]
        return [(out[2 * i], out[2 * i + 1]) for i in range(n)] if g2 else out
    z = f.ones((n,), dev) if affine else f.array(vals(1), dev)
    return f.array(vals(), dev), f.array(vals(), dev), z


def _curve_lanes(ops, n, dev):
    """(a, b) lanes of every case of the complete addition, and (a, b) of the
    mixed one (b affine): random pairs, P + P (the same triple and another
    representative), P + (-P), operands at infinity."""
    f = ops.f
    a = _random_triples(ops, n, 1, dev)
    b = _random_triples(ops, n, 2, dev)
    aff = _random_triples(ops, n, 3, dev, affine=True)
    k = n // 8
    head = lambda pt: tuple(c[:, :k] for c in pt)  # noqa: E731
    z = _random_triples(ops, k, 4, dev)[2]
    z2 = f.mul(z, z)
    other = (f.mul(a[0][:, :k], z2), f.mul(a[1][:, :k], f.mul(z2, z)), f.mul(a[2][:, :k], z))
    neg = lambda pt: (pt[0], f.sub(f.zeros(pt[1].shape[1:], dev), pt[1]), pt[2])  # noqa: E731
    inf = ops.neutral((k,), dev)
    cat = lambda *pts: tuple(torch.cat(cs, dim=-1) for cs in zip(*pts))  # noqa: E731
    # a Jacobian p1 with the same affine point as the affine p2
    a_of_aff = (f.mul(aff[0][:, :k], z2), f.mul(aff[1][:, :k], f.mul(z2, z)), z)
    return (cat(a, head(a), head(a), head(a), inf, head(a), inf),
            cat(b, head(a), other, neg(other), head(b), inf, inf),
            cat(a, a_of_aff, a_of_aff, inf, head(a), inf),
            cat(aff, head(aff), neg(head(aff)), head(aff), inf, inf))


@pytest.mark.parametrize("group", _CURVE_GROUPS)
def test_curve_kernel_matches_plain(dev, group):
    """Kernel 10's addition, mixed addition and doubling at 2^14 lanes, and
    an operand broadcast over them, bitwise against the plain group law on
    the card: random pairs, P + P, P + (-P), infinity; one launch an op."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    ops = M.make_ops(_curve(group))
    plain = ops.plain()
    a, b, am, bm = _curve_lanes(ops, 1 << 14, dev)
    g = ops.from_host([ops.curve.generator()], dev)
    native.launches.update({k: 0 for k in native.launches})
    cases = [(ops.add(a, b), plain.add(a, b)), (ops.add_mixed(am, bm), plain.add_mixed(am, bm)),
             (ops.double(a), plain.double(a)), (ops.add_mixed(a, g), plain.add_mixed(a, g)),
             (ops.add(g, a), plain.add(g, a))]
    torch.cuda.synchronize()
    assert native.launches[ops.counter("curve_op")] == len(cases)
    assert sum(native.launches.values()) == len(cases)
    for got, want in cases:
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("group", _CURVE_GROUPS)
def test_comb_kernel_matches_plain(dev, group):
    """Kernel 10's comb entry at 2^12 lanes (scalars 0, 1, r - 1, zero
    windows, and random ones): one launch, bitwise equal to the plain comb
    on the card (a window at a time over every lane), whose first lanes are
    the host's scalar multiplications."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    curve = _curve(group)
    ops = M.make_ops(curve)
    r = curve.order
    rng = np.random.default_rng(14)
    ks = [0, 1, r - 1, 1 << 252, 0xFF << 128] + [
        int.from_bytes(rng.bytes(32), "little") % r for _ in range((1 << 12) - 5)]
    digits = M.scalars_to_digits(curve, ks, dev)
    g = curve.generator()
    M.fixed_base_multiples(curve, digits[:, :1], g, ops)  # the table, built once
    native.launches.update({k: 0 for k in native.launches})
    got = M.fixed_base_multiples(curve, digits, g, ops)
    torch.cuda.synchronize()
    assert native.launches[ops.counter("curve_op")] == 1
    assert sum(native.launches.values()) == 1
    want = M.fixed_base_multiples(curve, digits, g, ops.plain())
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    mul = g.mul if hasattr(g, "mul") else g.operate_with_self
    assert ops.to_host(tuple(c[:, :8] for c in got)) == [mul(k) for k in ks[:8]]


def _skewed_ids(n, c, seed, dev):
    """Four windows of bucket ids: uniform, all equal, mostly 0 and 1 (a
    circom-style witness), half zeros."""
    rng = np.random.default_rng(seed)
    nb = 1 << c
    rows = [rng.integers(0, nb, n), np.full(n, rng.integers(1, nb)),
            rng.choice([0, 1, 2, nb - 1], n, p=[0.45, 0.45, 0.05, 0.05]),
            np.where(rng.random(n) < 0.5, 0, rng.integers(1, nb, n))]
    return torch.from_numpy(np.stack(rows).astype(np.int64)).to(dev)


@pytest.mark.parametrize("group", _CURVE_GROUPS)
def test_msm_bucket_kernel_matches_plain(dev, group, monkeypatch):
    """Kernel 11's accumulate and reduce over 2^11 points and 2^8 buckets,
    at skewed ids and points at infinity, bitwise against the plain bucket
    phase on the card: at the default tiles (one launch each: 128 leaves of
    16 positions, 16 leaves of 16 buckets), and at tiles of 4 leaves (four
    accumulate levels, two reduce levels)."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    ops = M.make_ops(_curve(group))
    n, c = 1 << 11, 8
    pts = _random_triples(ops, n, 5, dev, affine=True)
    pts = ops.select(torch.arange(n, device=dev) % 97 == 0, ops.neutral((n,), dev), pts)
    ids = _skewed_ids(n, c, 6, dev)
    for tile, acc_launches, reduce_launches in ((0, 1, 1), (4, 4, 2)):
        if tile:  # 2^11 -> 64 -> 16 -> 4 slots, then 2 leaves; 16 -> 4 -> 1 tiles
            monkeypatch.setattr(M, "BUCKET_TILE", tile)
        native.launches.update({k: 0 for k in native.launches})
        got = M.bucket_sums(ops, ids, pts, 1 << c)
        torch.cuda.synchronize()
        assert native.launches[ops.counter("msm_bucket")] == acc_launches
        want = M.bucket_sums_plain(ops, ids, pts, 1 << c)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        native.launches.update({k: 0 for k in native.launches})
        got_w = M.weighted_bucket_sums(ops, got)
        torch.cuda.synchronize()
        assert native.launches[ops.counter("msm_bucket")] == reduce_launches
        assert all(torch.equal(x, y)
                   for x, y in zip(got_w, M.weighted_bucket_sums_plain(ops, want)))


def _comb_points(curve, ops, n, seed, dev):
    """n points k_i G of the group (the comb on the card, then affine)."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % curve.order for _ in range(n)]
    return ops.affine_points(M.fixed_base_multiples(
        curve, M.scalars_to_digits(curve, ks, dev), curve.generator(), ops))


def test_pippenger_launches_kernel_11_and_no_group_op(dev):
    """A Pippenger MSM of 2^12 points on the card (c = 13, 20 windows): its
    bucket phase is kernel 11's levels alone, exactly 4 launches (the
    accumulate: 2 tiles a window of 2048 positions, then their 4 slots; the
    reduce: 4 tiles a window of 128 leaves of 16 buckets, then their
    roots), and nothing else runs on the card: no kernel 10 (group op) and
    no kernel 8 or 9, since the 20 window sums go affine on the host; the
    value is the double-and-add's."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.zoo import BN254Curve

    ops = M.make_ops(BN254Curve)
    pts = _comb_points(BN254Curve, ops, 1 << 12, 8, dev)
    rng = np.random.default_rng(9)
    r = BN254Curve.order
    scalars = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(1 << 12)]
    digits = M.scalars_to_digits(BN254Curve, scalars, dev)
    native.launches.update({k: 0 for k in native.launches})
    value = M.msm_pippenger(BN254Curve, digits, pts, ops=ops)
    assert native.launches["msm_bucket"] == 4
    assert sum(native.launches.values()) == 4
    assert value == ops.to_host(M.msm_double_and_add(BN254Curve, digits, pts, ops))[0]


@pytest.mark.parametrize("group", _CURVE_GROUPS)
def test_pippenger_skewed_scalars_equal_double_and_add(dev, group):
    """Pippenger MSMs of 2^12 points with skewed scalars, every scalar
    equal (one bucket a window) and 90% 0 or 1 with the rest uniform (a
    circom-style witness), equal to the device double-and-add, an
    independent algorithm; the bucket phase is 4 launches of kernel 11."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    curve = _curve(group)
    ops = M.make_ops(curve)
    n = 1 << 12
    pts = _comb_points(curve, ops, n, 10, dev)
    rng = np.random.default_rng(11)
    draw = lambda: int.from_bytes(rng.bytes(32), "little") % curve.order  # noqa: E731
    one = draw()
    for scalars in ([one] * n,
                    [0 if u < 0.45 else 1 if u < 0.9 else draw() for u in rng.random(n)]):
        digits = M.scalars_to_digits(curve, scalars, dev)
        native.launches.update({k: 0 for k in native.launches})
        value = M.msm_pippenger(curve, digits, pts, ops=ops)
        assert native.launches[ops.counter("msm_bucket")] == 4
        assert value == ops.to_host(M.msm_double_and_add(curve, digits, pts, ops))[0]


@pytest.mark.parametrize("case", ["plonk4", "plonk32"])
def test_plonk_proof_on_card_equals_jax_fixture(dev, case):
    """The Plonk fixture circuits proved on the card (SRS on the card too):
    every field of the proof equals the JAX package's, and it verifies."""
    import json

    from lambda_elliptic_curves_tpu_torch.commitments import (
        KateZaveruchaGoldberg, StructuredReferenceString,
    )
    from lambda_elliptic_curves_tpu_torch.curves.pairings import BN254Pairing
    from lambda_elliptic_curves_tpu_torch.provers.plonk import (
        CommonPreprocessedInput, Prover, TestRandomFieldGenerator, Verifier, Witness,
        proof_to_json, setup,
    )
    from lambda_elliptic_curves_tpu_torch.provers.plonk.circuits import fixture_circuit

    data = json.loads((FIXTURES / f"jax_bn254_{case}.json").read_text())
    f = _bn254()["fr"]
    system, assignments = fixture_circuit(f, data)
    cpi = CommonPreprocessedInput.from_constraint_system(system, data["k1"], device=dev)
    srs = StructuredReferenceString.insecure_setup(BN254Pairing, data["srs_size"],
                                                   tau=data["tau"], device=dev)
    kzg = KateZaveruchaGoldberg(BN254Pairing, srs, msm_method="naive", device=dev)
    vk = setup(cpi, kzg)
    witness = Witness.new(assignments, system)
    public_input = system.public_input_values(assignments)
    native.launches.update({k: 0 for k in native.launches})
    proof = Prover(kzg, TestRandomFieldGenerator(f)).prove(witness, public_input, cpi, vk)
    assert native.launches["dense_ntt"] > 0 and native.launches["dense_inv"] > 0
    assert native.launches["dense_field"] > 0
    assert native.launches["dense_program"] == 1  # round 3's quotient
    assert proof_to_json(proof) == data["proof"]
    assert Verifier(kzg).verify(proof, public_input, cpi, vk)


def test_plonk_proof_on_card_equals_cpu_path_with_random_blinders(dev):
    """The plonk32 circuit with random blinders (one seed for both): the
    card's proof equals the CPU path's in every field.  The SRS is made on
    the card and shared: its host points do not depend on the device."""
    import json
    import random

    from lambda_elliptic_curves_tpu_torch.commitments import (
        KateZaveruchaGoldberg, StructuredReferenceString,
    )
    from lambda_elliptic_curves_tpu_torch.curves.pairings import BN254Pairing
    from lambda_elliptic_curves_tpu_torch.provers.plonk import (
        CommonPreprocessedInput, Prover, RandomFieldGenerator, Verifier, Witness,
        proof_to_json, setup,
    )
    from lambda_elliptic_curves_tpu_torch.provers.plonk.circuits import fixture_circuit

    data = json.loads((FIXTURES / "jax_bn254_plonk32.json").read_text())
    f = _bn254()["fr"]
    system, assignments = fixture_circuit(f, data)
    witness = Witness.new(assignments, system)
    public_input = system.public_input_values(assignments)
    srs = StructuredReferenceString.insecure_setup(BN254Pairing, data["srs_size"],
                                                   tau=data["tau"], device=dev)
    proofs = {}
    for device in (dev, "cpu"):
        cpi = CommonPreprocessedInput.from_constraint_system(system, data["k1"], device=device)
        kzg = KateZaveruchaGoldberg(BN254Pairing, srs, device=device)
        vk = setup(cpi, kzg)
        rng = RandomFieldGenerator(f, random.Random(3))
        proof = Prover(kzg, rng).prove(witness, public_input, cpi, vk)
        assert Verifier(kzg).verify(proof, public_input, cpi, vk)
        proofs[str(device)] = proof_to_json(proof)
    assert proofs[str(dev)] == proofs["cpu"]


# -- BLS12-377: kernel 1 over Fr, kernels 8 and 9 over Fr and Fq (Fq on six
# words), the G1 and G2 MSMs and Groth16 on the card ----------------------------

def _bls():
    from lambda_elliptic_curves_tpu_torch.fields import BLS12377Field, BLS12377Fr

    return {"fr": BLS12377Fr, "fq": BLS12377Field}


def _bls_values(field, n, seed, zeros=0):
    rng = np.random.default_rng(seed)
    p, L = field.p, field.num_limbs
    edge = [0, 1, p - 1, p - 2, (1 << (32 * L - 3)) % p, (1 << (32 * L)) % p]
    vals = [0] * zeros + edge + [int.from_bytes(rng.bytes(48), "little") % p
                                 for _ in range(n)]
    return field.array(vals, "cpu")


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_bls12_377_field_kernel_matches_plain(dev, name):
    """Every op of kernel 8 over BLS12-377 (Fq on six words), bitwise
    against the plain version, a broadcast operand and a 377-bit exponent
    among them; one launch an op, counted under the curve's name."""
    f = _bls()[name]
    a = _bls_values(f, 4093, 1, zeros=3)
    b = _bls_values(f, 4093, 2, zeros=3).flip(1)
    c = b[:, 17:18].contiguous()
    cases = [
        (f.add, (a, b)), (f.sub, (a, b)), (f.mul, (a, b)), (f.mul, (a, c)),
        (f.neg, (a,)), (f.square, (a,)), (lambda x: f.pow(x, 65537), (a,)),
        (lambda x: f.pow(x, f.p - 2), (a,)),
    ]
    native.launches.update({k: 0 for k in native.launches})
    for i, (fn, args) in enumerate(cases):
        got = _on_card(fn, *(t.to(dev) for t in args))
        assert torch.equal(got, fn(*args)), i
    assert native.launches["dense_field_bls12_377"] == len(cases)
    assert sum(native.launches.values()) == len(cases)


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("shape, launches", [((3, 7, 1001), 1), ((2047,), 1), ((2049,), 1),
                                             ((1 << 18,), 1)])
def test_bls12_377_batch_inverse_kernel_matches_plain(dev, name, shape, launches):
    """Kernel 9 over BLS12-377 Fr and Fq (12 limbs) with zeros scattered and
    at both ends, bitwise against the plain version, with its launches (one
    a call)."""
    f = _bls()[name]
    n = int(np.prod(shape))
    a = _bls_values(f, n, n)[:, :n].clone()
    a[:, ::97] = 0
    a[:, [0, -1]] = 0
    a = a.reshape((f.num_limbs,) + shape)
    native.launches["dense_inv_bls12_377"] = 0
    got = _on_card(f.batch_inverse, a.to(dev))
    assert native.launches["dense_inv_bls12_377"] == launches
    assert torch.equal(got, f.ops.batch_inverse_plain(a.to(dev)).cpu())


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_bls12_377_ntt_pass_kernel_matches_plain(dev, rows):
    """Every pass of every BLS12-377 Fr transform 2^1 .. 2^14, radix up to
    2^8 and up to 2^3, forward and inverse root, bitwise against
    ntt_pass_plain on the card (3 rows: the QAP's A w, B w, C w)."""
    f = _bls()["fr"]
    for log_n in range(1, 15):
        x = _bls_values(f, rows << log_n, log_n)[:, :rows << log_n].reshape(8, rows, -1)
        x = x.contiguous().to(dev)
        w = f.params.primitive_root_of_unity(log_n)
        for root in (w, pow(w, f.p - 2, f.p)):
            tables = ntt.twiddle_tables(f, root, log_n, dev)
            for max_pass_log in (ntt.MAX_PASS_LOG, 3):
                cur, ns_log = x, 0
                for s in ntt.dense_pass_plan(log_n, max_pass_log):
                    native.launches["dense_ntt_bls12_377"] = 0
                    got = ntt.ntt_pass(cur, torch.empty_like(cur), tables, ns_log, s)
                    assert native.launches["dense_ntt_bls12_377"] == 1
                    assert torch.equal(got, ntt.ntt_pass_plain(cur, tables, ns_log, s)), \
                        (log_n, s, ns_log)
                    cur, ns_log = got, ns_log + s
                native.launches["dense_ntt_bls12_377"] = 0
                assert torch.equal(ntt.fft_with_root(x, f, root, max_pass_log), cur)
                assert native.launches["dense_ntt_bls12_377"] == len(
                    ntt.dense_pass_plan(log_n, max_pass_log))


@pytest.mark.parametrize("stage", ["fft", "pallas"])
def test_bls12_377_fft_on_card_equals_jax(dev, stage):
    """The card's transform over BLS12-377 Fr against the JAX ``ntt.fft``
    (2^1 .. 2^10) and the Pallas kernel's interpret-mode output."""
    import json

    f = _bls()["fr"]
    data = json.loads((FIXTURES / f"jax_bls12_377_{stage}.json").read_text())
    for case in data["cases"]:
        vals = np.array([int(v, 16) for v in case["input"]], dtype=object)
        x = f.array(vals.reshape(case.get("rows", 1), -1), dev)
        got = f.to_ints(ntt.fft(x, f)).reshape(-1)
        assert [int(v) for v in got] == [int(v, 16) for v in case["output"]]
        assert torch.equal(ntt.ifft(ntt.fft(x, f), f), x)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("method", ["pippenger", "naive"])
def test_bls12_377_msm_routes_equal_jax_device_msm(dev, group, method):
    """Both device routes over BLS12-377 G1 and G2 at 128 points (default
    window) against the JAX device MSM."""
    import json

    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.twists import bls12_377_twist
    from lambda_elliptic_curves_tpu_torch.curves.zoo import BLS12377Curve
    from lambda_elliptic_curves_tpu_torch.provers.groth16 import interop

    data = json.loads((FIXTURES / "jax_bls12_377_curves.json").read_text())["msm"]
    curve = BLS12377Curve if group == "g1" else bls12_377_twist()
    ops = M.make_ops(curve)
    ks = [int(k, 16) for k in data["point_scalars"]]
    points = ops.to_host(M.fixed_base_multiples(
        curve, M.scalars_to_digits(curve, ks, dev), curve.generator(), ops))
    scalars = [int(s, 16) for s in data["scalars"]]
    native.launches.update({k: 0 for k in native.launches})
    got = M.msm(curve, scalars, points, method=method, device=dev)
    assert native.launches["dense_field_bls12_377"] > 0
    dump = interop.g1_to_json if group == "g1" else interop.g2_to_json
    assert dump(got) == data[f"{group}_{method}"]


def test_bls12_377_g2_msm_routes_agree_on_card(dev):
    """Pippenger, the device double-and-add and the host G2 MSM at 2^8
    points."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.twists import (
        bls12_377_twist, msm_g2_naive_host,
    )

    tw = bls12_377_twist()
    ops = M.make_ops(tw)
    rng = np.random.default_rng(6)
    ks = [int.from_bytes(rng.bytes(32), "little") % tw.order for _ in range(1 << 8)]
    points = ops.to_host(M.fixed_base_multiples(tw, M.scalars_to_digits(tw, ks, dev),
                                                tw.generator(), ops))
    assert points[5] == tw.generator().mul(ks[5])
    scalars = [int.from_bytes(rng.bytes(32), "little") % tw.order for _ in range(1 << 8)]
    want = msm_g2_naive_host(scalars, points)
    assert M.msm(tw, scalars, points, device=dev) == want
    assert M.msm(tw, scalars, points, method="naive", device=dev) == want


def _groth16_case(case):
    import json

    from lambda_elliptic_curves_tpu_torch.curves.pairings import BLS12377Pairing, BN254Pairing
    from lambda_elliptic_curves_tpu_torch.fields import BN254Fr
    from lambda_elliptic_curves_tpu_torch.provers.groth16 import circuits

    data = json.loads((FIXTURES / f"jax_groth16_{case}.json").read_text())
    cfg, fr = (BN254Pairing, BN254Fr) if case == "bn254" else (BLS12377Pairing, _bls()["fr"])
    c = data["circuit"]
    r1cs = circuits.chain_r1cs(c["m"]) if c["name"] == "chain" else circuits.x_cubed_r1cs()
    return data, cfg, fr, r1cs


@pytest.mark.parametrize("case", ["x3", "chain", "bn254"])
def test_groth16_fixture_proofs_on_card_equal_jax(dev, case):
    """The Groth16 fixture circuits set up and proved on the card: the keys
    and the proof equal the JAX package's point for point, the bytes too;
    the card's and the JAX proof verify; a wrong public input is refused."""
    import random

    from lambda_elliptic_curves_tpu_torch.provers.groth16 import (
        QuadraticArithmeticProgram, interop, prove, setup, verify,
    )

    data, cfg, fr, r1cs = _groth16_case(case)
    qap = QuadraticArithmeticProgram.from_r1cs(fr, r1cs)
    native.launches.update({k: 0 for k in native.launches})
    pk, vk = setup(qap, cfg, random.Random(data["setup_seed"]), device=dev)
    witness = [int(v, 16) for v in data["witness"]]
    proof = prove(witness, qap, pk, cfg, random.Random(data["prove_seed"]), device=dev)
    suffix = "" if case == "bn254" else "_bls12_377"
    for k in ("dense_field", "dense_inv", "dense_ntt"):
        assert native.launches[k + suffix] > 0, k
    assert native.launches["dense_program" + suffix] == 2  # t and h
    assert interop.proving_key_to_json(pk) == data["pk"]
    assert interop.verifying_key_to_json(vk) == data["vk"]
    assert interop.proof_to_json(proof) == data["proof"]
    assert proof.serialize().hex() == data["proof_bytes"]
    pub = [int(v, 16) for v in data["public_inputs"]]
    assert verify(vk, proof, pub, cfg, device=dev)
    assert verify(vk, interop.proof_from_json(data["proof"], cfg), pub, cfg, device=dev)
    assert not verify(vk, proof, [pub[0], (pub[1] + 1) % fr.p], cfg, device=dev)


def test_groth16_card_proof_equals_cpu_path(dev, monkeypatch):
    """A chain of 100 constraints (128 gates, MSMs of 103-256 points: on
    the card's MSM routes) with one set of seeds: the card's keys and proof
    equal the CPU path's, whose MSMs run on the host (the exact oracle)."""
    import random

    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.pairings import BLS12377Pairing
    from lambda_elliptic_curves_tpu_torch.provers.groth16 import (
        QuadraticArithmeticProgram, circuits, interop, prove, setup, verify,
    )

    fr, cfg = _bls()["fr"], BLS12377Pairing
    qap = QuadraticArithmeticProgram.from_r1cs(fr, circuits.chain_r1cs(100))
    witness = circuits.chain_witness(100, 3, 11, fr.p)
    out = {}
    for device in (dev, "cpu"):
        if device == "cpu":
            monkeypatch.setattr(M, "HOST_MSM_MAX", 1 << 20)
        native.launches.update({k: 0 for k in native.launches})
        pk, vk = setup(qap, cfg, random.Random(41), device=device)
        proof = prove(witness, qap, pk, cfg, random.Random(42), device=device)
        assert verify(vk, proof, witness[:2], cfg, device=device)
        if device == dev:
            assert native.launches["dense_ntt_bls12_377"] > 0
            # the MSMs ran here: the G1 and the G2 comb, one launch of kernel
            # 10 each, Pippenger's bucket phase on kernel 11
            assert native.launches["curve_op_bls12_377"] == 2
            assert native.launches["msm_bucket_bls12_377"] > 0
        out[str(device)] = (interop.proving_key_to_json(pk), interop.proof_to_json(proof))
    assert out[str(dev)] == out["cpu"]
