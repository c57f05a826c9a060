"""The port's Stark252 limb arithmetic held against the JAX package.

Inputs are made with ``numpy.random.default_rng``; the JAX side runs
``lambda_elliptic_curves_tpu.fields.Stark252`` on the CPU.  Tolerance:
exact equality (finite-field values are deterministic).  The field
kernel is held against these plain versions in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu.fields import Stark252 as JStark252
from lambda_elliptic_curves_tpu_torch.fields import Stark252
from lambda_elliptic_curves_tpu_torch.ops import limbs

torch.set_num_threads(1)

P = Stark252.p


def _ints(seed, n, zeros=0):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    edge = [0, 1, P - 1, P - 2, (1 << 255) % P, (1 << 256) % P]
    vals = edge + vals
    return [0] * zeros + vals


def test_converters_round_trip():
    vals = _ints(1, 50)
    t = limbs.ints_to_limbs(vals, "cpu")
    assert t.shape == (8, len(vals)) and t.dtype == torch.int32
    assert [int(v) for v in limbs.limbs_to_ints(t)] == vals
    # Montgomery tensors carry over bit for bit in both directions
    jarr = np.asarray(JStark252.array(vals))
    port = Stark252.array(vals, "cpu")
    assert torch.equal(limbs.from_jax_digits(jarr), port)
    assert np.array_equal(limbs.to_jax_digits(port), jarr)
    assert [int(v) for v in Stark252.to_ints(port)] == vals
    # batch shapes survive
    t2 = limbs.ints_to_limbs(np.array(vals[:48], dtype=object).reshape(6, 8), "cpu")
    assert t2.shape == (8, 6, 8)
    assert [int(v) for v in limbs.limbs_to_ints(t2).ravel()] == vals[:48]


@pytest.mark.parametrize("op", ["add", "sub", "mul", "square", "neg"])
def test_plain_ops_equal_jax(op):
    a_vals, b_vals = _ints(2, 58), _ints(3, 58)
    ja, jb = JStark252.array(a_vals), JStark252.array(b_vals)
    a, b = Stark252.array(a_vals, "cpu"), Stark252.array(b_vals, "cpu")
    if op in ("square", "neg"):
        want, got = getattr(JStark252, op)(ja), getattr(Stark252, op)(a)
    else:
        want, got = getattr(JStark252, op)(ja, jb), getattr(Stark252, op)(a, b)
    assert np.array_equal(limbs.to_jax_digits(got), np.asarray(want))


def test_plain_pow_inv_batch_inverse_equal_jax():
    vals = _ints(4, 26)
    ja, a = JStark252.array(vals), Stark252.array(vals, "cpu")
    for e in (5, 2**64 + 3):
        assert np.array_equal(limbs.to_jax_digits(Stark252.pow(a, e)),
                              np.asarray(JStark252.pow(ja, e)))
    nz = [v for v in vals if v]
    assert np.array_equal(limbs.to_jax_digits(Stark252.inv(Stark252.array(nz, "cpu"))),
                          np.asarray(JStark252.inv(JStark252.array(nz))))
    # batch_inverse along a batch with leading dims
    grid = np.array(vals[:32], dtype=object).reshape(4, 8)
    want = JStark252.batch_inverse(JStark252.array(grid))
    got = Stark252.batch_inverse(Stark252.array(grid, "cpu"))
    assert np.array_equal(limbs.to_jax_digits(got), np.asarray(want))


def test_batch_inverse_maps_zeros_to_zero():
    vals = _ints(5, 10, zeros=3)
    inv = Stark252.to_ints(Stark252.batch_inverse(Stark252.array(vals, "cpu")))
    for v, w in zip(vals, inv):
        assert int(w) == (0 if v == 0 else pow(v, -1, P))


def test_fermat_plain_equals_batch_inverse_plain():
    """Fermat (a^(p-2), ``pow``'s route) and Montgomery's trick (the route
    of ``batch_inverse``, on the card and on the CPU) must agree, zeros
    included."""
    a = Stark252.array(_ints(6, 10, zeros=2), "cpu")
    assert torch.equal(limbs.mont_pow_plain(a, P - 2), limbs.batch_inverse_plain(a))
