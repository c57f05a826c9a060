"""BN254 curves, MSM, pairing, KZG and the transcript in the PyTorch port,
held against the JAX package.

The JAX package is called directly where that takes seconds (host points,
host MSMs, host transcripts); its device MSMs (Pippenger and
double-and-add at 100 points) and pairing values come from
``fixtures/jax_bn254_curves.json`` (``fixtures/make_torch_plonk.py``).
The port's device routes run here on the CPU (the plain versions of the
field kernels).  Tolerance: exact equality.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from lambda_elliptic_curves_tpu.curves.zoo import BN254Curve as JaxCurve
from lambda_elliptic_curves_tpu.curves.msm import msm as jax_msm, optimum_window_size as jax_window
from lambda_elliptic_curves_tpu.fiat_shamir import DefaultTranscript as JaxTranscript
from lambda_elliptic_curves_tpu.fields import BN254Fr as JaxFr
from lambda_elliptic_curves_tpu_torch.commitments import (
    KateZaveruchaGoldberg, StructuredReferenceString,
)
from lambda_elliptic_curves_tpu_torch.curves import msm as M
from lambda_elliptic_curves_tpu_torch.curves.pairings import BN254Pairing, pairing
from lambda_elliptic_curves_tpu_torch.curves.twists import bn254_twist
from lambda_elliptic_curves_tpu_torch.curves.weierstrass import JacobianOps
from lambda_elliptic_curves_tpu_torch.curves.zoo import BN254Curve
from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
from lambda_elliptic_curves_tpu_torch.fields import BN254Fr
from lambda_elliptic_curves_tpu_torch.poly import Polynomial

torch.set_num_threads(1)

FIXTURE = json.loads((pathlib.Path(__file__).parent / "fixtures"
                      / "jax_bn254_curves.json").read_text())
R_ORDER = BN254Curve.order


def _scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_ORDER for _ in range(n)]


def _affine(pt):
    a = pt.to_affine()
    return None if a.z == 0 else (int(a.x), int(a.y))


def test_host_points_equal_jax_host_points():
    g, jg = BN254Curve.generator(), JaxCurve.generator()
    for k in _scalars(1, 4) + [0, 1, 2, R_ORDER - 1, R_ORDER]:
        p, jp = g.operate_with_self(k), jg.operate_with_self(k)
        assert _affine(p) == _affine(jp)
        assert _affine(p.double()) == _affine(jp.double())
        assert _affine(p.operate_with(g)) == _affine(jp.operate_with(jg))
        assert _affine(p.neg()) == _affine(jp.neg())
    assert g.operate_with(g.neg()).is_neutral_element()


def test_jacobian_ops_equal_jax_host_points():
    """Batched double, add and mixed add on the plain versions against the
    JAX package's host points, with the special cases (infinity on either
    side, P + P, P + (-P)) in the batch."""
    g, jg = BN254Curve.generator(), JaxCurve.generator()
    ops = JacobianOps(BN254Curve)
    ks = _scalars(2, 6)
    pk = ks + [None, 1, 1, 1]
    qk = ks[::-1] + [1, None, 1, -1]

    def points(curve_g, neutral, keys):
        return [neutral if k is None else curve_g.operate_with_self(k % R_ORDER)
                for k in keys]

    ps, qs = points(g, BN254Curve.neutral(), pk), points(g, BN254Curve.neutral(), qk)
    jps, jqs = points(jg, JaxCurve.neutral(), pk), points(jg, JaxCurve.neutral(), qk)
    P, Q = ops.from_host(ps, "cpu"), ops.from_host(qs, "cpu")
    affine = lambda pts: [_affine(p) for p in pts]  # noqa: E731
    assert affine(ops.to_host(ops.double(P))) == affine(p.double() for p in jps)
    want = affine(p.operate_with(q) for p, q in zip(jps, jqs))
    assert affine(ops.to_host(ops.add(P, Q))) == want
    assert affine(ops.to_host(ops.add_mixed(P, Q))) == want
    # a Jacobian (z != 1) left operand
    assert affine(ops.to_host(ops.add(ops.double(P), Q))) == \
        affine(p.double().operate_with(q) for p, q in zip(jps, jqs))
    total = jps[0]
    for p in jps[1:]:
        total = total.operate_with(p)
    assert affine(ops.to_host(ops.tree_reduce(P))) == [_affine(total)]


def test_segmented_scan_sums_each_run():
    g = BN254Curve.generator()
    ops = JacobianOps(BN254Curve)
    pts = [g.operate_with_self(k) for k in range(1, 12)]
    heads = [1, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0]
    out = ops.to_host(ops.segmented_scan(ops.from_host(pts, "cpu"),
                                         torch.tensor(heads, dtype=torch.bool)))
    want, acc = [], None
    for p, h in zip(pts, heads):
        acc = p if h else acc.operate_with(p)
        want.append(acc)
    assert out == want


def test_msm_host_route_equals_jax_msm():
    g, jg = BN254Curve.generator(), JaxCurve.generator()
    ks, sc = _scalars(3, 40), _scalars(4, 40)
    got = M.msm(BN254Curve, sc, [g.operate_with_self(k) for k in ks], device="cpu")
    want = jax_msm(JaxCurve, sc, [jg.operate_with_self(k) for k in ks])
    assert _affine(got) == _affine(want)


@pytest.fixture(scope="module")
def msm_case():
    data = FIXTURE["msm"]
    g = BN254Curve.generator()
    points = [g.operate_with_self(int(k, 16)) for k in data["point_scalars"]]
    return data, [int(s, 16) for s in data["scalars"]], points


def _json_point(v):
    return None if v is None else (int(v[0], 16), int(v[1], 16))


@pytest.mark.parametrize("method", ["pippenger", "naive"])
def test_msm_device_routes_equal_jax_device_msm(msm_case, method):
    """The device routes over the plain versions, at 100 points (above the
    host threshold), against the JAX device MSM of the same route.  The
    Pippenger window is 5 bits here (on the CPU the default 9 is slow); the
    result does not depend on it."""
    data, scalars, points = msm_case
    assert len(points) > M.HOST_MSM_MAX
    got = M.msm(BN254Curve, scalars, points, window_size=5 if method == "pippenger" else None,
                method=method, device="cpu")
    assert _affine(got) == _json_point(data[method])


def _skewed_scalars(case, n, order, c, seed):
    """Scalars whose window ids pile up: all equal; mostly 0 and 1 (a
    circom-style witness); all below 2^c (every id of the other windows 0)."""
    rng = np.random.default_rng(seed)
    rand = lambda: int.from_bytes(rng.bytes(32), "little") % order  # noqa: E731
    if case == "all_equal":
        return [rand()] * n
    if case == "mostly_0_and_1":
        return [0 if u < 0.45 else 1 if u < 0.9 else rand() for u in rng.random(n)]
    return [int(v) for v in rng.integers(0, 1 << c, n)]


@pytest.mark.parametrize("case, log_n", [("all_equal", 6), ("mostly_0_and_1", 7),
                                         ("below_2^c", 6)])
def test_pippenger_skewed_scalars_equal_host_msm(case, log_n):
    """The chunked bucket phase (kernel 11's plain version) where the ids
    are skewed, on the device route (2^6-2^7 points, 3-bit windows: the
    plain version's time is its levels' steps), against msm_naive_host."""
    n = 1 << log_n
    g = BN254Curve.generator()
    points = [g.operate_with_self(k) for k in _scalars(11, n)]
    scalars = _skewed_scalars(case, n, R_ORDER, 3, 12)
    ops = JacobianOps(BN254Curve)
    digits = M.scalars_to_digits(BN254Curve, scalars, "cpu")
    got = M.msm_pippenger(BN254Curve, digits, ops.from_host(points, "cpu"), window_size=3,
                          ops=ops)
    assert got == M.msm_naive_host(scalars, points)


def test_msm_windows_and_digits():
    sc = _scalars(5, 10) + [0, R_ORDER - 1]
    d = M.scalars_to_digits(BN254Curve, sc, "cpu")
    for c in (1, 5, 13, 15):
        ids = M.window_ids(d, c, -(-254 // c))
        assert [sum(int(ids[w, i]) << (c * w) for w in range(ids.shape[0]))
                for i in range(len(sc))] == sc
    assert M.optimum_window_size(1 << 16) == jax_window(1 << 16)


def _fp12(value):
    if isinstance(value, tuple):
        return [_fp12(v) for v in value]
    return hex(int(value))


def test_pairing_equals_jax_and_is_bilinear():
    cfg = BN254Pairing
    g1, g2 = cfg.g1_curve.generator(), cfg.g2_generator()
    base = pairing(cfg, g1, g2)
    first, second = FIXTURE["pairings"]
    assert _fp12(base.value) == first["value"]
    a, b = int(second["a"], 16), int(second["b"], 16)
    e_ab = pairing(cfg, g1.operate_with_self(a), g2.mul(b))
    assert _fp12(e_ab.value) == second["value"]
    assert e_ab == base ** (a * b % cfg.r)
    assert base != cfg.fp12(1)
    assert bn254_twist().defining_equation(g2.x, g2.y)


def test_srs_bytes_both_ways():
    """The port reads the JAX package's SRS bytes and writes the same
    bytes; its ``insecure_setup`` (the batched double-and-add, here on the
    plain versions) gives the JAX package's points."""
    raw = bytes.fromhex(FIXTURE["srs_8_tau_941"])
    srs = StructuredReferenceString.deserialize(BN254Pairing, raw)
    assert srs.serialize() == raw
    assert StructuredReferenceString.insecure_setup(
        BN254Pairing, 8, tau=941, device="cpu").serialize() == raw


def test_kzg_commit_open_verify():
    srs = StructuredReferenceString.deserialize(
        BN254Pairing, bytes.fromhex(FIXTURE["srs_8_tau_941"]))
    kzg = KateZaveruchaGoldberg(BN254Pairing, srs, msm_method="naive", device="cpu")
    fr = BN254Fr
    p = Polynomial(fr, [1, 2, 3, 4])
    x = fr(5)
    y = p.evaluate(x)
    c = kzg.commit(p)
    proof = kzg.open(x, y, p)
    assert kzg.verify(x, y, c, proof)
    assert not kzg.verify(x, y + fr(1), c, proof)
    p2 = Polynomial(fr, [7, 0, 5, 2])
    ys = [p.evaluate(x), p2.evaluate(x)]
    batch = kzg.open_batch(x, ys, [p, p2], fr(99))
    assert kzg.verify_batch(x, ys, [c, kzg.commit(p2)], batch, fr(99))
    assert not kzg.verify_batch(x, [ys[0], ys[1] + fr(1)], [c, kzg.commit(p2)], batch, fr(99))


def test_device_entry_points_default_to_the_card():
    """No fallback: without a card, an entry point left at its default
    device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        StructuredReferenceString.insecure_setup(BN254Pairing, 8, tau=941)
    g = BN254Curve.generator()
    pts = [g.operate_with_self(k) for k in range(1, M.HOST_MSM_MAX + 2)]
    with pytest.raises((RuntimeError, AssertionError)):
        M.msm(BN254Curve, list(range(len(pts))), pts)


def test_transcript_samples_and_appends_bn254_fr_as_jax():
    port, ref = DefaultTranscript(BN254Fr), JaxTranscript(JaxFr)
    for v in _scalars(6, 3) + [0, BN254Fr.p - 1]:
        port.append_field_element(BN254Fr(v))
        ref.append_field_element(JaxFr(v))
        port.append_bytes(b"\x01\x02")
        ref.append_bytes(b"\x01\x02")
        assert int(port.sample_field_element()) == int(ref.sample_field_element())
