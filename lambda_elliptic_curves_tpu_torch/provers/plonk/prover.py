"""Plonk prover (parity: ``provers/plonk/src/prover.rs`` -- the five rounds
documented at :20-24 and implemented at :311-630).

Counterpart of ``lambda_elliptic_curves_tpu/provers/plonk/prover.py``, on
the commitment scheme's device: the transforms of rounds 1-3 run the NTT
(on the card kernel 1 over BN254 Fr), round 3's quotient stays on the
device as limb tensors (one launch of kernel 8's program entry for its
arithmetic, :func:`quotient_evaluations`, and one of kernel 9 for its
batch inversion), and the commitments are the KZG's MSMs (kernel 8 over
BN254 Fq, kernel 9 for the affine points).  The host loops of rounds 2, 4
and 5 stay host loops, as in the JAX package.  ``Prover.round_seconds``
holds the host-clock seconds of each round of the last proof.
"""

from __future__ import annotations

import dataclasses
import time

from ...poly import ntt
from ...poly.polynomial import Polynomial
from .setup import (
    CommonPreprocessedInput, VerificationKey, Witness, interpolate,
    new_strong_fiat_shamir_transcript, point_to_bytes,
)


class TestRandomFieldGenerator:
    """Deterministic zero-randomness generator (parity with the reference
    test double)."""

    __test__ = False  # a test double of the prover, not a pytest class

    def __init__(self, field):
        self.field = field

    def __call__(self):
        return self.field(0)


class RandomFieldGenerator:
    def __init__(self, field, rng=None):
        import random

        self.field = field
        self.rng = rng or random.SystemRandom()

    def __call__(self):
        return self.field(self.rng.randrange(self.field.p))


@dataclasses.dataclass
class Proof:
    a_1: object
    b_1: object
    c_1: object
    z_1: object
    t_lo_1: object
    t_mid_1: object
    t_hi_1: object
    a_zeta: object
    b_zeta: object
    c_zeta: object
    s1_zeta: object
    s2_zeta: object
    z_zeta_omega: object
    w_zeta_1: object
    w_zeta_omega_1: object
    p_non_constant_zeta: object
    t_zeta: object


class Prover:
    def __init__(self, commitment_scheme, random_generator):
        self.cs = commitment_scheme
        self.rand = random_generator
        self.device = commitment_scheme.device
        self.round_seconds = {}

    # ------------------------------------------------------------------
    def _blind(self, target: Polynomial, zh: Polynomial, n_blinders: int):
        bs = [self.rand() for _ in range(n_blinders)]
        return target + zh * Polynomial(target.field, bs)

    def _zh(self, field, n):
        return Polynomial.new_monomial(field(1), n) - Polynomial(field, [1])

    # ------------------------------------------------------------------
    def prove(self, witness: Witness, public_input,
              cpi: CommonPreprocessedInput, vk: VerificationKey) -> Proof:
        f = cpi.field
        dev = self.device
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            self.round_seconds[name] = now - clock[0]
            clock[0] = now

        _interp = lambda field, values: interpolate(field, values, dev)  # noqa: E731
        transcript = new_strong_fiat_shamir_transcript(f, vk, public_input)
        n = cpi.n
        zh = self._zh(f, n)

        # ----- round 1: blinded wire polynomials -----
        p_a = self._blind(_interp(f, witness.a), zh, 2)
        p_b = self._blind(_interp(f, witness.b), zh, 2)
        p_c = self._blind(_interp(f, witness.c), zh, 2)
        a_1, b_1, c_1 = (self.cs.commit(p) for p in (p_a, p_b, p_c))
        for cm in (a_1, b_1, c_1):
            transcript.append_bytes(point_to_bytes(cm))
        lap("round1")

        # ----- round 2: permutation polynomial z -----
        beta = transcript.sample_field_element()
        gamma = transcript.sample_field_element()
        k1, k2 = cpi.k1, cpi.k1 * cpi.k1
        coeffs = [f(1)]
        lp = lambda w, eta: w + beta * eta + gamma  # noqa: E731
        for i in range(n - 1):
            a_i, b_i, c_i = witness.a[i], witness.b[i], witness.c[i]
            num = lp(a_i, cpi.domain[i]) * lp(b_i, cpi.domain[i] * k1) \
                * lp(c_i, cpi.domain[i] * k2)
            den = lp(a_i, cpi.s1_lagrange[i]) * lp(b_i, cpi.s2_lagrange[i]) \
                * lp(c_i, cpi.s3_lagrange[i])
            coeffs.append(coeffs[-1] * num / den)
        p_z = self._blind(_interp(f, coeffs), zh, 3)
        z_1 = self.cs.commit(p_z)
        transcript.append_bytes(point_to_bytes(z_1))
        lap("round2")

        # ----- round 3: quotient t = (gates + copy) / Z_H -----
        alpha = transcript.sample_field_element()
        degree = 4 * n
        offset = cpi.k1

        z_x_omega = Polynomial(f, [
            c * cpi.domain[i % n] for i, c in enumerate(p_z.coefficients)
        ])
        e1 = [f(1)] + [f(0)] * (n - 1)
        l1 = _interp(f, e1)
        pi_y = list(public_input) + [f(0)] * (n - len(public_input))
        p_pi = _interp(f, pi_y)

        # the quotient on the device: all 4n-coset evaluations stay there as
        # (8, 4n) limb tensors, in place of a host loop (prover.rs round_3
        # under rayon)
        ev = lambda poly: _eval_offset_dev(f, poly, degree, offset, dev)  # noqa: E731
        a_e, b_e, c_e = ev(p_a), ev(p_b), ev(p_c)
        ql_e, qr_e, qm_e = ev(cpi.ql), ev(cpi.qr), ev(cpi.qm)
        qo_e, qc_e, pi_e = ev(cpi.qo), ev(cpi.qc), ev(p_pi)
        x_e = ev(Polynomial.new_monomial(f(1), 1))
        z_e, zw_e = ev(p_z), ev(z_x_omega)
        s1_e, s2_e, s3_e = ev(cpi.s1), ev(cpi.s2), ev(cpi.s3)
        l1_e = ev(l1)
        zh_e = ev(zh)

        # then one program of field ops over them, the inverse of Z_H and
        # the constants: on the card one launch of kernel 8's program entry
        zh_inv_e = f.batch_inverse(zh_e)
        ch = f.ops.chain()
        e = {k: ch.input(v) for k, v in (
            ("a", a_e), ("b", b_e), ("c", c_e), ("ql", ql_e), ("qr", qr_e), ("qm", qm_e),
            ("qo", qo_e), ("qc", qc_e), ("pi", pi_e), ("x", x_e), ("z", z_e), ("zw", zw_e),
            ("s1", s1_e), ("s2", s2_e), ("s3", s3_e), ("l1", l1_e), ("zh_inv", zh_inv_e))}
        cst = {k: ch.input(f.constant(int(v), (1,), dev)) for k, v in (
            ("beta", beta), ("gamma", gamma), ("k1", k1), ("k2", k2), ("alpha", alpha),
            ("one", 1))}
        p_eval = ch.run(quotient_evaluations(ch, e, cst))
        t_coeffs = ntt.interpolate_offset_fft(f, p_eval, int(offset))
        t = Polynomial(f, [int(v) for v in f.to_ints(t_coeffs)])

        tc = t.coefficients + [f(0)] * (3 * (n + 2) - len(t.coefficients))
        p_t_lo = Polynomial(f, tc[: n + 2])
        p_t_mid = Polynomial(f, tc[n + 2: 2 * (n + 2)])
        p_t_hi = Polynomial(f, tc[2 * (n + 2): 3 * (n + 2)])
        b0, b1 = self.rand(), self.rand()
        xn2 = Polynomial.new_monomial(f(1), n + 2)
        p_t_lo = p_t_lo + b0 * xn2
        p_t_mid = p_t_mid - b0 + b1 * xn2
        p_t_hi = p_t_hi - b1
        t_lo_1, t_mid_1, t_hi_1 = (self.cs.commit(p)
                                   for p in (p_t_lo, p_t_mid, p_t_hi))
        for cm in (t_lo_1, t_mid_1, t_hi_1):
            transcript.append_bytes(point_to_bytes(cm))
        lap("round3")

        # ----- round 4: evaluations at zeta -----
        zeta = transcript.sample_field_element()
        a_zeta = p_a.evaluate(zeta)
        b_zeta = p_b.evaluate(zeta)
        c_zeta = p_c.evaluate(zeta)
        s1_zeta = cpi.s1.evaluate(zeta)
        s2_zeta = cpi.s2.evaluate(zeta)
        z_zeta_omega = p_z.evaluate(zeta * cpi.omega)
        for v in (a_zeta, b_zeta, c_zeta, s1_zeta, s2_zeta, z_zeta_omega):
            transcript.append_field_element(v)
        lap("round4")

        # ----- round 5: openings -----
        upsilon = transcript.sample_field_element()
        zeta_n2 = zeta ** (n + 2)
        zeta_2n4 = zeta ** (2 * n + 4)
        l1_zeta = (zeta**n - f(1)) / (zeta - f(1)) / f(n)

        p_non_constant = cpi.qm * (a_zeta * b_zeta) + cpi.ql * a_zeta \
            + cpi.qr * b_zeta + cpi.qo * c_zeta + cpi.qc
        r21 = (a_zeta + beta * zeta + gamma) \
            * (b_zeta + beta * k1 * zeta + gamma) \
            * (c_zeta + beta * k2 * zeta + gamma)
        r22 = (a_zeta + beta * s1_zeta + gamma) \
            * (b_zeta + beta * s2_zeta + gamma) * beta * z_zeta_omega
        p_non_constant = p_non_constant \
            + (cpi.s3 * r22 - p_z * r21) * alpha \
            + p_z * (l1_zeta * alpha * alpha)

        partial_t = p_t_lo + p_t_mid * zeta_n2 + p_t_hi * zeta_2n4

        polynomials = [partial_t, p_non_constant, p_a, p_b, p_c,
                       cpi.s1, cpi.s2]
        ys = [p.evaluate(zeta) for p in polynomials]
        w_zeta_1 = self.cs.open_batch(zeta, ys, polynomials, upsilon)
        w_zeta_omega_1 = self.cs.open(zeta * cpi.omega, z_zeta_omega, p_z)
        lap("round5")

        return Proof(
            a_1=a_1, b_1=b_1, c_1=c_1, z_1=z_1,
            t_lo_1=t_lo_1, t_mid_1=t_mid_1, t_hi_1=t_hi_1,
            a_zeta=a_zeta, b_zeta=b_zeta, c_zeta=c_zeta,
            s1_zeta=s1_zeta, s2_zeta=s2_zeta, z_zeta_omega=z_zeta_omega,
            w_zeta_1=w_zeta_1, w_zeta_omega_1=w_zeta_omega_1,
            p_non_constant_zeta=ys[1], t_zeta=ys[0],
        )


def quotient_evaluations(F, e: dict, c: dict):
    """Round 3's quotient t = (gates + alpha copy_1 + alpha^2 copy_2) / Z_H
    at each point of the coset, written against ``F``'s ``add``, ``sub``
    and ``mul``: a field on evaluation tensors, or a :class:`..ops.dense.
    Chain`, which records the ops as one program.  ``e``: the coset
    evaluations ``a``, ``b``, ``c``, ``ql``, ``qr``, ``qm``, ``qo``, ``qc``,
    ``pi``, ``x``, ``z``, ``zw`` (z(x omega)), ``s1``, ``s2``, ``s3``, ``l1``
    and ``zh_inv`` (1 / Z_H); ``c``: ``beta``, ``gamma``, ``k1``, ``k2``,
    ``alpha`` and ``one`` (``prover.rs`` round_3)."""
    add3 = lambda u, v, w: F.add(F.add(u, v), w)  # noqa: E731
    a, b, cc = e["a"], e["b"], e["c"]
    gates = add3(
        F.add(F.mul(F.mul(a, b), e["qm"]), F.mul(a, e["ql"])),
        F.add(F.mul(b, e["qr"]), F.mul(cc, e["qo"])),
        F.add(e["qc"], e["pi"]),
    )
    beta, gamma = c["beta"], c["gamma"]
    xb = F.mul(e["x"], beta)
    f_i = F.mul(
        F.mul(add3(a, xb, gamma), add3(b, F.mul(xb, c["k1"]), gamma)),
        add3(cc, F.mul(xb, c["k2"]), gamma),
    )
    g_i = F.mul(
        F.mul(add3(a, F.mul(e["s1"], beta), gamma), add3(b, F.mul(e["s2"], beta), gamma)),
        add3(cc, F.mul(e["s3"], beta), gamma),
    )
    perm1 = F.sub(F.mul(g_i, e["zw"]), F.mul(f_i, e["z"]))
    perm2 = F.mul(F.sub(e["z"], c["one"]), e["l1"])
    numerator = F.add(F.mul(F.add(F.mul(perm2, c["alpha"]), perm1), c["alpha"]), gates)
    return F.mul(numerator, e["zh_inv"])


def _eval_offset_dev(field, poly: Polynomial, degree: int, offset, device):
    """(8, degree) evaluations of ``poly`` on the offset coset, on ``device``."""
    arr = poly.to_device(degree, device=device) if poly.coeff_len() \
        else field.zeros((degree,), device)
    return ntt.evaluate_offset_fft(field, arr, 1, degree, int(offset))


# -- proofs as affine coordinates and ints --------------------------------------

#: the fields of :class:`Proof` that are G1 points (the rest are Fr values)
POINT_FIELDS = ("a_1", "b_1", "c_1", "z_1", "t_lo_1", "t_mid_1", "t_hi_1",
                "w_zeta_1", "w_zeta_omega_1")


def point_to_json(pt):
    """A G1 point (of either package) as [hex x, hex y], or None at infinity."""
    aff = pt.to_affine()
    return None if aff.z == 0 else [hex(int(aff.x)), hex(int(aff.y))]


def point_from_json(curve, value):
    if value is None:
        return curve.neutral()
    return curve.point(int(value[0], 16), int(value[1], 16))


def proof_to_json(proof) -> dict:
    """A Plonk proof of either package as affine coordinates and ints
    (hex strings): what carries a proof between the two packages."""
    return {name: point_to_json(getattr(proof, name)) if name in POINT_FIELDS
            else hex(int(getattr(proof, name)))
            for name in (fld.name for fld in dataclasses.fields(Proof))}


def proof_from_json(data: dict, curve, field) -> Proof:
    """Inverse of :func:`proof_to_json`, into the port's :class:`Proof`."""
    return Proof(**{name: point_from_json(curve, value) if name in POINT_FIELDS
                    else field(int(value, 16)) for name, value in data.items()})
