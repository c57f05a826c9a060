"""G2: the sextic twists E'(Fp2) of BN254 and BLS12-377, on the host and as
batched limb tensors.

Counterpart of ``lambda_elliptic_curves_tpu/curves/twists.py``
(``TwistCurve`` :30, ``TwistJacobianOps`` :60, ``bn254_twist`` :141,
``bls12_377_twist`` :155, ``msm_g2_naive_host`` :168; parity the
reference's ``ShortWeierstrassProjectivePoint`` over the degree-2 extension
and the Pippenger MSM generic over ``IsGroup``, ``msm/pippenger.rs:19``).

A batch of G2 points is a triple of ``(2 L, *batch)`` Fp2 tensors (the
:class:`..fields.extensions.DeviceQuadraticField` layout: component 0's L
limbs, then component 1's), so :class:`.weierstrass.JacobianOps`'s group
law, the MSM's bucket machinery and the batched scalar multiplications
run unchanged over it.  On a card a G2 group op is one launch of kernel 10
and the bucket phase runs on kernel 11 (their G2 instances: the Fp2
product in registers, ``csrc/curve.cuh``); an Fp2 op outside them composes
base-field ops, launches of kernel 8 (an Fp2 product 7, a sum 2).
"""

from __future__ import annotations

import dataclasses
import functools

from ..fields import zoo as FZ
from ..fields.extensions import DeviceQuadraticField, ExtensionField
from .pairings import AffinePoint, BLS12377Pairing, BN254Pairing
from .weierstrass import JacobianOps


@dataclasses.dataclass(frozen=True, eq=False)
class TwistCurve:
    """y^2 = x^3 + a x + b over Fp2; G2 = the order-r subgroup."""

    name: str
    field: DeviceQuadraticField
    host_field: ExtensionField
    a: tuple
    b: tuple
    gx: tuple
    gy: tuple
    order: int
    #: the group's number in kernels 10 and 11 (``csrc/curve.cuh``
    #: ``LW_CURVE_*``): BN254 G2 1, BLS12-377 G2 3; -1 for none
    kernel_group: int = -1

    @property
    def jacobian_ops_class(self):
        """The batched group law of this curve (:func:`..curves.msm.msm`
        picks it)."""
        return TwistJacobianOps

    def generator(self) -> AffinePoint:
        return AffinePoint(self.host_field, self.host_field(self.gx),
                           self.host_field(self.gy))

    def neutral(self) -> AffinePoint:
        return AffinePoint.infinity(self.host_field)

    def defining_equation(self, x, y) -> bool:
        f = self.host_field
        xe, ye = f(x), f(y)
        return ye * ye == xe * xe * xe + f(self.a) * xe + f(self.b)


class TwistJacobianOps(JacobianOps):
    """Batched Jacobian group law over Fp2 tensors: every formula of
    :class:`JacobianOps` (on the card kernel 10's and 11's G2 instances,
    the twist's ``kernel_group``); only the host conversions and the curve
    coefficient differ."""

    def __init__(self, twist: TwistCurve, plain: bool = False):
        self.curve = twist
        self.f = twist.field.plain() if plain else twist.field
        self.a_is_zero = not any(int(c) for c in twist.a)
        self._plain = plain

    def from_host(self, points, device):
        """Host AffinePoints over Fp2 -> (x, y, z) tensors (affine with z = 1,
        or x = y = 1, z = 0 for infinity)."""
        xs, ys, zs = [], [], []
        for pt in points:
            if pt.inf:
                xs.append(1)
                ys.append(1)
                zs.append(0)
            else:
                xs.append(pt.x.value)
                ys.append(pt.y.value)
                zs.append(1)
        f = self.f
        return f.array(xs, device), f.array(ys, device), f.array(zs, device)

    def to_host(self, pt):
        """(x, y, z) tensors -> host AffinePoints: the affine coordinates on
        the device (one batch inversion), then one transfer."""
        x, y, finite = self.to_affine(pt)
        f, host = self.f, self.curve.host_field
        xs, ys = f.to_tuples(x.reshape(x.shape[0], -1)), f.to_tuples(y.reshape(y.shape[0], -1))
        fin = finite.reshape(-1).cpu().tolist()
        return [AffinePoint(host, host(a), host(b)) if ok else self.curve.neutral()
                for a, b, ok in zip(xs, ys, fin)]


    def to_host_exact(self, pt):
        """(x, y, z) tensors of a few points -> host AffinePoints, the division
        by z in the host's Fp2: one transfer and no device work."""
        host = self.curve.host_field
        out = []
        for x, y, z in zip(*(self._canonical(c.reshape(c.shape[0], -1)) for c in pt)):
            zh = host(z)
            if zh.is_zero():
                out.append(self.curve.neutral())
                continue
            zi = zh.inv()
            zi2 = zi * zi
            out.append(AffinePoint(host, host(x) * zi2, host(y) * zi2 * zi))
        return out


# ---------------------------------------------------------------------------
# concrete twists (generators shared with the pairing configurations)
# ---------------------------------------------------------------------------

@functools.cache
def bn254_twist() -> TwistCurve:
    cfg = BN254Pairing
    return TwistCurve(
        name="bn254_twist",
        field=DeviceQuadraticField(FZ.BN254Field, FZ.BN254Field.p - 1, name="bn254_fp2"),
        host_field=cfg.fp2,
        a=(0, 0), b=cfg.twist_b,
        gx=cfg.g2_x, gy=cfg.g2_y,
        order=FZ.BN254_ORDER,
        kernel_group=1,
    )


@functools.cache
def bls12_377_twist() -> TwistCurve:
    cfg = BLS12377Pairing
    return TwistCurve(
        name="bls12_377_twist",
        field=DeviceQuadraticField(FZ.BLS12377Field, FZ.BLS12377Field.p - 5,
                                   name="bls12_377_fp2"),
        host_field=cfg.fp2,
        a=(0, 0), b=cfg.twist_b,
        gx=cfg.g2_x, gy=cfg.g2_y,
        order=FZ.BLS12_377_ORDER,
        kernel_group=3,
    )


def msm_g2_naive_host(scalars, points):
    """Exact host G2 MSM (affine double-and-add over Fp2): the oracle."""
    if not points:
        raise ValueError("empty MSM")
    acc = AffinePoint.infinity(points[0].field)
    for s, pt in zip(scalars, points):
        acc = acc + pt.mul(int(s))
    return acc
