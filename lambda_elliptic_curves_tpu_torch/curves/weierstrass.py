"""Short Weierstrass curves: host points and the batched Jacobian group
law on limb tensors.

Counterpart of ``lambda_elliptic_curves_tpu/curves/weierstrass.py``
(``WeierstrassCurve`` :28, ``ProjectivePoint`` :59, ``JacobianOps`` :168;
parity ``short_weierstrass/point.rs``).  The host path is the JAX
package's exact projective arithmetic over Python ints.  On a device a
batch of points is a triple of ``(L, *batch)`` limb tensors ``(x, y, z)``
in Jacobian coordinates (infinity: z = 0).

:class:`JacobianOps`'s ``add``, ``add_mixed`` and ``double`` dispatch on the
device of the points: on a CUDA tensor one launch of kernel 10
(``csrc/curve.cu``, the whole formula in registers, the group the curve's
``kernel_group``), and a group without an instance raises; on a CPU tensor
the plain version, ``add_plain`` / ``add_mixed_plain`` / ``double_plain``:
straight-line field arithmetic with selects for the special cases, generic
over the field object ``f``, G1's :class:`..fields.field.PrimeField` or
G2's :class:`..fields.extensions.DeviceQuadraticField`
(:class:`.twists.TwistJacobianOps`).  :meth:`JacobianOps.plain` gives the
plain group law on any device, which the kernels are held against on the
card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from .. import native
from ..fields.field import PrimeField
from ..utils.errors import CreationError

#: kernel 10's ops (``csrc/curve.cuh`` ``LW_CURVE_ADD`` .. ``LW_CURVE_DOUBLE``)
_ADD, _ADD_MIXED, _DOUBLE = range(3)


@dataclasses.dataclass(frozen=True)
class WeierstrassCurve:
    """y^2 = x^3 + a x + b over ``field``; also carries subgroup data."""

    name: str
    field: PrimeField
    a: int
    b: int
    gx: int
    gy: int
    order: int = 0  # subgroup order (0 if unused)
    cofactor: int = 1
    #: the group's number in kernels 10 and 11 (``csrc/curve.cuh``
    #: ``LW_CURVE_*``): BN254 G1 0, BLS12-377 G1 2; -1 for none
    kernel_group: int = -1

    def generator(self) -> "ProjectivePoint":
        return ProjectivePoint(self, self.gx, self.gy, 1)

    def neutral(self) -> "ProjectivePoint":
        return ProjectivePoint(self, 0, 1, 0)

    def defining_equation(self, x: int, y: int) -> int:
        p = self.field.p
        return (y * y - (x * x * x + self.a * x + self.b)) % p

    def point(self, x, y) -> "ProjectivePoint":
        pt = ProjectivePoint(self, int(x), int(y), 1)
        if self.defining_equation(int(x), int(y)) != 0:
            raise CreationError(f"({x}, {y}) is not on {self.name}")
        return pt


class ProjectivePoint:
    """Host point in homogeneous projective coordinates (exact ints)."""

    __slots__ = ("curve", "x", "y", "z")

    def __init__(self, curve, x, y, z):
        self.curve = curve
        p = curve.field.p
        self.x, self.y, self.z = x % p, y % p, z % p

    def is_neutral_element(self) -> bool:
        return self.z == 0

    def to_affine(self):
        if self.z == 0:
            return self
        p = self.curve.field.p
        zinv = pow(self.z, -1, p)
        return ProjectivePoint(self.curve, self.x * zinv % p,
                               self.y * zinv % p, 1)

    def __eq__(self, other):
        p = self.curve.field.p
        return (
            self.x * other.z % p == other.x * self.z % p
            and self.y * other.z % p == other.y * self.z % p
            and (self.z == 0) == (other.z == 0)
        )

    def __repr__(self):
        a = self.to_affine()
        if a.z == 0:
            return "Point(infinity)"
        return f"Point({hex(a.x)}, {hex(a.y)})"

    def double(self):
        """Projective doubling (``short_weierstrass/point.rs:54``)."""
        p = self.curve.field.p
        if self.z == 0 or self.y == 0:
            return self.curve.neutral() if self.y == 0 else self
        X, Y, Z = self.x, self.y, self.z
        a = self.curve.a
        W = (a * Z * Z + 3 * X * X) % p
        S = Y * Z % p
        B = X * Y % p * S % p
        H = (W * W - 8 * B) % p
        X3 = 2 * H * S % p
        Y3 = (W * (4 * B - H) - 8 * Y * Y % p * S % p * S % p) % p
        Z3 = 8 * S * S % p * S % p
        return ProjectivePoint(self.curve, X3, Y3, Z3)

    def operate_with(self, other):
        """Group addition (``short_weierstrass/point.rs:91``)."""
        if self.z == 0:
            return other
        if other.z == 0:
            return self
        p = self.curve.field.p
        u1 = other.y * self.z % p
        u2 = self.y * other.z % p
        v1 = other.x * self.z % p
        v2 = self.x * other.z % p
        if v1 == v2:
            if u1 == u2:
                return self.double()
            return self.curve.neutral()
        u = (u1 - u2) % p
        v = (v1 - v2) % p
        w = self.z * other.z % p
        A = (u * u % p * w - v * v % p * v - 2 * v * v % p * v2) % p
        X3 = v * A % p
        Y3 = (u * (v * v % p * v2 - A) - v * v % p * v % p * u2) % p
        Z3 = v * v % p * v % p * w % p
        return ProjectivePoint(self.curve, X3, Y3, Z3)

    def __add__(self, other):
        return self.operate_with(other)

    def neg(self):
        return ProjectivePoint(self.curve, self.x, -self.y, self.z)

    def __neg__(self):
        return self.neg()

    def operate_with_self(self, times: int):
        """Double-and-add (``cyclic_group.rs:17``)."""
        result = self.curve.neutral()
        acc = self
        t = int(times)
        while t:
            if t & 1:
                result = result.operate_with(acc)
            acc = acc.double()
            t >>= 1
        return result

    def __mul__(self, times: int):
        return self.operate_with_self(times)

    __rmul__ = __mul__


class JacobianOps:
    """Batched Jacobian group law over limb tensors for one curve: kernel 10
    on the card; the plain version generic over the field object ``f`` (its
    ``add``, ``sub``, ``mul``, ``square``, ``batch_inverse``, ``is_zero``,
    ``select``, ``ones``, ``zeros``, ``array``, ``constant``).  With
    ``plain`` every op is the plain version over the field's plain ops, on
    any device."""

    def __init__(self, curve: WeierstrassCurve, plain: bool = False):
        self.curve = curve
        self.f = curve.field.plain() if plain else curve.field
        self.a_is_zero = curve.a % self.f.p == 0  # the doubling leaves out a z^4
        self._plain = plain

    def plain(self) -> "JacobianOps":
        """This group law with every op its plain version, on any device: the
        CPU route, which kernels 10 and 11 are held against on the card."""
        return type(self)(self.curve, plain=True)

    # -- kernels 10 and 11 ------------------------------------------------------
    def kernel_group(self, *pts):
        """The group's number in kernels 10 and 11 for points on a card, or
        None for the plain route (CPU tensors, or a plain group law); raises
        on a card for a group with no instance."""
        if self._plain or all(c.device.type == "cpu" for pt in pts for c in pt):
            return None
        group = getattr(self.curve, "kernel_group", -1)
        if group < 0 or not self.a_is_zero:
            raise NotImplementedError(f"{self.curve.name}: kernels 10 and 11 have no instance "
                                      "of this group")
        return group

    def counter(self, kernel: str) -> str:
        """The launch counter of ``kernel`` ("curve_op", "msm_bucket") for
        this curve: the BLS12-377 instances count apart."""
        return kernel + getattr(self.f, "prime", self.f).ops.counter_suffix

    def points_arg(self, pt, batch: tuple, n: int, device_type: str = "cuda"):
        """(9 longs: kernel 10 / 11's ``LwPoints``, the tensors they point
        into) for the points ``pt`` over the batch shape ``batch``: one
        point broadcast over it with element stride 0, a ``(rows, n)``
        plane set by its strides, anything else as a contiguous copy.  The
        host tests build the same arguments for CPU tensors."""
        rows = self.f.num_limbs
        ptrs, row_strides, elem_strides, keep = [], [], [], []
        for x in pt:
            if x.dtype != torch.int32 or x.device.type != device_type or x.shape[0] != rows:
                raise TypeError(f"kernels 10 and 11 take ({rows}, *batch) int32 "
                                f"{device_type} tensors")
            if n > 1 and all(s == 0 or d == 1 for s, d in zip(x.stride()[1:], x.shape[1:])):
                es = 0
            elif x.dim() == 2 and tuple(x.shape[1:]) == batch:
                es = x.stride(1)
            else:
                x = x.expand((rows,) + batch).contiguous()
                es = 1
            ptrs.append(x.data_ptr())
            row_strides.append(x.stride(0))
            elem_strides.append(es)
            keep.append(x)
        return ptrs + row_strides + elem_strides, keep

    def _op_cuda(self, group: int, op: int, p1, p2=None):
        """One launch of kernel 10: ``op`` over the broadcast batch of the
        points; three contiguous ``(L, *batch)`` tensors."""
        shape = torch.broadcast_shapes(*(c.shape for pt in (p1, p2 or p1) for c in pt))
        batch = tuple(shape[1:])
        n = math.prod(batch)
        out = tuple(torch.empty((self.f.num_limbs,) + batch, dtype=torch.int32,
                                device=p1[0].device) for _ in range(3))
        if n == 0:
            return out
        a, keep_a = self.points_arg(p1, batch, n)
        b, keep_b = self.points_arg(p2 or p1, batch, n)
        native.launch(self.counter("curve_op"), "lw_curve_op", group, op,
                      (ctypes.c_long * 18)(*(a + b)), *(o.data_ptr() for o in out), n)
        return out

    def _mul_a(self, v):
        """The curve's a times ``v``."""
        return self.f.mul(self.f.constant(self.curve.a, (1,) * (v.dim() - 1), v.device), v)

    # -- conversions --------------------------------------------------------
    def from_host(self, points, device):
        """List of host points -> (x, y, z) limb tensors (affine with z = 1,
        or z = 0 for infinity)."""
        xs, ys, zs = [], [], []
        for pt in points:
            aff = pt.to_affine()
            if aff.z == 0:
                xs.append(1)
                ys.append(1)
                zs.append(0)
            else:
                xs.append(aff.x)
                ys.append(aff.y)
                zs.append(1)
        f = self.f
        return f.array(xs, device), f.array(ys, device), f.array(zs, device)

    def to_affine(self, pt):
        """(x, y, z) -> (x / z^2, y / z^3, z != 0) on the device: one batch
        inversion of z (kernel 9 on the card; zeros stay zero)."""
        f = self.f
        X, Y, Z = pt
        zinv = f.batch_inverse(Z)
        zinv2 = f.square(zinv)
        return f.mul(X, zinv2), f.mul(Y, f.mul(zinv2, zinv)), ~f.is_zero(Z)

    def affine_points(self, pt):
        """(x, y, z) -> the same points as :meth:`from_host` lays them out
        (affine, z = 1; infinity x = y = 1, z = 0), on the device: one batch
        inversion."""
        f = self.f
        x, y, finite = self.to_affine(pt)
        one = f.ones(x.shape[1:], x.device)
        return (f.select(finite, x, one), f.select(finite, y, one),
                f.select(finite, one, f.zeros(x.shape[1:], x.device)))

    def to_host(self, pt):
        """(x, y, z) limb tensors -> list of affine host points."""
        x, y, finite = self.to_affine(pt)
        f = self.f
        xs, ys = f.to_ints(x).ravel(), f.to_ints(y).ravel()
        fin = finite.reshape(-1).cpu().tolist()
        return [ProjectivePoint(self.curve, int(a), int(b), 1) if ok else self.curve.neutral()
                for a, b, ok in zip(xs, ys, fin)]

    def _canonical(self, t):
        """``(rows, n)`` Montgomery limbs -> the n values as host ints (G1) or
        tuples of ints (G2): one transfer, R taken out on the host."""
        prime = getattr(self.f, "prime", self.f)
        L = prime.num_limbs
        D = self.f.num_limbs // L
        raw = prime.ops.limbs_to_ints(t.reshape(D, L, -1).transpose(0, 1))  # (D, n)
        rinv = pow(prime.params.r, -1, prime.p)
        vals = [[int(v) * rinv % prime.p for v in row] for row in raw]
        return vals[0] if D == 1 else list(zip(*vals))

    def to_host_exact(self, pt):
        """(x, y, z) limb tensors of a few points -> affine host points, the
        division by z done on the host in exact arithmetic: one transfer and
        no device work (an MSM's window sums)."""
        p = self.f.p
        out = []
        for x, y, z in zip(*(self._canonical(c.reshape(c.shape[0], -1)) for c in pt)):
            if z == 0:
                out.append(self.curve.neutral())
                continue
            zi = pow(z, -1, p)
            zi2 = zi * zi % p
            out.append(ProjectivePoint(self.curve, x * zi2 % p, y * zi2 % p * zi % p, 1))
        return out

    def neutral(self, batch_shape, device):
        f = self.f
        return (f.ones(batch_shape, device), f.ones(batch_shape, device),
                f.zeros(batch_shape, device))

    def select(self, cond, pt_true, pt_false):
        f = self.f
        return tuple(f.select(cond, a, b) for a, b in zip(pt_true, pt_false))

    # -- group law: kernel 10 on the card, the plain version on the CPU ---------
    def double(self, pt):
        """Jacobian doubling (dbl-2007-bl); infinity and 2-torsion points give
        z = 0."""
        group = self.kernel_group(pt)
        return self.double_plain(pt) if group is None else self._op_cuda(group, _DOUBLE, pt)

    def add(self, p1, p2):
        """Complete batched addition (add-2007-bl core)."""
        group = self.kernel_group(p1, p2)
        return self.add_plain(p1, p2) if group is None else self._op_cuda(group, _ADD, p1, p2)

    def add_mixed(self, p1, p2):
        """Mixed batched addition: ``p2`` affine-or-infinity (z in {0, 1},
        as :meth:`from_host` gives).  Complete."""
        group = self.kernel_group(p1, p2)
        if group is None:
            return self.add_mixed_plain(p1, p2)
        return self._op_cuda(group, _ADD_MIXED, p1, p2)

    # -- the plain versions: field arithmetic with selects ---------------------
    def double_plain(self, pt):
        """Jacobian doubling (dbl-2007-bl, general a); infinity and 2-torsion
        points give z = 0."""
        f = self.f
        X, Y, Z = pt
        xx = f.square(X)
        yy = f.square(Y)
        yyyy = f.square(yy)
        zz = f.square(Z)
        s = f.sub(f.square(f.add(X, yy)), f.add(xx, yyyy))
        s = f.add(s, s)
        m = f.add(xx, f.add(xx, xx))
        if not self.a_is_zero:
            m = f.add(m, self._mul_a(f.square(zz)))
        x3 = f.sub(f.square(m), f.add(s, s))
        y8 = _times8(f, yyyy)
        y3 = f.sub(f.mul(m, f.sub(s, x3)), y8)
        z3 = f.sub(f.square(f.add(Y, Z)), f.add(yy, zz))
        return (x3, y3, z3)

    def _complete(self, p1, p2, out, h, r):
        """Resolve the special cases of an addition with selects: same x and
        y -> doubling; same x, opposite y -> infinity; an infinite operand
        -> the other."""
        f = self.f
        p1_inf, p2_inf = f.is_zero(p1[2]), f.is_zero(p2[2])
        same_x, same_y = f.is_zero(h), f.is_zero(r)
        out = self.select(same_x & same_y, self.double_plain(p1), out)
        out = self.select(same_x & ~same_y & ~p1_inf & ~p2_inf,
                          self.neutral(out[0].shape[1:], out[0].device), out)
        out = self.select(p1_inf, p2, out)
        return self.select(p2_inf, p1, out)

    def add_plain(self, p1, p2):
        """Complete batched addition (add-2007-bl core)."""
        f = self.f
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        z1z1 = f.square(Z1)
        z2z2 = f.square(Z2)
        u1 = f.mul(X1, z2z2)
        u2 = f.mul(X2, z1z1)
        s1 = f.mul(f.mul(Y1, Z2), z2z2)
        s2 = f.mul(f.mul(Y2, Z1), z1z1)
        h = f.sub(u2, u1)
        r = f.sub(s2, s1)
        hh = f.square(h)
        hhh = f.mul(h, hh)
        v = f.mul(u1, hh)
        x3 = f.sub(f.sub(f.square(r), hhh), f.add(v, v))
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(s1, hhh))
        z3 = f.mul(f.mul(Z1, Z2), h)
        return self._complete(p1, p2, (x3, y3, z3), h, r)

    def add_mixed_plain(self, p1, p2):
        """Mixed batched addition: ``p2`` affine-or-infinity (z in {0, 1},
        as :meth:`from_host` gives), 4 products and a square fewer than
        :meth:`add_plain` (madd-2007-bl core).  Complete."""
        f = self.f
        X1, Y1, Z1 = p1
        X2, Y2, _ = p2
        z1z1 = f.square(Z1)
        u2 = f.mul(X2, z1z1)
        s2 = f.mul(f.mul(Y2, Z1), z1z1)
        h = f.sub(u2, X1)
        r = f.sub(s2, Y1)
        hh = f.square(h)
        hhh = f.mul(h, hh)
        v = f.mul(X1, hh)
        x3 = f.sub(f.sub(f.square(r), hhh), f.add(v, v))
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(Y1, hhh))
        z3 = f.mul(Z1, h)
        return self._complete(p1, p2, (x3, y3, z3), h, r)

    # -- reductions along the last axis ---------------------------------------
    def shift_down(self, pt, shift: int):
        """prev_i = pt_(i - shift) along the last axis, the first ``shift``
        positions the neutral point."""
        n = pt[0].shape[-1]
        fill = self.neutral(pt[0].shape[1:-1] + (min(shift, n),), pt[0].device)
        return tuple(torch.cat([fc[..., :min(shift, n)], c[..., :n - shift]], dim=-1)
                     for c, fc in zip(pt, fill))

    def tree_reduce(self, pt):
        """Sum of the points along the last axis by pairwise halving
        (log2(n) levels, n - 1 additions); returns shape (..., 1)."""
        while pt[0].shape[-1] > 1:
            n = pt[0].shape[-1]
            if n % 2:
                pt = tuple(torch.cat([c, nc], dim=-1) for c, nc in
                           zip(pt, self.neutral(pt[0].shape[1:-1] + (1,), pt[0].device)))
                n += 1
            pt = self.add(tuple(c[..., :n // 2] for c in pt),
                          tuple(c[..., n // 2:] for c in pt))
        return pt

    def segmented_scan(self, pt, seg_start):
        """Inclusive segmented prefix sums along the last axis (Hillis-Steele
        over log2(n) levels): ``seg_start`` (bool, the batch shape) marks
        segment heads; the last element of a segment holds its total."""
        n = pt[0].shape[-1]
        flags = seg_start.clone()
        shift = 1
        while shift < n:
            prev = self.shift_down(pt, shift)
            prev_flags = torch.cat([torch.ones_like(flags[..., :shift]),
                                    flags[..., :n - shift]], dim=-1)
            pt = self.select(flags, pt, self.add(pt, prev))
            flags = flags | prev_flags
            shift *= 2
        return pt


def _times8(f, v):
    v2 = f.add(v, v)
    v4 = f.add(v2, v2)
    return f.add(v4, v4)
