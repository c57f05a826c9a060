"""The port's short Weierstrass curves: BN254's and BLS12-377's G1
(``curves/zoo.py:40`` and :26 of the JAX package; the other curves there
are ROADMAP queue 1)."""

from __future__ import annotations

from ..fields import zoo as F
from .weierstrass import WeierstrassCurve

BN254Curve = WeierstrassCurve(
    name="bn254",
    field=F.BN254Field,
    a=0, b=3,
    gx=1, gy=2,
    order=F.BN254_ORDER,
    kernel_group=0,
)

BLS12377Curve = WeierstrassCurve(
    name="bls12_377",
    field=F.BLS12377Field,
    a=0, b=1,
    gx=int(
        "8848defe740a67c8fc6225bf87ff5485951e2caa9d41bb188282c8bd37cb5cd5"
        "481512ffcd394eeab9b16eb21be9ef", 16),
    gy=int(
        "1914a69c5102eff1f674f5d30afeec4bd7fb348ca3e52d96d182ad44fb82305c"
        "2fe3d3634a9591afd82de55559c8ea6", 16),
    order=F.BLS12_377_ORDER,
    cofactor=0x170B5D44300000000000000000000000,
    kernel_group=2,
)
