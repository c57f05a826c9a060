#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lambda_elliptic_curves_tpu_torch``) on
one NVIDIA card: builds the CUDA kernels from ``csrc/``, holds each kernel
against its plain PyTorch version on the card, then drives the Stark252
STARK prover end to end: the Fibonacci AIR, the other example AIRs, the
Stone format and the security presets (grinding); the STARK prover over
Goldilocks with Fp2 challenges and over BabyBear with Fp4 challenges;
Plonk over BN254 with KZG commitments, at 2^16 gates; and Groth16 over
BLS12-377, at 2^16 constraints, with its G2 MSM on the card.

    python3 chip_smoke.py

Phases (one result line each, with its seconds):
  1. card name and power limit (nvidia-smi); kernel build
  2. every kernel against its plain version on the card (bitwise), host-int
     spot checks, and kernel / plain timings at the prover's shapes; 2b2
     holds batch inversion against its plain version at the prover's
     shapes ((8, 2, N) and (8, 4, N) for N = 2^18 and 2^22), ragged sizes
     and a 3-D batch, with zeros, with the exact launches of each call,
     times it in turns against Fermat (a^(p-2)) at 2^18, 2^20, 2^23 and
     2^24 elements (the product rate is Fermat's), and times a call on one
     element (one launch: the one inversion's latency); 2c holds every NTT
     pass of every size 2^1 .. 2^22 at (8, 1|2|4, N) against
     ``ntt_pass_plain``, and the whole fft against the CPU path up to 2^14;
     2d times fft at 2^14 .. 2^22 and checks that fft 2^22 is its pass
     launches and no other device work; 2f holds the nonce search against
     its plain version (on the card) and the host loop ``lw_grind`` for 8
     seeds at factors 8-20 and a first hit in a later batch, with the
     launches of each search, and times it at factor 20 (against the host
     loop, and by batch size) and one full batch of each size; 2g holds
     kernel 6 (Goldilocks, BabyBear and their Fp2 and Fp4 towers) against
     its plain version for every op at 2^22 elements (batch inversion also
     over zero patterns laid on its blocks' chunks, a size that is no
     multiple of a block's elements and an operand read with element
     stride 0), times products at 2^22 and 2^24 (BabyBear beside the
     PyTorch yardstick (a * b) % p) and batch inversion at the prover's
     shapes, each with its bound, and reports both kernels' registers and
     occupancy; 2h holds kernel 7 (their NTT passes) against
     ``ntt_pass_plain`` at every pass of the fft's plan (``ntt.plan_for``)
     of every size 2^1 .. 2^22 at (L, 1|2|4, N) with the forward and the
     inverse root, and the whole fft at 2^22 (and 2^24 for BabyBear)
     against the plain transform and by ifft round trips, times those
     ffts (the passes' launches alone, and whole calls) against the fixed
     bound and the plan's bytes floor, and reports
     each pass's grid, threads, registers and occupancy at the prover's
     2^20 and 2^22 points, 1, 2 and 4 rows; 2i holds
     kernels 8 (BN254 Fr and Fq ops) and 9 (their batch inversion, one
     launch a call) against their plain versions at 2^18 and 2^22
     elements, times their launches alone (the C entries in a loop) at
     2^16, 2^17, 2^18 and 2^22 beside whole calls, against the bound at
     dense32.cuh's SASS with the fixed count beside it, and kernel 8's
     program entry on Plonk's round-3 quotient at 2^18 against
     ``program_plain`` (one launch), timed the same way; 2j holds kernel 1's BN254 Fr entry against
     ``ntt_pass_plain`` at every pass of every size 2^1 .. 2^20, forward
     and inverse root, the fft at 2^18 against the plain transform, and
     times the fft's passes alone (``ms``) and whole calls at 2^16, 2^18 and
     2^22; it holds the entry's product (``csrc/dense32.cuh``) against
     ``dense.cuh``'s on 2^20 random pairs and the edge values
     (``tools/dense_mul.py``, built beside the library in phase 1),
     reports both products' and butterflies' SASS instructions, bounds the
     fft by the fewer of dense32.cuh's SASS and the fixed count
     (``fixed_bound_ms``: 490 instructions a product, 48 a sum), and
     reports each pass's grid, registers and occupancy at 2^16 .. 2^18 (at
     least 132 blocks a pass); 2k and 2l do the same over
     BLS12-377 (kernels 8 and 9 over Fr and over Fq on six words, kernel
     8's programs on Groth16's t and h at 2^17, kernel 1 over Fr; every
     pass and the fft, both roots, also at the QAP's 3 rows at 2^16 and
     2^17; the fft checked at 2^17 and timed at 2^16, 2^17,
     2^18, 2^22); 2m holds kernel 10 (``csrc/curve.cu``: a group op a
     launch) against the plain group law for the addition, the mixed
     addition, the doubling and an operand broadcast, for BN254 G1 and G2
     and BLS12-377 G1 and G2, at the MSMs' scan width (17 x 2^16 lanes, with
     P + P, P + (-P) and infinity lanes), and kernel 11
     (``csrc/msm_bucket.cu``: Pippenger's bucket phase) against its plain
     version over skewed ids (uniform, one bucket, mostly 0 and 1, half
     zeros) of 2^12 points, c = 12 (two levels each of the accumulate and
     the reduce), for each group, with its occupancy at the blocks it
     launches; each timed with its bound
  3. Fibonacci 2^10 rows, ProofOptions(4, 32, 3, 0): serialized proof
     byte-equal to the JAX package's checked-in proof; verify accepts it and
     rejects it with fri_last_value + 1; 3b every example AIR of
     ``examples/catalog.py`` proved on the card, byte-equal to the JAX
     package's proof (``tests/fixtures/jax_stark_*_proof.json``); 3c the
     recorded Stone cases 1 and 2, ``serialize_proof_stone`` byte-equal to
     the JAX package's bytes; 3d the small-field proofs of
     ``examples/catalog.py``'s ``EXTENSION_CASES`` (Goldilocks + Fp2,
     BabyBear + Fp4, the Fp2 Fibonacci RAP) byte-equal to the JAX package's
     (``tests/fixtures/jax_stark_ext_*_proof.json``), the card's proof and
     the JAX proof both accepted by the verifier; 3e the Plonk fixture
     proofs over BN254 (``tests/fixtures/jax_bn254_plonk{4,32}.json``) on
     the card, every field equal to the JAX package's, both accepted, a
     wrong public input refused; 3f the Groth16 fixtures
     (``tests/fixtures/jax_groth16_{x3,chain,bn254}.json``) set up and
     proved on the card: keys, proofs and proof bytes equal to the JAX
     package's, both proofs accepted, a wrong public input refused
  4. Fibonacci 2^16 rows as bench.py's stark_fib_prove runs it: one warm-up
     prove, a timed prove (kernel launch counts reset just before it) and
     verify
  5. prove + verify at 2^20 rows: a first prove (it builds the NTT's root
     tables of the new sizes), the device bytes of every NTT cache after it,
     then a timed prove (launch counts reset just before it) and verify; 5b
     the same at the CONJECTURABLE_128 preset (4, 55, 3, 20), its nonce
     checked least by the host loop; 5c every security preset at 2^6 rows;
     5d and 5e Fibonacci at 2^20 rows, ProofOptions(4, 32, 3, 0), over
     Goldilocks with Fp2 challenges and over BabyBear with Fp4 challenges:
     a first prove, then a timed warm prove (launch counts reset just
     before it) with its phases, and verify; 5f an MSM of 2^16 BN254 G1
     points, Pippenger against the device double-and-add (timed), and both
     against ``msm_naive_host`` at 2^10; 5g Plonk over BN254 with KZG on a
     2^16-gate chain circuit (SRS of n + 6 points made on the card):
     preprocessing, setup, a first and a warm prove (launch counts reset
     just before it) with each round's time, verify, and a wrong public
     input refused; 5h MSMs of 2^16 BLS12-377 G2 points and of 2^16 G1
     points (from the setup's comb on the card), Pippenger against the
     device double-and-add (timed), and both against the host MSM at 2^8;
     5f and 5h also hold kernel 11 against its plain version over the
     MSM's own ids (its launches exactly its plan's: each launch's grid and
     longest chain of dependent group ops), report each MSM's launches by
     kernel and trace one more Pippenger MSM (fewer than 100 kernels of any
     kind), and run 2^16-point Pippenger MSMs over BN254 G1 (5f) and
     BLS12-377 G2 (5h) with skewed scalars (all equal; 90% 0 or 1, the
     rest uniform), each equal to the device double-and-add, with the
     bucket phase's time and share at their ids;
     5i Groth16 over BLS12-377 on a chain of 2^16 constraints: setup, a
     first and a warm prove (launch counts reset just before it) with each
     stage's time, verify, and a wrong public input refused
  6. launch count of each kernel during the timed proves of phases 4, 5,
     5b, 5d and 5e (each Stark252 kernel > 0 in the Stark252 proves, but
     the nonce search 0 without grinding; batch inversion exactly 6 at each
     size, two calls of 3 launches; none of the Fermat kernel
     ``field_pow``; the small-field proves launch kernels 6 and 7 and
     Keccak, and no Stark252 kernel; the Plonk prove launches kernel 1's
     BN254 Fr entry and kernels 8, 9 and 11 and nothing of the STARK paths,
     its round-3 quotient one launch of kernel 8's program entry, its SRS
     kernel 10; the Groth16 prove the BLS12-377 instances of kernels 1, 8,
     9 and 11 and nothing else, kernel 8 fewer than 1,000 times and its
     program entry twice (t and h), its setup kernel 10; kernel 10 exactly
     once for the SRS, twice for the Groth16 setup, never in a prove)
  7. a torch.profiler trace of one warm prove at 2^16 and at 2^20 rows, at
     2^20 rows at the preset, of both small-field 2^20-row proves, of a
     warm Plonk prove at 2^16 gates and of a warm Groth16 prove at 2^16
     constraints: device busy time, idle share, time and launches by
     kernel

Each kernel's ``bound_ms`` is the larger of its bytes (inputs read once,
outputs written once) over the card's memory rate and its 32-bit integer
operations over the card's integer rates, each pipe and the issue rate
(see ``bound``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any mismatch or exception exits
non-zero without that line.  Exits non-zero at once without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "jax_fib_1024_proof.json")
CSRC = "lambda_elliptic_curves_tpu_torch/csrc"

KERNELS = {
    "ntt": {"source": f"{CSRC}/ntt.cu",
            "replaces": "lambda_elliptic_curves_tpu/poly/ntt_pallas.py:164"},
    "keccak": {"source": f"{CSRC}/keccak.cu",
               "replaces": "lambda_elliptic_curves_tpu/hashes/keccak_pallas.py:109"},
    "field": {"source": f"{CSRC}/field.cu",
              "replaces": "lambda_elliptic_curves_tpu/ops/limbs.py:750"},
    "field_inv": {"source": f"{CSRC}/batch_inverse.cu",
                  "replaces": "lambda_elliptic_curves_tpu/ops/limbs.py:895"},
    "grind": {"source": f"{CSRC}/keccak.cu",
              "replaces": "lambda_elliptic_curves_tpu/provers/stark/grinding.py:52"},
    "small_field": {"source": f"{CSRC}/small_field.cu",
                    "replaces": "lambda_elliptic_curves_tpu/ops/limbs.py:750"},
    "small_ntt": {"source": f"{CSRC}/small_ntt.cu",
                  "replaces": "lambda_elliptic_curves_tpu/poly/ntt.py:327"},
    "dense_ntt": {"source": f"{CSRC}/ntt.cu",
                  "replaces": "lambda_elliptic_curves_tpu/poly/ntt_pallas.py:164"},
    "dense_field": {"source": f"{CSRC}/dense_field.cu",
                    "replaces": "lambda_elliptic_curves_tpu/ops/limbs.py:750"},
    "dense_program": {"source": f"{CSRC}/dense_field.cu",
                      "replaces": "lambda_elliptic_curves_tpu/provers/plonk/prover.py:124"},
    "dense_inv": {"source": f"{CSRC}/dense_inverse.cu",
                  "replaces": "lambda_elliptic_curves_tpu/ops/limbs.py:895"},
    "dense_ntt_bls12_377": {"source": f"{CSRC}/ntt.cu",
                            "replaces": "lambda_elliptic_curves_tpu/poly/ntt_pallas.py:164"},
    "dense_field_bls12_377": {"source": f"{CSRC}/dense_field.cu",
                              "replaces": "lambda_elliptic_curves_tpu/ops/limbs.py:750"},
    "dense_program_bls12_377": {"source": f"{CSRC}/dense_field.cu",
                                "replaces": "lambda_elliptic_curves_tpu/provers/groth16/qap.py:95"},
    "dense_inv_bls12_377": {"source": f"{CSRC}/dense_inverse.cu",
                            "replaces": "lambda_elliptic_curves_tpu/ops/limbs.py:895"},
    "curve_op": {"source": f"{CSRC}/curve.cu",
                 "replaces": "lambda_elliptic_curves_tpu/curves/weierstrass.py:284"},
    "msm_bucket": {"source": f"{CSRC}/msm_bucket.cu",
                   "replaces": "lambda_elliptic_curves_tpu/curves/msm.py:107"},
    "curve_op_bls12_377": {"source": f"{CSRC}/curve.cu",
                           "replaces": "lambda_elliptic_curves_tpu/curves/weierstrass.py:322"},
    "msm_bucket_bls12_377": {"source": f"{CSRC}/msm_bucket.cu",
                             "replaces": "lambda_elliptic_curves_tpu/curves/msm.py:107"},
}
#: the small-field proves of phases 5d and 5e: name -> (field, tower degree)
SMALL_PROVES = {"goldilocks_fp2": ("goldilocks", 2), "babybear_fp4": ("babybear", 4)}
#: the kernels of the Stark252 proves and of the small-field proves
STARK252_KERNELS = ("ntt", "keccak", "field", "field_inv", "grind")
SMALL_KERNELS = ("small_field", "small_ntt", "keccak")
#: the kernels of the Plonk proves over BN254 (kernel 1's BN254 Fr entry,
#: kernels 8, 9 and 11: the KZG commitments' Pippenger), the kernel of its
#: SRS (kernel 10: the comb, one launch), and the log2 of the gates of
#: phase 5g's circuit
BN254_KERNELS = ("dense_ntt", "dense_field", "dense_program", "dense_inv", "msm_bucket")
BN254_SETUP_KERNELS = ("curve_op",)
PLONK_LOG_GATES = 16
#: the kernels of the Groth16 proves over BLS12-377 (the same four kernels'
#: BLS12-377 instances: Fr on four words, Fq on six), the kernel of its
#: setup (kernel 10: the G1 and the G2 comb, a launch each), and the log2
#: of the constraints of phase 5i's circuit and of the points of phase 5h's
#: MSMs
BLS_KERNELS = ("dense_ntt_bls12_377", "dense_field_bls12_377", "dense_program_bls12_377",
               "dense_inv_bls12_377", "msm_bucket_bls12_377")
BLS_SETUP_KERNELS = ("curve_op_bls12_377",)
GROTH16_LOG_CONSTRAINTS = 16
G2_MSM_LOG_POINTS = 16
#: kernel 8 launches that a warm Groth16 prove at 2^16 stays below, now that
#: the curve work runs on kernels 10 and 11 (18,971 before them), and the
#: kernels of any kind that a Pippenger MSM of 2^16 points stays below
GROTH16_DENSE_FIELD_MAX = 1000
MSM_KERNELS_MAX = 100
#: the curve groups of kernels 10 and 11 (curve.cuh's LW_CURVE_*), and the
#: lanes phase 2m holds kernel 10 at: the MSMs' scan width, 17 windows of
#: 2^16 points
CURVE_GROUPS = ("bn254_g1", "bn254_g2", "bls12_377_g1", "bls12_377_g2")
#: the sources of kernels 10 and 11, whose registers and spills phase 1
#: reports
CURVE_SOURCES = ("curve.cu", "curve_g2.cu", "msm_bucket.cu", "msm_bucket_g2.cu",
                 "msm_bucket_bls12_377_g2.cu")
CURVE_LANES = 17 << 16
#: the fixed-base comb's lanes on the main path, which phase 2m holds kernel
#: 10's comb entry at (``tools/sweep_curve.py`` times the same): the Plonk
#: SRS (n + 6 points at 2^PLONK_LOG_GATES gates), about the Groth16 setup's
#: G1 comb (5 x 2^m) and its G2 comb (2^m + 6) at 2^GROTH16_LOG_CONSTRAINTS
#: constraints, and BN254 G2 at 2^16
COMB_LANES = {"bn254_g1": (1 << PLONK_LOG_GATES) + 6, "bn254_g2": 1 << 16,
              "bls12_377_g1": 5 << GROTH16_LOG_CONSTRAINTS,
              "bls12_377_g2": (1 << GROTH16_LOG_CONSTRAINTS) + 6}
# base products and base sums of one group op as curve.cuh writes it, over
# the curve's own field (an Fp2 product is 3 base products and 5 sums for
# BN254, u^2 = -1, or 9 for BLS12-377, u^2 = -5; an Fp2 sum 2): the mixed
# addition's 11 products (madd-2007-bl), the addition's 16 (add-2007-bl),
# the doubling's 8 (dbl-2007-bl), and the products before the test for a
# doubling (4 and 9), which a lane with p1 = -p2 stops after
CURVE_OP_COUNTS = {"add_mixed": (11, 7), "add": (16, 7), "double": (8, 16),
                   "add_mixed_head": (4, 2), "add_head": (9, 2)}

# The card's peak rates (NVIDIA's H100 SXM data sheet and the CUDA
# programming guide's throughput table for compute capability 9.0), at the
# card's maximum SM clock: device memory 3.35 TB/s.  Each SM issues one
# warp instruction per clock from each of its four schedulers (128 lanes
# per clock) to two integer pipes of 64 lanes per clock each: the FMA pipe
# alone runs multiply-adds (IMAD), the ALU pipe alone runs logic ops and
# funnel shifts (LOP3, SHF), and adds with carry and moves run on either
# (IADD3.X or IMAD.X, MOV or IMAD.MOV; the compiler splits them).  So a mix
# takes at least the largest of multiply-adds / 64, logic / 64 and
# all / 128 clocks per SM.
HBM_BYTES_PER_S = 3.35e12
INT_PIPE_PER_CLOCK_PER_SM = 64
INT_ISSUE_PER_CLOCK_PER_SM = 128
# 32-bit integer instructions per operation, estimated from the sources, as
# (multiply-adds, logic ops and shifts, other): a Montgomery product counts
# 170: 64 widening products of a*b and 24 of the reduction's m*p (p's five
# zero limbs fold away), carry adds, and the final conditional subtraction
# (8 selects); an add or sub with its reduction is 24, 8 of them selects;
# a keccak-f permutation is 3-input logic ops and funnel shifts (per round:
# theta 90, rho 48, chi 50, iota 2; 24 rounds).
MONT_MUL_OPS = (88, 8, 74)
ADD_OPS = (0, 8, 16)
# the small fields (csrc/small_field.cuh): a Goldilocks product is two
# 64x64-bit products of four widening 32-bit products each, carry adds, a
# subtraction and a select; a BabyBear product three widening products; an
# add is a 64-bit (or 32-bit) add, a compare and a select.  An Fp2 product
# is 4 base products (Karatsuba's 3 and one by the non-residue) and 5 adds,
# an Fp4 product 13 and 25.
SMALL_MUL_OPS = {"goldilocks": (8, 0, 14), "babybear": (3, 0, 3)}
SMALL_ADD_OPS = {"goldilocks": (0, 2, 6), "babybear": (0, 1, 2)}
TOWER_MULS = {1: (1, 0), 2: (4, 5), 4: (13, 25)}  # (base products, base adds)
# a batch inversion's base products an element besides the trick's 3 a
# nonzero element: the tower's norm down to the base field and the lift
# back (Fp2: 3 and 2; Fp4: an Fp2 norm of 2 Fp2 squares and a product by
# the non-residue, 7, its base norm 3, and the lifts 2 and 6)
TOWER_INV_MULS = {1: 0, 2: 5, 4: 18}
KECCAK_F_OPS = (0, 24 * 190, 0)
# BN254 (csrc/dense.cuh): a dense CIOS product is 32 64x64-bit multiply-adds
# (16 for a*b, 16 for m*p) and 4 products m = t0 n0; a 64x64 -> 128-bit
# product is about 8 32-bit multiply-adds (the high half 6, the low 2) and
# its two carried adds about 6 others; then the conditional subtraction.
# A sum or difference is 4 64-bit adds with compare carries and a select.
DENSE_MUL_OPS = (32 * 8 + 4 * 3, 0, 32 * 6 + 30)
DENSE_ADD_OPS = (0, 8, 40)
# BLS12-377 Fq on six words: the same product has 2 * 6^2 = 72 64x64-bit
# multiply-adds and 6 products m = t0 n0, a sum 6 64-bit adds
DENSE6_MUL_OPS = (72 * 8 + 6 * 3, 0, 72 * 6 + 45)
DENSE6_ADD_OPS = (0, 12, 60)
# the nonce search's cases (one seed each) and the factor it is timed at
# (the security presets' grinding factor)
GRIND_FACTORS = (8, 10, 12, 14, 16, 18, 20, 20)
GRIND_TIMED_FACTOR = 20
# batch sizes (log2) the search is timed at, and the plain version's batch
GRIND_BATCH_LOGS = (18, 20, 22)
GRIND_PLAIN_BATCH_LOG = 18


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def phase(name: str):
    def deco(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            detail = fn(*args, **kwargs)
            print(f"[phase {name}] ok {time.perf_counter() - t0:.3f}s {detail}",
                  flush=True)
        return run
    return deco


def max_abs_err(a, b) -> int:
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def ops(*terms) -> tuple:
    """(multiply-adds, logic ops, other) of ``terms``, each a pair (count,
    per-operation counts such as ``MONT_MUL_OPS``)."""
    return tuple(sum(count * per[i] for count, per in terms) for i in range(3))


def bound(state, nbytes: float, counts: tuple):
    """(least ms, what bounds it) for moving ``nbytes`` through device memory
    and doing ``counts`` = (multiply-adds, logic ops, other) 32-bit integer
    instructions on this card: the slower of the two, the instructions at
    the busier pipe's rate or at the issue rate, whichever is slower."""
    mads, logic, other = counts
    clocks = max(mads / INT_PIPE_PER_CLOCK_PER_SM, logic / INT_PIPE_PER_CLOCK_PER_SM,
                 (mads + logic + other) / INT_ISSUE_PER_CLOCK_PER_SM)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = clocks / state["sm_clocks_per_s"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def inv_bound(state, a):
    """Montgomery's trick: 3 products per nonzero element; 32 B read and 32 B
    written per element."""
    n = a[0].numel()
    nonzero = int((a != 0).any(dim=0).sum().item())
    return bound(state, 64.0 * n, ops((3 * nonzero, MONT_MUL_OPS)))


# ---------------------------------------------------------------------------

def phase_build(state):
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.tools._timing import smi

    state["smi"] = smi("name,power.limit")
    print(state["smi"], flush=True)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    state["sm_clocks_per_s"] = sms * clock_mhz * 1e6
    print(f"{sms} SMs at {clock_mhz:.0f} MHz: {state['sm_clocks_per_s'] * 64:.4g} integer "
          f"ops/s per pipe, {state['sm_clocks_per_s'] * 128:.4g} issued; memory "
          f"{HBM_BYTES_PER_S:.4g} B/s", flush=True)

    @phase("1 build")
    def run():
        import threading

        from lambda_elliptic_curves_tpu_torch.tools import dense_mul

        t0 = time.perf_counter()
        # the product tool (phases 2j, 2l) builds beside the library
        side = threading.Thread(target=dense_mul.build)
        side.start()
        native.cuda_lib()
        native.host_keccak()
        side.join()
        dense_mul.build()  # raises here if the side build failed
        state["build_s"] = time.perf_counter() - t0
        state["build_seconds"] = {k: round(v, 1) for k, v in sorted(
            native.build_seconds.items(), key=lambda kv: -kv[1])}
        state["ptxas"] = {src: _ptxas_summary(native.build_log.get(src, ""))
                          for src in CURVE_SOURCES}
        state["ptxas"].update({src: _ptxas_kernels(native.build_log.get(src, ""))
                               for src in ("dense_field.cu", "dense_inverse.cu")})
        return (f"kernels built in {state['build_s']:.1f}s from {CSRC}/*.cu; seconds by "
                f"source: {json.dumps(state['build_seconds'])}; the curve and dense kernels' "
                f"registers, stack and spills: {json.dumps(state['ptxas'])}")
    run()


def _ptxas_summary(log: str) -> dict:
    """"kernel or function, group" -> registers and spill bytes, from the
    ``nvcc -Xptxas -v`` output of a curve kernel's source (a called
    function's spills are listed under its own name)."""
    import re

    def label(mangled):
        field = "bls12_377" if "Bls12377" in mangled else "bn254"
        if "lw_fq_mul" in mangled:
            return f"product {field} Fq"
        group = field + ("_g2" if "LwFp2" in mangled else "_g1")
        for kind, mark in (("accumulate, mixed", "accumulate_kernel.*Lb1E"),
                           ("accumulate", "accumulate_kernel"), ("reduce", "reduce_kernel"),
                           ("kernel 10", "curve_point_op_kernel"),
                           ("kernel 10 comb", "curve_comb_kernel"), ("add_mixed", "9add_mixed"),
                           ("add", "3add"), ("double", "3dbl")):
            if re.search(mark, mangled):
                return f"{kind} {group}"
        return None

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = {"spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))}
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
    return out


def _ptxas_kernels(log: str) -> dict:
    """Kernel (its mangled name) -> registers, stack frame and spill bytes,
    from a source's ``nvcc -Xptxas -v`` output (kernels 8 and 9: the
    program's slots are its stack frame)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            out[name] = {"stack": int(m.group(1)), "spill_stores": int(m.group(2)),
                         "spill_loads": int(m.group(3))}
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
    return out


def _random_field(n: int, gen, dev):
    """(8, n) canonical values below 2^251 < p, drawn on the card from the
    CUDA generator ``gen``, with edge values first."""
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.tools._timing import random_field

    x = random_field((n,), gen)
    x[:, :4] = f.array([0, 1, f.p - 1, f.p - 2], dev)[:, :n]
    return x


def phase_kernels(state):
    import numpy as np
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.hashes import keccak
    from lambda_elliptic_curves_tpu_torch.ops import limbs
    from lambda_elliptic_curves_tpu_torch.poly import ntt
    from lambda_elliptic_curves_tpu_torch.tools._timing import cuda_ms, traced_kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = state["kernels"]

    @phase("2a keccak")
    def run_keccak():
        st = torch.randint(-2**31, 2**31, (25, 2, 1 << 16), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.int32)
        err = max_abs_err(keccak.keccak_f(st), keccak.keccak_f_plain(st))
        check(err == 0, "keccak_f kernel != plain")
        host = st[:, :, :8].cpu().numpy().view(np.uint32)
        out = keccak.keccak_f(st)[:, :, :8].cpu().numpy().view(np.uint32)
        for b in range(8):
            lanes = [int(host[i, 0, b]) | int(host[i, 1, b]) << 32 for i in range(25)]
            want = keccak._keccak_f_host(lanes)
            check([int(out[i, 0, b]) | int(out[i, 1, b]) << 32 for i in range(25)] == want,
                  "keccak_f kernel != host permutation")
        times = {}
        for nbytes in (32, 64):
            words = torch.randint(-2**31, 2**31, (nbytes // 4, 1 << 18), generator=gen,
                                  device=dev, dtype=torch.int64).to(torch.int32)
            got = keccak.keccak256_words(words, nbytes)
            err = max(err, max_abs_err(got, keccak.keccak256_words_plain(words, nbytes)))
            check(err == 0, f"keccak256_words kernel != plain at {nbytes} B")
            msgs = words[:, :256].cpu().numpy().T.astype("<i4")
            digests = keccak.digest_words_to_bytes(got[:, :256])
            check(digests == [keccak.keccak256(m.tobytes()) for m in msgs],
                  f"keccak256_words kernel != host keccak256 at {nbytes} B")
            times[nbytes] = (cuda_ms(lambda: keccak.keccak256_words(words, nbytes), 20),
                             cuda_ms(lambda: keccak.keccak256_words_plain(words, nbytes), 2))
        ms, plain_ms = times[64]
        # one permutation per message; 64 B read and a 32 B digest written
        bound_ms, bound_by = bound(state, 96.0 * (1 << 18), ops((1 << 18, KECCAK_F_OPS)))
        rec["keccak"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None,
                             shape="keccak256_words, 2^18 messages of 64 B")
        return ("keccak_f 2^16 states and keccak256_words 2^18 x {32,64} B bitwise equal; "
                + ", ".join(f"{b} B: kernel {t[0]:.4f} ms plain {t[1]:.3f} ms"
                            for b, t in times.items()))
    run_keccak()

    @phase("2b1 field ops")
    def run_field():
        n = 1 << 20
        a, b = _random_field(n, gen, dev), _random_field(n, gen, dev).flip(1)
        err = 0
        pairs = [(f.add(a, b), limbs.add_plain(a, b)), (f.sub(a, b), limbs.sub_plain(a, b)),
                 (f.mul(a, b), limbs.mont_mul_plain(a, b))]
        for got, want in pairs:
            err = max(err, max_abs_err(got, want))
        check(err == 0, "field kernel != plain")
        idx = torch.arange(0, n, n // 61)[:64].to(dev)
        av = [int(v) for v in limbs.limbs_to_ints(a[:, idx])]
        bv = [int(v) for v in limbs.limbs_to_ints(b[:, idx])]
        r_inv = pow(2**256, -1, f.p)
        host = {
            "add": [(x + y) % f.p for x, y in zip(av, bv)],
            "sub": [(x - y) % f.p for x, y in zip(av, bv)],
            "mul": [x * y * r_inv % f.p for x, y in zip(av, bv)],
        }
        for (got, _), name in zip(pairs, host):
            check([int(v) for v in limbs.limbs_to_ints(got[:, idx])] == host[name],
                  f"field {name} kernel != host ints")
        m = 1 << 18
        a2, b2 = a[:, :m].contiguous(), b[:, :m].contiguous()
        mul_18_ms = cuda_ms(lambda: f.mul(a2, b2), 50)
        # the kernels line's shape: 2^22 elements, an LDE column at 2^20 rows,
        # where the device time and not the launch dominates
        a4, b4 = _random_field(1 << 22, gen, dev), _random_field(1 << 22, gen, dev)
        ms = cuda_ms(lambda: f.mul(a4, b4), 20)
        plain_ms = cuda_ms(lambda: limbs.mont_mul_plain(a4, b4), 2)
        bound_ms, bound_by = bound(state, 96.0 * (1 << 22), ops((1 << 22, MONT_MUL_OPS)))
        rec["field"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None, shape="mul, 2^22 elements")
        state["field_extra"] = {"mul_2^18_ms": mul_18_ms}
        return (f"add/sub/mul on 2^20 bitwise equal, 64 host spot checks; mul 2^18: "
                f"kernel {mul_18_ms:.4f} ms; mul 2^22: kernel {ms:.4f} ms plain "
                f"{plain_ms:.3f} ms bound {bound_ms:.4f} ms ({bound_by})")
    run_field()

    @phase("2b2 batch inverse")
    def run_inverse():
        # the prover's shapes, boundary terms (8, 2, N) and DEEP (8, 4, N)
        # with N the LDE size (2^18 at 2^16 rows, 2^22 at 2^20 rows), then
        # ragged sizes and a 3-D batch, each two levels of tiles (3 launches)
        # at its own walk length (8 to 128 elements a thread); zeros
        # scattered, in a run, first and last
        launches = {(2, 1 << 18): 3, (4, 1 << 18): 3, (2, 1 << 22): 3, (4, 1 << 22): 3,
                    ((1 << 22) + 5,): 3, ((1 << 20) - 3,): 3, (3, 5, 7001): 3}
        shapes = list(launches)
        err = 0
        for shape in shapes:
            n = math.prod(shape)
            flat = _random_field(n, gen, dev)
            flat[:, ::997] = 0
            flat[:, 5000:5300] = 0
            flat[:, -1] = 0
            a = flat.reshape((8,) + shape)
            native.launches["field_inv"] = 0
            got = f.batch_inverse(a)
            check(native.launches["field_inv"] == launches[shape],
                  f"batch inverse at {shape}: {native.launches['field_inv']} launches, "
                  f"not {launches[shape]}")
            err = max(err, max_abs_err(got, limbs.batch_inverse_plain(a)))
            check(err == 0, f"batch inverse kernel != plain at {shape}")
            idx = torch.cat([torch.arange(0, n, n // 61)[:62],
                             torch.tensor([n - 2, n - 1])]).to(dev)
            av = [int(v) for v in f.to_ints(flat[:, idx])]
            check([int(v) for v in f.to_ints(got.reshape(8, n)[:, idx])]
                  == [0 if x == 0 else pow(x, -1, f.p) for x in av],
                  f"batch inverse kernel != host ints at {shape}")
            check(av.count(0) >= 2, "the spot checks hold no zero")
            del flat, a, got
        torch.cuda.empty_cache()

        # kernel and Fermat (a^(p-2), the route the card took before) in
        # turns: kernel, Fermat, Fermat, kernel
        times, xs = {}, {}
        for log_n in (18, 20, 23, 24):
            x = xs[log_n] = _random_field(1 << log_n, gen, dev)
            reps_k, reps_f = (20, 3) if log_n <= 20 else (5, 1)
            kern = lambda: f.batch_inverse(x)  # noqa: E731
            ferm = lambda: limbs.mont_pow(x, f.p - 2)  # noqa: E731
            k1, f1, f2, k2 = (cuda_ms(kern, reps_k), cuda_ms(ferm, reps_f),
                              cuda_ms(ferm, reps_f), cuda_ms(kern, reps_k))
            check(torch.equal(kern(), ferm()), f"batch inverse != Fermat at 2^{log_n}")
            b_ms, b_by = inv_bound(state, x)
            # Fermat: 252 squarings and 194 multiplies per element
            fb_ms, fb_by = bound(state, 64.0 * x.shape[1],
                                 ops((446 * x.shape[1], MONT_MUL_OPS)))
            times[log_n] = {"kernel_ms": [k1, k2], "fermat_ms": [f1, f2], "bound_ms": b_ms,
                            "bound_by": b_by, "fermat_bound_ms": fb_ms, "fermat_bound_by": fb_by,
                            "speedup": (f1 + f2) / (k1 + k2)}
        # Fermat's operations per second at 2^24: a blend of 252 squarings
        # and 194 products per element, not the product's rate (the
        # squaring is the faster; tools/sweep_batch_inverse.py times each);
        # and one element: one launch, whose time is the one inversion's
        # latency and the walks and trees around it
        n24 = xs[24].shape[1]
        fermat_op_rate = 446 * n24 / (sum(times[24]["fermat_ms"]) / 2 * 1e-3)
        one = xs[18][:, 5:6].contiguous()
        one_us = cuda_ms(lambda: f.batch_inverse(one), 50) * 1e3
        check(int(f.to_ints(f.batch_inverse(one))[0]) * int(f.to_ints(one)[0]) % f.p == 1,
              "batch inverse of one element is wrong")
        ms = sum(times[20]["kernel_ms"]) / 2
        plain_ms = cuda_ms(lambda: limbs.batch_inverse_plain(xs[20]), 1)
        rec["field_inv"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=times[20]["bound_ms"], bound_by=times[20]["bound_by"],
                                library_ms=None, shape="batch_inverse, 2^20 elements")
        state["inv_times"] = times
        state["inv_extra"] = {"one_element_us": one_us, "fermat_ops_per_s_2^24": fermat_op_rate}
        return (f"{len(shapes)} shapes bitwise equal to plain ("
                + ", ".join(str(s) for s in shapes) + "), 64 host spot checks and the exact "
                f"launches each; one element {one_us:.2f} us; Fermat 2^24 "
                f"{fermat_op_rate:.4g} operations/s (252 squarings + 194 products); "
                + ", ".join(
                    f"2^{k}: kernel {t['kernel_ms'][0]:.4f}/{t['kernel_ms'][1]:.4f} ms, Fermat "
                    f"{t['fermat_ms'][0]:.3f}/{t['fermat_ms'][1]:.3f} ms ({t['speedup']:.1f}x), "
                    f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})" for k, t in times.items()))
    run_inverse()

    @phase("2c ntt passes")
    def run_passes():
        # every pass of every size 2^1 .. 2^22 at the prover's batches
        # (1, 2 and 4 rows), bitwise against ntt_pass_plain on the same input;
        # up to 2^14 also with radices of at most 2^3 (more passes), and the
        # whole fft against the CPU path (the same passes on a CPU tensor)
        err, checked = 0, 0
        for log_n in range(1, 23):
            n = 1 << log_n
            root = f.params.primitive_root_of_unity(log_n)
            tables = ntt.twiddle_tables(f, root, log_n, dev)
            for rows in (1, 2, 4):
                x = _random_field(rows * n, gen, dev).reshape(8, rows, n)
                for max_pass_log in (ntt.MAX_PASS_LOG, 3)[:2 if log_n <= 14 else 1]:
                    cur, ns_log = x, 0
                    for s in ntt.pass_plan(log_n, max_pass_log):
                        got = ntt.ntt_pass(cur, torch.empty_like(cur), tables, ns_log, s)
                        want = ntt.ntt_pass_plain(cur, tables, ns_log, s)
                        err = max(err, max_abs_err(got, want))
                        check(err == 0, f"NTT pass kernel != plain at 2^{log_n} x {rows}, "
                              f"radix 2^{s} after 2^{ns_log}")
                        cur, ns_log = got, ns_log + s
                        checked += 1
                    check(torch.equal(ntt.fft_with_root(x, f, root, max_pass_log), cur),
                          f"fft != its chain of passes at 2^{log_n} x {rows}")
                    if log_n <= 14:
                        check(torch.equal(cur.cpu(), ntt.fft_with_root(x.cpu(), f, root,
                                                                       max_pass_log)),
                              f"fft on the card != CPU path at 2^{log_n} x {rows}")
                del x, cur, got, want
        state["ntt_err"] = err
        torch.cuda.empty_cache()
        return (f"{checked} passes bitwise equal to ntt_pass_plain (2^1 .. 2^22 x 1/2/4 rows; "
                f"radix <= 2^{ntt.MAX_PASS_LOG}, and <= 2^3 up to 2^14); fft = CPU path up to 2^14")
    run_passes()

    @phase("2d fft")
    def run_fft():
        times, bounds = {}, {}
        for log_n in (14, 16, 18, 22):
            n = 1 << log_n
            x = _random_field(n, gen, dev)
            got = ntt.fft(x, f)
            check(torch.equal(ntt.ifft(got, f), x), f"ifft(fft(x)) != x at 2^{log_n}")
            times[log_n] = cuda_ms(lambda: ntt.fft(x, f), 20 if log_n < 22 else 10)
            # (n / 2) log2 n butterflies of one product, one add and one sub;
            # 32 B read and 32 B written per point
            bounds[log_n] = bound(state, 64.0 * n, ops((n // 2 * log_n, MONT_MUL_OPS),
                                                       (n * log_n, ADD_OPS)))
            if log_n == 18:
                plain_ms = cuda_ms(lambda: ntt.fft_with_root_plain(
                    x, f, f.params.primitive_root_of_unity(18)), 1)
            if log_n == 22:
                # the whole transform is the pass kernel's launches and nothing
                # else: the launch counts say how many, every trace holds pass
                # launches only, and one trace holds them all
                passes = len(ntt.pass_plan(22))

                def counted_fft():
                    native.launches.update({k: 0 for k in native.launches})
                    ntt.fft(x, f)
                    check(native.launches["ntt"] == passes
                          and sum(native.launches.values()) == passes,
                          f"fft 2^22 launched {native.launches}, not {passes} passes")

                traces = traced_kernels(counted_fft, passes)
                check(all("ntt_pass_kernel" in k for names in traces for k in names)
                      and len(traces[-1]) == passes,
                      f"fft 2^22 ran other device work than {passes} pass launches: {traces}")
        rec["ntt"].update(max_abs_err=state["ntt_err"], ms=times[18], plain_ms=plain_ms,
                          bound_ms=bounds[18][0], bound_by=bounds[18][1], library_ms=None,
                          shape=f"fft 2^18, passes {ntt.pass_plan(18)}",
                          **{"fft_2^22": {"ms": times[22], "bound_ms": bounds[22][0],
                                          "bound_by": bounds[22][1],
                                          "passes": ntt.pass_plan(22)}})
        state["fft_times"] = {k: (t, bounds[k][0]) for k, t in times.items()}
        return ("ifft round trip at 2^14/16/18/22; fft 2^22 = "
                f"{len(ntt.pass_plan(22))} pass launches and nothing else (kernels per trace "
                f"{[len(names) for names in traces]}); " + ", ".join(
                    f"2^{k}: {t:.4f} ms (bound {bounds[k][0]:.4f}, share "
                    f"{bounds[k][0] / t:.3f})" for k, t in times.items())
                + f"; plain 2^18 {plain_ms:.1f} ms")
    run_fft()

    @phase("2e interpolate 2^22")
    def run_interp():
        n = 1 << 22
        evals = _random_field(n, gen, dev)
        ms = cuda_ms(lambda: ntt.interpolate_fft(f, evals), 5)
        coeffs = ntt.interpolate_fft(f, evals)
        w = f.params.primitive_root_of_unity(22)
        for j in (0, 1, n // 3):
            check(_eval_at(f, coeffs, pow(w, j, f.p)) == int(f.to_ints(evals[:, j:j + 1])[0]),
                  f"interpolate 2^22 wrong at point {j}")
        state["interp_22_ms"] = ms
        return f"stark252_interpolate_2^22 {ms:.3f} ms (3 points checked)"
    run_interp()

    @phase("2f grind")
    def run_grind():
        state["grind"] = _grind_phase(state, dev)
        g = state["grind"]
        return json.dumps(g)
    run_grind()


# ---------------------------------------------------------------------------
# Goldilocks and BabyBear: kernels 6 and 7
# ---------------------------------------------------------------------------

def _small(name):
    """(PrimeField, its ``ops.small`` arithmetic) of a small field."""
    from lambda_elliptic_curves_tpu_torch import fields

    f = {"goldilocks": fields.Goldilocks, "babybear": fields.BabyBear}[name]
    return f, f.ops


def _tower(f, degree):
    from lambda_elliptic_curves_tpu_torch.provers.stark.extension import ChallengeBundle

    return f if degree == 1 else ChallengeBundle(f, degree).fd


def _random_small(f, degree: int, n: int, gen):
    """(degree L, n) int32 limbs of canonical values of ``f`` (each a
    Montgomery form) drawn uniformly from [0, p) on the card, 0, 1, p - 1,
    p - 2 first in every component.  A Goldilocks value is two uniform
    32-bit halves, drawn again while at or above p."""
    import torch

    def draw(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=gen.device,
                             dtype=torch.int64)

    comps = []
    for _ in range(degree):
        if f.num_limbs == 1:
            v = draw(f.p, (1, n))
        else:  # (low, high) 32-bit halves; p = 2^64 - 2^32 + 1
            v = draw(1 << 32, (2, n))
            while True:
                over = (v[1] == 0xFFFFFFFF) & (v[0] > 0)
                if not bool(over.any()):
                    break
                v[:, over] = draw(1 << 32, (2, int(over.sum())))
        for i, x in enumerate((0, 1, f.p - 1, f.p - 2)[:n]):
            v[:, i] = torch.tensor([(x >> (32 * k)) & 0xFFFFFFFF for k in range(f.num_limbs)],
                                   device=v.device)
        comps.append(v.to(torch.int32))  # the low 32 bits of each half
    return torch.cat(comps, dim=0)


def _small_mul_bound(state, name, degree, n):
    """Bound of n products of the degree-``degree`` tower over field
    ``name``: 3 values of D * 8 (or 4) bytes per element, and the tower's
    base products and adds."""
    muls, adds = TOWER_MULS[degree]
    width = degree * (8 if name == "goldilocks" else 4)
    return bound(state, 3.0 * width * n, ops((muls * n, SMALL_MUL_OPS[name]),
                                            (adds * n, SMALL_ADD_OPS[name])))


def _small_inv_bound(state, name, degree, a):
    """Bound of a batch inversion of ``a``, (degree L, *batch), over field
    ``name``: each value read once and written once, and 3 base products a
    nonzero element plus the tower's norm and lift an element
    (``TOWER_INV_MULS``), at ``SMALL_MUL_OPS`` (sums not counted)."""
    n = a[0].numel()
    nonzero = int((a != 0).reshape(a.shape[0], -1).any(dim=0).sum().item())
    width = degree * (8 if name == "goldilocks" else 4)
    return bound(state, 2.0 * width * n,
                 ops((3 * nonzero + TOWER_INV_MULS[degree] * n, SMALL_MUL_OPS[name])))


def _small_info(entry: str, *args) -> dict:
    """Threads a block, blocks an SM holds (the occupancy calculator),
    registers and spilled bytes a thread of a kernel 6 or 7 instance, from
    its C entry ``lw_small_field_info`` / ``lw_small_ntt_info``."""
    import ctypes

    from lambda_elliptic_curves_tpu_torch import native

    info = (ctypes.c_int * 5)()
    rc = getattr(native.cuda_lib(), entry)(*args, info)
    check(rc == 0, f"{entry}{args}: CUDA error {rc}")
    return {"threads": info[0], "blocks_per_sm": info[1], "registers": info[2],
            "spill_bytes": info[3], **({"elements_per_block": info[4]}
                                       if entry == "lw_small_field_info" else {})}


def _zero_patterns(n: int, per_block: int, threads: int) -> dict:
    """Boolean masks (on the CPU) of the elements a batch-inversion case sets
    to zero, laid on kernel 6's blocks: a block takes ``per_block``
    elements, thread t of it elements t, t + threads, ..."""
    import torch

    k = per_block // threads
    first = torch.zeros(n, dtype=torch.bool)  # thread 1 of block 2, each of its k positions
    first[2 * per_block + 1 + threads * torch.arange(k)] = True
    block = torch.zeros(n, dtype=torch.bool)  # the whole of block 3
    block[3 * per_block:4 * per_block] = True
    return {"a zero at each of a thread's k positions": first, "a whole block of zeros": block,
            "every element zero": torch.ones(n, dtype=torch.bool)}


def phase_small_kernels(state):
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.poly import ntt
    from lambda_elliptic_curves_tpu_torch.tools._timing import cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rec = state["kernels"]

    @phase("2g small-field ops")
    def run_ops():
        n, err, checked = 1 << 22, 0, 0
        for name in ("goldilocks", "babybear"):
            f, arith = _small(name)
            for degree in (1, 2, 4):
                fd = _tower(f, degree)
                a, b = _random_small(f, degree, n, gen), _random_small(f, degree, n, gen).flip(1)
                c = b[:, 5:6].contiguous()
                plain = fd.plain()
                cases = {
                    "add": (fd.add(a, b), plain.add(a, b)),
                    "sub": (fd.sub(a, b), plain.sub(a, b)),
                    "neg": (fd.neg(a), plain.neg(a)),
                    "mul": (fd.mul(a, b), plain.mul(a, b)),
                    "mul by one value": (fd.mul(a, c), plain.mul(a, c)),
                    "square": (fd.square(a), plain.mul(a, a)),
                    "pow 65537": (fd.pow(a, 65537), plain.pow(a, 65537)),
                    "batch_inverse": (fd.batch_inverse(a), plain.batch_inverse(a)),
                }
                if degree == 1:
                    cases["pow 2^40 + 3"] = (fd.pow(a, 2**40 + 3), plain.pow(a, 2**40 + 3))
                for op, (got, want) in cases.items():
                    err = max(err, max_abs_err(got, want))
                    check(err == 0, f"kernel 6 != plain: {name} degree {degree} {op}")
                    checked += 1
                del cases
                # batch inversion's zero patterns on its own blocks, a size
                # that is no multiple of a block's elements, and one value
                # read with element stride 0
                geo = _small_info("lw_small_field_info", f.ops.kernel_id, degree, 1)
                inv_cases = {}
                for what, mask in _zero_patterns(n, geo["elements_per_block"],
                                                 geo["threads"]).items():
                    z = a.clone()
                    z[:, mask.to(dev)] = 0
                    inv_cases[what] = z
                inv_cases["2^22 - 5 elements"] = a[:, 5:].contiguous()
                inv_cases["one value, element stride 0"] = c.expand(-1, n)
                for what, z in inv_cases.items():
                    err = max(err, max_abs_err(fd.batch_inverse(z),
                                               plain.batch_inverse(z.contiguous())))
                    check(err == 0, f"kernel 6 != plain: {name} degree {degree} batch_inverse, "
                          f"{what}")
                    checked += 1
                del a, b, c, inv_cases
                torch.cuda.empty_cache()
        # spot checks against host ints: Goldilocks products
        f, arith = _small("goldilocks")
        a, b = _random_small(f, 1, 64, gen), _random_small(f, 1, 64, gen).flip(1)
        av, bv = arith.limbs_to_ints(a), arith.limbs_to_ints(b)
        r_inv = pow(2**64, -1, f.p)
        check([int(v) for v in arith.limbs_to_ints(f.mul(a, b))]
              == [x * y * r_inv % f.p for x, y in zip(av, bv)], "Goldilocks mul != host ints")

        # products at 2^22 and 2^24 of each tower, against their bounds;
        # BabyBear beside the PyTorch yardstick (a * b) % p on canonical int64
        times = {}
        for name in ("goldilocks", "babybear"):
            f, _ = _small(name)
            for degree in (1, 2, 4):
                fd = _tower(f, degree)
                for log_n in (22, 24):
                    x, y = _random_small(f, degree, 1 << log_n, gen), \
                        _random_small(f, degree, 1 << log_n, gen)
                    ms = cuda_ms(lambda: fd.mul(x, y), 20)
                    b_ms, b_by = _small_mul_bound(state, name, degree, 1 << log_n)
                    times[f"{name} degree {degree} mul 2^{log_n}"] = {
                        "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms}
                    if name == "babybear" and degree == 1:
                        x64, y64 = x[0].to(torch.int64), y[0].to(torch.int64)
                        times[f"babybear pytorch (a * b) % p 2^{log_n}"] = {
                            "ms": cuda_ms(lambda: (x64 * y64) % f.p, 20)}
                        del x64, y64
                    del x, y
                torch.cuda.empty_cache()
        # the prover's batch inversions at 2^20 rows (N = 2^22): boundary
        # terms (L, 2, N) in the base field, DEEP terms (D L, 4, N) in E;
        # each one launch of the inversion kernel
        inv = {}
        for proof_name, (name, degree) in SMALL_PROVES.items():
            f, _ = _small(name)
            fd = _tower(f, degree)
            base = _random_small(f, 1, 2 << 22, gen).reshape(f.num_limbs, 2, 1 << 22)
            ext = _random_small(f, degree, 4 << 22, gen).reshape(fd.num_limbs, 4, 1 << 22)
            inv[proof_name] = {}
            for what, fx, d, x in (("base (L, 2, 2^22)", f, 1, base),
                                   ("E (D L, 4, 2^22)", fd, degree, ext)):
                native.launches["small_field"] = 0
                fx.batch_inverse(x)
                check(native.launches["small_field"] == 1,
                      f"{proof_name} {what} inversion: {native.launches['small_field']} launches")
                ms = cuda_ms(lambda: fx.batch_inverse(x), 10)
                b_ms, b_by = _small_inv_bound(state, name, d, x)
                inv[proof_name][what] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                                         "share": b_ms / ms}
            del base, ext
            torch.cuda.empty_cache()
        info = {f"{name} degree {d} {kind}": _small_info("lw_small_field_info",
                                                          _small(name)[1].kernel_id, d, inv_k)
                for name in ("goldilocks", "babybear") for d in (1, 2, 4)
                for kind, inv_k in (("op", 0), ("inverse", 1))}
        # the kernels line: Goldilocks Fp2 products at 2^22 elements, the
        # main path's LDE size and its commonest product
        f, _ = _small("goldilocks")
        fd = _tower(f, 2)
        x, y = _random_small(f, 2, n, gen), _random_small(f, 2, n, gen)
        t = times["goldilocks degree 2 mul 2^22"]
        plain_ms = cuda_ms(lambda: fd.plain().mul(x, y), 2)
        g_inv = inv["goldilocks_fp2"]
        rec["small_field"].update(max_abs_err=err, ms=t["ms"], plain_ms=plain_ms,
                                  bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                                  share=t["share"],
                                  library_ms=None, shape="Goldilocks Fp2 mul, 2^22 elements",
                                  babybear_yardstick_ms={k: v["ms"] for k, v in times.items()
                                                         if "pytorch" in k},
                                  inverse={"Goldilocks " + k: v for k, v in g_inv.items()},
                                  occupancy={k: v for k, v in info.items()
                                             if k.startswith("goldilocks degree 2")})
        state["small_field"] = {"mul": times, "batch_inverse": inv, "kernels": info}
        del x, y
        torch.cuda.empty_cache()
        return (f"{checked} ops bitwise equal to plain at 2^22 (both fields, degrees 1/2/4; "
                "batch inversion also over zero patterns, a ragged size and a stride-0 "
                "operand); " + json.dumps(state["small_field"]))
    run_ops()

    @phase("2h small-field ntt")
    def run_ntt():
        # every pass of every size 2^1 .. 2^22 at 1, 2 and 4 rows (a prove
        # transforms one row, or the D = 2 or 4 rows of an E vector: 2^20
        # and 2^22 inverse, 2^22 forward, and FRI's sizes forward), with the
        # forward and the inverse root, bitwise against ntt_pass_plain on
        # the same input; up to 2^14 also with radices of at most 2^3; the
        # whole fft against its chain of passes, and up to 2^14 against the
        # CPU path
        err, checked, times = 0, 0, {}
        for name in ("goldilocks", "babybear"):
            f, _ = _small(name)
            for log_n in range(1, 23):
                w = f.params.primitive_root_of_unity(log_n)
                for root in (w, pow(w, f.p - 2, f.p)):
                    tables = ntt.twiddle_tables(f, root, log_n, dev)
                    for rows in (1, 2, 4):
                        x = _random_small(f, 1, rows << log_n, gen).reshape(f.num_limbs,
                                                                           rows, -1)
                        # the fft's plan; up to 2^14 also radix-2^8 passes (the
                        # kernel's largest) and radix at most 2^3
                        plans = [ntt.plan_for(f, log_n)] + ([
                            ntt.pass_plan(log_n, ntt.SMALL_DFT_LOG), ntt.pass_plan(log_n, 3)]
                            if log_n <= 14 else [])
                        for plan in plans:
                            cur, ns_log = x, 0
                            for s in plan:
                                got = ntt.ntt_pass(cur, torch.empty_like(cur), tables, ns_log, s)
                                want = ntt.ntt_pass_plain(cur, tables, ns_log, s)
                                err = max(err, max_abs_err(got, want))
                                check(err == 0, f"kernel 7 != plain: {name} 2^{log_n} x {rows},"
                                      f" radix 2^{s} after 2^{ns_log}")
                                cur, ns_log = got, ns_log + s
                                checked += 1
                            # every plan computes the same transform
                            check(torch.equal(ntt.fft_with_root(x, f, root), cur),
                                  f"{name} fft != the chain of passes {plan} at 2^{log_n} x {rows}")
                            if log_n <= 14:
                                check(torch.equal(cur.cpu(), ntt.fft_with_root(x.cpu(), f, root)),
                                      f"{name} fft on the card != CPU path at 2^{log_n} x {rows}")
                        del x, cur, got, want
                torch.cuda.empty_cache()
            # the main path's fft sizes, held against the plain transform on
            # the same input, with their launches, round trip and times
            for log_n in ((22, 24) if name == "babybear" else (22,)):
                n = 1 << log_n
                root = f.params.primitive_root_of_unity(log_n)
                x = _random_small(f, 1, n, gen)
                native.launches["small_ntt"] = 0
                y = ntt.fft(x, f)
                plan = ntt.plan_for(f, log_n)
                check(native.launches["small_ntt"] == len(plan),
                      f"{name} fft 2^{log_n}: {native.launches['small_ntt']} launches")
                want = ntt.fft_with_root_plain(x, f, root)
                err = max(err, max_abs_err(y, want))
                check(err == 0, f"{name} fft 2^{log_n} != its plain version")
                check(torch.equal(ntt.ifft(y, f), x), f"{name} ifft(fft(x)) != x at 2^{log_n}")
                ms = cuda_ms(lambda: ntt.fft(x, f), 10)
                # (n / 2) log2 n butterflies of one product, one add and one
                # sub; each value read once and written once
                width = 8 if name == "goldilocks" else 4
                b_ms, b_by = bound(state, 2.0 * width * n,
                                   ops((n // 2 * log_n, SMALL_MUL_OPS[name]),
                                       (n * log_n, SMALL_ADD_OPS[name])))
                # the passes' launches alone, on buffers allocated once
                tables = ntt.twiddle_tables(f, root, log_n, dev)
                cur = x.reshape(f.num_limbs, 1, n)
                out, buf = torch.empty_like(cur), torch.empty_like(cur)
                passes_ms = cuda_ms(lambda: ntt._launch(cur, out, buf, tables, 0, plan), 10)
                # the plan's bytes floor: every pass reads and writes each value
                floor_ms = len(plan) * 2.0 * width * n / HBM_BYTES_PER_S * 1e3
                times[f"{name} fft 2^{log_n}"] = {
                    "ms": passes_ms, "fft_call_ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "share": b_ms / passes_ms, "passes": plan, "plan_bytes_floor_ms": floor_ms,
                    "plan_floor_share": floor_ms / passes_ms,
                    "plain_ms": cuda_ms(lambda: ntt.fft_with_root_plain(x, f, root), 1)}
                del x, y, want, cur, out, buf
                torch.cuda.empty_cache()
        # each pass's grid at the prover's sizes: one row, and the D = 2 and
        # 4 rows of an E vector; every pass on at least one block an SM
        sms = ntt.sm_count(dev)
        grids = {}
        for name in ("goldilocks", "babybear"):
            f, _ = _small(name)
            for log_n in (20, 22):
                for rows in (1, 2, 4):
                    passes = []
                    for s in ntt.plan_for(f, log_n):
                        lc = ntt.small_cols_log(rows, log_n, s, sms)
                        blocks = -(-(rows << (log_n - s)) >> lc)
                        check(blocks >= sms, f"{name} 2^{log_n} x {rows}: a radix-2^{s} pass "
                              f"on {blocks} blocks, fewer than the card's {sms} SMs")
                        passes.append({"radix_log": s, "cols_log": lc, "blocks": blocks,
                                       **_small_info("lw_small_ntt_info", f.ops.kernel_id, s,
                                                     lc)})
                    grids[f"{name} 2^{log_n} x {rows}"] = passes
        t = times["goldilocks fft 2^22"]
        rec["small_ntt"].update(max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
                                share=t["share"], plan_bytes_floor_ms=t["plan_bytes_floor_ms"],
                                plan_floor_share=t["plan_floor_share"],
                                fft_call_ms=t["fft_call_ms"],
                                shape=f"Goldilocks fft 2^22, passes {t['passes']} (their "
                                      "launches alone)",
                                passes=grids["goldilocks 2^22 x 1"])
        state["small_ntt"] = {**times, "grids": grids}
        return (f"{checked} passes bitwise equal to ntt_pass_plain (2^1 .. 2^22 x 1/2/4 rows, "
                "forward and inverse root, both fields; the fft's plan, and up to 2^14 radix "
                "2^8 and radix <= 2^3); fft = CPU path up to 2^14; fft = plain fft and ifft round "
                "trips at 2^22 (and 2^24 BabyBear); " + json.dumps(state["small_ntt"]))
    run_ntt()


def _grind_seed(i: int) -> bytes:
    import numpy as np

    return np.random.default_rng(1000 + i).bytes(32)


def _grind_phase(state, dev) -> dict:
    """The nonce search (kernel 5) against its plain version on the card and
    the host loop ``lw_grind``: 8 seeds at factors 8-20 in the prover's
    batches, each search's launches (one per batch up to the hit), and a
    first hit in a later batch (batches of 2^10 at factor 16).  Then the
    searches at ``GRIND_TIMED_FACTOR`` timed (CUDA events around the whole
    search, host reads included) against the host loop, by batch size, and
    one full batch of each size (factor 64: no hit)."""
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.provers.stark import grinding
    from lambda_elliptic_curves_tpu_torch.tools._timing import cuda_ms

    B, rounds = grinding.GRIND_BATCH, grinding.MAX_TRIES // grinding.GRIND_BATCH
    cases, err = [], 0
    for i, factor in enumerate(GRIND_FACTORS):
        seed = _grind_seed(i)
        native.launches["grind"] = 0
        got = grinding.search_nonce_device(seed, factor, B, rounds, dev)
        launches = native.launches["grind"]
        plain = grinding.search_nonce_plain(seed, factor, 1 << GRIND_PLAIN_BATCH_LOG,
                                            grinding.MAX_TRIES >> GRIND_PLAIN_BATCH_LOG, dev)
        t0 = time.perf_counter()
        host = grinding.generate_nonce(seed, factor)
        host_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, abs(got - plain), abs(got - host))
        check(got == plain == host, f"nonce search at factor {factor}: kernel {got}, plain "
              f"{plain}, lw_grind {host}")
        check(launches == got // B + 1, f"the search for {got} launched {launches} batches")
        check(grinding.is_valid_nonce(seed, got, factor)
              and native.grind(grinding._inner_hash(seed, factor), factor, 0, got) == -1,
              f"nonce {got} is not the least valid one")
        cases.append({"seed": i, "factor": factor, "nonce": got, "launches": launches,
                      "lw_grind_ms": round(host_ms, 3)})
    seed = _grind_seed(100)
    native.launches["grind"] = 0
    got = grinding.search_nonce_device(seed, 16, 1 << 10, 1 << 22, dev)
    launches = native.launches["grind"]
    check(got >= 1 << 10 and launches == (got >> 10) + 1 and got == grinding.generate_nonce(
        seed, 16), f"later-batch search: nonce {got} in {launches} batches of 2^10")
    later = {"factor": 16, "batch": 1 << 10, "nonce": got, "launches": launches}

    # the timed factor: the whole search in the prover's batches, its plain
    # version and the host loop; the bound counts the hashes that show the
    # nonce is the least, nonce + 1 permutations
    timed, tf = [], GRIND_TIMED_FACTOR
    for c in cases:
        if c["factor"] != tf:
            continue
        s = _grind_seed(c["seed"])
        ms = cuda_ms(lambda: grinding.search_nonce_device(s, tf, B, rounds, dev), 10)
        b_ms, b_by = bound(state, 40.0, ops((c["nonce"] + 1, KECCAK_F_OPS)))
        timed.append({**c, "ms": ms, "bound_ms": b_ms, "bound_by": b_by})
    first = timed[0]
    s = _grind_seed(first["seed"])
    plain_ms = cuda_ms(lambda: grinding.search_nonce_plain(s, tf, B, rounds, dev), 1)
    by_batch, full = {}, {}
    for log_b in GRIND_BATCH_LOGS:
        by_batch[f"2^{log_b}"] = [cuda_ms(lambda: grinding.search_nonce_device(
            _grind_seed(c["seed"]), tf, 1 << log_b, grinding.MAX_TRIES >> log_b, dev), 5)
            for c in timed]
        inner = grinding._inner_hash(s, 64)
        full_ms = cuda_ms(lambda: grinding.grind_batch(inner, 64, 0, 1 << log_b, dev), 20)
        full[f"2^{log_b}"] = {"ms": full_ms, "hashes_per_s": (1 << log_b) / full_ms * 1e3,
                              "bound_ms": bound(state, 40.0,
                                                ops((1 << log_b, KECCAK_F_OPS)))[0]}
    state["kernels"]["grind"].update(
        max_abs_err=err, ms=first["ms"], plain_ms=plain_ms, bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], library_ms=None,
        shape=f"search_nonce_device at factor {tf} in batches of 2^{B.bit_length() - 1}, "
              f"nonce {first['nonce']}")
    return {"cases": cases, "later_batch": later, f"factor_{tf}": timed,
            f"factor_{tf}_plain_ms": plain_ms, "by_batch": by_batch, "full_batch_ms": full}


def _eval_at(f, coeffs, x: int) -> int:
    """p(x) by even/odd folding on the card: p(x) = e(x^2) + x*o(x^2)."""
    out = coeffs
    while out.shape[-1] > 1:
        xc = f.constant(x, (1,), out.device)
        out = f.add(out[..., 0::2], f.mul(xc, out[..., 1::2]))
        x = x * x % f.p
    return int(f.to_ints(out)[0])


def _fib(rows, dev, f=None, degree: int = 1):
    """The Fibonacci AIR over ``f`` (Stark252 by default) with challenges in
    its degree-``degree`` tower, its trace of ``rows`` on ``dev``, and its
    public inputs."""
    from lambda_elliptic_curves_tpu_torch.fields import Stark252
    from lambda_elliptic_curves_tpu_torch.provers.stark.examples.fibonacci import (
        FibonacciPublicInputs, fibonacci_air_for, fibonacci_trace,
    )
    f = f or Stark252
    return (fibonacci_air_for(f, degree), fibonacci_trace(f, [1, 1], rows, dev),
            FibonacciPublicInputs(a0=1, a1=1))


def _prove_verify(rows, dev, options, f=None, degree: int = 1):
    import torch
    from lambda_elliptic_curves_tpu_torch.fields import Stark252
    from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
    from lambda_elliptic_curves_tpu_torch.provers.stark import prove, verify

    f = f or Stark252
    air, trace, pub = _fib(rows, dev, f, degree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = prove(air, trace, pub, options, DefaultTranscript(f), device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    ok = verify(air, proof, pub, options, DefaultTranscript(f))
    return proof, ms, ok


def phase_fixture(state):
    import torch
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions, verify
    from lambda_elliptic_curves_tpu_torch.utils.serialization import serialize_proof

    @phase("3 fib 2^10 vs JAX proof")
    def run():
        opts = ProofOptions(4, 32, 3, 0)
        proof, ms, ok = _prove_verify(1 << 10, torch.device("cuda"), opts)
        with open(FIXTURE, "rb") as fh:
            want = fh.read()
        check(serialize_proof(proof) == want,
              "2^10 proof differs from the JAX package's fixture")
        check(ok, "verify rejected the 2^10 proof")
        air, _, pub = _fib(1 << 10, "cpu")
        proof.fri_last_value = (proof.fri_last_value + 1) % f.p
        check(not verify(air, proof, pub, opts, DefaultTranscript(f)),
              "verify accepted a proof with fri_last_value + 1")
        return f"serialize_proof byte-equal to the fixture ({len(want)} B), verify ok, tamper rejected"
    run()

    @phase("3b example AIRs vs JAX proofs")
    def run_examples():
        from lambda_elliptic_curves_tpu_torch.provers.stark import prove
        from lambda_elliptic_curves_tpu_torch.provers.stark.examples.catalog import CASES

        dev, done = torch.device("cuda"), []
        for name, make in CASES.items():
            air, trace, pub, opts = make(dev)
            proof = prove(air, trace, pub, opts, DefaultTranscript(f), device=dev)
            with open(os.path.join(FIXTURES, f"jax_stark_{name}_proof.json"), "rb") as fh:
                check(serialize_proof(proof) == fh.read(),
                      f"the {name} proof differs from the JAX package's")
            check(verify(air, proof, pub, opts, DefaultTranscript(f)),
                  f"verify rejected the {name} proof")
            done.append(name if proof.nonce is None else f"{name} (nonce {proof.nonce})")
        return f"{len(done)} proofs byte-equal to the JAX package's and verified: {done}"
    run_examples()

    @phase("3c Stone cases vs JAX bytes")
    def run_stone():
        from lambda_elliptic_curves_tpu_torch.fiat_shamir import StoneProverTranscript
        from lambda_elliptic_curves_tpu_torch.provers.stark import prove
        from lambda_elliptic_curves_tpu_torch.provers.stark.examples.catalog import stone_case
        from lambda_elliptic_curves_tpu_torch.provers.stark.stone_serializer import (
            get_fri_query_indexes, serialize_proof_stone,
        )

        dev, out = torch.device("cuda"), []
        # the reference's recorded trace commitments and query indexes
        recorded = {1: ("0eb9dcc0fb1854572a01236753ce05139d392aa3aeafe72abff150fe21175594", [1]),
                    2: ("6d31dd00038974bde5fe0c5e3a765f8ddc822a5df3254fca85a1950ae0208cbe",
                        [4239])}
        for case, (root, iotas) in recorded.items():
            air, trace, pub, opts, seed = stone_case(case, dev)
            proof = prove(air, trace, pub, opts, StoneProverTranscript(seed), device=dev)
            data = serialize_proof_stone(air, proof, pub, opts, seed)
            with open(os.path.join(FIXTURES, f"jax_stone_case{case}.bin"), "rb") as fh:
                check(data == fh.read(), f"Stone case {case} bytes differ from the JAX package's")
            check(proof.lde_trace_main_merkle_root.hex() == root
                  and get_fri_query_indexes(air, proof, pub, opts, seed) == iotas,
                  f"Stone case {case} differs from the recorded vectors")
            check(verify(air, proof, pub, opts, StoneProverTranscript(seed)),
                  f"verify rejected Stone case {case}")
            out.append(f"case {case}: {len(data)} B")
        return "serialize_proof_stone byte-equal to the JAX bytes, recorded root and iota: " + \
            ", ".join(out)
    run_stone()

    @phase("3d small-field proofs vs JAX proofs")
    def run_extension():
        from lambda_elliptic_curves_tpu_torch.provers.stark import prove
        from lambda_elliptic_curves_tpu_torch.provers.stark.examples.catalog import (
            EXTENSION_CASES,
        )
        from lambda_elliptic_curves_tpu_torch.utils.serialization import deserialize_proof

        dev, done = torch.device("cuda"), []
        for name, make in EXTENSION_CASES.items():
            air, trace, pub, opts, field = make(dev)
            proof = prove(air, trace, pub, opts, DefaultTranscript(field), device=dev)
            with open(os.path.join(FIXTURES, f"jax_stark_ext_{name}_proof.json"), "rb") as fh:
                want = fh.read()
            check(serialize_proof(proof) == want, f"the {name} proof differs from the JAX package's")
            check(verify(air, proof, pub, opts, DefaultTranscript(field)),
                  f"verify rejected the card's {name} proof")
            check(verify(air, deserialize_proof(want), pub, opts, DefaultTranscript(field)),
                  f"verify rejected the JAX package's {name} proof")
            done.append(name)
        return (f"{len(done)} proofs byte-equal to the JAX package's, the card's and the JAX "
                f"proofs verified: {done}")
    run_extension()


def phase_bench(state):
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions
    from lambda_elliptic_curves_tpu_torch.provers.stark import prover as prover_mod

    opts = ProofOptions(4, 32, 3, 0)
    dev = torch.device("cuda")

    @phase("4 stark_fib_prove_2^16")
    def run():
        _prove_verify(1 << 16, dev, opts)  # warm-up
        for name in native.launches:
            native.launches[name] = 0
        proof, ms, ok = _prove_verify(1 << 16, dev, opts)
        state["launches"] = dict(native.launches)
        check(ok, "verify rejected the 2^16 proof")
        phases = {k: round(v * 1000.0, 3) for k, v in prover_mod.last_timings.items()}
        state["prove_16"] = {"ms": ms, "phases_ms": phases}
        return json.dumps({"metric": "stark_fib_prove_2^16", "value": round(ms, 3),
                           "unit": "ms", "check": "ok", "phases_ms": phases})
    run()


def phase_big(state):
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.poly import ntt
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions
    from lambda_elliptic_curves_tpu_torch.provers.stark import prover as prover_mod
    from lambda_elliptic_curves_tpu_torch.tools._timing import cache_bytes

    @phase("5 stark_fib_prove_2^20")
    def run():
        dev, opts = torch.device("cuda"), ProofOptions(4, 32, 3, 0)
        _, first_ms, ok = _prove_verify(1 << 20, dev, opts)  # builds the twiddle tables
        check(ok, "verify rejected the first 2^20 proof")
        cached = cache_bytes(ntt)
        torch.cuda.reset_peak_memory_stats()
        for name in native.launches:
            native.launches[name] = 0
        proof, ms, ok = _prove_verify(1 << 20, dev, opts)
        state["launches_20"] = dict(native.launches)
        check(ok, "verify rejected the 2^20 proof")
        phases = {k: round(v * 1000.0, 3) for k, v in prover_mod.last_timings.items()}
        state["prove_20"] = {"ms": ms, "first_ms": first_ms, "phases_ms": phases,
                             "cached_bytes": cached}
        return json.dumps({"metric": "stark_fib_prove_2^20", "value": round(ms, 3),
                           "unit": "ms", "check": "ok", "first_prove_ms": round(first_ms, 3),
                           "phases_ms": phases, "cached_bytes_after_first_prove": cached,
                           "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
    run()

    @phase("5b stark_fib_prove_2^20 at CONJECTURABLE_128")
    def run_preset():
        from lambda_elliptic_curves_tpu_torch.provers.stark import SecurityLevel

        dev = torch.device("cuda")
        opts = ProofOptions.new_secure(SecurityLevel.CONJECTURABLE_128)
        for name in native.launches:
            native.launches[name] = 0
        proof, ms, ok = _prove_verify(1 << 20, dev, opts)
        state["launches_preset"] = dict(native.launches)
        check(ok, "verify rejected the 2^20 proof at CONJECTURABLE_128")
        _check_least_nonce(proof, opts)
        phases = {k: round(v * 1000.0, 3) for k, v in prover_mod.last_timings.items()}
        state["prove_preset"] = {"ms": ms, "options": list(vars(opts).values()),
                                 "nonce": proof.nonce, "phases_ms": phases}
        return json.dumps({"metric": "stark_fib_prove_2^20_conjecturable_128",
                           "value": round(ms, 3), "unit": "ms", "check": "ok",
                           "nonce": proof.nonce, "phases_ms": phases})
    run_preset()

    @phase("5c every security preset at 2^6 rows")
    def run_levels():
        from lambda_elliptic_curves_tpu_torch.provers.stark import SecurityLevel

        dev, out = torch.device("cuda"), {}
        for level in SecurityLevel:
            opts = ProofOptions.new_secure(level)
            native.launches["grind"] = 0
            proof, _, ok = _prove_verify(1 << 6, dev, opts)
            check(ok and native.launches["grind"] >= 1,
                  f"{level.name}: verify {ok}, {native.launches['grind']} search launches")
            _check_least_nonce(proof, opts)
            out[level.name] = proof.nonce
        return "proved, verified, least nonce: " + json.dumps(out)
    run_levels()


def phase_small_proves(state):
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.fields.extensions import (
        flat_components, nest_components,
    )
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions
    from lambda_elliptic_curves_tpu_torch.provers.stark import prover as prover_mod

    dev, opts = torch.device("cuda"), ProofOptions(4, 32, 3, 0)
    for i, (name, (field_name, degree)) in enumerate(SMALL_PROVES.items()):
        @phase(f"5{'de'[i]} stark_fib_prove_2^20_{name}")
        def run():
            f, _ = _small(field_name)
            _, first_ms, ok = _prove_verify(1 << 20, dev, opts, f, degree)
            check(ok, f"verify rejected the first 2^20 {name} proof")
            torch.cuda.reset_peak_memory_stats()
            for k in native.launches:
                native.launches[k] = 0
            proof, ms, ok = _prove_verify(1 << 20, dev, opts, f, degree)
            state[f"launches_{name}"] = dict(native.launches)
            check(ok, f"verify rejected the 2^20 {name} proof")
            v = proof.fri_last_value
            check(isinstance(v, tuple) and nest_components(flat_components(v, degree), degree) == v,
                  f"the {name} proof's last FRI value is not in the degree-{degree} tower")
            phases = {k: round(v * 1000.0, 3) for k, v in prover_mod.last_timings.items()}
            state[f"prove_{name}"] = {"ms": ms, "first_ms": first_ms, "phases_ms": phases}
            return json.dumps({"metric": f"stark_fib_prove_2^20_{name}", "value": round(ms, 3),
                               "unit": "ms", "check": "ok", "first_prove_ms": round(first_ms, 3),
                               "phases_ms": phases, "launches": state[f"launches_{name}"],
                               "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30,
                                                     3)})
        run()


# ---------------------------------------------------------------------------
# BN254: kernel 1 over Fr, kernels 8 and 9, MSM and Plonk with KZG

def _dense_fields(curve):
    from lambda_elliptic_curves_tpu_torch import fields as F

    return ({"fr": F.BN254Fr, "fq": F.BN254Field} if curve == "bn254"
            else {"fr": F.BLS12377Fr, "fq": F.BLS12377Field})


def _bn254(name):
    return _dense_fields("bn254")[name]


def _random_dense(f, n: int, gen, edge_copies: int = 1):
    """(L, n) int32 limbs of canonical values of ``f`` (each a Montgomery
    form) drawn uniformly from [0, p) on the card: L uniform 32-bit limbs,
    the top one cut to p's top limb's bit length, drawn again while at or
    above p.  The raw edge values 0, 1, p - 1, p - 2 come first,
    ``edge_copies`` times over, so that two operands drawn here meet edge
    against edge (and, with a second copy, edge against random)."""
    import torch

    L = f.num_limbs
    p_limbs = [(f.p >> (32 * k)) & 0xFFFFFFFF for k in range(L)]
    top_mask = (1 << p_limbs[L - 1].bit_length()) - 1

    def draw(m):
        v = torch.randint(0, 1 << 32, (L, m), generator=gen, device=gen.device,
                          dtype=torch.int64)
        v[L - 1] &= top_mask
        return v

    v = draw(n)
    while True:
        below = torch.zeros(n, dtype=torch.bool, device=v.device)
        equal = torch.ones(n, dtype=torch.bool, device=v.device)
        for k in reversed(range(L)):
            below |= equal & (v[k] < p_limbs[k])
            equal &= v[k] == p_limbs[k]
        if bool(below.all()):
            break
        v[:, ~below] = draw(int((~below).sum()))
    edges = [x for _ in range(edge_copies) for x in (0, 1, f.p - 1, f.p - 2)][:n]
    v[:, :len(edges)] = torch.tensor([[(x >> (32 * k)) & 0xFFFFFFFF for x in edges]
                                      for k in range(L)], device=v.device)
    return v.to(torch.int32)  # the low 32 bits of each limb


def _dense_bound(state, n: int, muls: int, adds: int = 0, values: int = 3, words: int = 4):
    """``values`` values of 8 ``words`` bytes per element moved, ``muls``
    dense products and ``adds`` sums on ``words`` 64-bit words."""
    mul_ops, add_ops = (DENSE_MUL_OPS, DENSE_ADD_OPS) if words == 4 else (DENSE6_MUL_OPS,
                                                                          DENSE6_ADD_OPS)
    return bound(state, 8.0 * words * values * n, ops((muls, mul_ops), (adds, add_ops)))


#: Plonk's round-3 quotient's evaluations and constants
#: (provers/plonk/prover.py's quotient_evaluations)
QUOTIENT_EVALS = ("a", "b", "c", "ql", "qr", "qm", "qo", "qc", "pi", "x", "z", "zw", "s1", "s2",
                  "s3", "l1", "zh_inv")
QUOTIENT_CONSTS = ("beta", "gamma", "k1", "k2", "alpha", "one")


def _sass_field(f) -> str:
    """The field whose dense32.cuh SASS (tools/dense_mul.py) counts ``f``'s
    product: its own, BN254 Fq at BN254 Fr's (same width, the tool builds
    no BN254 Fq product)."""
    return {"bn254_scalar": "bn254_fr", "bn254_base": "bn254_fr",
            "bls12_377_scalar": "bls12_377_fr", "bls12_377_base": "bls12_377_fq"}[f.ops.name]


def _dense_op_times(state, f, n: int, ms: float, muls: int, adds: int = 0,
                    values: int = 3) -> dict:
    """A kernel 8 or 9 reading ``ms`` against its bounds: the larger of
    ``values`` values of n elements moved and ``muls`` products and ``adds``
    sums at dense32.cuh's SASS (a sum half a butterfly), and beside it the
    fixed count (490 / 1071 instructions a product, 48 / 72 a sum)."""
    from lambda_elliptic_curves_tpu_torch.tools import dense_mul

    key = f"{_sass_field(f)} {dense_mul.VARIANTS[1]}"
    prod = dense_mul.sass_ops(state["dense_mul_sass"][key])
    half = tuple(v / 2 for v in dense_mul.sass_ops(state["dense_mul_sass"][key + " butterfly"]))
    b_ms, b_by = bound(state, 4.0 * f.num_limbs * values * n, ops((muls, prod), (adds, half)))
    fixed_ms, _ = _dense_bound(state, n, muls, adds, values=values, words=f.ops.WORDS)
    return {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
            "fixed_bound_ms": fixed_ms, "fixed_share": fixed_ms / ms,
            "counts": f"{values} values of {4 * f.num_limbs} B an element; {muls} products at "
                      f"{prod} and {adds} sums at {half} (multiply-adds, logic, other; "
                      f"dense32.cuh's SASS, a sum half a butterfly)"}


def _program_launch(f, ch, out):
    """A closure that launches ``ch``'s program into ``out`` through the C
    entry alone (its arguments built once)."""
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.ops import dense

    L, n = f.num_limbs, out[0].numel()
    batch = tuple(out.shape[1:])
    ops_, dst, src_a, src_b, out_slot = dense._schedule(ch.steps_encoded(), len(ch.inputs))
    operands = [f.ops._operand(t, L, batch, n) for t in ch.inputs]
    k, m = len(operands), len(ops_)
    u8 = lambda v: (ctypes.c_uint8 * m)(*v)  # noqa: E731
    args = (f.ops.kernel_id, k, (ctypes.c_void_p * k)(*[t.data_ptr() for t, _, _ in operands]),
            (ctypes.c_long * k)(*[ls for _, ls, _ in operands]),
            (ctypes.c_long * k)(*[es for _, _, es in operands]), m, u8(ops_), u8(dst),
            u8(src_a), u8(src_b), out_slot, out.data_ptr(), n)
    lib = native.cuda_lib()

    def launch():
        rc = lib.lw_dense_field_program(*args, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"lw_dense_field_program: CUDA error {rc}")
    launch.operands = operands  # the tensors whose pointers args holds
    return launch


#: phases 2i / 2j (BN254, the Plonk slice) and 2k / 2l (BLS12-377, the
#: Groth16 slice): their names, the fft sizes timed, the shapes that the
#: kernels line reports (field, log2 n, what the shape is), and the rows a
#: transform of the prover takes beyond one (log2 n -> rows)
DENSE_CURVES = {
    "bn254": {"ops_phase": "2i bn254 field ops and batch inversion", "ntt_phase": "2j bn254 ntt",
              "fft_logs": (16, 18, 22), "fft_line": (18, "Plonk's 4n"), "prove_rows": {},
              "mul_line": ("fr", 18, "BN254 Fr mul, 2^18 elements (Plonk's round-3 quotient "
                           "at 4n, 2^16 gates)"),
              "inv_line": ("fr", 18, "BN254 Fr, 2^18 elements (Plonk's 4n at 2^16 gates)"),
              "program_line": ("plonk quotient 2^18", "Plonk's round-3 quotient over BN254 Fr "
                               "at 4n = 2^18 (2^16 gates): 42 steps over 17 planes and 6 "
                               "constants")},
    "bls12_377": {"ops_phase": "2k bls12_377 field ops and batch inversion",
                  "ntt_phase": "2l bls12_377 ntt", "fft_logs": (16, 17, 18, 22),
                  "fft_line": (17, "Groth16's 2n at 2^16 constraints"),
                  # the QAP transforms A w, B w and C w at once: 3 rows at n
                  # and 2n for 2^16 constraints
                  "prove_rows": {16: 3, 17: 3},
                  "mul_line": ("fr", 18, "BLS12-377 Fr mul, 2^18 elements (about the QAP's "
                               "3 x 2^17 at 2^16 constraints)"),
                  "inv_line": ("fq", 18, "BLS12-377 Fq (six words), 2^18 elements (Groth16 "
                               "setup's affine G1 points at 2^16 constraints: 2^18.3)"),
                  "program_line": ("groth16 h 2^17", "Groth16's h = (l r - o) / t over "
                                   "BLS12-377 Fr at 2n = 2^17 (2^16 constraints): 3 steps")},
}


def phase_dense_kernels(state, curve):
    """Kernels 8 and 9 over ``curve``'s Fr and Fq, and kernel 1 over its Fr,
    against their plain versions, timed against their bounds."""
    import ctypes

    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.poly import ntt
    from lambda_elliptic_curves_tpu_torch.tools._timing import cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11 if curve == "bn254" else 12)
    rec = state["kernels"]
    cfg, fields = DENSE_CURVES[curve], _dense_fields(curve)
    suffix = "" if curve == "bn254" else "_" + curve
    label = {"bn254": "BN254", "bls12_377": "BLS12-377"}[curve]

    @phase(cfg["ops_phase"])
    def run_ops():
        from lambda_elliptic_curves_tpu_torch.provers.plonk.prover import quotient_evaluations
        from lambda_elliptic_curves_tpu_torch.tools import dense_mul

        if "dense_mul_sass" not in state:
            state["dense_mul_sass"] = dense_mul.sass_counts()
        lib = native.cuda_lib()
        stream = torch.cuda.current_stream().cuda_stream
        no_exponent = (ctypes.c_uint32 * 12)()
        err, checked, times = 0, 0, {}
        for name in ("fr", "fq"):
            f = fields[name]
            words = f.ops.WORDS
            plain = f.plain()
            for log_n in (18, 22):
                n = 1 << log_n
                a, b = _random_dense(f, n, gen), _random_dense(f, n, gen, edge_copies=2)
                c = b[:, 9:10].contiguous()
                inv_in = a.clone()
                inv_in[:, ::1009] = 0
                cases = {
                    "add": (f.add(a, b), plain.add(a, b)),
                    "sub": (f.sub(a, b), plain.sub(a, b)),
                    "neg": (f.neg(a), plain.neg(a)),
                    "mul": (f.mul(a, b), plain.mul(a, b)),
                    "mul by one value": (f.mul(a, c), plain.mul(a, c)),
                    "one value times": (f.mul(c, a), plain.mul(c, a)),
                    "square": (f.square(a), plain.square(a)),
                    "pow 65537": (f.pow(a, 65537), plain.pow(a, 65537)),
                    "batch_inverse": (f.batch_inverse(inv_in), plain.batch_inverse(inv_in)),
                }
                for op, (got, want) in cases.items():
                    err = max(err, max_abs_err(got, want))
                    check(err == 0, f"{label} {name} kernel != plain: {op} at 2^{log_n}")
                    checked += 1
                del cases
                native.launches[f.ops.inv_counter] = 0
                f.batch_inverse(inv_in)
                launches = native.launches[f.ops.inv_counter]
                check(launches == 1, f"{label} {name} batch inversion at 2^{log_n}: "
                      f"{launches} launches, not 1")
                del a, b, c, inv_in
                torch.cuda.empty_cache()
            # the launches alone (outputs allocated once, the C entries in a
            # loop) at the provers' sizes and 2^22, whole calls beside
            info = (ctypes.c_int * 7)()
            for log_n in (16, 17, 18, 22):
                n = 1 << log_n
                a, b = _random_dense(f, n, gen), _random_dense(f, n, gen, edge_copies=2)
                out = torch.empty_like(a)
                reps = 20 if log_n < 22 else 10
                for op, code, call in (("mul", 2, f.mul), ("add", 0, f.add)):
                    def launch(code=code):
                        rc = lib.lw_dense_field_op(f.ops.kernel_id, code, a.data_ptr(), n, 1,
                                                   b.data_ptr(), n, 1, out.data_ptr(), n,
                                                   no_exponent, 0, stream)
                        check(rc == 0, f"lw_dense_field_op: CUDA error {rc}")
                    ms = cuda_ms(launch, reps)
                    t = _dense_op_times(state, f, n, ms, muls=n if op == "mul" else 0,
                                        adds=0 if op == "mul" else n, values=3)
                    t["call_ms"] = cuda_ms(lambda call=call: call(a, b), reps)
                    if log_n in (18, 22):
                        t["plain_ms"] = cuda_ms(lambda: (plain.mul if op == "mul"
                                                         else plain.add)(a, b), 2)
                    times[f"{name} {op} 2^{log_n}"] = t
                inv_in = a.clone()
                inv_in[:, ::1009] = 0
                nonzero = int((inv_in != 0).any(dim=0).sum().item())

                def invert():
                    rc = lib.lw_dense_inverse(f.ops.kernel_id, inv_in.data_ptr(), out.data_ptr(),
                                              n, stream)
                    check(rc == 0, f"lw_dense_inverse: CUDA error {rc}")
                ms = cuda_ms(invert, reps)
                check(lib.lw_dense_inverse_info(f.ops.kernel_id, n, info) == 0,
                      "lw_dense_inverse_info failed")
                t = _dense_op_times(state, f, n, ms, muls=3 * nonzero, values=2)
                t.update(call_ms=cuda_ms(lambda: f.batch_inverse(inv_in), reps), launches=1,
                         tile=dict(zip(("threads", "k", "rounds", "blocks", "blocks_per_sm",
                                        "registers", "local_bytes"), info)))
                if log_n == 18:
                    t["plain_ms"] = cuda_ms(lambda: plain.batch_inverse(inv_in), 1)
                times[f"{name} batch_inverse 2^{log_n}"] = t
                del a, b, out, inv_in
                torch.cuda.empty_cache()
            # one element: one block, one inversion (its latency)
            one = _random_dense(f, 8, gen)[:, 5:6].contiguous()
            times[f"{name} batch_inverse 1 element"] = {
                "call_ms": cuda_ms(lambda: f.batch_inverse(one), 20)}
        # spot checks against host ints
        for name in ("fr", "fq"):
            f = fields[name]
            a, b = _random_dense(f, 64, gen), _random_dense(f, 64, gen, edge_copies=2)
            av, bv = f.to_ints(a), f.to_ints(b)
            check([int(v) for v in f.to_ints(f.mul(a, b))]
                  == [int(x) * int(y) % f.p for x, y in zip(av, bv)], f"{name} mul != host ints")
            check([int(v) for v in f.to_ints(f.batch_inverse(a))]
                  == [pow(int(x), -1, f.p) if x else 0 for x in av], f"{name} inverse != host")
        # kernel 8's programs at the provers' shapes against program_plain:
        # Plonk's round-3 quotient at 4n = 2^18 (BN254), Groth16's t and h
        # at 2n = 2^17 (BLS12-377, l, r and o rows of one tensor)
        f = fields["fr"]
        programs = {}
        if curve == "bn254":
            n = 1 << 18
            ch = f.ops.chain()
            e = {k: ch.input(_random_dense(f, n, gen)) for k in QUOTIENT_EVALS}
            cst = {k: ch.input(_random_dense(f, 8, gen)[:, 5:6].contiguous())
                   for k in QUOTIENT_CONSTS}
            programs["plonk quotient 2^18"] = (ch, quotient_evaluations(ch, e, cst), n)
        else:
            n = 1 << 17
            ch = f.ops.chain()
            ch.sub(ch.mul(ch.input(_random_dense(f, n, gen)),
                          ch.input(_random_dense(f, 8, gen)[:, 5:6].contiguous())),
                   ch.input(f.ones((1,), dev)))
            programs["groth16 t 2^17"] = (ch, ("step", 1), n)
            lrc = _random_dense(f, 3 * n, gen).reshape(f.num_limbs, 3, n)
            ch = f.ops.chain()
            h = ch.mul(ch.sub(ch.mul(ch.input(lrc[:, 0]), ch.input(lrc[:, 1])),
                              ch.input(lrc[:, 2])), ch.input(_random_dense(f, n, gen)))
            programs["groth16 h 2^17"] = (ch, h, n)
        for what, (ch, handle, n) in programs.items():
            native.launches.update({k: 0 for k in native.launches})
            got = ch.run(handle)
            check(native.launches[f.ops.program_counter] == 1
                  and sum(native.launches.values()) == 1, f"{label} {what}: not one launch")
            err = max(err, max_abs_err(got, f.ops.program_plain(ch.steps_encoded(), ch.inputs)))
            check(err == 0, f"{label} {what}: program != program_plain")
            checked += 1
            launch = _program_launch(f, ch, got)
            steps = [op for op, _, _ in ch.steps]
            planes = sum(1 for t in ch.inputs if t[0].numel() > 1)
            t = _dense_op_times(state, f, n, cuda_ms(launch, 20),
                                muls=n * sum(op in ("mul", "square") for op in steps),
                                adds=n * sum(op in ("add", "sub", "neg") for op in steps),
                                values=planes + 1)
            t.update(call_ms=cuda_ms(lambda: ch.run(handle), 20), steps=len(steps),
                     input_planes=planes, inputs=len(ch.inputs),
                     plain_ms=cuda_ms(lambda: f.ops.program_plain(ch.steps_encoded(),
                                                                  ch.inputs), 1))
            times[what] = t
        del programs, ch
        # the kernels line: kernel 8 at its main-path shape, kernel 9 at the
        # inversion of its main path, the program of its main path
        sass = {k + (what or " product"): state["dense_mul_sass"].get(
            f"{_sass_field(fields[k])} {dense_mul.VARIANTS[1]}{what}", {}).get("instructions")
            for k in ("fr", "fq") for what in ("", " butterfly")}
        name, log_n, shape = cfg["mul_line"]
        t = times[f"{name} mul 2^{log_n}"]
        rec["dense_field" + suffix].update(
            max_abs_err=err, ms=t["ms"], ms_what="the launches alone (lw_dense_field_op)",
            call_ms=t["call_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], share=t["share"], fixed_bound_ms=t["fixed_bound_ms"],
            library_ms=None, shape=shape, sass_instructions=sass, bound_counts=t["counts"])
        name, log_n, shape = cfg["inv_line"]
        t = times[f"{name} batch_inverse 2^{log_n}"]
        rec["dense_inv" + suffix].update(
            max_abs_err=err, ms=t["ms"], ms_what="the launch alone (lw_dense_inverse)",
            call_ms=t["call_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], share=t["share"], fixed_bound_ms=t["fixed_bound_ms"],
            library_ms=None, shape=shape, sass_instructions=sass, bound_counts=t["counts"],
            tile=t["tile"])
        what, shape = cfg["program_line"]
        t = times[what]
        rec["dense_program" + suffix].update(
            max_abs_err=err, ms=t["ms"], ms_what="the launch alone (lw_dense_field_program)",
            call_ms=t["call_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], share=t["share"], fixed_bound_ms=t["fixed_bound_ms"],
            library_ms=None, shape=shape, sass_instructions=sass, bound_counts=t["counts"],
            steps=t["steps"], input_planes=t["input_planes"])
        state[f"{curve}_field"] = times
        torch.cuda.empty_cache()
        return (f"{checked} ops, inversions and programs bitwise equal to plain (ops at 2^18 "
                f"and 2^22, Fr and Fq; kernel 9 one launch a call); " + json.dumps(times))
    run_ops()

    @phase(cfg["ntt_phase"])
    def run_ntt():
        # every pass of every size 2^1 .. 2^20 over Fr at one row, forward
        # and inverse root, bitwise against ntt_pass_plain; up to 2^14 also
        # at 2 rows and radices of at most 2^3, and at the prover's own row
        # counts (prove_rows); the fft at the kernels line's size and at the
        # prover's row counts against the plain transform; fft times
        # against the bound
        from lambda_elliptic_curves_tpu_torch.tools import dense_mul

        f = fields["fr"]
        prove_rows = cfg["prove_rows"]
        counter = f.ops.ntt_counter
        err, checked, times = 0, 0, {}
        # the pass's product (dense32.cuh) against dense.cuh's CIOS product,
        # 2^20 random pairs and the edge values each against each, over Fr
        # (and BLS12-377 Fq on six words)
        products = {}
        for name in (("fr",) if curve == "bn254" else ("fr", "fq")):
            got = dense_mul.check(fields[name].ops.kernel_id)
            check(got["pairs"] > 1 << 20 and all(v == 0 for k, v in got.items() if k != "pairs"),
                  f"{label} {name}: dense32.cuh's product != dense.cuh's: {got}")
            products[name] = got
        # each pass's grid at the provers' sizes: blocks, threads, registers,
        # spilled bytes and the blocks an SM holds (the occupancy calculator)
        grids, info = {}, (ctypes.c_int * 4)()
        for log_n, rows in [(16, 1), (17, 1), (18, 1)] + sorted(prove_rows.items()):
            passes = []
            for s in ntt.dense_pass_plan(log_n):
                lc = ntt.dense_cols_log(rows, log_n, s, ntt.sm_count(dev))
                rc = native.cuda_lib().lw_dense_ntt_info(f.ops.kernel_id, s, lc, info)
                check(rc == 0, f"lw_dense_ntt_info: CUDA error {rc}")
                blocks = -(-(rows << (log_n - s)) >> lc)
                check(blocks >= 132, f"{label} 2^{log_n} x {rows}: a pass of {blocks} blocks")
                passes.append({"radix": s, "cols_log": lc, "blocks": blocks, "threads": info[0],
                               "blocks_per_sm": info[1], "registers": info[2],
                               "local_bytes": info[3],
                               "warps_per_sm": info[1] * -(-info[0] // 32)})
            grids[f"2^{log_n} x {rows}"] = passes
        # the bound's instruction counts: the fixed count (DENSE_MUL_OPS and
        # two DENSE_ADD_OPS a butterfly, as since the first version), and
        # the fewest a product and a butterfly are known to need (this
        # build's dense32.cuh SASS, tools/dense_mul.py); the bound is the
        # lesser of the two
        if "dense_mul_sass" not in state:
            state["dense_mul_sass"] = dense_mul.sass_counts()
        fname = {"bn254": "bn254_fr", "bls12_377": "bls12_377_fr"}[curve]
        chains = f"{fname} {dense_mul.VARIANTS[1]}"
        least = {"product": dense_mul.sass_ops(state["dense_mul_sass"][chains]),
                 "butterfly": dense_mul.sass_ops(state["dense_mul_sass"][chains + " butterfly"])}

        def ntt_bounds(log_n):
            """((least ms, what bounds it), the fixed count's least ms) of
            a one-row transform of 2^log_n points."""
            n, bfly = 1 << log_n, (1 << log_n) // 2 * log_n
            fixed = _dense_bound(state, n, bfly, 2 * bfly, values=2)
            known = bound(state, 2 * 32.0 * n, ops((bfly, least["product"]),
                                                   (bfly, least["butterfly"])))
            return min(fixed, known), fixed[0]
        for log_n in range(1, 21):
            w = f.params.primitive_root_of_unity(log_n)
            for root in (w, pow(w, f.p - 2, f.p)):
                tables = ntt.twiddle_tables(f, root, log_n, dev)
                for rows in ((1, 2) if log_n <= 14 else (1,)) + tuple(
                        r for r in (prove_rows.get(log_n, 1),) if r > 1):
                    x = _random_dense(f, rows << log_n, gen).reshape(f.num_limbs, rows, -1)
                    for max_pass_log in (ntt.MAX_PASS_LOG, 3)[:2 if log_n <= 14 else 1]:
                        cur, ns_log = x, 0
                        for s in ntt.dense_pass_plan(log_n, max_pass_log):
                            native.launches[counter] = 0
                            got = ntt.ntt_pass(cur, torch.empty_like(cur), tables, ns_log, s)
                            check(native.launches[counter] == 1, "a pass is one launch")
                            want = ntt.ntt_pass_plain(cur, tables, ns_log, s)
                            err = max(err, max_abs_err(got, want))
                            check(err == 0, f"{label} Fr pass != plain: 2^{log_n} x {rows}, "
                                  f"radix 2^{s} after 2^{ns_log}")
                            cur, ns_log = got, ns_log + s
                            checked += 1
                    del x, cur, got, want
            torch.cuda.empty_cache()
        line_log, line_what = cfg["fft_line"]
        for log_n in cfg["fft_logs"]:
            n = 1 << log_n
            root = f.params.primitive_root_of_unity(log_n)
            x = _random_dense(f, n, gen)
            native.launches[counter] = 0
            y = ntt.fft(x, f)
            check(native.launches[counter] == len(ntt.dense_pass_plan(log_n)),
                  f"{label} fft 2^{log_n}: {native.launches[counter]} launches")
            if log_n == line_log:
                want = ntt.fft_with_root_plain(x, f, root)
                err = max(err, max_abs_err(y, want))
                check(err == 0, f"{label} fft 2^{log_n} != its plain version")
                check(torch.equal(ntt.ifft(y, f), x), f"{label} ifft(fft(x)) != x at 2^{log_n}")
                del want
            # the passes' launches alone (the fft's own host work, about 0.1 ms
            # a call, outlasts them up to 2^18), then a whole fft call
            plan, xr = ntt.dense_pass_plan(log_n), x.reshape(f.num_limbs, 1, n)
            tables = ntt.twiddle_tables(f, root, log_n, dev)
            out, buf = torch.empty_like(xr), torch.empty_like(xr)
            ms = cuda_ms(lambda: ntt._launch(xr, out, buf, tables, 0, plan), 20)
            (b_ms, b_by), fixed_ms = ntt_bounds(log_n)
            times[f"fft 2^{log_n}"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                                       "share": b_ms / ms, "fixed_bound_ms": fixed_ms,
                                       "fixed_share": fixed_ms / ms, "passes": plan,
                                       "fft_call_ms": cuda_ms(lambda: ntt.fft(x, f), 10)}
            del out, buf
            if log_n == line_log:
                times[f"fft 2^{log_n}"]["plain_ms"] = cuda_ms(
                    lambda: ntt.fft_with_root_plain(x, f, root), 1)
            del x, y
            torch.cuda.empty_cache()
        for log_n, rows in prove_rows.items():
            w = f.params.primitive_root_of_unity(log_n)
            x = _random_dense(f, rows << log_n, gen).reshape(f.num_limbs, rows, -1)
            for root in (w, pow(w, f.p - 2, f.p)):
                native.launches[counter] = 0
                got = ntt.fft_with_root(x, f, root)
                check(native.launches[counter] == len(ntt.dense_pass_plan(log_n)),
                      f"{label} fft 2^{log_n} x {rows}: {native.launches[counter]} launches")
                err = max(err, max_abs_err(got, ntt.fft_with_root_plain(x, f, root)))
                check(err == 0, f"{label} fft 2^{log_n} x {rows} != its plain version")
            del x, got
            torch.cuda.empty_cache()
        t = times[f"fft 2^{line_log}"]
        sass = {v + what: state["dense_mul_sass"].get(f"{fname} {v}{what}", {}).get(
            "instructions") for v in dense_mul.VARIANTS.values() for what in ("", " butterfly")}
        rec["dense_ntt" + suffix].update(
            max_abs_err=err, ms=t["ms"], ms_what="the passes' launches alone (ntt._launch)",
            fft_call_ms=t["fft_call_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None, share=t["share"],
            bound_counts=f"(n/2) log2 n products and butterflies at dense32.cuh's SASS "
                         f"{json.dumps(least)} (multiply-adds, logic, other)",
            fixed_bound_ms=t["fixed_bound_ms"], fixed_share=t["fixed_share"],
            shape=f"{label} Fr fft 2^{line_log} ({line_what}), passes {t['passes']}",
            grid=grids[f"2^{line_log} x 1"], sass_instructions=sass)
        state[f"{curve}_ntt"] = {"times": times, "grids": grids, "products": products,
                                 "sass": sass, "least_ops": least}
        return (f"{checked} passes bitwise equal to ntt_pass_plain (2^1 .. 2^20, forward and "
                f"inverse root, 1 row, and 2 rows and radix <= 2^3 up to 2^14; the prover's "
                f"rows by log2 n: {prove_rows}); fft 2^{line_log} = plain fft, ifft round trip; "
                f"ffts at the prover's rows = plain; dense32.cuh's product = dense.cuh's on "
                f"{json.dumps(products)}; SASS instructions {json.dumps(sass)}; every "
                f"pass of 2^16 .. 2^18 on >= 132 blocks: {json.dumps(grids)}; "
                + json.dumps(times))
    run_ntt()


def phase_bn254_kernels(state):
    phase_dense_kernels(state, "bn254")


def phase_bls12_377_kernels(state):
    phase_dense_kernels(state, "bls12_377")


# ---------------------------------------------------------------------------
# kernels 10 and 11: the group law and Pippenger's bucket phase

def _curve_ops(group):
    """(the group's JacobianOps, its base field Fq, whether it is a G2)."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.twists import bls12_377_twist, bn254_twist
    from lambda_elliptic_curves_tpu_torch.curves.zoo import BLS12377Curve, BN254Curve

    curve = {"bn254_g1": BN254Curve, "bn254_g2": bn254_twist(),
             "bls12_377_g1": BLS12377Curve, "bls12_377_g2": bls12_377_twist()}[group]
    return M.make_ops(curve), _dense_fields(group.rsplit("_", 1)[0])["fq"], group.endswith("g2")


def _curve_bound(state, group, counts: dict, nbytes: float) -> dict:
    """The bound of the group ops ``counts`` (an op of CURVE_OP_COUNTS ->
    how many) moving ``nbytes``: the larger of the bytes and the base
    products and sums at dense32.cuh's SASS (tools/dense_mul.py; BN254 Fq
    at BN254 Fr's, a sum half a butterfly), and beside it the fixed count
    (490 / 1071 instructions a product, 48 / 72 a sum)."""
    from lambda_elliptic_curves_tpu_torch.tools import dense_mul

    _, fq, g2 = _curve_ops(group)
    prods = adds = 0
    for op, count in counts.items():
        p, a = CURVE_OP_COUNTS[op]
        if g2:
            p, a = 3 * p, p * (5 if group.startswith("bn254") else 9) + 2 * a
        prods, adds = prods + count * p, adds + count * a
    if "dense_mul_sass" not in state:
        state["dense_mul_sass"] = dense_mul.sass_counts()
    key = f"{_sass_field(fq)} {dense_mul.VARIANTS[1]}"
    prod = dense_mul.sass_ops(state["dense_mul_sass"][key])
    half = tuple(v / 2 for v in dense_mul.sass_ops(state["dense_mul_sass"][key + " butterfly"]))
    b_ms, b_by = bound(state, nbytes, ops((prods, prod), (adds, half)))
    mul_ops, add_ops = ((DENSE_MUL_OPS, DENSE_ADD_OPS) if fq.ops.WORDS == 4
                        else (DENSE6_MUL_OPS, DENSE6_ADD_OPS))
    fixed_ms, _ = bound(state, nbytes, ops((prods, mul_ops), (adds, add_ops)))
    return {"bound_ms": b_ms, "bound_by": b_by, "fixed_bound_ms": fixed_ms,
            "sass_instructions": {"product": state["dense_mul_sass"][key]["instructions"],
                                  "sum": state["dense_mul_sass"][key + " butterfly"][
                                      "instructions"] / 2},
            "bound_counts": f"{nbytes:.0f} B; {prods} base products at {prod} and {adds} "
                            f"sums at {half} (multiply-adds, logic, other; dense32.cuh's "
                            f"SASS, a sum half a butterfly); ops {counts}"}


def _curve_values(fq, g2, n, gen):
    """n random values of the group's field (Fq, or Fp2 as two Fq planes)."""
    import torch

    if g2:
        return torch.cat([_random_dense(fq, n, gen), _random_dense(fq, n, gen)])
    return _random_dense(fq, n, gen)


def _curve_lanes(ops, fq, g2, n, gen):
    """The operands of phase 2m over n lanes: random field triples (off the
    curve, which the formulas do not need; the random z's first lane is 0,
    an infinity), then blocks of k = n / 16 lanes of each special case:
    (a, b) of the addition: P + P with the same triple and with another
    representative, P + (-P), an infinite operand each side, both; (a, b)
    of the mixed one (b affine): the same cases."""
    import torch

    f, dev = ops.f, gen.device
    k = n // 16
    val = lambda m: _curve_values(fq, g2, m, gen)  # noqa: E731
    head = lambda pt: tuple(c[:, :k] for c in pt)  # noqa: E731
    cat = lambda *pts: tuple(torch.cat(cs, dim=-1) for cs in zip(*pts))  # noqa: E731
    neg = lambda pt: (pt[0], f.sub(f.zeros(pt[1].shape[1:], dev), pt[1]), pt[2])  # noqa: E731
    ra, rb = (val(n - 6 * k), val(n - 6 * k), val(n - 6 * k)), (val(n - 6 * k), val(n - 6 * k),
                                                               val(n - 6 * k))
    z = val(k)
    z[:, 0] = f.ones((1,), dev)[:, 0]  # no zero z in a representative
    z2 = f.mul(z, z)
    rep = lambda pt: (f.mul(pt[0], z2), f.mul(pt[1], f.mul(z2, z)), f.mul(pt[2], z))  # noqa: E731
    inf = ops.neutral((k,), dev)
    a = cat(ra, head(ra), head(ra), head(ra), inf, head(ra), inf)
    b = cat(rb, head(ra), rep(head(ra)), neg(rep(head(ra))), head(rb), inf, inf)
    ram = (val(n - 5 * k), val(n - 5 * k), val(n - 5 * k))
    aff = (val(n - 5 * k), val(n - 5 * k), f.ones((n - 5 * k,), dev))
    a_of_aff = rep(head(aff))
    am = cat(ram, a_of_aff, a_of_aff, inf, head(ram), inf)
    bm = cat(aff, head(aff), neg(head(aff)), head(aff), inf, inf)
    return a, b, am, bm


def _skewed_ids(n: int, c: int, gen):
    """(4, n) bucket ids of c bits: uniform, all one bucket, mostly 0 and 1
    (a circom-style witness: 45% each, 10% spread), half zeros."""
    import torch

    dev = gen.device
    nb = 1 << c
    u = torch.randint(0, nb, (4, n), generator=gen, device=dev)
    r = torch.rand((2, n), generator=gen, device=dev)
    ones = torch.full((n,), int(u[1, 0]) % (nb - 1) + 1, device=dev)
    mostly = torch.where(r[0] < 0.45, 0, torch.where(r[0] < 0.9, 1, u[2]))
    half = torch.where(r[1] < 0.5, 0, u[3])
    return torch.stack([u[0], ones, mostly, half])


def _bucket_work(sorted_ids, nonempty, chunk: int, reduce_chunk: int) -> dict:
    """The group ops that the bucket phase's data needs (``csrc/
    msm_bucket.cuh``), counted on the host from the sorted ids (numpy, (W,
    S)) and which buckets are nonempty ((W, N)): the accumulate's mixed
    additions (level 0) and full ones (the merges of later levels), the
    reduce's additions with no neutral operand and its doublings of
    nonempty sums."""
    import numpy as np

    mixed = full = dbls = 0
    seq, first_level = sorted_ids, True
    while True:
        W, S = seq.shape
        K = -(-S // chunk)
        v = np.zeros((W, K * chunk), np.int64)
        v[:, :S] = seq
        v = v.reshape(W, K, chunk)
        nz = v != 0
        last_nz = np.maximum.accumulate(np.where(nz, np.arange(chunk), -1), axis=-1)
        prev = np.concatenate([np.full((W, K, 1), -1), last_nz[..., :-1]], axis=-1)
        new_run = nz & ((prev < 0) | (v != np.take_along_axis(v, np.maximum(prev, 0), -1)))
        adds = int(nz.sum() - new_run.sum())
        mixed, full = (mixed + adds, full) if first_level else (mixed, full + adds)
        if K == 1:
            break
        runs = new_run.sum(-1)
        first_id = np.take_along_axis(v, np.argmax(new_run, -1)[..., None], -1)[..., 0]
        last_id = np.take_along_axis(v, np.maximum(last_nz[..., -1], 0)[..., None], -1)[..., 0]
        seq = np.stack([np.where(runs > 0, first_id, 0), np.where(runs > 1, last_id, 0)],
                       -1).reshape(W, 2 * K)
        first_level = False
    ne, carry, depth, m = nonempty, None, 0, reduce_chunk
    while True:
        W, N = ne.shape
        K = -(-N // m)
        A = np.zeros((W, K * m), bool)
        A[:, :N - 1] = ne[:, 1:]
        A = A.reshape(W, K, m)
        run, acc = np.zeros((W, K), bool), np.zeros((W, K), bool)
        for t in reversed(range(m)):
            full += int((A[..., t] & run).sum())
            run |= A[..., t]
            full += int((run & acc).sum())
            acc |= run
        if carry is not None:
            C = np.zeros((W, K * m), bool)
            C[:, :N] = carry
            C = C.reshape(W, K, m)
            d = np.zeros((W, K), bool)
            for t in range(m):
                full += int((C[..., t] & d).sum())
                d |= C[..., t]
            dbls += int(acc.sum()) * depth * (m.bit_length() - 1)
            full += int((d & acc).sum())
            acc |= d
        if N <= m:
            return {"add_mixed": mixed, "add": full, "double": dbls}
        ne, carry, depth = run, acc, depth + 1


def _bucket_phase(ops, ids, pts, nbuckets: int, plain: bool = False):
    """sum_j j B_j of every window: kernel 11's levels, or their plain
    version; (L, W, 1)."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    if plain:
        return M.weighted_bucket_sums_plain(ops, M.bucket_sums_plain(ops, ids, pts, nbuckets))
    return M.weighted_bucket_sums(ops, M.bucket_sums(ops, ids, pts, nbuckets))


def _bucket_launches(ops, W: int, S: int, nbuckets: int) -> list:
    """Kernel 11's launches for W windows of S points and nbuckets buckets
    of ``ops``' group (``curves/msm.py``'s leaves and tiles, the
    accumulate's first leaves as ``_leaf_length`` sizes them): each
    launch's grid (blocks of threads) and the dependent group ops on its
    longest thread's path, from its inputs to its outputs: a leaf's walk
    (the accumulate's T - 1 additions; the reduce's 2 m additions and
    log2 m doublings, the scaling of its R), then a step of the tree each
    (the accumulate's one addition; the reduce's two on the V thread, an
    addition and a doubling on the R~ thread)."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    out, seq, level = [], S, 0
    chunk = M._leaf_length(M.BUCKET_CHUNK, S, W, M.BUCKET_TILE, ops)
    while True:
        P = M._tile(-(-seq // chunk), M.BUCKET_TILE)
        K = -(-seq // (P * chunk))
        steps = P.bit_length() - 1
        out.append({"launch": f"accumulate level {level}", "blocks": W * K, "threads": P,
                    "inputs_a_block": P * chunk, "chain": chunk - 1 + steps,
                    "chain_ops": f"{chunk - 1} {'mixed ' if level == 0 else ''}additions + "
                                 f"{steps} combines"})
        if K == 1:
            break
        seq, chunk, level = 2 * K, M.MERGE_CHUNK, level + 1
    N, r, level, m = nbuckets, None, 0, M.REDUCE_CHUNK
    while True:
        _, P, K = M._reduce_shape(N, m, M.BUCKET_TILE, r is None)
        steps = P.bit_length() - 1
        walk = (2 * m + m.bit_length() - 1) if r is None else 0
        out.append({"launch": f"reduce level {level}", "blocks": W * K, "threads": P,
                    "inputs_a_block": P * (m if r is None else 1), "chain": walk + 2 * steps,
                    "chain_ops": (f"{2 * m} additions + {m.bit_length() - 1} doublings + "
                                  if r is None else "") + f"{steps} x 2 additions"})
        if K == 1:
            return out
        N, r, level = K, True, level + 1


def _bucket_occupancy(group: str) -> dict:
    """Kernel 11's instances of ``group`` at blocks of BUCKET_TILE threads:
    the blocks and warps an SM holds at once (the CUDA occupancy
    calculator: registers, dynamic shared memory, the launch bound), a
    block's shared bytes, and the card's blocks at once beside the
    ``WAVE_BLOCKS`` that size the accumulate's first leaves."""
    import ctypes

    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    gid = CURVE_GROUPS.index(group)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"wave_blocks": M.WAVE_BLOCKS[gid]}
    for kind, name in enumerate(("accumulate, mixed", "accumulate", "reduce")):
        res = (ctypes.c_long * 2)()
        err = native.cuda_lib().lw_msm_bucket_occupancy(gid, kind, M.BUCKET_TILE, res)
        check(err == 0, f"{group} {name}: the occupancy query failed ({err})")
        out[name] = {"threads": M.BUCKET_TILE, "blocks_per_sm": res[0],
                     "warps_per_sm": res[0] * M.BUCKET_TILE // 32, "shared_bytes": res[1],
                     "card_blocks": res[0] * sms}
    return out


def _time_bucket_phase(state, group, ops, ids, pts, nbuckets: int) -> dict:
    """Kernel 11's device ms over (W, S) ids: the whole bucket phase (the
    stable sort and the table's fill included), the accumulate and the
    reduce, its launches, and the bound of the work that the ids need as
    the earlier chunked design's levels counted it (``_bucket_work(.., 16,
    16)``, a fixed count, so that a design doing more additions looks no
    closer to its bound)."""
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.tools._timing import cuda_ms

    counter = ops.counter("msm_bucket")
    native.launches[counter] = 0
    table = M.bucket_sums(ops, ids, pts, nbuckets)
    torch.cuda.synchronize()
    acc_launches = native.launches[counter]
    M.weighted_bucket_sums(ops, table)
    torch.cuda.synchronize()
    launches = native.launches[counter]
    sorted_ids = torch.sort(ids, dim=-1, stable=True)[0].cpu().numpy()
    nonempty = (~ops.f.is_zero(table[2])).cpu().numpy()
    work = _bucket_work(sorted_ids, nonempty, 16, 16)
    W, S = ids.shape
    pbytes = 3 * ops.f.num_limbs * 4
    b = _curve_bound(state, group, work, 16.0 * W * S + pbytes * (S + W))
    ms = cuda_ms(lambda: _bucket_phase(ops, ids, pts, nbuckets), 3)
    acc_ms = cuda_ms(lambda: M.bucket_sums(ops, ids, pts, nbuckets), 3)
    reduce_ms = cuda_ms(lambda: M.weighted_bucket_sums(ops, table), 3)
    plan = _bucket_launches(ops, W, S, nbuckets)
    check(launches == len(plan), f"{group}: kernel 11 launched {launches} times, not the "
          f"{len(plan)} of its plan")
    return {"ms": ms, "accumulate_ms": acc_ms, "reduce_ms": reduce_ms, **b,
            "share": b["bound_ms"] / ms, "fixed_share": b["fixed_bound_ms"] / ms,
            "launches": launches,
            "accumulate_launches": acc_launches, "work": work, "plan": plan,
            "chain": sum(x["chain"] for x in plan)}


def _hold_bucket_phase(state, group, ops, ids, pts, nbuckets: int, what: str) -> dict:
    """Kernel 11 against its plain version on the card over (W, S) ids:
    the bucket table and the weighted sums bitwise, then its times,
    launches and bound (``_time_bucket_phase``) and the plain version's
    time."""
    import torch
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    table = M.bucket_sums(ops, ids, pts, nbuckets)
    value = M.weighted_bucket_sums(ops, table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_table = M.bucket_sums_plain(ops, ids, pts, nbuckets)
    want = M.weighted_bucket_sums_plain(ops, want_table)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(x, y) for x, y in zip(table + value, want_table + want))
    check(err == 0, f"{group}: kernel 11 != its plain version over {what}")
    del value, want_table, want
    timed = _time_bucket_phase(state, group, ops, ids, pts, nbuckets)
    del table
    return {"what": what, **timed, "plain_ms": plain_ms, "max_abs_err": err}


def phase_curve_kernels(state):
    """Kernel 10 (every op of every group at the MSMs' scan width, and an
    operand broadcast) and kernel 11 (over skewed ids of 2^12 points,
    12-bit windows; its occupancy) against their plain versions on the
    card."""
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.tools._timing import cuda_ms

    @phase("2m curve kernels")
    def run():
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(13)
        n, k = CURVE_LANES, CURVE_LANES // 16
        times, buckets, err = {}, {}, 0
        for group in CURVE_GROUPS:
            ops, fq, g2 = _curve_ops(group)
            plain, counter = ops.plain(), ops.counter("curve_op")
            a, b, am, bm = _curve_lanes(ops, fq, g2, n, gen)
            g = ops.from_host([ops.curve.generator()], dev)
            pbytes = 3 * ops.f.num_limbs * 4
            cases = {
                "add": (lambda: ops.add(a, b), lambda: plain.add(a, b),
                        {"add": n - 6 * k, "add_head": 3 * k, "double": 2 * k}, 3 * n * pbytes),
                "add_mixed": (lambda: ops.add_mixed(am, bm), lambda: plain.add_mixed(am, bm),
                              {"add_mixed": n - 5 * k, "add_mixed_head": 2 * k, "double": k},
                              3 * n * pbytes),
                "double": (lambda: ops.double(a), lambda: plain.double(a), {"double": n},
                           2 * n * pbytes),
                "add_mixed, one point broadcast": (
                    lambda: ops.add_mixed(a, g), lambda: plain.add_mixed(a, g),
                    {"add_mixed": n - 2 * k}, (2 * n + 1) * pbytes),
            }
            times[group] = {}
            for name, (kern, pl, counts, nbytes) in cases.items():
                native.launches[counter] = 0
                got = kern()
                torch.cuda.synchronize()
                check(native.launches[counter] == 1, f"{group} {name}: "
                      f"{native.launches[counter]} launches of kernel 10, not 1")
                t0 = time.perf_counter()
                want = pl()
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                err = max(err, max(max_abs_err(x, y) for x, y in zip(got, want)))
                check(err == 0, f"{group} {name}: kernel 10 != its plain version")
                del got, want
                ms = cuda_ms(kern, 3)
                b = _curve_bound(state, group, counts, nbytes)
                times[group][name] = {"ms": ms, **b, "share": b["bound_ms"] / ms,
                                      "fixed_share": b["fixed_bound_ms"] / ms,
                                      "plain_ms": plain_ms}
            del a, b, am, bm, cases
            torch.cuda.empty_cache()
            # kernel 11 over skewed ids at 2^12 points, 12-bit windows: two
            # accumulate and two reduce levels (the plain version's time
            # grows with its steps; phases 5f and 5h hold the kernel over the
            # MSMs' own ids at 2^16)
            ids = _skewed_ids(1 << 12, 12, gen)
            pts = (_curve_values(fq, g2, 1 << 12, gen), _curve_values(fq, g2, 1 << 12, gen),
                   ops.f.ones((1 << 12,), dev))
            buckets[group] = _hold_bucket_phase(state, group, ops, ids, pts, 1 << 12,
                                                "skewed ids (uniform, one bucket, mostly 0 and "
                                                "1, half zeros) of 2^12 points, c = 12")
            buckets[group]["occupancy"] = _bucket_occupancy(group)
            del ids, pts
            torch.cuda.empty_cache()
        combs = {group: _hold_comb(state, group, gen)
                 for group in ("bn254_g1", "bls12_377_g1", "bls12_377_g2")}
        for name, group in (("curve_op", "bn254_g1"), ("curve_op_bls12_377", "bls12_377_g2")):
            t = combs[group]
            state["kernels"][name].update(
                max_abs_err=max(err, t["max_abs_err"]), ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
                fixed_bound_ms=t["fixed_bound_ms"], sass_instructions=t["sass_instructions"],
                bound_counts=t["bound_counts"], whole_call_ms=t["whole_call_ms"],
                occupancy=t["occupancy"], shape=f"{group} fixed-base comb over {t['lanes']} "
                f"lanes ({t['what']}), {t['windows']} windows of {t['window']} bits, the launch "
                "alone")
        state["curve_op"], state["bucket_skewed"] = {"ops": times, "comb": combs}, buckets
        return ("kernel 10: add, add_mixed, double and a broadcast operand bitwise equal to "
                f"plain for {', '.join(CURVE_GROUPS)} at {n} lanes, the comb at its main-path "
                "shapes (one launch each); kernel 11 bitwise equal to plain over skewed ids; "
                + json.dumps({"curve_op": state["curve_op"], "msm_bucket": buckets}))
    run()


def _curve_info(group: str) -> dict:
    """Kernel 10's two entries for ``group``: threads a block, blocks an SM
    at once (the occupancy calculator), registers and local bytes a thread
    (``lw_curve_info``)."""
    import ctypes

    from lambda_elliptic_curves_tpu_torch import native

    out = {}
    for kind, name in ((0, "op"), (1, "comb")):
        res = (ctypes.c_long * 4)()
        err = native.cuda_lib().lw_curve_info(CURVE_GROUPS.index(group), kind, res)
        check(err == 0, f"{group} {name}: the occupancy query failed ({err})")
        out[name] = {"threads": res[0], "blocks_per_sm": res[1], "registers": res[2],
                     "local_bytes": res[3]}
    return out


def _hold_comb(state, group: str, gen) -> dict:
    """Kernel 10's comb entry at its main-path shape (``COMB_LANES``) over
    random scalars drawn on the card: one launch a call, bitwise equal to
    the plain comb (``fixed_base_multiples`` with the plain group law: a
    window at a time over every lane); the launch alone (CUDA events, the
    arguments and outputs made once) and whole calls, against the bound of
    the mixed additions its ids need (a lane adds every nonzero window
    after its first) at dense32.cuh's SASS and the fixed count, with the
    bytes of its digits read, its points written and the table read once."""
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.tools._timing import cuda_ms, random_digits

    ops, _, _ = _curve_ops(group)
    curve, n, c = ops.curve, COMB_LANES[group], M.FIXED_BASE_WINDOW
    bits = M._scalar_bits(curve)
    windows = -(-bits // c)
    digits = random_digits(bits, n, gen, M.DIGIT_BITS)
    digits[:, :3] = M.scalars_to_digits(curve, [0, 1, curve.order - 1], gen.device)
    base, counter = curve.generator(), ops.counter("curve_op")
    M.fixed_base_multiples(curve, digits[:, :1], base, ops)  # the table, built and cached
    native.launches[counter] = 0
    got = M.fixed_base_multiples(curve, digits, base, ops)
    torch.cuda.synchronize()
    check(native.launches[counter] == 1, f"{group} comb: {native.launches[counter]} launches "
          "of kernel 10, not 1")
    t0 = time.perf_counter()
    want = M.fixed_base_multiples(curve, digits, base, ops.plain())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    check(err == 0, f"{group} comb: kernel 10 != the plain comb over {n} lanes")
    del want
    table = M._comb_table(ops, base, c, windows, gen.device)
    args = M.comb_args(table, digits, c, windows)
    lib, gid = native.cuda_lib(), curve.kernel_group

    def launch():
        lib.lw_curve_comb(gid, args, *(o.data_ptr() for o in got), n,
                          torch.cuda.current_stream().cuda_stream)
    ms = cuda_ms(launch, 5)
    whole_ms = cuda_ms(lambda: M.fixed_base_multiples(curve, digits, base, ops), 5)
    nonzero = (M.window_ids(digits, c, windows) != 0).sum(dim=0)
    adds = int((nonzero - 1).clamp(min=0).sum())
    rows = ops.f.num_limbs
    nbytes = n * (8.0 * digits.shape[0] + 12 * rows) + table[1].numel() * 4 + table[2].numel()
    b = _curve_bound(state, group, {"add_mixed": adds}, nbytes)
    m = f"2^{GROTH16_LOG_CONSTRAINTS} constraints"
    what = {"bn254_g1": f"the Plonk SRS at 2^{PLONK_LOG_GATES} gates",
            "bls12_377_g1": f"about the Groth16 setup's G1 comb at {m}",
            "bls12_377_g2": f"the Groth16 setup's G2 comb at {m}"}[group]
    return {"lanes": n, "what": what, "windows": windows, "window": c, "ms": ms,
            "whole_call_ms": whole_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "mixed_additions": adds, **b, "share": b["bound_ms"] / ms,
            "fixed_share": b["fixed_bound_ms"] / ms, "occupancy": _curve_info(group)}


def _plonk_fixture_proof(case: str, dev) -> tuple:
    """Prove a Plonk fixture circuit on ``dev`` (SRS on the card too); the
    proof as ``proof_to_json``, the fixture, and whether it verified."""
    from lambda_elliptic_curves_tpu_torch.commitments import (
        KateZaveruchaGoldberg, StructuredReferenceString,
    )
    from lambda_elliptic_curves_tpu_torch.curves.pairings import BN254Pairing
    from lambda_elliptic_curves_tpu_torch.provers.plonk import (
        CommonPreprocessedInput, Prover, TestRandomFieldGenerator, Verifier, Witness,
        proof_from_json, proof_to_json, setup,
    )
    from lambda_elliptic_curves_tpu_torch.provers.plonk.circuits import fixture_circuit

    with open(os.path.join(FIXTURES, f"jax_bn254_{case}.json")) as fh:
        data = json.load(fh)
    f = _bn254("fr")
    system, assignments = fixture_circuit(f, data)
    cpi = CommonPreprocessedInput.from_constraint_system(system, data["k1"], device=dev)
    srs = StructuredReferenceString.insecure_setup(BN254Pairing, data["srs_size"],
                                                   tau=data["tau"], device=dev)
    kzg = KateZaveruchaGoldberg(BN254Pairing, srs, msm_method="naive", device=dev)
    vk = setup(cpi, kzg)
    witness = Witness.new(assignments, system)
    public = system.public_input_values(assignments)
    proof = Prover(kzg, TestRandomFieldGenerator(f)).prove(witness, public, cpi, vk)
    verifier = Verifier(kzg)
    jax_proof = proof_from_json(data["proof"], BN254Pairing.g1_curve, f)
    wrong = [public[0], public[1] + f(1)]
    ok = (verifier.verify(proof, public, cpi, vk) and verifier.verify(jax_proof, public, cpi, vk)
          and not verifier.verify(proof, wrong, cpi, vk))
    return proof_to_json(proof), data, ok


def phase_bn254_fixture(state):
    import torch

    @phase("3e Plonk BN254 fixture proofs vs JAX proofs")
    def run():
        dev = torch.device("cuda")
        for case in ("plonk4", "plonk32"):
            got, data, ok = _plonk_fixture_proof(case, dev)
            for name, want in data["proof"].items():
                check(got[name] == want, f"{case}: proof field {name} != the JAX package's")
            check(ok, f"{case}: the verifier did not accept the card's and the JAX proof, or "
                  "accepted a wrong public input")
        return ("plonk4 (n = 4) and plonk32 (n = 32) on the card: every proof field equal to "
                "the JAX package's; both proofs verify; a wrong public input is refused")
    run()


def _msm_kernels(state, group, ops, digits, pts_dev, at: str):
    """Kernel 11 held against its plain version over a Pippenger MSM's own
    ids (its record in the kernels line, for the main path's groups), and
    every kernel of three more Pippenger MSMs traced: fewer than
    MSM_KERNELS_MAX of any kind in the fullest trace."""
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.tools._timing import profile

    curve = ops.curve
    B = digits.shape[-1]
    c = min(M.optimum_window_size(B), 15)
    n_windows = -(-M._scalar_bits(curve) // c)
    ids = M.window_ids(digits, c, n_windows)
    bucket = _hold_bucket_phase(state, group, ops, ids, pts_dev, 1 << c,
                                f"the ids of phase {at}'s MSM ({n_windows} windows of {B} "
                                f"points, c = {c})")
    name = {"bn254_g1": "msm_bucket", "bls12_377_g2": "msm_bucket_bls12_377"}.get(group)
    if name:
        state["kernels"][name].update(
            max_abs_err=bucket["max_abs_err"], ms=bucket["ms"], plain_ms=bucket["plain_ms"],
            bound_ms=bucket["bound_ms"], bound_by=bucket["bound_by"], library_ms=None,
            share=bucket["share"], fixed_bound_ms=bucket["fixed_bound_ms"],
            sass_instructions=bucket["sass_instructions"], bound_counts=bucket["bound_counts"],
            occupancy=state["bucket_skewed"][group]["occupancy"],
            shape=f"{group} bucket phase ({bucket['launches']} launches: accumulate and "
                  f"reduce levels; the stable sort and the table's fill included) over "
                  + bucket["what"])
    # the tracer can drop kernel records: the most of three traces
    traces = [profile(lambda: M.msm_pippenger(curve, digits, pts_dev, ops=ops))[1]
              for _ in range(3)]
    traced = max(traces, key=lambda t: t["kernels"])
    check(traced["kernels"] < MSM_KERNELS_MAX, f"{group}: a Pippenger MSM of {B} points ran "
          f"{traced['kernels']} kernels, not fewer than {MSM_KERNELS_MAX}")
    return bucket, {**traced, "kernels_by_trace": [t["kernels"] for t in traces]}


def _skewed_msms(state, group, curve, ops, pts_dev, rng) -> dict:
    """Pippenger MSMs of the phase's points with skewed scalars (every
    scalar equal; 90% 0 or 1 and the rest uniform), each equal to the
    device double-and-add (an independent algorithm); the MSM's host-clock
    ms and its bucket phase's device ms, launches and share at their ids."""
    import torch
    from lambda_elliptic_curves_tpu_torch.curves import msm as M

    n, r = pts_dev[0].shape[-1], curve.order
    draw = lambda: int.from_bytes(rng.bytes(32), "little") % r  # noqa: E731
    one = draw()
    mixes = {"all equal": [one] * n,
             "90% 0 or 1": [0 if u < 0.45 else 1 if u < 0.9 else draw() for u in rng.random(n)]}
    c = min(M.optimum_window_size(n), 15)
    out = {}
    for name, scalars in mixes.items():
        digits = M.scalars_to_digits(curve, scalars, pts_dev[0].device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = M.msm_pippenger(curve, digits, pts_dev, ops=ops)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(value == ops.to_host(M.msm_double_and_add(curve, digits, pts_dev, ops))[0],
              f"{group}: Pippenger != double-and-add at {n} points, scalars {name}")
        ids = M.window_ids(digits, c, -(-M._scalar_bits(curve) // c))
        out[name] = {"msm_ms": ms, "bucket_phase": _time_bucket_phase(
            state, group, ops, ids, pts_dev, 1 << c)}
    return out


def phase_bn254_msm(state):
    import numpy as np
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.weierstrass import JacobianOps
    from lambda_elliptic_curves_tpu_torch.curves.zoo import BN254Curve

    @phase("5f bn254_g1_msm_2^16")
    def run():
        dev = torch.device("cuda")
        rng = np.random.default_rng(16)
        r = BN254Curve.order
        ops = JacobianOps(BN254Curve)
        # 2^16 points k_i G from the comb on the card
        ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(1 << 16)]
        pts_dev = ops.affine_points(M.fixed_base_multiples(
            BN254Curve, M.scalars_to_digits(BN254Curve, ks, dev), BN254Curve.generator(), ops))
        scalars = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(1 << 16)]
        digits = M.scalars_to_digits(BN254Curve, scalars, dev)
        torch.cuda.synchronize()
        out = {}
        for route, fn in (("pippenger", lambda: M.msm_pippenger(BN254Curve, digits, pts_dev,
                                                                 ops=ops)),
                          ("double_and_add", lambda: ops.to_host(M.msm_double_and_add(
                              BN254Curve, digits, pts_dev, ops))[0])):
            fn()  # warm
            native.launches.update({k: 0 for k in native.launches})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = fn()
            torch.cuda.synchronize()
            out[route] = {"ms": (time.perf_counter() - t0) * 1e3, "value": value,
                          "launches": {k: v for k, v in native.launches.items() if v}}
        check(out["pippenger"]["value"] == out["double_and_add"]["value"],
              "Pippenger != double-and-add at 2^16 points")
        bucket, traced = _msm_kernels(state, "bn254_g1", ops, digits, pts_dev, "5f")
        out["pippenger"]["bucket_phase"], out["pippenger"]["traced"] = bucket, traced
        out["skewed"] = _skewed_msms(state, "bn254_g1", BN254Curve, ops, pts_dev,
                                     np.random.default_rng(18))
        # 2^10 points against the host MSM
        host_pts = ops.to_host(tuple(c[:, :1 << 10] for c in pts_dev))
        want = M.msm_naive_host(scalars[:1 << 10], host_pts)
        for route in ("pippenger", "naive"):
            check(M.msm(BN254Curve, scalars[:1 << 10], host_pts, method=route, device=dev)
                  == want, f"{route} != msm_naive_host at 2^10 points")
        state["msm"] = {route: {k: v for k, v in o.items() if k != "value"}
                        for route, o in out.items()}
        return json.dumps({"metric": "bn254_g1_msm_2^16", "value": round(
            out["pippenger"]["ms"], 3), "unit": "ms", "check": "ok", **state["msm"],
            "window_bits": min(M.optimum_window_size(1 << 16), 15)})
    run()


def phase_bn254_plonk(state):
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.commitments import (
        KateZaveruchaGoldberg, StructuredReferenceString,
    )
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.pairings import BN254Pairing
    from lambda_elliptic_curves_tpu_torch.curves.weierstrass import JacobianOps
    from lambda_elliptic_curves_tpu_torch.provers.plonk import (
        CommonPreprocessedInput, ConstraintSystem, Prover, RandomFieldGenerator, Verifier,
        Witness, setup,
    )
    from lambda_elliptic_curves_tpu_torch.provers.plonk.circuits import (
        chain_circuit, chain_output, chain_steps,
    )

    @phase(f"5g plonk_bn254_prove_2^{PLONK_LOG_GATES}")
    def run():
        import random

        dev = torch.device("cuda")
        f, n = _bn254("fr"), 1 << PLONK_LOG_GATES
        t = {}
        t0 = time.perf_counter()
        system = ConstraintSystem(f)
        steps = chain_steps(n)
        x, y, e = chain_circuit(system, steps)
        assignments = system.solve({x: f(4), e: f(3), y: chain_output(f, steps, 4, 3)})
        t["circuit_and_solve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpi = CommonPreprocessedInput.from_constraint_system(system, 7, device=dev)
        check(cpi.n == n, f"the circuit has {cpi.n} rows, not {n}")
        t["preprocess_s"] = time.perf_counter() - t0
        M._comb_tables.clear()  # a first SRS: the comb's table is built in it
        native.launches.update({k: 0 for k in native.launches})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srs = StructuredReferenceString.insecure_setup(BN254Pairing, n + 6, tau=7913, device=dev)
        torch.cuda.synchronize()
        t["srs_s"] = time.perf_counter() - t0
        state["launches_srs"] = dict(native.launches)
        g = BN254Pairing.g1_curve.generator()
        for i in (0, 1, n + 5):  # the card's points against host scalar multiplications
            check(srs.powers_main_group[i] == g.operate_with_self(pow(7913, i, BN254Pairing.r)),
                  f"SRS point {i} != tau^{i} G1")
        # the same points by a batched double-and-add, the route the comb
        # replaced, timed the same way
        ops = JacobianOps(BN254Pairing.g1_curve)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        digits = M.scalars_to_digits(g.curve, [pow(7913, i, BN254Pairing.r)
                                               for i in range(n + 6)], dev)
        old = ops.to_host(M.scalar_multiples(g.curve, digits, ops.from_host([g], dev), ops))
        t["srs_double_and_add_s"] = time.perf_counter() - t0
        check(old == srs.powers_main_group, "SRS: the comb's points != the double-and-add's")
        del old, digits
        kzg = KateZaveruchaGoldberg(BN254Pairing, srs, device=dev)
        t0 = time.perf_counter()
        vk = setup(cpi, kzg)
        t["setup_s"] = time.perf_counter() - t0
        witness = Witness.new(assignments, system)
        public = system.public_input_values(assignments)
        prover = Prover(kzg, RandomFieldGenerator(f, random.Random(1)))
        runs = {}
        for label in ("first", "warm"):
            if label == "warm":
                native.launches.update({k: 0 for k in native.launches})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof = prover.prove(witness, public, cpi, vk)
            torch.cuda.synchronize()
            runs[label] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "rounds_ms": {k: round(v * 1e3, 3)
                                         for k, v in prover.round_seconds.items()}}
            if label == "warm":
                state["launches_plonk"] = dict(native.launches)
        t0 = time.perf_counter()
        ok = Verifier(kzg).verify(proof, public, cpi, vk)
        t["verify_s"] = time.perf_counter() - t0
        check(ok, f"verify rejected the 2^{PLONK_LOG_GATES}-gate Plonk proof")
        check(not Verifier(kzg).verify(proof, [public[0], public[1] + f(1)], cpi, vk),
              "verify accepted a wrong public input")
        state["plonk"] = {"first": runs["first"], "warm": runs["warm"],
                          "setup_s": {k: round(v, 3) for k, v in t.items()}}
        state["plonk_case"] = (prover, witness, public, cpi, vk)
        return json.dumps({"metric": f"plonk_bn254_prove_2^{PLONK_LOG_GATES}",
                           "value": round(runs["warm"]["ms"], 3), "unit": "ms", "check": "ok",
                           **state["plonk"], "launches": state["launches_plonk"],
                           "launches_srs": {k: v for k, v in state["launches_srs"].items() if v},
                           "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
    run()


def _groth16_fixture_proof(case: str, dev) -> dict:
    """Set up and prove a Groth16 fixture circuit on ``dev`` with the
    fixture's seeds; which parts equal the JAX package's, and the verifier's
    answers."""
    import random

    from lambda_elliptic_curves_tpu_torch.curves.pairings import BLS12377Pairing, BN254Pairing
    from lambda_elliptic_curves_tpu_torch.provers.groth16 import (
        QuadraticArithmeticProgram, circuits, interop, prove, setup, verify,
    )

    with open(os.path.join(FIXTURES, f"jax_groth16_{case}.json")) as fh:
        data = json.load(fh)
    cfg = BN254Pairing if case == "bn254" else BLS12377Pairing
    fr = _dense_fields("bn254" if case == "bn254" else "bls12_377")["fr"]
    c = data["circuit"]
    r1cs = circuits.chain_r1cs(c["m"]) if c["name"] == "chain" else circuits.x_cubed_r1cs()
    qap = QuadraticArithmeticProgram.from_r1cs(fr, r1cs)
    pk, vk = setup(qap, cfg, random.Random(data["setup_seed"]), device=dev)
    witness = [int(v, 16) for v in data["witness"]]
    proof = prove(witness, qap, pk, cfg, random.Random(data["prove_seed"]), device=dev)
    pub = [int(v, 16) for v in data["public_inputs"]]
    return {"keys": interop.keys_equal_json(pk, vk, data),
            "proof": interop.proof_to_json(proof) == data["proof"],
            "bytes": proof.serialize().hex() == data["proof_bytes"],
            "verifies": verify(vk, proof, pub, cfg, device=dev),
            "jax_proof_verifies": verify(vk, interop.proof_from_json(data["proof"], cfg), pub,
                                         cfg, device=dev),
            "wrong_input_refused": not verify(vk, proof, [pub[0], (pub[1] + 1) % fr.p], cfg,
                                              device=dev)}


def phase_groth16_fixture(state):
    import torch

    @phase("3f Groth16 fixture proofs vs JAX proofs")
    def run():
        dev = torch.device("cuda")
        for case in ("x3", "chain", "bn254"):
            got = _groth16_fixture_proof(case, dev)
            bad = [k for k, ok in got["keys"].items() if not ok]
            check(not bad, f"{case}: key entries {bad} != the JAX package's")
            for what in ("proof", "bytes", "verifies", "jax_proof_verifies",
                         "wrong_input_refused"):
                check(got[what], f"{case}: {what} failed")
        return ("x^3 and a 20-constraint chain over BLS12-377 and x^3 over BN254, set up and "
                "proved on the card: keys, proofs and proof bytes equal to the JAX package's; "
                "the card's and the JAX proofs verify; a wrong public input is refused")
    run()


def phase_bls12_377_msm(state):
    import numpy as np
    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.twists import (
        bls12_377_twist, msm_g2_naive_host,
    )
    from lambda_elliptic_curves_tpu_torch.curves.zoo import BLS12377Curve

    @phase(f"5h bls12_377_g2_msm_2^{G2_MSM_LOG_POINTS}")
    def run():
        dev = torch.device("cuda")
        rng = np.random.default_rng(17)
        n = 1 << G2_MSM_LOG_POINTS
        out = {}
        for group, curve, host_msm in (("g2", bls12_377_twist(), msm_g2_naive_host),
                                       ("g1", BLS12377Curve, M.msm_naive_host)):
            ops, r = M.make_ops(curve), curve.order
            # the points k_i G from the comb on the card
            ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
            pts_dev = ops.affine_points(M.fixed_base_multiples(
                curve, M.scalars_to_digits(curve, ks, dev), curve.generator(), ops))
            scalars = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
            digits = M.scalars_to_digits(curve, scalars, dev)
            M.msm_pippenger(curve, digits, pts_dev, ops=ops)  # warm
            res = {}
            for route, fn in (("pippenger", lambda: M.msm_pippenger(curve, digits, pts_dev,
                                                                     ops=ops)),
                              ("double_and_add", lambda: ops.to_host(M.msm_double_and_add(
                                  curve, digits, pts_dev, ops))[0])):
                native.launches.update({k: 0 for k in native.launches})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                value = fn()
                torch.cuda.synchronize()
                res[route] = {"ms": (time.perf_counter() - t0) * 1e3, "value": value,
                              "launches": {k: v for k, v in native.launches.items() if v}}
            check(res["pippenger"]["value"] == res["double_and_add"]["value"],
                  f"{group}: Pippenger != double-and-add at 2^{G2_MSM_LOG_POINTS} points")
            bucket, traced = _msm_kernels(state, f"bls12_377_{group}", ops, digits, pts_dev,
                                          "5h")
            res["pippenger"]["bucket_phase"], res["pippenger"]["traced"] = bucket, traced
            if group == "g2":
                res["skewed"] = _skewed_msms(state, "bls12_377_g2", curve, ops, pts_dev,
                                             np.random.default_rng(19))
            # 2^8 points against the host MSM, and the comb's points against
            # host scalar multiplications
            host_pts = ops.to_host(tuple(c[:, :1 << 8] for c in pts_dev))
            g = curve.generator()
            for i in (0, 1, 255):
                check(host_pts[i] == (g.mul(ks[i]) if group == "g2"
                                      else g.operate_with_self(ks[i])),
                      f"{group}: comb point {i} != k_i G")
            want = host_msm(scalars[:1 << 8], host_pts)
            for route in ("pippenger", "naive"):
                check(M.msm(curve, scalars[:1 << 8], host_pts, method=route, device=dev)
                      == want, f"{group}: {route} != the host MSM at 2^8 points")
            out[group] = {route: {k: v for k, v in o.items() if k != "value"}
                          for route, o in res.items()}
            del pts_dev, digits
            torch.cuda.empty_cache()
        state["msm_bls12_377"] = out
        return json.dumps({"metric": f"bls12_377_g2_msm_2^{G2_MSM_LOG_POINTS}",
                           "value": round(out["g2"]["pippenger"]["ms"], 3), "unit": "ms",
                           "check": "ok", **out,
                           "window_bits": min(M.optimum_window_size(n), 15)})
    run()


def phase_groth16(state):
    import random

    import torch
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.curves import msm as M
    from lambda_elliptic_curves_tpu_torch.curves.pairings import BLS12377Pairing
    from lambda_elliptic_curves_tpu_torch.provers.groth16 import (
        QuadraticArithmeticProgram, circuits, prove, setup, verify,
    )
    from lambda_elliptic_curves_tpu_torch.provers.groth16 import prover as prover_mod

    @phase(f"5i groth16_bls12_377_prove_2^{GROTH16_LOG_CONSTRAINTS}")
    def run():
        dev = torch.device("cuda")
        cfg, fr = BLS12377Pairing, _dense_fields("bls12_377")["fr"]
        m = 1 << GROTH16_LOG_CONSTRAINTS
        t = {}
        t0 = time.perf_counter()
        r1cs = circuits.chain_r1cs(m)
        witness = circuits.chain_witness(m, 3, 5, fr.p)
        check(r1cs.is_satisfied(witness, fr.p), "the chain's witness does not satisfy it")
        qap = QuadraticArithmeticProgram.from_r1cs(fr, r1cs)
        check(qap.num_of_gates == m, f"the QAP has {qap.num_of_gates} gates, not {m}")
        t["circuit_s"] = time.perf_counter() - t0
        # a first setup (the comb's G1 and G2 tables built in it, as a
        # user's first setup builds them), then one on the cached tables
        M._comb_tables.clear()
        native.launches.update({k: 0 for k in native.launches})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pk, vk = setup(qap, cfg, random.Random(9), device=dev)
        torch.cuda.synchronize()
        t["setup_s"] = time.perf_counter() - t0
        setup_launches = {k: v for k, v in native.launches.items() if v}
        state["launches_groth16_setup"] = dict(native.launches)
        t0 = time.perf_counter()
        cached = setup(qap, cfg, random.Random(9), device=dev)
        torch.cuda.synchronize()
        t["setup_cached_tables_s"] = time.perf_counter() - t0
        check(cached[1].verifier_k_tau_g1 == vk.verifier_k_tau_g1,
              "a second setup gave other keys")
        del cached
        runs = {}
        for label, seed in (("first", 10), ("warm", 11)):
            if label == "warm":
                native.launches.update({k: 0 for k in native.launches})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof = prove(witness, qap, pk, cfg, random.Random(seed), device=dev)
            torch.cuda.synchronize()
            runs[label] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "stages_ms": {k: round(v * 1e3, 3)
                                         for k, v in prover_mod.last_timings.items()}}
            if label == "warm":
                state["launches_groth16"] = dict(native.launches)
            t0 = time.perf_counter()
            check(verify(vk, proof, witness[:2], cfg, device=dev),
                  f"verify rejected the {label} 2^{GROTH16_LOG_CONSTRAINTS}-constraint proof")
            t[f"verify_{label}_s"] = time.perf_counter() - t0
        check(not verify(vk, proof, [1, (witness[1] + 1) % fr.p], cfg, device=dev),
              "verify accepted a wrong public input")
        # the points each MSM runs over: the prover drops zero scalars, and
        # h has degree n - 2 or less, so most of its 2n coefficients are 0
        w = [int(x) % fr.p for x in witness]
        h = qap.calculate_h_coefficients(w, device=dev)
        nonzero = lambda xs: sum(1 for x in xs if x)  # noqa: E731
        msm_points = {"l_tau_g1": nonzero(w), "r_tau_g2": nonzero(w), "r_tau_g1": nonzero(w),
                      "z_powers_of_tau_g1": nonzero(h), "z_powers_of_tau_g1_of": len(h),
                      "prover_k_tau_g1": nonzero(w[qap.num_of_public_inputs:])}
        state["groth16"] = {"first": runs["first"], "warm": runs["warm"],
                            "setup_s": {k: round(v, 3) for k, v in t.items()},
                            "setup_launches": setup_launches, "msm_points": msm_points}
        state["groth16_case"] = (qap, pk, vk, witness)
        return json.dumps({"metric": f"groth16_bls12_377_prove_2^{GROTH16_LOG_CONSTRAINTS}",
                           "value": round(runs["warm"]["ms"], 3), "unit": "ms", "check": "ok",
                           **state["groth16"], "launches": state["launches_groth16"],
                           "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
    run()


def _check_least_nonce(proof, opts) -> None:
    """The proof's nonce is valid and the host loop finds none below it,
    from the transcript state the prover ground on."""
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
    from lambda_elliptic_curves_tpu_torch.provers.stark import grinding
    from lambda_elliptic_curves_tpu_torch.provers.stark.examples.fibonacci import (
        FibonacciPublicInputs, fibonacci_air_for,
    )
    from lambda_elliptic_curves_tpu_torch.provers.stark.verifier import grinding_seed

    air, pub = fibonacci_air_for(f), FibonacciPublicInputs(a0=1, a1=1)
    seed, factor = grinding_seed(air, proof, pub, opts, DefaultTranscript(f)), opts.grinding_factor
    check(proof.nonce is not None and grinding.is_valid_nonce(seed, proof.nonce, factor)
          and native.grind(grinding._inner_hash(seed, factor), factor, 0, proof.nonce) == -1,
          f"nonce {proof.nonce} is not the least valid nonce")


def phase_launches(state):
    @phase("6 launch counts")
    def run():
        runs = (("2^16", state["launches"], False), ("2^20", state["launches_20"], False),
                ("2^20 at CONJECTURABLE_128", state["launches_preset"], True))
        for rows, counts, grinds in runs:
            for name in SMALL_KERNELS[:2]:
                check(counts.get(name, 0) == 0, f"the Stark252 {rows}-row prove launched {name}")
            for name in STARK252_KERNELS:
                if name == "grind" and not grinds:
                    check(counts.get(name, 0) == 0, f"the {rows}-row prove without grinding "
                          "launched the nonce search")
                    continue
                check(counts.get(name, 0) > 0,
                      f"kernel {name} was not launched by the {rows}-row prove")
            check(counts.get("field_pow", 0) == 0, f"the {rows}-row prove inverted by Fermat "
                  "(field_pow) instead of the batch-inverse kernel")
            # two calls, (8, 2, N) and (8, 4, N) with N the LDE size (2^18 at
            # 2^16 rows, 2^22 at 2^20 rows), of two levels, 3 launches, each
            check(counts.get("field_inv") == 6, f"the {rows}-row prove launched batch "
                  f"inversion {counts.get('field_inv')} times, not 6")
        small_runs = {name: state[f"launches_{name}"] for name in SMALL_PROVES}
        for name, counts in small_runs.items():
            for k in SMALL_KERNELS:
                check(counts.get(k, 0) > 0, f"kernel {k} was not launched by the {name} prove")
            for k in set(STARK252_KERNELS + ("field_pow",)) - set(SMALL_KERNELS):
                check(counts.get(k, 0) == 0, f"the {name} prove launched the Stark252 kernel {k}")
        for rows, counts, _ in runs:
            for k in BN254_KERNELS + BN254_SETUP_KERNELS:
                check(counts.get(k, 0) == 0, f"the Stark252 {rows}-row prove launched {k}")
        for name, counts in small_runs.items():
            for k in BN254_KERNELS + BN254_SETUP_KERNELS:
                check(counts.get(k, 0) == 0, f"the {name} prove launched {k}")
        # the Plonk prove: kernel 1's BN254 Fr entry, kernels 8 and 9, and no
        # kernel of the STARK paths (its transcript hashes on the host)
        plonk = state["launches_plonk"]
        for k in BN254_KERNELS:
            check(plonk.get(k, 0) > 0, f"kernel {k} was not launched by the Plonk prove")
        # round 3's quotient: one launch of kernel 8's program entry
        check(plonk["dense_program"] == 1, f"the Plonk prove ran {plonk['dense_program']} "
              "kernel-8 programs, not 1 (its round-3 quotient)")
        for k in set(STARK252_KERNELS + SMALL_KERNELS + BLS_KERNELS + BLS_SETUP_KERNELS
                     + BN254_SETUP_KERNELS + ("field_pow",)):
            check(plonk.get(k, 0) == 0, f"the Plonk prove launched {k}")
        # its SRS: the comb, one launch of kernel 10
        srs = state["launches_srs"]
        for k in BN254_SETUP_KERNELS:
            check(srs.get(k, 0) == 1, f"the SRS launched kernel {k} {srs.get(k, 0)} times, "
                  "not once (its comb)")
        for k in set(STARK252_KERNELS + SMALL_KERNELS + BLS_KERNELS + BLS_SETUP_KERNELS):
            check(srs.get(k, 0) == 0, f"the SRS launched {k}")
        # the Groth16 prove over BLS12-377: the BLS12-377 instances of kernels
        # 1, 8 and 9, and nothing else
        groth16 = state["launches_groth16"]
        for k in BLS_KERNELS:
            check(groth16.get(k, 0) > 0, f"kernel {k} was not launched by the Groth16 prove")
        for k in set(STARK252_KERNELS + SMALL_KERNELS + BN254_KERNELS + BN254_SETUP_KERNELS
                     + BLS_SETUP_KERNELS + ("field_pow",)):
            check(groth16.get(k, 0) == 0, f"the Groth16 prove launched {k}")
        check(groth16["dense_program_bls12_377"] == 2, "the Groth16 prove ran "
              f"{groth16['dense_program_bls12_377']} kernel-8 programs, not 2 (t and h)")
        check(groth16["dense_field_bls12_377"] < GROTH16_DENSE_FIELD_MAX,
              f"the Groth16 prove launched kernel 8 {groth16['dense_field_bls12_377']} times, "
              f"not fewer than {GROTH16_DENSE_FIELD_MAX}")
        # its setup: the G1 and the G2 comb, one launch of kernel 10 each
        g16_setup = state["launches_groth16_setup"]
        for k in BLS_SETUP_KERNELS:
            check(g16_setup.get(k, 0) == 2, f"the Groth16 setup launched kernel {k} "
                  f"{g16_setup.get(k, 0)} times, not twice (its two combs)")
        for k in set(STARK252_KERNELS + SMALL_KERNELS + BN254_KERNELS + BN254_SETUP_KERNELS):
            check(g16_setup.get(k, 0) == 0, f"the Groth16 setup launched {k}")
        for counts in [c for _, c, _ in runs] + list(small_runs.values()):
            for k in BLS_KERNELS + BLS_SETUP_KERNELS:
                check(counts.get(k, 0) == 0, f"a STARK prove launched {k}")
        for name in KERNELS:
            if name in BLS_SETUP_KERNELS:  # the Groth16 setup of phase 5i
                state["kernels"][name]["launches"] = g16_setup[name]
                continue
            if name in BN254_SETUP_KERNELS:  # the Plonk SRS of phase 5g
                state["kernels"][name]["launches"] = srs[name]
                continue
            if name in BLS_KERNELS:  # the main path of slice 9: Groth16 at 2^16
                state["kernels"][name]["launches"] = groth16[name]
                continue
            if name in BN254_KERNELS:  # the main path of slice 8: Plonk at 2^16 gates
                state["kernels"][name]["launches"] = plonk[name]
                continue
            if name in SMALL_KERNELS[:2]:  # the main path of slice 7: Goldilocks + Fp2
                state["kernels"][name]["launches"] = small_runs["goldilocks_fp2"][name]
                state["kernels"][name]["launches_babybear_fp4"] = small_runs["babybear_fp4"][name]
                continue
            state["kernels"][name]["launches"] = (state["launches_preset"] if name == "grind"
                                                  else state["launches"])[name]
        return json.dumps({**{rows: counts for rows, counts, _ in runs}, **small_runs,
                           f"plonk 2^{PLONK_LOG_GATES}": plonk, "plonk srs": srs,
                           f"groth16 2^{GROTH16_LOG_CONSTRAINTS}": groth16,
                           "groth16 setup": g16_setup})
    run()


def _profile_prove(rows: int, opts, field_name: str = "stark252", degree: int = 1) -> dict:
    """Device time of one warm prove from a torch.profiler trace
    (``tools/_timing.py``'s ``profile``): wall time, device busy time,
    idle share, and time and launches by kernel."""
    import torch

    from lambda_elliptic_curves_tpu_torch import fields
    from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
    from lambda_elliptic_curves_tpu_torch.provers.stark import prove, verify
    from lambda_elliptic_curves_tpu_torch.tools._timing import profile

    f = getattr(fields, {"stark252": "Stark252", "goldilocks": "Goldilocks",
                         "babybear": "BabyBear"}[field_name])
    dev = torch.device("cuda")
    _prove_verify(rows, dev, opts, f, degree)  # warm
    air, trace, pub = _fib(rows, dev, f, degree)
    torch.cuda.synchronize()
    # the window holds the prove alone: not the trace's upload, not verify
    proof, stats = profile(
        lambda: prove(air, trace, pub, opts, DefaultTranscript(f), device=dev))
    check(verify(air, proof, pub, opts, DefaultTranscript(f)),
          f"verify rejected the profiled 2^{rows.bit_length() - 1} proof")
    return stats


def _profile_plonk(state) -> dict:
    """Device time of one more (warm) Plonk prove of phase 5g, traced."""
    from lambda_elliptic_curves_tpu_torch.provers.plonk import Verifier
    from lambda_elliptic_curves_tpu_torch.tools._timing import profile

    prover, witness, public, cpi, vk = state["plonk_case"]
    proof, stats = profile(lambda: prover.prove(witness, public, cpi, vk))
    check(Verifier(prover.cs).verify(proof, public, cpi, vk), "verify rejected the traced "
          "Plonk proof")
    return stats


def _profile_groth16(state) -> dict:
    """Device time of one more (warm) Groth16 prove of phase 5i, traced."""
    import random

    from lambda_elliptic_curves_tpu_torch.curves.pairings import BLS12377Pairing
    from lambda_elliptic_curves_tpu_torch.provers.groth16 import prove, verify
    from lambda_elliptic_curves_tpu_torch.tools._timing import profile

    qap, pk, vk, witness = state["groth16_case"]
    cfg = BLS12377Pairing
    proof, stats = profile(lambda: prove(witness, qap, pk, cfg, random.Random(12),
                                         device="cuda"))
    check(verify(vk, proof, witness[:2], cfg, device="cuda"),
          "verify rejected the traced Groth16 proof")
    return stats


def phase_profile(state):
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions, SecurityLevel

    @phase("7 profile")
    def run():
        opts = ProofOptions(4, 32, 3, 0)
        state["profile"] = {f"2^{lg}": _profile_prove(1 << lg, opts) for lg in (16, 20)}
        state["profile"]["2^20 at CONJECTURABLE_128"] = _profile_prove(
            1 << 20, ProofOptions.new_secure(SecurityLevel.CONJECTURABLE_128))
        for name, (field_name, degree) in SMALL_PROVES.items():
            state["profile"][f"2^20 {name}"] = _profile_prove(1 << 20, opts, field_name, degree)
        state["profile"][f"plonk 2^{PLONK_LOG_GATES}"] = _profile_plonk(state)
        state["profile"][f"groth16 2^{GROTH16_LOG_CONSTRAINTS}"] = _profile_groth16(state)
        return json.dumps(state["profile"])
    run()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import lambda_elliptic_curves_tpu_torch as port
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to this script: {e}",
              file=sys.stderr)
        return 2
    if not os.path.abspath(port.__file__).startswith(os.path.join(HERE, "")):
        print(f"chip_smoke: imported the port from {port.__file__}, not from this "
              "checkout", file=sys.stderr)
        return 2

    state = {"kernels": {k: {"name": k, "route": "cuda", **v} for k, v in KERNELS.items()}}
    try:
        for run_phase in (phase_build, phase_kernels, phase_small_kernels, phase_bn254_kernels,
                          phase_bls12_377_kernels, phase_curve_kernels, phase_fixture,
                          phase_bn254_fixture,
                          phase_groth16_fixture, phase_bench, phase_big, phase_small_proves,
                          phase_bn254_msm, phase_bn254_plonk, phase_bls12_377_msm,
                          phase_groth16, phase_launches, phase_profile):
            run_phase(state)
    except Exception as e:  # noqa: BLE001 — report the failing phase, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    summary = {"card": state["smi"], "build_s": round(state["build_s"], 3),
               "build_seconds": state["build_seconds"], "ptxas": state["ptxas"],
               "fft_ms": {f"2^{k}": {"kernel": t[0], "bound": t[1]}
                          for k, t in state["fft_times"].items()},
               "interpolate_2^22_ms": state["interp_22_ms"],
               "field": state["field_extra"],
               "batch_inverse": {**{f"2^{k}": t for k, t in state["inv_times"].items()},
                                 **state["inv_extra"]},
               "grind": state["grind"],
               "prove_2^16": state["prove_16"], "prove_2^20": state["prove_20"],
               "prove_2^20_conjecturable_128": state["prove_preset"],
               "launches_2^16": state["launches"], "launches_2^20": state["launches_20"],
               "launches_2^20_conjecturable_128": state["launches_preset"],
               "small_field": state["small_field"], "small_ntt": state["small_ntt"],
               **{f"prove_2^20_{name}": state[f"prove_{name}"] for name in SMALL_PROVES},
               **{f"launches_2^20_{name}": state[f"launches_{name}"] for name in SMALL_PROVES},
               "bn254_field": state["bn254_field"], "bn254_ntt": state["bn254_ntt"],
               "msm_2^16": state["msm"], f"plonk_2^{PLONK_LOG_GATES}": state["plonk"],
               f"launches_plonk_2^{PLONK_LOG_GATES}": state["launches_plonk"],
               "bls12_377_field": state["bls12_377_field"],
               "bls12_377_ntt": state["bls12_377_ntt"],
               "curve_op": state["curve_op"], "msm_bucket_skewed": state["bucket_skewed"],
               f"bls12_377_msm_2^{G2_MSM_LOG_POINTS}": state["msm_bls12_377"],
               f"groth16_2^{GROTH16_LOG_CONSTRAINTS}": state["groth16"],
               f"launches_groth16_2^{GROTH16_LOG_CONSTRAINTS}": state["launches_groth16"],
               "profile": state["profile"]}
    print("summary " + json.dumps(summary), flush=True)
    print(json.dumps({"kernels": list(state["kernels"].values())}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
