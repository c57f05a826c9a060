"""Time the port on one NVIDIA card for any checkout of it: this one, or an
older one unpacked beside it, so that two versions are compared in one
machine's run.

    python3 lambda_elliptic_curves_tpu_torch/tools/time_tree.py [--tree DIR] [GROUP ...]

Run as a script (not with ``-m``): it imports ``lambda_elliptic_curves_tpu_torch``
from DIR (default: the checkout holding this file) and only through the
entry points every version has: ``fields.Stark252``, ``ops.limbs.mont_pow``,
``poly.ntt``, ``provers.stark.prove`` and ``native.launches`` (and, for a
group of a later slice, that slice's entry points).  Times are
CUDA-event means over repeated calls after one warm-up, unless said
otherwise.  The groups, run in this order whatever order they are given in
(default: all):

* ``prove``: the first Fibonacci prove at 2^20 rows, ``ProofOptions(4, 32,
  3, 0)`` (it builds the NTT's tables), then two warm proves (host clock
  around work ending in a synchronise), kernel launches of the second and
  the device allocations (``cudaMalloc`` / ``cudaFree``) the caching
  allocator made during it; device bytes held by the NTT module's caches
  after the first prove; a ``torch.profiler`` trace of one more warm prove:
  device busy ms and time and launches of the largest kernels.  Each
  prove's ``prover.last_timings`` (ms per phase) is kept beside it;
* ``fft``: fft of 2^18 and 2^22 points, ``interpolate_fft`` of 2^22
  evaluations, and the wall time per call of 200 ffts of 2^10 points back
  to back (host bound: what one call costs the host);
* ``field``: field mul at 2^22, and a^(p-2) (``field_pow``) at 2^18 and
  2^24;
* ``inverse``: ``batch_inverse`` of 2^18, 2^20, 2^23 and 2^24 random
  elements with zeros, each output first held bitwise against Fermat
  (a^(p-2) on the card, zeros to zero); one warm prove at 2^16 and at 2^20
  rows under ``torch.profiler``: batch inversion's device ms and launches
  per prove (the launch counters and the trace), and the device busy ms;
* ``curve``: kernel 10 (``curves.msm``'s group law and comb) for BN254
  G1 and G2 and BLS12-377 G1 and G2: the mixed addition at 17 x 2^16 and
  2^16 lanes, the C entry ``lw_curve_op`` alone in a loop on outputs
  allocated once (its signature is the same in every version since slice
  10) and whole calls (``add_mixed``); the fixed-base comb
  (``fixed_base_multiples`` over random scalars, its table built and
  cached first) at the main path's shapes, 65,542 BN254 G1 lanes (the
  Plonk SRS), 5 x 2^16 BLS12-377 G1 and 2^16 + 6 G2 lanes (the Groth16
  setup's combs) and BN254 G2 at 2^16: whole calls with their kernel-10
  launches, and for a tree with the comb entry (``lw_curve_comb``) its
  launch alone, each output held against the first tree's digest of it
  (the same seeds, so the same points in every tree);
* ``bucket``: Pippenger's bucket phase (kernel 11, ``curves.msm``'s
  ``bucket_sums`` and ``weighted_bucket_sums``) over the ids of 17 windows
  of 2^16 random scalars at c = 15 (an MSM of 2^16 points) and random
  affine points, for BN254 G1, BLS12-377 G1 and BLS12-377 G2: the whole
  phase, the accumulate and the reduce alone, its launches, and its
  blocks an SM (``lw_msm_bucket_occupancy``, all four groups); then a
  Groth16 prove over BLS12-377 of a chain of 2^16 constraints (setup seed
  9, prove seeds 10 and 11), the second, warm, under ``torch.profiler``:
  kernel 11's device ms and launches, the device busy ms and the wall ms;
* ``plonk``: a Plonk prove over BN254 of a 2^16-gate chain (SRS of n + 6
  points at tau 7913), a first and a warm one under ``torch.profiler``:
  kernel 11's device ms and launches, busy and wall ms (about a minute);
* ``dense_fft``: kernel 1 over the dense fields (``ntt.fft`` over
  ``fields.BN254Fr`` and ``fields.BLS12377Fr``): fft over BN254 Fr at 2^16,
  2^18 and 2^22 points, over BLS12-377 Fr at 2^16 x 3 rows, 2^17 x 3 rows,
  2^17 and 2^22, each after its tables are built, whole calls and the
  passes' launches alone (``ntt._launch`` on buffers allocated once: up
  to 2^18 a call's host work outlasts its kernels); then a warm Plonk prove
  at 2^16 gates (as ``plonk``) and a warm Groth16 prove at 2^16
  constraints (as ``bucket``) under ``torch.profiler``: kernel 1's device
  ms and traced launches, its launch count (``native.launches``), busy and
  wall ms (about two minutes);
* ``small``: kernels 6 and 7 over the small fields (``fields.Goldilocks``,
  ``fields.BabyBear``): fft at 2^20 points at 1, 2 and 4 rows and at 2^22
  (BabyBear also 2^24), each after its tables are built, whole calls and
  the passes' launches alone, and
  ``batch_inverse`` at the prover's shapes, base ``(L, 2, 2^22)`` and E
  ``(D L, 4, 2^22)`` (Goldilocks with Fp2, BabyBear with Fp4); then one
  warm 2^20-row Fibonacci prove over Goldilocks + Fp2 and one over
  BabyBear + Fp4 at ``ProofOptions(4, 32, 3, 0)`` under
  ``torch.profiler``: kernels 6 and 7's device ms and traced launches,
  their launch counts, busy and wall ms, and the inversions' part of
  kernel 6: the prove's ``batch_inverse`` calls (recorded by wrapping
  ``PrimeField.batch_inverse`` and ``DeviceQuadraticField.batch_inverse``
  while it runs) timed again at their shapes on random values (about a
  minute);
* ``dense``: kernels 8 and 9 over the dense fields (``fields.BN254Fr``,
  ``BN254Field``, ``BLS12377Fr``, ``BLS12377Field``): a product at 2^16,
  2^17, 2^18 and 2^22 and a sum at 2^22, the C entry ``lw_dense_field_op``
  alone in a loop on an output allocated once (its signature is the same
  in every version since slice 8); batch inversion at 2^16, 2^17, 2^18 and
  2^22, whole calls and the launches alone (``lw_dense_inverse``, or an
  older tree's ``lw_dense_batch_inverse`` on scratch allocated once), each
  output held against the plain version; Plonk's round-3 quotient at 2^18
  over BN254 Fr and Groth16's t and h at 2^17 over BLS12-377 Fr as the
  tree runs them (one program launch, ``ops.dense.Chain``, or one launch
  an op in an older tree), each held against the plain ops; then a warm
  Plonk prove at 2^16 gates and a warm Groth16 prove at 2^16 constraints
  under ``torch.profiler``: kernels 8 and 9's device ms and traced
  launches, their launch counts, busy and wall ms (about two minutes).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__:
    from ._timing import (cache_bytes, cuda_ms, digest, profile, random_dense, random_digits,
                          random_field, random_small, smi)
else:  # run as a script: this file's folder heads sys.path, whatever DIR holds
    from _timing import (cache_bytes, cuda_ms, digest, profile, random_dense, random_digits,
                         random_field, random_small, smi)

GROUPS = ("prove", "fft", "field", "inverse", "curve", "bucket", "plonk", "dense_fft", "small",
          "dense")


class Failed(Exception):
    pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("groups", nargs="*", choices=GROUPS, help="default: all")
    args = ap.parse_args()
    groups = args.groups or GROUPS
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("time_tree: no CUDA device", file=sys.stderr)
        return 2
    import lambda_elliptic_curves_tpu_torch as port
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
    from lambda_elliptic_curves_tpu_torch.ops import limbs
    from lambda_elliptic_curves_tpu_torch.poly import ntt
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions, prove, verify
    from lambda_elliptic_curves_tpu_torch.provers.stark import prover as prover_mod
    from lambda_elliptic_curves_tpu_torch.provers.stark.examples.fibonacci import (
        FibonacciPublicInputs, fibonacci_air_for, fibonacci_trace,
    )

    if not os.path.abspath(port.__file__).startswith(tree + os.sep):
        print(f"time_tree: imported {port.__file__}, not from {tree}", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(card, flush=True)
    t0 = time.perf_counter()
    native.cuda_lib()
    native.host_keccak()
    rec = {"tree": tree, "card": card, "build_s": time.perf_counter() - t0}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    f.mul(f.ones((4,), dev), f.ones((4,), dev))  # the card's context, outside every timing
    air, pub, opts = fibonacci_air_for(f), FibonacciPublicInputs(a0=1, a1=1), \
        ProofOptions(4, 32, 3, 0)

    def verified(proof, what):
        if not verify(air, proof, pub, opts, DefaultTranscript(f)):
            raise Failed(f"verify rejected the {what} proof")

    def prove_once():
        trace = fibonacci_trace(f, [1, 1], 1 << 20, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = prove(air, trace, pub, opts, DefaultTranscript(f), device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1000.0
        rec.setdefault("phases_ms", []).append(
            {k: round(v * 1000.0, 3) for k, v in prover_mod.last_timings.items()})
        return proof, ms

    def run_prove():
        proof, rec["first_prove_2^20_ms"] = prove_once()
        verified(proof, "first 2^20")
        rec["cached_after_first_prove"] = cache_bytes(ntt)
        _, warm1 = prove_once()
        for k in native.launches:
            native.launches[k] = 0
        keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
        before = torch.cuda.memory_stats()
        proof, warm2 = prove_once()
        after = torch.cuda.memory_stats()
        rec["allocator_during_warm_prove"] = {k: after.get(k, 0) - before.get(k, 0)
                                              for k in keys}
        rec["warm_prove_2^20_ms"] = [warm1, warm2]
        rec["launches_2^20"] = dict(native.launches)
        verified(proof, "warm 2^20")
        trace = fibonacci_trace(f, [1, 1], 1 << 20, dev)
        _, rec["profile_2^20"] = profile(
            lambda: prove(air, trace, pub, opts, DefaultTranscript(f), device=dev))

    def run_fft():
        for log_n in (18, 22):
            x = random_field((1 << log_n,), gen)
            rec[f"fft_2^{log_n}_ms"] = cuda_ms(lambda: ntt.fft(x, f), 20 if log_n < 22 else 10)
            if log_n == 22:
                rec["interpolate_2^22_ms"] = cuda_ms(lambda: ntt.interpolate_fft(f, x), 5)
        # the host's share: 200 transforms of 2^10 points back to back
        x = random_field((1 << 10,), gen)
        ntt.fft(x, f)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            ntt.fft(x, f)
        torch.cuda.synchronize()
        rec["fft_2^10_host_us"] = (time.perf_counter() - t) * 1e6 / 200

    def run_field():
        a, b = random_field((1 << 22,), gen), random_field((1 << 22,), gen)
        rec["mul_2^22_ms"] = cuda_ms(lambda: f.mul(a, b), 20)
        for log_n in (18, 24):
            x = random_field((1 << log_n,), gen)
            rec[f"pow_p-2_2^{log_n}_ms"] = cuda_ms(lambda: limbs.mont_pow(x, f.p - 2),
                                                   3 if log_n == 18 else 1)

    def run_inverse():
        for log_n in (18, 20, 23, 24):
            x = random_field((1 << log_n,), gen)
            x[:, ::1009] = 0
            if not torch.equal(f.batch_inverse(x), limbs.mont_pow(x, f.p - 2)):
                raise Failed(f"batch_inverse != Fermat at 2^{log_n}")
            rec[f"batch_inverse_2^{log_n}_ms"] = cuda_ms(lambda: f.batch_inverse(x),
                                                         20 if log_n <= 20 else 10)
        torch.cuda.empty_cache()
        for log_rows in (16, 20):
            trace = fibonacci_trace(f, [1, 1], 1 << log_rows, dev)
            prove(air, trace, pub, opts, DefaultTranscript(f), device=dev)  # tables built
            torch.cuda.synchronize()
            for k in native.launches:
                native.launches[k] = 0
            proof, stats = profile(
                lambda: prove(air, trace, pub, opts, DefaultTranscript(f), device=dev), top=40)
            verified(proof, f"2^{log_rows}")
            inv = [v for k, v in stats["by_kernel"].items() if "batch_inverse" in k]
            rec[f"prove_2^{log_rows}"] = {
                "batch_inverse_device_ms": sum(v["ms"] for v in inv),
                "batch_inverse_traced_launches": sum(v["launches"] for v in inv),
                "field_inv_launches": native.launches["field_inv"],
                "field_pow_launches": native.launches["field_pow"],
                "device_busy_ms": stats["device_busy_ms"], "wall_ms": stats["wall_ms"]}

    def run_curve():
        import ctypes

        from lambda_elliptic_curves_tpu_torch.curves import msm as M
        from lambda_elliptic_curves_tpu_torch.curves.twists import bls12_377_twist, bn254_twist
        from lambda_elliptic_curves_tpu_torch.curves.zoo import BLS12377Curve, BN254Curve

        lib = native.cuda_lib()
        comb_lanes = {"bn254_g1": 65542, "bn254_g2": 1 << 16, "bls12_377_g1": 5 << 16,
                      "bls12_377_g2": (1 << 16) + 6}

        out = rec["curve"] = {}
        for name, curve in (("bn254_g1", BN254Curve), ("bn254_g2", bn254_twist()),
                            ("bls12_377_g1", BLS12377Curve), ("bls12_377_g2", bls12_377_twist())):
            ops, g = M.make_ops(curve), torch.Generator(device=dev).manual_seed(41)
            fd, gid, r = ops.f, curve.kernel_group, out.setdefault(name, {})
            for n in (17 << 16, 1 << 16):
                a = (random_dense(fd, n, g), random_dense(fd, n, g), random_dense(fd, n, g))
                b = (random_dense(fd, n, g), random_dense(fd, n, g), fd.ones((n,), dev))
                arg_a, keep_a = ops.points_arg(a, (n,), n)
                arg_b, keep_b = ops.points_arg(b, (n,), n)
                args = (ctypes.c_long * 18)(*(arg_a + arg_b))
                o = tuple(torch.empty((fd.num_limbs, n), dtype=torch.int32, device=dev)
                          for _ in range(3))

                def launch():
                    rc = lib.lw_curve_op(gid, 1, args, *(x.data_ptr() for x in o), n,
                                         torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise Failed(f"{name}: lw_curve_op: CUDA error {rc}")
                r[f"add_mixed_{n}_ms"] = cuda_ms(launch, 10)
                r[f"add_mixed_{n}_whole_ms"] = cuda_ms(lambda: ops.add_mixed(a, b), 10)
                if n == 1 << 16:
                    r["add_mixed_digest"] = digest(o)
                del a, b, o, keep_a, keep_b
            n, bits = comb_lanes[name], curve.order.bit_length()
            digits = random_digits(bits, n, g, M.DIGIT_BITS)
            base = curve.generator()
            M.fixed_base_multiples(curve, digits[:, :1], base, ops)  # the table, cached
            torch.cuda.synchronize()
            counter = ops.counter("curve_op")
            native.launches[counter] = 0
            got = M.fixed_base_multiples(curve, digits, base, ops)
            torch.cuda.synchronize()
            r.update(comb_lanes=n, comb_launches=native.launches[counter],
                     comb_digest=digest(got),
                     comb_whole_ms=cuda_ms(lambda: M.fixed_base_multiples(curve, digits, base,
                                                                         ops), 5))
            if hasattr(lib, "lw_curve_comb"):
                windows = -(-bits // M.FIXED_BASE_WINDOW)
                table = M._comb_table(ops, base, M.FIXED_BASE_WINDOW, windows, dev)
                args = M.comb_args(table, digits, M.FIXED_BASE_WINDOW, windows)
                r["comb_ms"] = cuda_ms(lambda: lib.lw_curve_comb(
                    gid, args, *(x.data_ptr() for x in got), n,
                    torch.cuda.current_stream().cuda_stream), 10)
            del digits, got
            torch.cuda.empty_cache()

    def kernel_11(stats):
        k11 = [v for k, v in stats["by_kernel"].items() if "msm_bucket" in k]
        return {"kernel_11_device_ms": sum(v["ms"] for v in k11),
                "kernel_11_traced_launches": sum(v["launches"] for v in k11),
                "device_busy_ms": stats["device_busy_ms"], "wall_ms": stats["wall_ms"]}

    def run_bucket():
        import ctypes

        import numpy as np
        from lambda_elliptic_curves_tpu_torch.curves import msm as M
        from lambda_elliptic_curves_tpu_torch.curves.twists import bls12_377_twist
        from lambda_elliptic_curves_tpu_torch.curves.zoo import BLS12377Curve, BN254Curve

        n, c = 1 << 16, 15
        for name, curve in (("bn254_g1", BN254Curve), ("bls12_377_g1", BLS12377Curve),
                            ("bls12_377_g2", bls12_377_twist())):
            ops, rng = M.make_ops(curve), np.random.default_rng(21)
            fq = ops.f
            g2 = fq.num_limbs > 12
            vals = lambda: [int.from_bytes(rng.bytes(48), "little") % fq.p  # noqa: E731
                            for _ in range(2 * n if g2 else n)]
            coord = lambda v: fq.array(list(zip(v[::2], v[1::2])) if g2 else v, dev)  # noqa
            pts = (coord(vals()), coord(vals()), fq.ones((n,), dev))
            scalars = [int.from_bytes(rng.bytes(32), "little") % curve.order for _ in range(n)]
            digits = M.scalars_to_digits(curve, scalars, dev)
            ids = M.window_ids(digits, c, -(-curve.order.bit_length() // c))
            table = M.bucket_sums(ops, ids, pts, 1 << c)
            for k in native.launches:
                native.launches[k] = 0
            M.weighted_bucket_sums(ops, M.bucket_sums(ops, ids, pts, 1 << c))
            torch.cuda.synchronize()
            launches = sum(native.launches.values())
            rec[f"bucket_{name}"] = {
                "ms": cuda_ms(lambda: M.weighted_bucket_sums(ops, M.bucket_sums(
                    ops, ids, pts, 1 << c)), 3),
                "accumulate_ms": cuda_ms(lambda: M.bucket_sums(ops, ids, pts, 1 << c), 3),
                "reduce_ms": cuda_ms(lambda: M.weighted_bucket_sums(ops, table), 3),
                "launches": launches}
            del pts, table
            torch.cuda.empty_cache()
        lib = native.cuda_lib()
        for gid, name in enumerate(("bn254_g1", "bn254_g2", "bls12_377_g1", "bls12_377_g2")):
            occupancy = rec.setdefault("bucket_occupancy", {})[name] = {}
            for kind, what in enumerate(("accumulate, mixed", "accumulate", "reduce")):
                res = (ctypes.c_long * 2)()
                if lib.lw_msm_bucket_occupancy(gid, kind, M.BUCKET_TILE, res) != 0:
                    raise Failed(f"{name} {what}: the occupancy query failed")
                occupancy[what] = {"blocks_per_sm": res[0], "shared_bytes": res[1]}
        _, stats = profile(groth16_prover(), top=40)
        rec["groth16_2^16_warm"] = kernel_11(stats)

    def plonk_prover():
        import random

        from lambda_elliptic_curves_tpu_torch import fields
        from lambda_elliptic_curves_tpu_torch.commitments import (
            KateZaveruchaGoldberg, StructuredReferenceString,
        )
        from lambda_elliptic_curves_tpu_torch.curves.pairings import BN254Pairing
        from lambda_elliptic_curves_tpu_torch.provers.plonk import (
            CommonPreprocessedInput, ConstraintSystem, Prover, RandomFieldGenerator, Witness,
            setup as plonk_setup,
        )
        from lambda_elliptic_curves_tpu_torch.provers.plonk.circuits import (
            chain_circuit, chain_output, chain_steps,
        )

        fr, n = fields.BN254Fr, 1 << 16
        system = ConstraintSystem(fr)
        steps = chain_steps(n)
        x, y, e = chain_circuit(system, steps)
        assignments = system.solve({x: fr(4), e: fr(3), y: chain_output(fr, steps, 4, 3)})
        cpi = CommonPreprocessedInput.from_constraint_system(system, 7, device=dev)
        srs = StructuredReferenceString.insecure_setup(BN254Pairing, n + 6, tau=7913, device=dev)
        kzg = KateZaveruchaGoldberg(BN254Pairing, srs, device=dev)
        vk = plonk_setup(cpi, kzg)
        witness = Witness.new(assignments, system)
        public = system.public_input_values(assignments)
        prover = Prover(kzg, RandomFieldGenerator(fr, random.Random(1)))
        prover.prove(witness, public, cpi, vk)
        torch.cuda.synchronize()
        return lambda: prover.prove(witness, public, cpi, vk)

    def groth16_prover():
        import random

        from lambda_elliptic_curves_tpu_torch import fields
        from lambda_elliptic_curves_tpu_torch.curves.pairings import BLS12377Pairing
        from lambda_elliptic_curves_tpu_torch.provers.groth16 import (
            QuadraticArithmeticProgram, circuits, prove as g16_prove, setup as g16_setup,
        )

        cfg, m, fr = BLS12377Pairing, 1 << 16, fields.BLS12377Fr
        qap = QuadraticArithmeticProgram.from_r1cs(fr, circuits.chain_r1cs(m))
        witness = circuits.chain_witness(m, 3, 5, fr.p)
        pk, _ = g16_setup(qap, cfg, random.Random(9), device=dev)
        g16_prove(witness, qap, pk, cfg, random.Random(10), device=dev)
        torch.cuda.synchronize()
        return lambda: g16_prove(witness, qap, pk, cfg, random.Random(11), device=dev)

    def run_plonk():
        _, stats = profile(plonk_prover(), top=40)
        rec["plonk_2^16_warm"] = kernel_11(stats)

    def run_dense_fft():
        from lambda_elliptic_curves_tpu_torch import fields

        shapes = [(fields.BN254Fr, 16, 1), (fields.BN254Fr, 18, 1), (fields.BN254Fr, 22, 1),
                  (fields.BLS12377Fr, 16, 3), (fields.BLS12377Fr, 17, 3),
                  (fields.BLS12377Fr, 17, 1), (fields.BLS12377Fr, 22, 1)]
        # the plan the tree's fft runs (a tree before the dense plan: pass_plan)
        plan_of = getattr(ntt, "dense_pass_plan", ntt.pass_plan)
        for fr, log_n, rows in shapes:
            x = random_field((rows, 1 << log_n), gen)  # below 2^251 < p
            reps = 20 if log_n < 22 else 10
            key = f"{fr.name} fft 2^{log_n} x {rows}"
            rec[key + " ms"] = cuda_ms(lambda: ntt.fft(x, fr), reps)
            # the passes' launches alone, on buffers allocated once
            tables = ntt.twiddle_tables(fr, fr.params.primitive_root_of_unity(log_n), log_n,
                                        dev)
            out, buf = torch.empty_like(x), torch.empty_like(x)
            rec[key + " passes"] = plan_of(log_n)
            rec[key + " kernels ms"] = cuda_ms(lambda: ntt._launch(
                x, out, buf, tables, 0, plan_of(log_n)), reps)
            del x, out, buf
            torch.cuda.empty_cache()
        for name, counter, make in (("plonk_2^16_warm", "dense_ntt", plonk_prover),
                                    ("groth16_2^16_warm", "dense_ntt_bls12_377",
                                     groth16_prover)):
            prove_once = make()
            for k in native.launches:
                native.launches[k] = 0
            _, stats = profile(prove_once, top=60)
            k1 = [v for k, v in stats["by_kernel"].items() if "ntt" in k and "pass_kernel" in k]
            rec[name + "_kernel_1"] = {
                "kernel_1_device_ms": sum(v["ms"] for v in k1),
                "kernel_1_traced_launches": sum(v["launches"] for v in k1),
                "kernel_1_launches": native.launches[counter],
                "device_busy_ms": stats["device_busy_ms"], "wall_ms": stats["wall_ms"]}
            del prove_once
            torch.cuda.empty_cache()

    def run_small():
        from lambda_elliptic_curves_tpu_torch import fields
        from lambda_elliptic_curves_tpu_torch.fields import extensions
        from lambda_elliptic_curves_tpu_torch.fields import field as field_mod
        from lambda_elliptic_curves_tpu_torch.provers.stark.extension import ChallengeBundle

        proves = (("goldilocks_fp2", fields.Goldilocks, 2), ("babybear_fp4", fields.BabyBear, 4))
        base_of = {f.p: f for _, f, _ in proves}

        def values(fd, shape):
            """Random canonical values of ``fd`` (a field or a tower over
            one) as its (D L, *shape) limbs."""
            lb = base_of[fd.p].num_limbs
            x = random_small(lb, fd.p, (fd.num_limbs // lb,) + tuple(shape), gen)
            return x.transpose(0, 1).reshape((fd.num_limbs,) + tuple(shape))

        for name, f, degree in proves:
            fd = ChallengeBundle(f, degree).fd
            shapes = [(20, 1), (20, 2), (20, 4), (22, 1)] + ([(24, 1)] if degree == 4 else [])
            # the plan the tree's fft runs (a tree before plan_for: pass_plan)
            plan_of = getattr(ntt, "plan_for", lambda _, log_n: ntt.pass_plan(log_n))
            for log_n, rows in shapes:
                x = values(f, (rows, 1 << log_n))
                reps = 20 if log_n < 22 else 10
                key = f"{f.name} fft 2^{log_n} x {rows}"
                rec[key + " ms"] = cuda_ms(lambda: ntt.fft(x, f), reps)
                # the passes' launches alone, on buffers allocated once (a
                # whole call's host work outlasts its kernels at 2^20)
                tables = ntt.twiddle_tables(f, f.params.primitive_root_of_unity(log_n), log_n,
                                            dev)
                cur = x.reshape(f.num_limbs, rows, 1 << log_n)
                out, buf = torch.empty_like(cur), torch.empty_like(cur)
                rec[key + " passes"] = plan_of(f, log_n)
                rec[key + " kernels ms"] = cuda_ms(lambda: ntt._launch(
                    cur, out, buf, tables, 0, plan_of(f, log_n)), reps)
                del x, cur, out, buf
            base, ext = values(f, (2, 1 << 22)), values(fd, (4, 1 << 22))
            rec[f"{f.name} batch_inverse base (L, 2, 2^22) ms"] = cuda_ms(
                lambda: f.batch_inverse(base), 5)
            rec[f"{name} batch_inverse E (D L, 4, 2^22) ms"] = cuda_ms(
                lambda: fd.batch_inverse(ext), 5)
            del base, ext
            torch.cuda.empty_cache()
        for name, f, degree in proves:
            air_s, pub_s = fibonacci_air_for(f, degree), FibonacciPublicInputs(a0=1, a1=1)
            trace = fibonacci_trace(f, [1, 1], 1 << 20, dev)
            prove(air_s, trace, pub_s, opts, DefaultTranscript(f), device=dev)  # tables built
            torch.cuda.synchronize()
            calls, taps = [], {}
            for cls in (field_mod.PrimeField, extensions.DeviceQuadraticField):
                def tap(self, a, _orig=cls.batch_inverse):
                    calls.append((self, tuple(a.shape)))
                    return _orig(self, a)
                taps[cls] = cls.batch_inverse
                cls.batch_inverse = tap
            for k in native.launches:
                native.launches[k] = 0
            try:
                proof, stats = profile(lambda: prove(air_s, trace, pub_s, opts,
                                                     DefaultTranscript(f), device=dev), top=60)
            finally:
                for cls, orig in taps.items():
                    cls.batch_inverse = orig
            if not verify(air_s, proof, pub_s, opts, DefaultTranscript(f)):
                raise Failed(f"verify rejected the traced {name} proof")
            launches = dict(native.launches)
            inv_ms = []
            for obj, shape in calls:
                x = values(obj, shape[1:])
                inv_ms.append(cuda_ms(lambda: obj.batch_inverse(x), 5))
                del x

            def of(mark):
                hit = [v for k, v in stats["by_kernel"].items() if mark in k]
                return sum(v["ms"] for v in hit), sum(v["launches"] for v in hit)

            k6_ms, k6_traced = of("small_field")
            k7_ms, k7_traced = of("small_ntt")
            rec[f"prove_2^20_{name}"] = {
                "kernel_6_device_ms": k6_ms, "kernel_6_traced_launches": k6_traced,
                "kernel_6_launches": launches["small_field"],
                "kernel_6_inv_kernel_device_ms": of("small_field_inv")[0],
                "inversions": [{"shape": list(shape), "ms": ms}
                               for (_, shape), ms in zip(calls, inv_ms)],
                "inversions_ms": sum(inv_ms),
                "inversion_share_of_kernel_6": sum(inv_ms) / k6_ms if k6_ms else None,
                "kernel_7_device_ms": k7_ms, "kernel_7_traced_launches": k7_traced,
                "kernel_7_launches": launches["small_ntt"],
                "device_busy_ms": stats["device_busy_ms"], "wall_ms": stats["wall_ms"]}
            del trace, proof
            torch.cuda.empty_cache()

    def run_dense():
        import ctypes

        from lambda_elliptic_curves_tpu_torch import fields

        lib = native.cuda_lib()
        stream = torch.cuda.current_stream().cuda_stream
        no_exponent = (ctypes.c_uint32 * 12)()

        def canonical(fd, shape):
            """Random limbs of ``fd`` below p (the top limb below p's)."""
            x = torch.randint(-2**31, 2**31, (fd.num_limbs,) + tuple(shape), generator=gen,
                              device=dev, dtype=torch.int64)
            x[-1] = x[-1].abs() % (fd.p >> (32 * (fd.num_limbs - 1)))
            return x.to(torch.int32)

        def checked(rc, what):
            if rc != 0:
                raise Failed(f"{what}: CUDA error {rc}")

        for fd in (fields.BN254Fr, fields.BN254Field, fields.BLS12377Fr, fields.BLS12377Field):
            kid = fd.ops.kernel_id
            for log_n in (16, 17, 18, 22):
                n = 1 << log_n
                a, b = canonical(fd, (n,)), canonical(fd, (n,))
                out = torch.empty_like(a)
                reps = 20 if log_n < 22 else 10
                for op, code in (("mul", 2), ("add", 0))[:2 if log_n == 22 else 1]:
                    key = f"{fd.name} {op} 2^{log_n}"
                    launch = lambda code=code: checked(lib.lw_dense_field_op(  # noqa: E731
                        kid, code, a.data_ptr(), n, 1, b.data_ptr(), n, 1, out.data_ptr(), n,
                        no_exponent, 0, stream), "lw_dense_field_op")
                    launch()
                    want = (fd.ops.mont_mul_plain if op == "mul" else fd.ops.add_plain)(a, b)
                    if not torch.equal(out, want):
                        raise Failed(f"{key} != plain")
                    rec[key + " kernel ms"] = cuda_ms(launch, reps)
                a[:, ::1009] = 0
                want = fd.ops.batch_inverse_plain(a)
                key = f"{fd.name} batch_inverse 2^{log_n}"
                for k in native.launches:
                    native.launches[k] = 0
                if not torch.equal(fd.batch_inverse(a), want):
                    raise Failed(f"{key} != plain")
                rec[key + " launches"] = native.launches[fd.ops.inv_counter]
                rec[key + " ms"] = cuda_ms(lambda: fd.batch_inverse(a), reps)
                if hasattr(native.cuda_lib(), "lw_dense_inverse_info"):
                    launch = lambda: checked(lib.lw_dense_inverse(  # noqa: E731
                        kid, a.data_ptr(), out.data_ptr(), n, stream), "lw_dense_inverse")
                else:  # a tree before slice 14: three launches on scratch
                    words = ctypes.c_long()
                    lib.lw_dense_batch_inverse_plan(kid, n, ctypes.byref(words))
                    scratch = torch.empty(max(words.value, 1), dtype=torch.int32, device=dev)
                    launch = lambda scratch=scratch: checked(  # noqa: E731
                        lib.lw_dense_batch_inverse(kid, a.data_ptr(), out.data_ptr(),
                                                   scratch.data_ptr(), n, stream),
                        "lw_dense_batch_inverse")
                launch()
                if not torch.equal(out, want):
                    raise Failed(f"{key} launches alone != plain")
                rec[key + " kernel ms"] = cuda_ms(launch, reps)
                del a, b, out, want
                torch.cuda.empty_cache()

        def quotient(F, e, c):
            """provers/plonk/prover.py's quotient_evaluations (slice 14), here
            so that it runs against any tree's field ops"""
            add3 = lambda u, v, w: F.add(F.add(u, v), w)  # noqa: E731
            a, b, cc = e["a"], e["b"], e["c"]
            gates = add3(F.add(F.mul(F.mul(a, b), e["qm"]), F.mul(a, e["ql"])),
                         F.add(F.mul(b, e["qr"]), F.mul(cc, e["qo"])), F.add(e["qc"], e["pi"]))
            beta, gamma = c["beta"], c["gamma"]
            xb = F.mul(e["x"], beta)
            f_i = F.mul(F.mul(add3(a, xb, gamma), add3(b, F.mul(xb, c["k1"]), gamma)),
                        add3(cc, F.mul(xb, c["k2"]), gamma))
            g_i = F.mul(F.mul(add3(a, F.mul(e["s1"], beta), gamma),
                              add3(b, F.mul(e["s2"], beta), gamma)),
                        add3(cc, F.mul(e["s3"], beta), gamma))
            perm1 = F.sub(F.mul(g_i, e["zw"]), F.mul(f_i, e["z"]))
            perm2 = F.mul(F.sub(e["z"], c["one"]), e["l1"])
            num = F.add(F.mul(F.add(F.mul(perm2, c["alpha"]), perm1), c["alpha"]), gates)
            return F.mul(num, e["zh_inv"])

        def t_of(F, e, c):  # provers/groth16/qap.py's t, then h
            return F.sub(F.mul(e["t"], c["off"]), c["one"])

        def h_of(F, e, c):
            return F.mul(F.sub(F.mul(e["l"], e["r"]), e["o"]), e["t_inv"])

        names = ("a", "b", "c", "ql", "qr", "qm", "qo", "qc", "pi", "x", "z", "zw", "s1", "s2",
                 "s3", "l1", "zh_inv")
        fr = fields.BN254Fr
        ev = {k: canonical(fr, (1 << 18,)) for k in names}
        cs = {k: canonical(fr, (1,)) for k in ("beta", "gamma", "k1", "k2", "alpha", "one")}
        fb = fields.BLS12377Fr
        lrc = canonical(fb, (3, 1 << 17))
        ev_h = {"t": canonical(fb, (1 << 17,)), "l": lrc[:, 0], "r": lrc[:, 1], "o": lrc[:, 2],
                "t_inv": canonical(fb, (1 << 17,))}
        cs_h = {"off": canonical(fb, (1,)), "one": fb.ones((1,), dev)}
        plain = lambda fd: fd.plain() if hasattr(fd, "plain") else fd  # noqa: E731
        cases = {"plonk quotient 2^18": (fr, quotient, ev, cs),
                 "groth16 t 2^17": (fb, t_of, ev_h, cs_h),
                 "groth16 h 2^17": (fb, h_of, ev_h, cs_h)}
        for key, (fd, expr, e, c) in cases.items():
            if hasattr(fd.ops, "chain"):  # one program launch
                def run(fd=fd, expr=expr, e=e, c=c):
                    ch = fd.ops.chain()
                    ins = lambda d: {k: ch.input(v) for k, v in d.items()}  # noqa: E731
                    return ch.run(expr(ch, ins(e), ins(c)))
            else:  # one launch an op
                run = lambda fd=fd, expr=expr, e=e, c=c: expr(fd, e, c)  # noqa: E731
            for k in native.launches:
                native.launches[k] = 0
            got = run()
            rec[key + " launches"] = {k: v for k, v in native.launches.items() if v}
            if not torch.equal(got, expr(plain(fd), e, c)):
                raise Failed(f"{key} != plain")
            rec[key + " ms"] = cuda_ms(run, 20)
        del ev, cs, lrc, ev_h
        torch.cuda.empty_cache()
        for name, make, suffix in (("plonk_2^16_warm", plonk_prover, ""),
                                   ("groth16_2^16_warm", groth16_prover, "_bls12_377")):
            prove_once = make()
            for k in native.launches:
                native.launches[k] = 0
            _, stats = profile(prove_once, top=80)

            def of(*marks):
                hit = [v for k, v in stats["by_kernel"].items() if any(m in k for m in marks)]
                return sum(v["ms"] for v in hit), sum(v["launches"] for v in hit)

            k8_ms, k8_traced = of("dense_field_op", "dense_field_program")
            k9_ms, k9_traced = of("dense_inverse", "batch_inverse")
            rec[name + "_kernels_8_9"] = {
                "kernel_8_device_ms": k8_ms, "kernel_8_traced_launches": k8_traced,
                "kernel_8_program_device_ms": of("dense_field_program")[0],
                "kernel_8_launches": native.launches["dense_field" + suffix]
                + native.launches.get("dense_program" + suffix, 0),
                "kernel_8_program_launches": native.launches.get("dense_program" + suffix, 0),
                "kernel_9_device_ms": k9_ms, "kernel_9_traced_launches": k9_traced,
                "kernel_9_launches": native.launches["dense_inv" + suffix],
                "device_busy_ms": stats["device_busy_ms"], "wall_ms": stats["wall_ms"]}
            del prove_once
            torch.cuda.empty_cache()

    runs = {"prove": run_prove, "fft": run_fft, "field": run_field, "inverse": run_inverse,
            "curve": run_curve, "bucket": run_bucket, "plonk": run_plonk, "dense_fft": run_dense_fft,
            "small": run_small, "dense": run_dense}
    try:
        for group in GROUPS:
            if group in groups:
                runs[group]()
                torch.cuda.empty_cache()
    except Failed as e:
        print(f"time_tree: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
