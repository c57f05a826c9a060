#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lambda_elliptic_curves_tpu_torch``) on
one NVIDIA card: builds the CUDA kernels from ``csrc/``, holds each kernel
against its plain PyTorch version on the card, then drives the Stark252
Fibonacci STARK prover end to end.

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
     launches and no other device work
  3. Fibonacci 2^10 rows, ProofOptions(4, 32, 3, 0): serialized proof
     byte-equal to the JAX package's checked-in proof; verify accepts it and
     rejects it with fri_last_value + 1
  4. Fibonacci 2^16 rows as bench.py's stark_fib_prove runs it: one warm-up
     prove, a timed prove (kernel launch counts reset just before it) and
     verify
  5. prove + verify at 2^20 rows: a first prove (it builds the NTT's root
     tables of the new sizes), the device bytes of every NTT cache after it,
     then a timed prove (launch counts reset just before it) and verify
  6. launch count of each kernel during the timed proves of phases 4 and 5
     (each > 0; batch inversion exactly 6 at each size, two calls of 3
     launches; none of the Fermat kernel ``field_pow``)
  7. a torch.profiler trace of one warm prove at 2^16 and at 2^20 rows:
     device busy time, idle share, time and launches by kernel

Each kernel's ``bound_ms`` is the larger of its bytes (inputs read once,
outputs written once) over the card's memory rate and its 32-bit integer
operations over the card's integer rates, each pipe and the issue rate
(see ``bound``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any mismatch or exception exits
non-zero without that line.  Exits non-zero at once without a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "jax_fib_1024_proof.json")
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
}

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
KECCAK_F_OPS = (0, 24 * 190, 0)


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
        t0 = time.perf_counter()
        native.cuda_lib()
        native.host_keccak()
        state["build_s"] = time.perf_counter() - t0
        return f"kernels built in {state['build_s']:.1f}s from {CSRC}/*.cu"
    run()


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


def _eval_at(f, coeffs, x: int) -> int:
    """p(x) by even/odd folding on the card: p(x) = e(x^2) + x*o(x^2)."""
    out = coeffs
    while out.shape[-1] > 1:
        xc = f.constant(x, (1,), out.device)
        out = f.add(out[..., 0::2], f.mul(xc, out[..., 1::2]))
        x = x * x % f.p
    return int(f.to_ints(out)[0])


def _fib(rows, dev):
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.provers.stark.examples.fibonacci import (
        FibonacciPublicInputs, fibonacci_air_for, fibonacci_trace,
    )
    return (fibonacci_air_for(f), fibonacci_trace(f, [1, 1], rows, dev),
            FibonacciPublicInputs(a0=1, a1=1))


def _prove_verify(rows, dev, options):
    import torch
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
    from lambda_elliptic_curves_tpu_torch.provers.stark import prove, verify

    air, trace, pub = _fib(rows, dev)
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


def phase_launches(state):
    @phase("6 launch counts")
    def run():
        for rows, counts in (("2^16", state["launches"]), ("2^20", state["launches_20"])):
            for name in KERNELS:
                check(counts.get(name, 0) > 0,
                      f"kernel {name} was not launched by the {rows}-row prove")
            check(counts.get("field_pow", 0) == 0, f"the {rows}-row prove inverted by Fermat "
                  "(field_pow) instead of the batch-inverse kernel")
            # two calls, (8, 2, N) and (8, 4, N) with N the LDE size (2^18 at
            # 2^16 rows, 2^22 at 2^20 rows), of two levels, 3 launches, each
            want = {"2^16": 6, "2^20": 6}[rows]
            check(counts.get("field_inv") == want, f"the {rows}-row prove launched batch "
                  f"inversion {counts.get('field_inv')} times, not {want}")
        for name in KERNELS:
            state["kernels"][name]["launches"] = state["launches"][name]
        return json.dumps({"2^16": state["launches"], "2^20": state["launches_20"]})
    run()


def _profile_prove(rows: int) -> dict:
    """Device time of one warm prove from a torch.profiler trace
    (``tools/_timing.py``'s ``profile``): wall time, device busy time,
    idle share, and time and launches by kernel."""
    import torch

    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions, prove, verify
    from lambda_elliptic_curves_tpu_torch.tools._timing import profile

    dev, opts = torch.device("cuda"), ProofOptions(4, 32, 3, 0)
    _prove_verify(rows, dev, opts)  # warm
    air, trace, pub = _fib(rows, dev)
    torch.cuda.synchronize()
    # the window holds the prove alone: not the trace's upload, not verify
    proof, stats = profile(
        lambda: prove(air, trace, pub, opts, DefaultTranscript(f), device=dev))
    check(verify(air, proof, pub, opts, DefaultTranscript(f)),
          f"verify rejected the profiled 2^{rows.bit_length() - 1} proof")
    return stats


def phase_profile(state):
    @phase("7 profile")
    def run():
        state["profile"] = {f"2^{lg}": _profile_prove(1 << lg) for lg in (16, 20)}
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
        for run_phase in (phase_build, phase_kernels, phase_fixture, phase_bench,
                          phase_big, phase_launches, phase_profile):
            run_phase(state)
    except Exception as e:  # noqa: BLE001 — report the failing phase, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    summary = {"card": state["smi"], "build_s": round(state["build_s"], 3),
               "fft_ms": {f"2^{k}": {"kernel": t[0], "bound": t[1]}
                          for k, t in state["fft_times"].items()},
               "interpolate_2^22_ms": state["interp_22_ms"],
               "field": state["field_extra"],
               "batch_inverse": {**{f"2^{k}": t for k, t in state["inv_times"].items()},
                                 **state["inv_extra"]},
               "prove_2^16": state["prove_16"], "prove_2^20": state["prove_20"],
               "launches_2^16": state["launches"], "launches_2^20": state["launches_20"],
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
