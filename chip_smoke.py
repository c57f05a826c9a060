#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lambda_elliptic_curves_tpu_torch``) on
one NVIDIA card: builds the CUDA kernels from ``csrc/``, holds each kernel
against its plain PyTorch version on the card, then drives the Stark252
Fibonacci STARK prover end to end.

    python3 chip_smoke.py

Phases (one result line each, with its seconds):
  1. card name and power limit (nvidia-smi); kernel build
  2. every kernel against its plain version on the card (bitwise), host-int
     spot checks, and kernel / plain timings at the prover's shapes
  3. Fibonacci 2^10 rows, ProofOptions(4, 32, 3, 0): serialized proof
     byte-equal to the JAX package's checked-in proof; verify accepts it and
     rejects it with fri_last_value + 1
  4. Fibonacci 2^16 rows as bench.py's stark_fib_prove runs it: one warm-up
     prove, a timed prove (kernel launch counts reset just before it) and
     verify
  5. prove + verify at 2^20 rows: a first prove (it builds the twiddle
     tables of the new sizes), then a timed prove and verify
  6. launch count of each kernel during phase 4's timed prove (each > 0)

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any mismatch or exception exits
non-zero without that line.  Exits non-zero at once without a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
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
}


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events, one
    warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ---------------------------------------------------------------------------

def phase_build(state):
    from lambda_elliptic_curves_tpu_torch import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    state["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(state["smi"], flush=True)

    @phase("1 build")
    def run():
        t0 = time.perf_counter()
        native.cuda_lib()
        native.host_keccak()
        state["build_s"] = time.perf_counter() - t0
        return f"kernels built in {state['build_s']:.1f}s from {CSRC}/*.cu"
    run()


def _random_field(n: int, gen, dev):
    """(8, n) canonical values below 2^251 < p, with edge values first."""
    import torch
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f

    x = torch.randint(-2**31, 2**31, (8, n), generator=gen, dtype=torch.int64)
    x = x.to(torch.int32)
    x[7] &= 0x07FFFFFF
    edge = f.array([0, 1, f.p - 1, f.p - 2], "cpu")
    x[:, :4] = edge
    return x.to(dev)


def phase_kernels(state):
    import numpy as np
    import torch
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.hashes import keccak
    from lambda_elliptic_curves_tpu_torch.ops import limbs
    from lambda_elliptic_curves_tpu_torch.poly import ntt

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rec = state["kernels"]

    @phase("2a keccak")
    def run_keccak():
        st = torch.randint(-2**31, 2**31, (25, 2, 1 << 16), generator=gen,
                           dtype=torch.int64).to(torch.int32).to(dev)
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
                                  dtype=torch.int64).to(torch.int32).to(dev)
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
        rec["keccak"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             shape="keccak256_words, 2^18 messages of 64 B")
        return ("keccak_f 2^16 states and keccak256_words 2^18 x {32,64} B bitwise equal; "
                + ", ".join(f"{b} B: kernel {t[0]:.4f} ms plain {t[1]:.3f} ms"
                            for b, t in times.items()))
    run_keccak()

    @phase("2b field")
    def run_field():
        n = 1 << 20
        a, b = _random_field(n, gen, dev), _random_field(n, gen, dev).flip(1)
        err = 0
        pairs = [(f.add(a, b), limbs.add_plain(a, b)), (f.sub(a, b), limbs.sub_plain(a, b)),
                 (f.mul(a, b), limbs.mont_mul_plain(a, b)),
                 (f.batch_inverse(a), limbs.batch_inverse_plain(a))]
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
            "inv": [0 if x == 0 else pow(x * r_inv, -1, f.p) * 2**256 % f.p for x in av],
        }
        for (got, _), name in zip(pairs, host):
            check([int(v) for v in limbs.limbs_to_ints(got[:, idx])] == host[name],
                  f"field {name} kernel != host ints")
        m = 1 << 18
        a2, b2 = a[:, :m].contiguous(), b[:, :m].contiguous()
        ms = cuda_ms(lambda: f.mul(a2, b2), 50)
        plain_ms = cuda_ms(lambda: limbs.mont_mul_plain(a2, b2), 3)
        inv_ms = cuda_ms(lambda: f.batch_inverse(a2), 5)
        inv_plain_ms = cuda_ms(lambda: limbs.batch_inverse_plain(a2), 2)
        rec["field"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            shape="mul, 2^18 elements")
        state["field_extra"] = {"inv_2^18_ms": inv_ms, "inv_2^18_plain_ms": inv_plain_ms}
        return (f"add/sub/mul/inv on 2^20 bitwise equal, 64 host spot checks; mul 2^18: "
                f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms; batch_inverse 2^18: kernel "
                f"{inv_ms:.3f} ms plain {inv_plain_ms:.3f} ms")
    run_field()

    @phase("2c local ntt")
    def run_local():
        err = 0
        for log_n in range(1, 12):
            n = 1 << log_n
            x = _random_field(64 * n, gen, dev).reshape(8, 64, n)
            root = f.params.primitive_root_of_unity(log_n)
            err = max(err, max_abs_err(ntt.local_ntt(x, f, root),
                                       ntt._local_plain_any(x, f, root)))
        check(err == 0, "local NTT kernel != plain")
        return "n = 2^1 .. 2^11 (64 rows each) bitwise equal"
    run_local()

    @phase("2d fft")
    def run_fft():
        err = 0
        times = {}
        for log_n in (14, 16, 18, 22):
            n = 1 << log_n
            x = _random_field(n, gen, dev)
            root = f.params.primitive_root_of_unity(log_n)
            got = ntt.fft(x, f)
            err = max(err, max_abs_err(got, ntt.fft_with_root_plain(x, f, root)))
            check(err == 0, f"fft 2^{log_n} kernel path != plain path")
            check(torch.equal(ntt.ifft(got, f), x), f"ifft(fft(x)) != x at 2^{log_n}")
            times[log_n] = (cuda_ms(lambda: ntt.fft(x, f), 10 if log_n < 22 else 5),
                            cuda_ms(lambda: ntt.fft_with_root_plain(x, f, root), 1))
        ms, plain_ms = times[18]
        rec["ntt"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          shape="fft 2^18 (four-step over 2^9-point local kernels)")
        state["fft_times"] = times
        return "fft 2^14/16/18/22 equal to plain, ifft round trip; " + ", ".join(
            f"2^{k}: kernel {t[0]:.3f} ms plain {t[1]:.1f} ms" for k, t in times.items())
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
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions
    from lambda_elliptic_curves_tpu_torch.provers.stark import prover as prover_mod

    @phase("5 stark_fib_prove_2^20")
    def run():
        dev, opts = torch.device("cuda"), ProofOptions(4, 32, 3, 0)
        _, first_ms, ok = _prove_verify(1 << 20, dev, opts)  # builds the twiddle tables
        check(ok, "verify rejected the first 2^20 proof")
        torch.cuda.reset_peak_memory_stats()
        proof, ms, ok = _prove_verify(1 << 20, dev, opts)
        check(ok, "verify rejected the 2^20 proof")
        phases = {k: round(v * 1000.0, 3) for k, v in prover_mod.last_timings.items()}
        state["prove_20"] = {"ms": ms, "first_ms": first_ms, "phases_ms": phases}
        return json.dumps({"metric": "stark_fib_prove_2^20", "value": round(ms, 3),
                           "unit": "ms", "check": "ok", "first_prove_ms": round(first_ms, 3),
                           "phases_ms": phases,
                           "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
    run()


def phase_launches(state):
    @phase("6 launch counts")
    def run():
        counts = state["launches"]
        for name in KERNELS:
            check(counts.get(name, 0) > 0, f"kernel {name} was not launched by the prover")
            state["kernels"][name]["launches"] = counts[name]
        return json.dumps(counts)
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
                          phase_big, phase_launches):
            run_phase(state)
    except Exception as e:  # noqa: BLE001 — report the failing phase, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    summary = {"card": state["smi"], "build_s": round(state["build_s"], 3),
               "fft_ms": {f"2^{k}": {"kernel": round(t[0], 4), "plain": round(t[1], 3)}
                          for k, t in state["fft_times"].items()},
               "interpolate_2^22_ms": state["interp_22_ms"],
               "field": state["field_extra"],
               "prove_2^16": state["prove_16"], "prove_2^20": state["prove_20"]}
    print("summary " + json.dumps(summary), flush=True)
    print(json.dumps({"kernels": list(state["kernels"].values())}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
