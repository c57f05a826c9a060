"""Time the port's NTT and the prove around it on one NVIDIA card, for any
checkout of the port: this one, or an older one unpacked beside it, so that
two versions are compared in one machine's run.

    python3 lambda_elliptic_curves_tpu_torch/tools/time_fft.py [--tree DIR]

Run as a script (not with ``-m``): it imports ``lambda_elliptic_curves_tpu_torch``
from DIR (default: the checkout holding this file) and only through the
entry points every version has: ``poly.ntt.fft``, ``poly.ntt.interpolate_fft``,
``provers.stark.prove`` and ``native.launches``.  In one process it
measures, on the card:

* the first Fibonacci prove at 2^20 rows, ``ProofOptions(4, 32, 3, 0)``
  (it builds the NTT's tables), then two warm proves (host clock around
  work ending in a synchronise), kernel launches of the second and the
  device allocations (``cudaMalloc`` / ``cudaFree``) the caching allocator
  made during it;
* device bytes held by the NTT module's caches after the first prove;
* a ``torch.profiler`` trace of one more warm prove: device busy ms and
  time and launches of the largest kernels;
* fft of 2^18 and 2^22 points and ``interpolate_fft`` of 2^22 evaluations,
  CUDA-event means after one warm-up;
* the wall time per call of 200 ffts of 2^10 points back to back (host
  bound: what one call costs the host).

Each prove's ``prover.last_timings`` (ms per phase) is kept beside it.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__:
    from ._timing import cache_bytes, cuda_ms, profile, random_field, smi
else:  # run as a script: this file's folder heads sys.path, whatever DIR holds
    from _timing import cache_bytes, cuda_ms, profile, random_field, smi


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("time_fft: no CUDA device", file=sys.stderr)
        return 2
    import lambda_elliptic_curves_tpu_torch as port
    from lambda_elliptic_curves_tpu_torch import native
    from lambda_elliptic_curves_tpu_torch.fields import Stark252 as f
    from lambda_elliptic_curves_tpu_torch.fiat_shamir import DefaultTranscript
    from lambda_elliptic_curves_tpu_torch.poly import ntt
    from lambda_elliptic_curves_tpu_torch.provers.stark import ProofOptions, prove, verify
    from lambda_elliptic_curves_tpu_torch.provers.stark import prover as prover_mod
    from lambda_elliptic_curves_tpu_torch.provers.stark.examples.fibonacci import (
        FibonacciPublicInputs, fibonacci_air_for, fibonacci_trace,
    )

    if not os.path.abspath(port.__file__).startswith(tree + os.sep):
        print(f"time_fft: imported {port.__file__}, not from {tree}", file=sys.stderr)
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

    proof, rec["first_prove_2^20_ms"] = prove_once()
    if not verify(air, proof, pub, opts, DefaultTranscript(f)):
        print("time_fft: verify rejected the first 2^20 proof", file=sys.stderr)
        return 1
    rec["cached_after_first_prove"] = cache_bytes(ntt)
    _, warm1 = prove_once()
    for k in native.launches:
        native.launches[k] = 0
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    before = torch.cuda.memory_stats()
    proof, warm2 = prove_once()
    after = torch.cuda.memory_stats()
    rec["allocator_during_warm_prove"] = {k: after.get(k, 0) - before.get(k, 0) for k in keys}
    rec["warm_prove_2^20_ms"] = [warm1, warm2]
    rec["launches_2^20"] = dict(native.launches)
    if not verify(air, proof, pub, opts, DefaultTranscript(f)):
        print("time_fft: verify rejected the warm 2^20 proof", file=sys.stderr)
        return 1
    trace = fibonacci_trace(f, [1, 1], 1 << 20, dev)
    _, rec["profile_2^20"] = profile(
        lambda: prove(air, trace, pub, opts, DefaultTranscript(f), device=dev))
    del trace, proof
    for log_n in (18, 22):
        x = random_field((1 << log_n,), gen)
        rec[f"fft_2^{log_n}_ms"] = cuda_ms(lambda: ntt.fft(x, f), 20 if log_n < 22 else 10)
        if log_n == 22:
            rec["interpolate_2^22_ms"] = cuda_ms(lambda: ntt.interpolate_fft(f, x), 5)
        del x
    # the host's share: 200 transforms of 2^10 points back to back
    x = random_field((1 << 10,), gen)
    ntt.fft(x, f)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        ntt.fft(x, f)
    torch.cuda.synchronize()
    rec["fft_2^10_host_us"] = (time.perf_counter() - t) * 1e6 / 200
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
