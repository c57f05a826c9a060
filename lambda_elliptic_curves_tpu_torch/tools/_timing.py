"""Measurement helpers shared by ``chip_smoke.py`` and the tools in this
folder: the card's ``nvidia-smi`` fields, a CUDA-event timer, a
``torch.profiler`` summary, the device bytes held by a module's caches,
and random field limbs drawn on the card.

Imports nothing of the port, so that ``tools/time_tree.py``, run as a
script, can load it from this folder beside any checkout of the port.
"""

from __future__ import annotations

import subprocess
import time


def smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` for the
    first card, e.g. ``smi("name,power.limit")``."""
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unknown"


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, one
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


def profile(fn, top: int = 12):
    """(fn(), stats) with fn run under ``torch.profiler``: wall ms (host
    clock, ending in a synchronise), device busy ms (the union of kernel and
    copy intervals on the card), idle share of the wall time, the kernels
    launched (copies and memsets left out), and ms and launches of the
    ``top`` largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    spans, by_kernel, kernels = [], {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        kernels += not e.name.startswith(("Memcpy", "Memset"))
        name = e.name.split("(")[0].split("<")[0].replace("void ", "").strip()
        ms, count = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy, reach = busy + end - start, end
        elif end > reach:
            busy, reach = busy + end - reach, end
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return value, {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
                   "idle_share": 1.0 - busy / 1e3 / wall_ms if wall_ms else None,
                   "kernels": kernels,
                   "by_kernel": {k: {"ms": round(v[0], 4), "launches": v[1]}
                                 for k, v in ranked}}


def traced_kernels(fn, expect: int, tries: int = 3) -> list:
    """Names of the kernels that ``fn()`` ran on the card (copies and
    memsets left out), one list per ``torch.profiler`` trace.

    The tracer does not promise to keep every kernel record: in one run of
    ``chip_smoke.py`` the trace of fft 2^22 held two of its three pass
    launches.  So one trace of nothing warms the tracer up, and ``fn`` is
    then traced up to ``tries`` times, until a trace holds ``expect``
    kernels.  The caller checks every trace for foreign kernels and the last
    for the full count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    traces = []
    for _ in range(tries):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        traces.append([e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                       and not e.name.startswith(("Memcpy", "Memset"))])
        if len(traces[-1]) == expect:
            break
    return traces


def cache_bytes(module) -> dict:
    """Entries and device bytes of every ``*_cache`` dict of ``module`` (its
    tensors, and tensors inside tuple values)."""
    import torch

    out = {}
    for name, val in vars(module).items():
        if not (name.endswith("_cache") and isinstance(val, dict)):
            continue
        total = 0
        for v in val.values():
            for t in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    total += t.numel() * t.element_size()
        out[name] = {"count": len(val), "bytes": total}
    return out


def random_field(shape: tuple, gen):
    """``(8, *shape)`` int32 Stark252 limbs of values below 2^251 < p, drawn
    from the generator ``gen`` on its device."""
    import torch

    x = torch.randint(-2**31, 2**31, (8,) + tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.int64).to(torch.int32)
    x[7] &= 0x07FFFFFF
    return x


def random_small(limbs: int, p: int, shape: tuple, gen):
    """``(limbs, *shape)`` int32 limbs of canonical values of a field p <
    2^(32 limbs) (Goldilocks: 2, BabyBear: 1), drawn from the generator
    ``gen`` on its device: BabyBear uniform in [0, p); Goldilocks two
    32-bit halves, the high one below 2^32 - 1, so every value is below
    2^64 - 2^32 < p."""
    import torch

    if limbs == 1:
        x = torch.randint(0, p, (1,) + tuple(shape), generator=gen, device=gen.device,
                          dtype=torch.int64)
    else:
        x = torch.randint(0, 1 << 32, (2,) + tuple(shape), generator=gen, device=gen.device,
                          dtype=torch.int64)
        x[1] %= (1 << 32) - 1
    return x.to(torch.int32)


def random_dense(f, n: int, gen):
    """``(f.num_limbs, n)`` int32 limbs of canonical values of the dense
    field ``f`` (both components of an Fp2 value, whose field has a
    ``prime``), drawn from ``gen`` on its device: each base value's top limb
    below p's."""
    import torch

    prime = getattr(f, "prime", f)
    L = prime.num_limbs
    x = torch.randint(0, 1 << 32, (f.num_limbs, n), generator=gen, device=gen.device,
                      dtype=torch.int64)
    for k in range(L - 1, f.num_limbs, L):
        x[k] %= prime.p >> (32 * (L - 1))
    return x.to(torch.int32)


def random_digits(bits: int, n: int, gen, digit_bits: int = 16):
    """``(ceil(bits / digit_bits), n)`` int64 digits of n random scalars
    below 2^bits, drawn from ``gen`` on its device (the layout of the port's
    ``curves.msm.scalars_to_digits``)."""
    import torch

    rows = -(-bits // digit_bits)
    d = torch.randint(0, 1 << digit_bits, (rows, n), generator=gen, device=gen.device,
                      dtype=torch.int64)
    d[-1] &= (1 << (bits - digit_bits * (rows - 1))) - 1
    return d


def digest(tensors) -> str:
    """A short hash of the tensors' bytes: outputs compared across
    processes and checkouts."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]
