"""Time the batch-inversion kernel over its tile, T threads per block and L
elements per thread, at every batch size n = 2^18 .. 2^24 on one NVIDIA
card, beside the port's own ``batch_inverse``; ``csrc/batch_inverse.cuh``'s
``LW_INV_THREADS`` and ``lw_inv_walk`` come from this sweep.  Also the latency of one inversion by
the two candidates, which at small n sets the kernel's time:
``lw_mont_inv`` (``mont.cuh``, a binary extended Euclid on the limbs) and
a fixed addition chain for a^(p-2) (written here only to be timed); the latency of one product and one squaring; and their
rates on 2^20 threads; ptxas's registers for each of the kernel's three
modes (up, top, down).

    python3 -m lambda_elliptic_curves_tpu_torch.tools.sweep_batch_inverse

The kernel runs through a launch entry that this script builds with
``nvcc`` from ``csrc/batch_inverse.cu`` (the port's entry fixes T and L;
this one takes them).  Each output is held bitwise against the plain
version before it is timed, and both inversions against the plain version
on 4096 values; times are CUDA-event means after one warm-up launch.  A
latency is one thread's chain of k operations, (time(1 + k) - time(1)) / k.
Prints the card's name and power limit, one JSON line per size, and as the
last line a JSON object with everything.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from .. import native
from ._timing import cuda_ms, random_field, smi

THREADS = (64, 128, 256)
WALKS = (4, 8, 16, 32, 64, 128)
LOG_SIZES = (18, 20, 22, 23, 24)
OPS = {"inv_chain": 0, "inv_gcd": 1, "mul": 2, "sqr": 3}

_SRC = r"""
#include "batch_inverse.cu"

// a^-1 (Montgomery form) as a^(p-2) by a fixed addition chain, the other
// candidate for lw_mont_inv: p - 2 = 2^251 + 2^196 + 2^192 - 1 is, from the
// top, a one, 54 zeros, a one, 4 zeros and 192 ones; w = a^(2^16 - 1) takes
// 15 squarings and 4 products, then a is squared 55 times, multiplied by
// a, squared 4 times, and twelve times squared 16 times and multiplied by
// w: 266 squarings and 17 products
__device__ void sqr_n(uint32_t a[8], int k) {
#pragma unroll 1
    for (int i = 0; i < k; i++) lw_mont_sqr(a, a);
}

__device__ void chain_inv(const uint32_t a[8], uint32_t r[8]) {
    uint32_t w[8], t[8];
    lw_copy(a, w);
#pragma unroll 1
    for (int k = 1; k < 16; k *= 2) {
        lw_copy(w, t);
        sqr_n(t, k);
        lw_mont_mul(t, w, w);
    }
    lw_copy(a, t);
    sqr_n(t, 55);
    lw_mont_mul(t, a, t);
    sqr_n(t, 4);
#pragma unroll 1
    for (int i = 0; i < 12; i++) {
        sqr_n(t, 16);
        lw_mont_mul(t, w, t);
    }
    lw_copy(t, r);
}

// out[:, i] = op applied reps times to x[:, i], one thread per element
__global__ void op_kernel(const int32_t* x, int32_t* out, long n, int op, int reps) {
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t v[8], w[8];
    lw_load_plane(x, n, i, v);
    lw_copy(v, w);
    for (int k = 0; k < reps; k++) {
        if (op == 0) chain_inv(v, v);
        else if (op == 1) lw_mont_inv(v, v);
        else if (op == 2) lw_mont_mul(v, w, v);
        else lw_mont_sqr(v, v);
    }
    lw_store_plane(out, n, i, v);
}

// one product and one squaring, for their compiled code (never launched)
__global__ void one_mul_kernel(const int32_t* x, int32_t* out, long n) {
    uint32_t a[8], b[8];
    lw_load_plane(x, n, threadIdx.x, a);
    lw_load_plane(x, n, threadIdx.x + 32, b);
    lw_mont_mul(a, b, a);
    lw_store_plane(out, n, threadIdx.x, a);
}

__global__ void one_sqr_kernel(const int32_t* x, int32_t* out, long n) {
    uint32_t a[8];
    lw_load_plane(x, n, threadIdx.x, a);
    lw_mont_sqr(a, a);
    lw_store_plane(out, n, threadIdx.x, a);
}

extern "C" int sweep_plan(long n, int T, int L, long* scratch_words) {
    const LwInvPlan P = lw_inv_plan(n, T, L);
    *scratch_words = P.scratch_words;
    return P.launches;
}

extern "C" int sweep_batch_inverse(const int32_t* x, int32_t* out, int32_t* scratch, long n,
                                   int T, int L, void* stream) {
    return lw_inv_run(x, out, scratch, n, T, L, stream);
}

extern "C" int sweep_op(const int32_t* x, int32_t* out, long n, int op, int reps,
                        void* stream) {
    op_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(x, out, n, op, reps);
    return (int)cudaGetLastError();
}
"""


def _build():
    """(ctypes handle, {kernel: ptxas's registers line}) of the sweep's
    build of batch_inverse.cu."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    src = os.path.join(native.BUILD_DIR, "sweep_batch_inverse.cu")
    with open(src, "w") as fh:
        fh.write(_SRC)
    flags = native.NVCC_FLAGS + ["-I", native.CSRC_DIR, "-Xptxas", "-v"]
    deps = [src] + [os.path.join(native.CSRC_DIR, h)
                    for h in ("batch_inverse.cu", "batch_inverse.cuh", "mont.cuh")]
    so = native._tagged_path("libsweep_batch_inverse", deps, flags)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([native._nvcc()] + flags + ["-o", tmp, src], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, so)
    log = (r.stdout + r.stderr).splitlines()
    regs = {}
    for k, line in enumerate(log):
        if "batch_inverse_kernel" in line and "Compiling" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
            regs[name] = next((w.split(":", 1)[1].strip() for w in log[k + 1:]
                               if "registers" in w), "")
    lib = ctypes.CDLL(so)
    lib.sass = sass_mix(so)
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    for name, args in (("sweep_plan", [L, I, I, P]),
                       ("sweep_batch_inverse", [P, P, P, L, I, I, P]),
                       ("sweep_op", [P, P, L, I, I, P])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = I
    return lib, regs


def sass_mix(so: str) -> dict:
    """Instructions of each kernel in ``so`` by opcode (``cuobjdump -sass``;
    static code: a loop's body counts once), the largest first."""
    tool = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    r = subprocess.run([tool, "-sass", so], capture_output=True, text=True)
    mix, name = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            mix[name] = {}
        elif name and line.strip().startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].replace(";", " ").split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0][0].isupper():
                mix[name][words[0]] = mix[name].get(words[0], 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in mix.items()
            if any(w in k for w in ("batch_inverse_kernel", "one_mul", "one_sqr"))}


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def latencies(lib, gen) -> dict:
    """Both inversions against the plain version on 4096 values, then the
    latency in microseconds of one inversion, product and squaring (one
    thread), and products and squarings per second on 2^20 threads."""
    import torch

    from ..ops import limbs

    stream = torch.cuda.current_stream().cuda_stream
    x = random_field((1 << 20,), gen)
    x[:, 0] = 0
    out = torch.empty_like(x)
    small, small_out = x[:, :4096].contiguous(), out[:, :4096].contiguous()
    want = limbs.batch_inverse_plain(small)
    for name in ("inv_chain", "inv_gcd"):
        _check(lib.sweep_op(small.data_ptr(), small_out.data_ptr(), 4096, OPS[name], 1, stream),
               name)
        if not torch.equal(small_out, want):
            raise RuntimeError(f"{name} differs from the plain version")
    one = x[:, 1:2].contiguous()
    res = torch.empty_like(one)
    rec = {}

    def op_ms(name, src, dst, n, reps):
        return cuda_ms(lambda: _check(lib.sweep_op(src.data_ptr(), dst.data_ptr(), n, OPS[name],
                                                   reps, stream), name), 10)

    for name, k in (("inv_chain", 8), ("inv_gcd", 8), ("mul", 2000), ("sqr", 2000)):
        rec[f"{name}_us"] = (op_ms(name, one, res, 1, 1 + k) - op_ms(name, one, res, 1, 1)) \
            * 1e3 / k
    for name in ("mul", "sqr"):
        ms = op_ms(name, x, out, 1 << 20, 65) - op_ms(name, x, out, 1 << 20, 1)
        rec[f"{name}_per_s"] = 64 * (1 << 20) / (ms * 1e-3)
    return rec


def sweep(lib, log_n: int, gen) -> dict:
    """ms by T and L at n = 2^log_n (random values below
    2^251 < p with a few zeros), and the port's own batch_inverse."""
    import torch

    from ..ops import limbs

    n = 1 << log_n
    x = random_field((n,), gen)
    x[:, ::1021] = 0
    want = limbs.batch_inverse_plain(x)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    reps = 10 if log_n <= 20 else 4
    ms = {}
    for t in THREADS:
        for walk in WALKS:
            words = ctypes.c_long()
            launches = lib.sweep_plan(n, t, walk, ctypes.byref(words))
            scratch = torch.empty(max(words.value, 1), dtype=torch.int32, device=x.device)

            def run(t=t, walk=walk, scratch=scratch):
                _check(lib.sweep_batch_inverse(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                               n, t, walk, stream), f"T={t} L={walk}")

            out.zero_()
            run()
            if not torch.equal(out, want):
                raise RuntimeError(f"T = {t}, L = {walk} at n = 2^{log_n} differs from the "
                                   "plain version")
            ms[f"{t}x{walk}"] = {"ms": cuda_ms(run, reps), "launches": launches}
    got = limbs.batch_inverse(x)
    if not torch.equal(got, want):
        raise RuntimeError(f"batch_inverse at n = 2^{log_n} differs from the plain version")
    port_ms = cuda_ms(lambda: limbs.batch_inverse(x), reps)
    fastest = min(ms, key=lambda k: ms[k]["ms"])
    return {"n": f"2^{log_n}", "fastest": fastest, "fastest_ms": ms[fastest]["ms"],
            "port_ms": port_ms, "ms": ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_batch_inverse: no CUDA device", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(card, flush=True)
    lib, regs = _build()
    gen = torch.Generator(device="cuda").manual_seed(2)
    rec = {"card": card, "registers": regs, "sass": lib.sass, "latency": latencies(lib, gen),
           "sweep": []}
    print(json.dumps({k: rec[k] for k in ("registers", "latency", "sass")}), flush=True)
    for log_n in LOG_SIZES:
        row = sweep(lib, log_n, gen)
        rec["sweep"].append(row)
        print(json.dumps({k: row[k] for k in ("n", "fastest", "fastest_ms", "port_ms")}),
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
