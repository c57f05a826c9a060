"""Sweep kernels 8 and 9 over the dense fields on one NVIDIA card: kernel
8's elements a thread E (1, 2, 4) for a product and a sum, and kernel 9's
threads a block T (64, 128, 256) and elements a thread K (1, 2, 4, 8), at
four words (BN254 Fr) and six (BLS12-377 Fq), at the provers' sizes 2^16,
2^17, 2^18, at 2^22, and (kernel 9) at 5 x 2^16, about the affine
conversion of a Groth16 setup's G1 points at 2^16 constraints.
``csrc/dense_field.cu``'s ``LW_DN_WIDE_N`` and ``csrc/dense_inverse.cu``'s
``LW_DI_THREADS``, ``LW_DI_K4`` and ``LW_DI_K6`` come from this sweep.  Also
the latency of one inversion (``LwDense<Q>::inv``, the binary Euclid) on
one thread, and of a one-block call of kernel 9 at the port's tile, at
both widths; ptxas's registers and spills of every kernel built.

    python3 -m lambda_elliptic_curves_tpu_torch.tools.sweep_dense

The kernels run through entries that this script builds with ``nvcc`` on
``csrc/dense_field.cu`` and ``csrc/dense_inverse.cu`` (one build per width,
both at once), kernel 9 at the port's rounds (one wave of the card) and at
one round.  Every output is held bitwise against the plain
version before it is timed; times are CUDA-event means of the launches
alone (outputs allocated once) after one warm-up.  A latency is one
thread's chain of k inversions, (time(1 + k) - time(1)) / k.  Prints the
card's name and power limit, one JSON line per size, and as the last line
a JSON object with everything (about 2 minutes).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

from .. import native
from ._timing import cuda_ms, smi

ELEMENTS = (1, 2, 4)
THREADS = (64, 128, 256)
KS = (1, 2, 4, 8)
OP_LOGS = (16, 17, 18, 22)
INV_SIZES = ((16, 1 << 16), (17, 1 << 17), (18, 1 << 18), ("5x2^16", 5 << 16), (22, 1 << 22))
#: the width's field: BN254 Fr at four words, BLS12-377 Fq at six
WIDTHS = {4: "bn254_fr", 6: "bls12_377_fq"}

_SRC = r"""
#include "dense_field.cu"
#include "dense_inverse.cu"

#if SWEEP_W == 4
typedef LwBn254Fr32 F;
#else
typedef LwBls12377Fq32 F;
#endif

// one thread: reps inversions of x in a chain
__global__ void inv_chain_kernel(const int32_t* x, int32_t* out, int reps) {
    uint32_t v[F::LIMBS];
    for (int k = 0; k < F::LIMBS; k++) v[k] = (uint32_t)x[k];
    for (int r = 0; r < reps; r++) F::inv(v, v);
    for (int k = 0; k < F::LIMBS; k++) out[k] = (int32_t)v[k];
}

template <int OP>
static int op_by_e(int E, LwDnOperand a, LwDnOperand b, int32_t* out, long n, cudaStream_t s) {
    const LwDnExponent<F::LIMBS> e = {};
    switch (E) {
        case 1: return launch_op<F, OP, 1>(a, b, out, n, e, 0, s);
        case 2: return launch_op<F, OP, 2>(a, b, out, n, e, 0, s);
        case 4: return launch_op<F, OP, 4>(a, b, out, n, e, 0, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// kernel 8's product (mul != 0) or sum of n elements at E elements a thread
extern "C" int sweep_op(int mul, int E, const int32_t* a, const int32_t* b, int32_t* out,
                        long n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const LwDnOperand x = {a, n, 1}, y = {b, n, 1};
    return mul ? op_by_e<LW_DN_MUL>(E, x, y, out, n, s) : op_by_e<LW_DN_ADD>(E, x, y, out, n, s);
}

// kernel 9 at T threads and K elements a thread a round, with the port's
// rounds (rounds = 0) or the given ones; the rounds taken into *taken
template <int K, int T>
static int inv_kt(const int32_t* x, int32_t* out, long n, int rounds, int* taken,
                  cudaStream_t s) {
    int per_sm = 0;
    if (rounds <= 0) {
        const int err = plan<F, K, T>(n, &rounds, &per_sm);
        if (err) return err;
    }
    *taken = rounds;
    const long per_block = (long)T * K * rounds;
    const size_t smem = 4 * lw_di_smem_words(T, F::LIMBS);
    dense_inverse_kernel<F, K, T><<<(n + per_block - 1) / per_block, T, smem, s>>>(
        x, out, n, rounds);
    return (int)cudaGetLastError();
}

template <int T>
static int inv_k(int K, const int32_t* x, int32_t* out, long n, int rounds, int* taken,
                 cudaStream_t s) {
    switch (K) {
        case 1: return inv_kt<1, T>(x, out, n, rounds, taken, s);
        case 2: return inv_kt<2, T>(x, out, n, rounds, taken, s);
        case 4: return inv_kt<4, T>(x, out, n, rounds, taken, s);
        case 8: return inv_kt<8, T>(x, out, n, rounds, taken, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int sweep_inv(int T, int K, const int32_t* x, int32_t* out, long n, int rounds,
                         int* taken, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (T) {
        case 64: return inv_k<64>(K, x, out, n, rounds, taken, s);
        case 128: return inv_k<128>(K, x, out, n, rounds, taken, s);
        case 256: return inv_k<256>(K, x, out, n, rounds, taken, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int sweep_inv_chain(const int32_t* x, int32_t* out, int reps, void* stream) {
    inv_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, out, reps);
    return (int)cudaGetLastError();
}
"""


def _build() -> dict:
    """width -> (ctypes handle, {kernel: ptxas's registers and spills}), the
    two widths built at once."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    src = os.path.join(native.BUILD_DIR, "sweep_dense.cu")
    with open(src, "w") as fh:
        fh.write(_SRC)
    deps = [src] + [os.path.join(native.CSRC_DIR, h) for h in
                    ("dense_field.cu", "dense_field.cuh", "dense_inverse.cu",
                     "dense_inverse.cuh", "dense32.cuh", "dense.cuh", "mont.cuh")]
    jobs = {}
    for w in WIDTHS:
        flags = native.NVCC_FLAGS + ["-I", native.CSRC_DIR, "-Xptxas", "-v", f"-DSWEEP_W={w}"]
        so = native._tagged_path(f"libsweep_dense{w}", deps, flags)
        tmp = f"{so}.{os.getpid()}.tmp"
        jobs[w] = (so, tmp, subprocess.Popen([native._nvcc()] + flags + ["-o", tmp, src],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    out = {}
    for w, (so, tmp, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, so)
        regs, name = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and "Used" in line and "registers" in line:
                regs[name] = line.split(":", 1)[-1].strip()
            elif name and "spill" in line:
                regs[name + " spills"] = line.split(":", 1)[-1].strip()
        lib = ctypes.CDLL(so)
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        for fn, args in (("sweep_op", [I, I, P, P, P, L, P]),
                         ("sweep_inv", [I, I, P, P, L, I, P, P]),
                         ("sweep_inv_chain", [P, P, I, P])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = I
        out[w] = (lib, regs)
    return out


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _field(w):
    from .. import fields

    return {"bn254_fr": fields.BN254Fr, "bls12_377_fq": fields.BLS12377Field}[WIDTHS[w]]


def random_dense(f, n: int, gen):
    """(L, n) canonical limbs of ``f`` drawn on the card: each limb uniform,
    the top one below p's top limb."""
    import torch

    x = torch.randint(-2**31, 2**31, (f.num_limbs, n), generator=gen, device=gen.device,
                      dtype=torch.int64)
    x[-1] = x[-1].abs() % (f.p >> (32 * (f.num_limbs - 1)))
    return x.to(torch.int32)


def sweep_ops(lib, f, gen) -> list:
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for log_n in OP_LOGS:
        n = 1 << log_n
        a, b = random_dense(f, n, gen), random_dense(f, n, gen)
        out = torch.empty_like(a)
        row = {"n": f"2^{log_n}"}
        for mul, name in ((1, "mul"), (0, "add")):
            want = (f.ops.mont_mul_plain if mul else f.ops.add_plain)(a, b)
            for e in ELEMENTS:
                run = lambda mul=mul, e=e: _check(lib.sweep_op(  # noqa: E731
                    mul, e, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, stream), "op")
                out.zero_()
                run()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name} at E = {e}, 2^{log_n} != plain")
                row[f"{name} E={e} ms"] = cuda_ms(run, 20 if log_n < 22 else 10)
        rows.append(row)
        print(json.dumps({"field": f.name, **row}), flush=True)
        del a, b, out
        torch.cuda.empty_cache()
    return rows


def sweep_inverse(lib, f, gen) -> list:
    """ms by T and K at the port's rounds (the rounds beside each), and at
    one round (the block of threads x K elements alone), for each size."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, n in INV_SIZES:
        x = random_dense(f, n, gen)
        x[:, ::1009] = 0
        want = f.ops.batch_inverse_plain(x)
        out = torch.empty_like(x)
        row = {"n": label if isinstance(label, str) else f"2^{label}"}
        taken = ctypes.c_int()
        for t in THREADS:
            for k in KS:
                for rounds, tag in ((0, ""), (1, " r=1")):
                    run = lambda t=t, k=k, rounds=rounds: _check(lib.sweep_inv(  # noqa: E731
                        t, k, x.data_ptr(), out.data_ptr(), n, rounds, ctypes.byref(taken),
                        stream), f"T={t} K={k}")
                    out.zero_()
                    run()
                    if not torch.equal(out, want):
                        raise RuntimeError(f"inverse T = {t}, K = {k}, rounds {taken.value} "
                                           f"at {row['n']} != plain")
                    row[f"{t}x{k}{tag}"] = cuda_ms(run, 10 if n < 1 << 22 else 5)
                    if not rounds:
                        row[f"{t}x{k} rounds"] = taken.value
        times = [k for k in row if k[0].isdigit() and not k.endswith("rounds")]
        row["fastest"] = min(times, key=row.get)
        row["port_ms"] = cuda_ms(lambda: f.batch_inverse(x), 10 if n < 1 << 22 else 5)
        rows.append(row)
        print(json.dumps({"field": f.name, **row}), flush=True)
        del x, want, out
        torch.cuda.empty_cache()
    return rows


def latencies(lib, f, gen) -> dict:
    """One inversion's latency on one thread (µs), and one call of the
    port's kernel 9 on one element (one block, ms)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    one = random_dense(f, 1, gen)
    res = torch.empty_like(one)

    def chain_ms(reps):
        return cuda_ms(lambda: _check(lib.sweep_inv_chain(one.data_ptr(), res.data_ptr(), reps,
                                                          stream), "chain"), 10)

    _check(lib.sweep_inv_chain(one.data_ptr(), res.data_ptr(), 1, stream), "chain")
    if not torch.equal(res, f.ops.batch_inverse_plain(one)):
        raise RuntimeError("the one inversion != plain")
    return {"inv_us": (chain_ms(9) - chain_ms(1)) * 1e3 / 8,
            "one_block_call_ms": cuda_ms(lambda: f.batch_inverse(one), 20)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_dense: no CUDA device", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(card, flush=True)
    t0 = time.perf_counter()
    built = _build()
    rec = {"card": card, "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for w, (lib, regs) in built.items():
        f = _field(w)
        rec[WIDTHS[w]] = {"registers": regs, "latency": latencies(lib, f, gen)}
        print(json.dumps({"field": f.name, **rec[WIDTHS[w]]}), flush=True)
        rec[WIDTHS[w]]["ops"] = sweep_ops(lib, f, gen)
        rec[WIDTHS[w]]["inverse"] = sweep_inverse(lib, f, gen)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
