"""Time the NTT pass kernel over its two tile parameters on one NVIDIA card:
the largest radix of a pass, 2^s (``max_pass_log``), and the columns a
block takes, 2^c.  ``poly/ntt.py``'s ``MAX_PASS_LOG`` and ``csrc/ntt.cu``'s
``LW_NTT_TILE_COLS_LOG`` come from this sweep.

    python3 -m lambda_elliptic_curves_tpu_torch.tools.sweep_ntt [--dense | --small]

The passes run through a launch entry that this script builds with
``nvcc`` from ``csrc/ntt.cu`` (the port's entry fixes c; this one takes
it).  For every pair whose tile fits a block's shared memory, fft runs at
2^18 points and at 2^22 points (the LDE size of a 2^20-row prove), each
output first held bitwise against the plain version
(``fft_with_root_plain`` on the card, computed once per size), then timed
with CUDA events (mean over repeated launches after one warm-up); the
port's ``fft`` is timed beside them.  Prints the card's name and power
limit, the kernel's resource line from ``nvcc -Xptxas -v`` (when this
process built the port's library), one JSON line per pair, and as the
last line a JSON object with every pair and the fastest pair per size.

With ``--dense`` it sweeps kernel 1's dense entry instead (BN254 Fr at one
row, BLS12-377 Fr at the QAP's three rows, at the provers' sizes and at
2^22): the largest radix (2^4 .. 2^9) and the columns a block takes, a
fixed 2^0 .. 2^3 or the port's rule (``ntt.dense_cols_log``), through the
port's own entry ``lw_dense_ntt_passes`` (which takes the columns pass by
pass); each output first held bitwise against the plain fft on the card,
each pass's grid beside its time.

With ``--small`` it sweeps the small fields' kernels (Goldilocks and
BabyBear): kernel 7's plan (largest radix 2^5 .. 2^8) and the columns a
block takes (a fixed 2^2 .. 2^5, or the port's rule ``ntt.small_cols_log``
at 1, 2 and 4 blocks an SM and at most 2^3 .. 2^5 columns; the threads of
a block follow, C r2) through the
port's entry ``lw_small_ntt_passes``, at one row of 2^20 and 2^22 points
and at 4 rows of 2^20 (BabyBear also one row of 2^24), each output first
held bitwise against the plain fft on the card; then kernel 6's batch
inversion at the prover's shapes (Goldilocks base and Fp2, BabyBear base
and Fp4, 2^23 or 2^24 elements) over its elements a thread K and threads a
block, through an entry that this script builds with ``nvcc`` from
``csrc/small_field.cu``, each output first held bitwise against the port's
``batch_inverse``, beside one ``copy_`` of the same values; and the floors
of the fft's passes: each pass after the first at its own columns with its
loads, tile and stores and no arithmetic (a kernel of the same build), and
one ``copy_`` of the values.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

from .. import native
from ._timing import cuda_ms, random_field, smi

PASS_LOGS = (4, 5, 6, 7, 8, 9)
COLS_LOGS = (2, 3, 4, 5)
LOG_SIZES = (18, 22)
SMEM_BYTES = 232448  # a block's shared memory on sm_90

_SRC = r"""
#include "ntt.cu"

extern "C" int sweep_ntt_passes(const int32_t* x, int32_t* out, int32_t* buf,
                                const int32_t* t_lo, const int32_t* t_hi, long rows,
                                int log_n, const int* radix, int npasses, int log_c,
                                void* stream) {
    return lw_ntt_run(x, out, buf, t_lo, t_hi, rows, log_n, 0, radix, npasses, log_c, stream);
}
"""


def smem_bytes(s: int, cols_log: int) -> int:
    """Shared memory of one block (``lw_ntt_pass_smem_words`` in ntt.cuh)."""
    r, c, a = 1 << s, 1 << cols_log, (s + 1) // 2
    return 4 * 8 * (r * (c + 1) + r // 2 + (c << a) + (c << (s - a)))


def _build():
    """ctypes entry ``sweep_ntt_passes`` of the sweep's build of ntt.cu."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    src = os.path.join(native.BUILD_DIR, "sweep_ntt.cu")
    with open(src, "w") as fh:
        fh.write(_SRC)
    flags = native.NVCC_FLAGS + ["-I", native.CSRC_DIR]
    deps = [src] + [os.path.join(native.CSRC_DIR, h) for h in ("ntt.cu", "ntt.cuh", "mont.cuh")]
    so = native._tagged_path("libsweep_ntt", deps, flags)
    if not os.path.exists(so):
        native._compile([native._nvcc()] + flags, so, [src])
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    fn = ctypes.CDLL(so).sweep_ntt_passes
    fn.argtypes = [P, P, P, P, P, L, I, P, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def _fft_with(fn, x, tables, plan, cols_log):
    """The passes of ``poly/ntt.py``'s ``_transform`` with 2^cols_log
    columns per block."""
    import torch

    out, buf = torch.empty_like(x), torch.empty_like(x)
    err = fn(x.data_ptr(), out.data_ptr(), buf.data_ptr(), tables.lo_rows.data_ptr(),
             tables.hi_rows.data_ptr(), x.shape[1], x.shape[2].bit_length() - 1,
             (ctypes.c_int * len(plan))(*plan), len(plan), cols_log,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sweep_ntt_passes: CUDA error {err}")
    return out


#: the dense sweep's shapes: (field, log2 N, rows)
DENSE_SHAPES = (("bn254_fr", 16, 1), ("bn254_fr", 17, 1), ("bn254_fr", 18, 1),
                ("bn254_fr", 22, 1), ("bls12_377_fr", 16, 3), ("bls12_377_fr", 17, 3))
DENSE_PASS_LOGS = (4, 5, 6, 7, 8, 9)
DENSE_COLS = ("rule", 0, 1, 2, 3)


def _dense_fft(x, tables, plan, cols_log):
    import torch

    out, buf = torch.empty_like(x), torch.empty_like(x)
    err = native.cuda_lib().lw_dense_ntt_passes(
        tables.ops.kernel_id, x.data_ptr(), out.data_ptr(), buf.data_ptr(),
        tables.powers.data_ptr(), x.shape[1], x.shape[2].bit_length() - 1, 0,
        (ctypes.c_int * len(plan))(*plan), (ctypes.c_int * len(plan))(*cols_log), len(plan),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lw_dense_ntt_passes: CUDA error {err}")
    return out


def main_dense(card: str) -> int:
    import torch

    from .. import fields
    from ..poly import ntt

    by_name = {"bn254_fr": fields.BN254Fr, "bls12_377_fr": fields.BLS12377Fr}
    gen = torch.Generator(device="cuda").manual_seed(4)
    results = []
    for name, log_n, rows in DENSE_SHAPES:
        f = by_name[name]
        n = 1 << log_n
        x = random_field((rows, n), gen)  # below 2^251 < p
        root = f.params.primitive_root_of_unity(log_n)
        tables = ntt.twiddle_tables(f, root, log_n, x.device)
        want = ntt.fft_with_root_plain(x, f, root)
        reps = 20 if log_n < 22 else 10
        for s in DENSE_PASS_LOGS:
            plan = ntt.pass_plan(log_n, s)
            for cols in DENSE_COLS:
                cols_log = [ntt.dense_cols_log(rows, log_n, r, ntt.sm_count(x.device))
                            if cols == "rule" else cols for r in plan]
                if max(4 * 8 * ((1 << r) * ((1 << c) + 1) + (1 << r) // 2)
                       for r, c in zip(plan, cols_log)) > SMEM_BYTES:
                    continue
                if not torch.equal(_dense_fft(x, tables, plan, cols_log), want):
                    print(f"sweep_ntt: {name} 2^{log_n} x {rows} s<={s} C={cols} != plain",
                          file=sys.stderr)
                    return 1
                ms = cuda_ms(lambda: _dense_fft(x, tables, plan, cols_log), reps)
                rec = {"field": name, "log_n": log_n, "rows": rows, "max_pass_log": s,
                       "cols": cols, "passes": plan, "cols_log": cols_log,
                       "blocks": [-(-(rows << (log_n - r)) >> c) for r, c in zip(plan, cols_log)],
                       "ms": ms}
                results.append(rec)
                print(json.dumps(rec), flush=True)
        del x, want
        torch.cuda.empty_cache()
    best = {f"{k[0]} 2^{k[1]} x {k[2]}": min(
        (r for r in results if (r["field"], r["log_n"], r["rows"]) == k), key=lambda r: r["ms"])
        for k in DENSE_SHAPES}
    print(json.dumps({"card": card, "results": results, "fastest": best}))
    return 0


_SMALL_INV_SRC = r"""
#include "small_field.cu"
#include "small_ntt.cuh"

template <class F, int D>
static int sweep_k(int k, int threads, const int32_t* a, int32_t* out, long n, uint64_t nr,
                   cudaStream_t s) {
#define LW_SWEEP_T(K, T) \
    if (k == (K) && threads == (T)) return run_inv<F, D, (K), (T)>(a, n, 1, out, n, nr, s);
#define LW_SWEEP_K(K) LW_SWEEP_T(K, 128) LW_SWEEP_T(K, 256) LW_SWEEP_T(K, 512)
    LW_SWEEP_K(D < 4 ? 4 / D : 1) LW_SWEEP_K(8 / D) LW_SWEEP_K(16 / D) LW_SWEEP_K(32 / D)
    return (int)cudaErrorInvalidValue;
}

// a pass's bytes alone: the loads, tile and stores of lw_sntt_pass_block_s
// (step A's columns, step B's output addresses when Ns >= C) and no
// arithmetic, so out is a permutation of x
template <class F, int S>
__global__ void __launch_bounds__(256) sweep_copy_pass_kernel(LwSmallNttPass P) {
    typedef typename F::T T;
    extern __shared__ __align__(8) unsigned char sm_bytes[];
    T* tile = reinterpret_cast<T*>(sm_bytes);
    constexpr int S1 = (S + 1) / 2, S2 = S / 2, R1 = 1 << S1, R2 = 1 << S2;
    const int C = 1 << P.log_c, cs = C + 1, log_cols = P.log_n - S;
    const long n = 1L << P.log_n, plane = P.rows * n;
    const long cols_mask = (1L << log_cols) - 1, ns_mask = (1L << P.ns_log) - 1;
    const long col0 = (long)blockIdx.x << P.log_c;
    for (int idx = threadIdx.x; idx < (C << S2); idx += blockDim.x) {
        const int c = idx & (C - 1), t2 = idx >> P.log_c;
        const long J = col0 + c, src = (J >> log_cols) * n + (J & cols_mask);
        T v[R1];
#pragma unroll
        for (int t1 = 0; t1 < R1; t1++)
            v[t1] = F::load(P.x, plane, src + ((long)(t2 + (t1 << S2)) << log_cols));
#pragma unroll
        for (int k1 = 0; k1 < R1; k1++) tile[(long)(k1 + R1 * t2) * cs + c] = v[k1];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < (C << S1); idx += blockDim.x) {
        const int c = idx & (C - 1), k1 = idx >> P.log_c;
        const long J = col0 + c, j = J & cols_mask;
        T v[R2];
#pragma unroll
        for (int t2 = 0; t2 < R2; t2++) v[t2] = tile[(long)(k1 + R1 * t2) * cs + c];
        const long dst = (J >> log_cols) * n + ((j >> P.ns_log) << (P.ns_log + S))
                         + (j & ns_mask) + ((long)k1 << P.ns_log);
#pragma unroll
        for (int k2 = 0; k2 < R2; k2++)
            F::store(P.out, plane, dst + ((long)(R1 * k2) << P.ns_log), v[k2]);
    }
}

template <class F, int S>
static int copy_pass(const int32_t* x, int32_t* out, long rows, int log_n, int ns_log, int log_c,
                     cudaStream_t s) {
    LwSmallNttPass P = {x, out, nullptr, nullptr, nullptr, rows, log_n, ns_log, S, log_c, S};
    const long smem = (long)sizeof(typename F::T) * lw_sntt_smem_values(S, log_c);
    cudaFuncSetAttribute(sweep_copy_pass_kernel<F, S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    const long blocks = (rows << (log_n - S)) >> log_c;
    const int threads = lw_sntt_threads(S, log_c);
    sweep_copy_pass_kernel<F, S><<<blocks, threads, smem, s>>>(P);
    return (int)cudaGetLastError();
}

// one copy pass of radix 2^s (5 or 6) on 2^log_c columns, Ns = 2^ns_log >= C
extern "C" int sweep_copy_pass(int field, const int32_t* x, int32_t* out, long rows, int log_n,
                               int ns_log, int s, int log_c, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (ns_log < log_c || (s != 5 && s != 6)) return (int)cudaErrorInvalidValue;
    if (field == SF_GOLDILOCKS)
        return s == 6 ? copy_pass<LwGoldilocks, 6>(x, out, rows, log_n, ns_log, log_c, st)
                      : copy_pass<LwGoldilocks, 5>(x, out, rows, log_n, ns_log, log_c, st);
    return s == 6 ? copy_pass<LwBabyBear, 6>(x, out, rows, log_n, ns_log, log_c, st)
                  : copy_pass<LwBabyBear, 5>(x, out, rows, log_n, ns_log, log_c, st);
}

extern "C" int sweep_small_inverse(int field, int degree, int k, int threads, const int32_t* a,
                                   int32_t* out, long n, uint64_t nr, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == SF_GOLDILOCKS && degree == 1)
        return sweep_k<LwGoldilocks, 1>(k, threads, a, out, n, nr, s);
    if (field == SF_GOLDILOCKS && degree == 2)
        return sweep_k<LwGoldilocks, 2>(k, threads, a, out, n, nr, s);
    if (field == SF_BABYBEAR && degree == 1)
        return sweep_k<LwBabyBear, 1>(k, threads, a, out, n, nr, s);
    if (field == SF_BABYBEAR && degree == 4)
        return sweep_k<LwBabyBear, 4>(k, threads, a, out, n, nr, s);
    return (int)cudaErrorInvalidValue;
}
"""

#: the small sweep: (field, log2 N, rows) of the ffts, the largest radices,
#: the columns (a fixed log2, or ("rule", blocks an SM)), and the
#: inversions' (field, degree, elements) with their K x D and threads
SMALL_FFTS = (("goldilocks", 20, 1), ("goldilocks", 22, 1), ("goldilocks", 20, 4),
              ("babybear", 20, 1), ("babybear", 22, 1), ("babybear", 20, 4),
              ("babybear", 24, 1))
SMALL_PASS_LOGS = (5, 6, 7, 8)
SMALL_COLS = (2, 3, 4, 5, ("rule", 1, 5), ("rule", 2, 5), ("rule", 2, 4), ("rule", 4, 4),
              ("rule", 2, 3))
SMALL_INVERSES = (("goldilocks", 1, 1 << 23), ("goldilocks", 2, 1 << 24),
                  ("babybear", 1, 1 << 23), ("babybear", 4, 1 << 24))
SMALL_INV_KD = (4, 8, 16, 32)
SMALL_INV_THREADS = (128, 256, 512)


def _small_fft(f, x, tables, plan, cols_log):
    import torch

    out, buf = torch.empty_like(x), torch.empty_like(x)
    err = native.cuda_lib().lw_small_ntt_passes(
        f.ops.kernel_id, x.data_ptr(), out.data_ptr(), buf.data_ptr(),
        tables.lo_rows.data_ptr(), tables.hi_rows.data_ptr(), tables.dft.data_ptr(),
        x.shape[1], x.shape[2].bit_length() - 1, 0, tables.dft.shape[0].bit_length() - 1,
        (ctypes.c_int * len(plan))(*plan), (ctypes.c_int * len(plan))(*cols_log), len(plan),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lw_small_ntt_passes: CUDA error {err}")
    return out


def _build_small_inverse():
    """ctypes entry ``sweep_small_inverse`` of the sweep's build of
    small_field.cu (every K and threads the sweep takes)."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    src = os.path.join(native.BUILD_DIR, "sweep_small_inverse.cu")
    with open(src, "w") as fh:
        fh.write(_SMALL_INV_SRC)
    flags = native.NVCC_FLAGS + ["-I", native.CSRC_DIR]
    deps = [src] + [os.path.join(native.CSRC_DIR, h) for h in ("small_field.cu",
                                                               "small_field.cuh",
                                                               "small_ntt.cuh")]
    so = native._tagged_path("libsweep_small_inverse", deps, flags)
    if not os.path.exists(so):
        native._compile([native._nvcc()] + flags, so, [src])
    P, L, I, U = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint64
    lib = ctypes.CDLL(so)
    lib.sweep_small_inverse.argtypes = [I, I, I, I, P, P, L, U, P]
    lib.sweep_copy_pass.argtypes = [I, P, P, L, I, I, I, I, P]
    for fn in (lib.sweep_small_inverse, lib.sweep_copy_pass):
        fn.restype = ctypes.c_int
    return lib


def main_small(card: str) -> int:
    import threading

    import torch

    from .. import fields
    from ..poly import ntt
    from ..provers.stark.extension import ChallengeBundle
    from ._timing import random_small

    by_name = {"goldilocks": fields.Goldilocks, "babybear": fields.BabyBear}
    built = {}
    side = threading.Thread(target=lambda: built.update(fn=_build_small_inverse()))
    side.start()
    native.cuda_lib()
    side.join()  # no compile beside the timings
    ptxas = {src: [line.strip() for line in native.build_log.get(src, "").splitlines()
                   if "registers" in line or "spill" in line]
             for src in ("small_ntt.cu", "small_field.cu")}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = ntt.sm_count(torch.device("cuda"))
    rule, ffts = (ntt.SMALL_BLOCKS_PER_SM, ntt.SMALL_MAX_COLS_LOG), []
    for name, log_n, rows in SMALL_FFTS:
        f = by_name[name]
        x = random_small(f.num_limbs, f.p, (rows, 1 << log_n), gen)
        root = f.params.primitive_root_of_unity(log_n)
        tables = ntt.twiddle_tables(f, root, log_n, x.device)
        want = ntt.fft_with_root_plain(x, f, root)
        reps = 20 if log_n < 22 else 10
        for s_max in SMALL_PASS_LOGS:
            plan = ntt.pass_plan(log_n, s_max)
            for cols in SMALL_COLS:
                if isinstance(cols, tuple):  # the port's rule at other constants
                    ntt.SMALL_BLOCKS_PER_SM, ntt.SMALL_MAX_COLS_LOG = cols[1:]
                    cols_log = [ntt.small_cols_log(rows, log_n, r, sms) for r in plan]
                else:
                    cols_log = [min(cols, 8 - r // 2) for r in plan]
                if not torch.equal(_small_fft(f, x, tables, plan, cols_log), want):
                    print(f"sweep_ntt: {name} 2^{log_n} x {rows} s<={s_max} C={cols} != plain",
                          file=sys.stderr)
                    return 1
                ms = cuda_ms(lambda: _small_fft(f, x, tables, plan, cols_log), reps)
                rec = {"field": name, "log_n": log_n, "rows": rows, "max_pass_log": s_max,
                       "cols": cols, "passes": plan, "cols_log": cols_log,
                       "blocks": [-(-(rows << (log_n - r)) >> c) for r, c in zip(plan, cols_log)],
                       "threads": [1 << (c + r // 2) for r, c in zip(plan, cols_log)], "ms": ms}
                ffts.append(rec)
                print(json.dumps(rec), flush=True)
        del x, want
        torch.cuda.empty_cache()
    ntt.SMALL_BLOCKS_PER_SM, ntt.SMALL_MAX_COLS_LOG = rule
    if "fn" not in built:
        print("sweep_ntt: the inversion sweep's build failed", file=sys.stderr)
        return 1
    lib, inverses = built["fn"], []
    fn = lib.sweep_small_inverse
    for name, degree, n in SMALL_INVERSES:
        f = by_name[name]
        fd = f if degree == 1 else ChallengeBundle(f, degree).fd
        nr = 0 if degree == 1 else (fd.non_residue if degree == 2 else fd.base.non_residue)
        lb = f.num_limbs
        a = random_small(lb, f.p, (degree, n), gen).transpose(0, 1).reshape(degree * lb, n)
        a[:, ::1009] = 0
        a = a.contiguous()
        want = fd.batch_inverse(a)
        for kd in SMALL_INV_KD:
            k = max(kd // degree, 1)
            for threads in SMALL_INV_THREADS:
                out = torch.empty_like(a)

                def call():
                    err = fn(f.ops.kernel_id, degree, k, threads, a.data_ptr(), out.data_ptr(),
                             n, int(nr) * f.ops.R % f.p, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"sweep_small_inverse: CUDA error {err}")
                call()
                if not torch.equal(out, want):
                    print(f"sweep_ntt: {name} degree {degree} inverse K={k} T={threads} != "
                          "batch_inverse", file=sys.stderr)
                    return 1
                rec = {"field": name, "degree": degree, "n": n, "k": k, "threads": threads,
                       "ms": cuda_ms(call, 10)}
                inverses.append(rec)
                print(json.dumps(rec), flush=True)
        copy_out = torch.empty_like(a)
        rec = {"field": name, "degree": degree, "n": n, "port_batch_inverse_ms":
               cuda_ms(lambda: fd.batch_inverse(a), 10),
               "copy_ms": cuda_ms(lambda: copy_out.copy_(a), 10)}
        inverses.append(rec)
        print(json.dumps(rec), flush=True)
        del a, want
        torch.cuda.empty_cache()
    # the floors of the prover's fft passes at one row: a pass's loads, tile
    # and stores alone (sweep_copy_pass), and one copy_ of the values
    floors = []
    for name, log_n in (("goldilocks", 22), ("babybear", 22), ("babybear", 24)):
        f = by_name[name]
        x = random_small(f.num_limbs, f.p, (1, 1 << log_n), gen)
        out = torch.empty_like(x)
        plan, ns_log = ntt.plan_for(f, log_n), 0
        for s in plan:
            lc = ntt.small_cols_log(1, log_n, s, sms)
            if ns_log >= lc:
                rec = {"field": name, "log_n": log_n, "radix_log": s, "ns_log": ns_log,
                       "cols_log": lc, "copy_pass_ms": cuda_ms(lambda: lib.sweep_copy_pass(
                           f.ops.kernel_id, x.data_ptr(), out.data_ptr(), 1, log_n, ns_log, s,
                           lc, torch.cuda.current_stream().cuda_stream), 20)}
                floors.append(rec)
                print(json.dumps(rec), flush=True)
            ns_log += s
        rec = {"field": name, "log_n": log_n, "torch_copy_ms": cuda_ms(lambda: out.copy_(x), 20)}
        floors.append(rec)
        print(json.dumps(rec), flush=True)
    best = {f"{k[0]} 2^{k[1]} x {k[2]}": min(
        (r for r in ffts if (r["field"], r["log_n"], r["rows"]) == k), key=lambda r: r["ms"])
        for k in SMALL_FFTS}
    best.update({f"{k[0]} degree {k[1]} inverse": min(
        (r for r in inverses if (r["field"], r["degree"]) == k[:2] and "k" in r),
        key=lambda r: r["ms"]) for k in SMALL_INVERSES})
    print(json.dumps({"card": card, "ffts": ffts, "inverses": inverses, "floors": floors,
                      "fastest": best}))
    return 0


def main() -> int:
    import torch

    from ..fields import Stark252 as f
    from ..poly import ntt

    if not torch.cuda.is_available():
        print("sweep_ntt: no CUDA device", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(card, flush=True)
    if "--dense" in sys.argv[1:]:
        return main_dense(card)
    if "--small" in sys.argv[1:]:
        return main_small(card)
    native.cuda_lib()
    ptxas = " | ".join(line.strip() for line in native.build_log.get("ntt.cu", "").splitlines()
                       if "registers" in line or "spill" in line)
    print(ptxas, flush=True)
    fn = _build()
    gen = torch.Generator(device="cuda").manual_seed(4)
    results, port = [], {}
    for log_n in LOG_SIZES:
        n = 1 << log_n
        x = random_field((1, n), gen)
        root = f.params.primitive_root_of_unity(log_n)
        tables = ntt.twiddle_tables(f, root, log_n, x.device)
        want = ntt.fft_with_root_plain(x, f, root)
        reps = 20 if log_n < 22 else 10
        for s in PASS_LOGS:
            plan = ntt.pass_plan(log_n, s)
            for cols_log in COLS_LOGS:
                if smem_bytes(s, cols_log) > SMEM_BYTES:
                    continue
                if not torch.equal(_fft_with(fn, x, tables, plan, cols_log), want):
                    print(f"sweep_ntt: 2^{log_n} s<={s} C=2^{cols_log} != plain",
                          file=sys.stderr)
                    return 1
                ms = cuda_ms(lambda: _fft_with(fn, x, tables, plan, cols_log), reps)
                rec = {"log_n": log_n, "max_pass_log": s, "cols_log": cols_log, "passes": plan,
                       "smem_bytes": smem_bytes(s, cols_log), "ms": ms}
                results.append(rec)
                print(json.dumps(rec), flush=True)
        if not torch.equal(ntt.fft_with_root(x, f, root), want):
            print(f"sweep_ntt: the port's fft != plain at 2^{log_n}", file=sys.stderr)
            return 1
        port[f"2^{log_n}"] = cuda_ms(lambda: ntt.fft_with_root(x, f, root), reps)
        print(json.dumps({"log_n": log_n, "port_fft_ms": port[f"2^{log_n}"]}), flush=True)
        del x, want
    best = {f"2^{k}": min((r for r in results if r["log_n"] == k), key=lambda r: r["ms"])
            for k in LOG_SIZES}
    print(json.dumps({"card": card, "ptxas": ptxas, "results": results, "fastest": best,
                      "port_fft_ms": port}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
