"""Time the NTT pass kernel over its two tile parameters on one NVIDIA card:
the largest radix of a pass, 2^s (``max_pass_log``), and the columns a
block takes, 2^c.  ``poly/ntt.py``'s ``MAX_PASS_LOG`` and ``csrc/ntt.cu``'s
``LW_NTT_TILE_COLS_LOG`` come from this sweep.

    python3 -m lambda_elliptic_curves_tpu_torch.tools.sweep_ntt [--dense]

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
