"""Time kernel 11 (Pippenger's bucket phase, ``csrc/msm_bucket.cuh``) launch
by launch on one NVIDIA card, for the port's kernel and for variants of its
header built beside it.

    python3 -m lambda_elliptic_curves_tpu_torch.tools.sweep_bucket [VARIANT ...]

Over the ids of 17 windows of 2^16 random points at c = 15 (an MSM of 2^16
points) and random affine points of BN254 G1 and BLS12-377 G2, the bucket
phase (``bucket_sums``, then ``weighted_bucket_sums``) runs three times;
each launch of the last run is timed with CUDA events around it.  For
``base`` (the port's library) kernel 10's addition and mixed addition at
17 x 2^16 lanes are timed beside it (CUDA-event means).  Every other
variant builds ``msm_bucket.cu``, ``msm_bucket_g2.cu`` and
``msm_bucket_bls12_377_g2.cu`` with ``nvcc`` from a copy of ``csrc/``
whose header is edited as named below, and routes kernel 11's entries to
that library; the variants marked "timing only" compute wrong sums and are
not checked:

* ``regwalk``: the reduce's and the accumulate's walks keep their running
  sums in registers and write the tile at the end;
* ``lb3``, ``lb4``: ``__launch_bounds__(128, 3)`` or ``(128, 4)`` (at most
  168 or 128 registers a thread);
* ``sameload``: the reduce's walk reads the same two buckets at every step
  (timing only: the cost of its loads);
* ``notree``: no tree steps (timing only: the walks alone);
* ``nodbl``: no doublings of a reduce leaf's R (timing only).

Variants combine with ``_`` (``regwalk_lb3``); each runs in a process of
its own (two builds of the same kernels clash in one process).  Prints
the card's name and power limit, then one JSON line a variant with its
registers and spills from ``nvcc -Xptxas -v``.  Default: all of them.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import native
from ..curves import msm as M
from ..curves.twists import bls12_377_twist
from ..curves.zoo import BN254Curve
from ._timing import cuda_ms, smi

VARIANTS = ("base", "regwalk", "lb3", "lb4", "sameload", "notree", "nodbl")
SOURCES = ("msm_bucket.cu", "msm_bucket_g2.cu", "msm_bucket_bls12_377_g2.cu")

_ACC_WALK = ("""    P q;
    P* acc = &s.pt[2 * t];  // the open run's sum: the first run's slot until it closes
    int64_t acc_id = 0, first_id = 0;
    for (long pos = lo; pos < hi; pos++) {
        const int64_t id = a.ids[w * a.S + pos];
        if (id == 0) continue;
        const long e = a.order ? (long)a.order[w * a.S + pos] : w * a.S + pos;
        lw_load_point<G>(a.in, e, q);
        if (id == acc_id) {
            if (MIXED) G::add_mixed(*acc, q, *acc);
            else G::add(*acc, q, *acc);
            continue;
        }
        if (acc_id != 0) {  // the open run closes
            if (first_id == 0) {
                first_id = acc_id;
                acc = &s.pt[2 * t + 1];
            } else {
                lw_bucket_to_table<G>(a, w, acc_id, *acc);
            }
        }
        *acc = q;
        acc_id = id;
    }""", """    P q, cur;
    int64_t acc_id = 0, first_id = 0;
    for (long pos = lo; pos < hi; pos++) {
        const int64_t id = a.ids[w * a.S + pos];
        if (id == 0) continue;
        const long e = a.order ? (long)a.order[w * a.S + pos] : w * a.S + pos;
        lw_load_point<G>(a.in, e, q);
        if (id == acc_id) {
            if (MIXED) G::add_mixed(cur, q, cur);
            else G::add(cur, q, cur);
            continue;
        }
        if (acc_id != 0) {
            if (first_id == 0) {
                first_id = acc_id;
                s.pt[2 * t] = cur;
            } else {
                lw_bucket_to_table<G>(a, w, acc_id, cur);
            }
        }
        cur = q;
        acc_id = id;
    }
    s.pt[first_id == 0 ? 2 * t : 2 * t + 1] = cur;""")

_REDUCE_WALK = ("""    P e;
    G::neutral(v[t]);
    G::neutral(rt[t]);
    const long lo = k * a.m;
    const long hi = lo + a.m < a.N - 1 ? lo + a.m : a.N - 1;
    for (long i = hi - 1; i >= lo; i--) {  // A_i = B_(i+1), walked down
        lw_load_point<G>(a.in, w * a.N + i + 1, e);
        G::add(rt[t], e, rt[t]);
        G::add(v[t], rt[t], v[t]);
    }""", """    P e, run, acc;
    G::neutral(run);
    G::neutral(acc);
    const long lo = k * a.m;
    const long hi = lo + a.m < a.N - 1 ? lo + a.m : a.N - 1;
    for (long i = hi - 1; i >= lo; i--) {
        lw_load_point<G>(a.in, w * a.N + i + 1, e);
        G::add(run, e, run);
        G::add(acc, run, acc);
    }
    v[t] = acc;
    rt[t] = run;""")

_EDITS = {
    "regwalk": [_ACC_WALK, _REDUCE_WALK],
    "lb3": [("__launch_bounds__(kBucketTileMax)", "__launch_bounds__(kBucketTileMax, 3)")],
    "lb4": [("__launch_bounds__(kBucketTileMax)", "__launch_bounds__(kBucketTileMax, 4)")],
    "sameload": [("lw_load_point<G>(a.in, w * a.N + i + 1, e);",
                  "lw_load_point<G>(a.in, w * a.N + 1 + (i & 1), e);")],
    "notree": [("""    for (int d = 0; (1L << d) < a.P; d++) {
        __syncthreads();
        if (t < (a.P >> d)) lw_bucket_reduce_combine<G>(a, v, d, t);
    }""", ""), ("""    for (int d = 0; (1L << d) < a.P; d++) {
        __syncthreads();
        if (t < (a.P >> (d + 1))) lw_bucket_acc_combine<G>(a, s, w, d, t);
    }""", "")],
    "nodbl": [("    for (int j = 0; j < a.dbl; j++) G::dbl(rt[t], rt[t]);", "")],
}


def build(variant: str, tmp: str):
    """The port's library for ``base``; else kernel 11's sources built from
    an edited copy of ``csrc/``: (ctypes handle, ptxas registers and spills
    by kernel)."""
    if variant == "base":
        return native.cuda_lib(), None
    d = os.path.join(tmp, variant)
    shutil.copytree(native.CSRC_DIR, d)
    path = os.path.join(d, "msm_bucket.cuh")
    with open(path) as fh:
        h = fh.read()
    for name in variant.split("_"):
        for old, new in _EDITS[name]:
            if old not in h:
                raise RuntimeError(f"{variant}: the header no longer holds the text it edits")
            h = h.replace(old, new)
    with open(path, "w") as fh:
        fh.write(h)
    so = os.path.join(d, "lib.so")
    r = subprocess.run([native._nvcc()] + native.NVCC_FLAGS + ["-Xptxas", "-v", "-o", so]
                       + [os.path.join(d, s) for s in SOURCES], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{variant}: nvcc failed\n{r.stderr[-3000:]}")
    regs = re.findall(r"Compiling entry function '_Z\d+(msm_bucket_\w+?_kernel)I10LwJacobianI(\w+?)"
                      r"Params.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                      r.stdout + r.stderr, re.S)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (("lw_msm_bucket_accumulate", [I, I, P, P]),
                           ("lw_msm_bucket_reduce", [I, P, P])):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = I
    return lib, [f"{k} {f}: {r} registers, {s} B spilled" for k, f, s, r in regs]


def run_variant(variant: str, tmp: str) -> dict:
    lib, ptxas = build(variant, tmp)
    dev = torch.device("cuda")
    events, port_launch = [], native.launch

    def timed_launch(kernel, entry, *args, count=1):
        if "msm_bucket" not in entry:
            return port_launch(kernel, entry, *args, count=count)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
        end.record()
        if err != 0:
            raise RuntimeError(f"{entry}: CUDA error {err}")
        events.append((entry.rsplit("_", 1)[-1], start, end))
        native.launches[kernel] += count

    out = {"variant": variant, "ptxas": ptxas}
    native.launch = timed_launch
    try:
        for name, curve in (("bn254_g1", BN254Curve), ("bls12_377_g2", bls12_377_twist())):
            ops, rng = M.make_ops(curve), np.random.default_rng(21)
            fq, n, c = ops.f, 1 << 16, 15
            g2 = fq.num_limbs > 12

            def coord():
                v = [int.from_bytes(rng.bytes(48), "little") % fq.p
                     for _ in range(2 * n if g2 else n)]
                return fq.array(list(zip(v[::2], v[1::2])) if g2 else v, dev)
            pts = (coord(), coord(), fq.ones((n,), dev))
            ids = torch.from_numpy(rng.integers(0, 1 << c, (17, n))).to(dev)
            for _ in range(3):
                events.clear()
                M.weighted_bucket_sums(ops, M.bucket_sums(ops, ids, pts, 1 << c))
            torch.cuda.synchronize()
            rec = {"launches_ms": [(kind, round(s.elapsed_time(e), 4)) for kind, s, e in events]}
            if variant == "base":
                native.launch = port_launch
                big = tuple(torch.cat([x] * 17, dim=-1) for x in pts)
                jac = (big[0], big[1], big[0])
                rec["kernel10_add_17x2^16_ms"] = cuda_ms(lambda: ops.add(jac, big), 3)
                rec["kernel10_add_mixed_17x2^16_ms"] = cuda_ms(lambda: ops.add_mixed(jac, big), 3)
                native.launch = timed_launch
                del big, jac
            out[name] = rec
            del pts
            torch.cuda.empty_cache()
    finally:
        native.launch = port_launch
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_bucket: no CUDA device", file=sys.stderr)
        return 2
    variants = sys.argv[1:] or VARIANTS
    if len(variants) > 1:  # a process a variant: two builds of one kernel clash in one
        print(smi("name,power.limit"), flush=True)
        rcs = [subprocess.run([sys.executable, "-m", __spec__.name, v]).returncode
               for v in variants]
        return max(rcs)
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(run_variant(variants[0], tmp)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
