"""Sweep kernel 10's launch shape on one NVIDIA card: threads a block and the
launch bound's least blocks an SM, for both of its entries (the group op,
``lw_curve_op``, and the fixed-base comb, ``lw_curve_comb``) over the four
curve groups.

    python3 -m lambda_elliptic_curves_tpu_torch.tools.sweep_curve [--rounds R] [T,B ...]

Each shape (default: ``SHAPES``; 64 or 128 or 256 threads, and least
blocks that cap a thread at 255, 168 or 128 registers) builds
``tools/sweep_curve.cu`` in an ``nvcc`` of its own (all at once: the
group law's out-of-line functions take the register limit of their
callers) and runs in a process of its own, R times (default 1), the
shapes' order reversed every other round, so that a drift of the card
falls on every shape alike.  Over inputs drawn on the card from fixed
seeds, each process times, with CUDA events around the C entry alone on
outputs allocated once:

* the mixed addition at 17 x 2^16 and 2^16 lanes (random Jacobian triples
  and random affine points, off the curve, which the formulas do not
  need);
* the comb at its main-path shapes (``chip_smoke.py``'s ``COMB_LANES``:
  the Plonk SRS of 2^16 gates, the Groth16 setup's G1 and G2 combs at 2^16
  constraints, BN254 G2 at 2^16), random scalars, at the port's window
  (``curves.msm.FIXED_BASE_WINDOW``);

and reports each kernel's threads, blocks an SM, registers and local bytes
(``lw_curve_info``'s query) and ptxas's registers and spills.  Every
output is held bitwise against the port's own kernel on the same inputs
(a digest of its bytes, from a process of its own).  The best shape of a
group is the one with the least median comb time over the rounds.
Prints the card's name and power limit, then one JSON line; about 5
minutes a round.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

from .. import native
from ._timing import cuda_ms, digest, random_dense, random_digits, smi

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "sweep_curve.cu")
#: (threads a block, least blocks an SM): register caps 255 / 168 / 128 at
#: 64 threads, 255 / 168 / 128 at 128, 255 / 128 at 256
SHAPES = ((64, 1), (64, 6), (64, 8), (128, 1), (128, 3), (128, 4), (256, 1), (256, 2))
GROUPS = ("bn254_g1", "bn254_g2", "bls12_377_g1", "bls12_377_g2")
OP_LANES = (17 << 16, 1 << 16)


def _comb_lanes() -> dict:
    """``chip_smoke.py``'s ``COMB_LANES``: the comb's lanes on the main
    path, by group (the script sits at the root of the checkout)."""
    path = os.path.join(HERE, os.pardir, os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.COMB_LANES


def _curve(group):
    from ..curves.twists import bls12_377_twist, bn254_twist
    from ..curves.zoo import BLS12377Curve, BN254Curve

    return {"bn254_g1": BN254Curve, "bn254_g2": bn254_twist(),
            "bls12_377_g1": BLS12377Curve, "bls12_377_g2": bls12_377_twist()}[group]


def build(shapes) -> dict:
    """(threads, blocks) -> (library path, ptxas output), every shape
    compiled at once into the port's build directory (reused when there)."""
    jobs = {}
    for t, b in shapes:
        flags = native.COMPILE_FLAGS + ["-shared", "-I", native.CSRC_DIR,
                                        f"-DSW_THREADS={t}", f"-DSW_MIN_BLOCKS={b}"]
        deps = [SRC] + [os.path.join(native.CSRC_DIR, h)
                        for h in ("curve.cuh", "dense32.cuh", "dense.cuh", "mont.cuh")]
        so = native._tagged_path(f"libsweep_curve_{t}_{b}", deps, flags)
        if os.path.exists(so):
            jobs[(t, b)] = (so, None, None)
            continue
        os.makedirs(native.BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        jobs[(t, b)] = (so, tmp, subprocess.Popen([native._nvcc()] + flags + ["-o", tmp, SRC],
                                                  stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    out = {}
    for shape, (so, tmp, proc) in jobs.items():
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {shape}:\n{log}")
            with open(so + ".log", "w") as fh:
                fh.write(log)
            os.replace(tmp, so)
        out[shape] = (so, open(so + ".log").read() if os.path.exists(so + ".log") else "")
    return out


def ptxas(log: str) -> dict:
    """"{group} {op|comb}" and the group ops' functions -> registers and
    spill bytes, from one shape's ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or re.search(
            r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            field = "bls12_377" if "Bls12377" in mangled else "bn254"
            group = field + ("_g2" if "LwFp2" in mangled else "_g1")
            kind = next((k for k, mark in (("op", "curve_point_op_kernel"),
                                           ("comb", "curve_comb_kernel"),
                                           ("add_mixed", "9add_mixed"), ("add", "3add"),
                                           ("double", "3dbl"), ("product", "lw_fq_mul"))
                         if mark in mangled), None)
            name = None if kind is None else (f"product {field}" if kind == "product"
                                              else f"{group} {kind}")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def _inputs(group, gen):
    """(ops, group number, op operands a and b at the largest OP_LANES,
    comb table, its windows, comb digits)."""
    from ..curves import msm as M

    curve = _curve(group)
    ops = M.make_ops(curve)
    f, n = ops.f, max(OP_LANES)
    a = (random_dense(f, n, gen), random_dense(f, n, gen), random_dense(f, n, gen))
    b = (random_dense(f, n, gen), random_dense(f, n, gen), f.ones((n,), gen.device))
    bits = M._scalar_bits(curve)
    windows = -(-bits // M.FIXED_BASE_WINDOW)
    table = M._comb_table(ops, curve.generator(), M.FIXED_BASE_WINDOW, windows, gen.device)
    digits = random_digits(bits, _comb_lanes()[group], gen, M.DIGIT_BITS)
    return ops, curve.kernel_group, a, b, table, windows, digits


def run_shape(so) -> dict:
    """Times, digests and occupancy of one shape's library (``so``), or of
    the port's own kernel (``so`` None)."""
    import torch

    from ..curves import msm as M

    lib = native.cuda_lib() if so is None else ctypes.CDLL(so)
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    op_fn = lib.lw_curve_op if so is None else lib.sw_op
    comb_fn = lib.lw_curve_comb if so is None else lib.sw_comb
    info_fn = lib.lw_curve_info if so is None else lib.sw_info
    if so is not None:
        op_fn.argtypes, comb_fn.argtypes = [I, I, P, P, P, P, L, P], [I, P, P, P, P, L, P]
        info_fn.argtypes = [I, I, P]
        for fn in (op_fn, comb_fn, info_fn):
            fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {}
    for group in GROUPS:
        gen = torch.Generator(device=dev).manual_seed(GROUPS.index(group) + 31)
        ops, gid, a, b, table, windows, digits = _inputs(group, gen)
        rec = out[group] = {}
        for kind, name in ((0, "op"), (1, "comb")):
            res = (ctypes.c_long * 4)()
            if info_fn(gid, kind, res) != 0:
                raise RuntimeError(f"{group}: the occupancy query failed")
            rec[name] = {"threads": res[0], "blocks_per_sm": res[1], "registers": res[2],
                         "local_bytes": res[3]}
        for n in OP_LANES:
            pa = tuple(c[:, :n] for c in a)
            pb = tuple(c[:, :n] for c in b)
            args_a, keep_a = ops.points_arg(pa, (n,), n)
            args_b, keep_b = ops.points_arg(pb, (n,), n)
            args = (ctypes.c_long * 18)(*(args_a + args_b))
            o = tuple(torch.empty((ops.f.num_limbs, n), dtype=torch.int32, device=dev)
                      for _ in range(3))

            def launch():
                if op_fn(gid, 1, args, *(x.data_ptr() for x in o), n, stream()) != 0:
                    raise RuntimeError(f"{group}: the op entry failed")
            rec[f"add_mixed_{n}_ms"] = cuda_ms(launch, 5)
            if n == min(OP_LANES):
                rec["add_mixed_digest"] = digest(o)
            del keep_a, keep_b, o
        n = digits.shape[-1]
        o = tuple(torch.empty((ops.f.num_limbs, n), dtype=torch.int32, device=dev)
                  for _ in range(3))
        args = M.comb_args(table, digits, M.FIXED_BASE_WINDOW, windows)

        def launch():
            if comb_fn(gid, args, *(x.data_ptr() for x in o), n, stream()) != 0:
                raise RuntimeError(f"{group}: the comb entry failed")
        o[2].fill_(-1)
        launch()
        rec["comb_digest"] = digest(o)
        rec["comb_ms"] = cuda_ms(launch, 5)
        rec["comb_lanes"] = n
        del a, b, o, digits
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import statistics

    import torch

    args = sys.argv[1:]
    if args[:1] == ["--run"]:  # one shape's process
        print(json.dumps(run_shape(None if args[1] == "port" else args[1])))
        return 0
    if not torch.cuda.is_available():
        print("sweep_curve: no CUDA device", file=sys.stderr)
        return 2
    rounds = 1
    if args[:1] == ["--rounds"]:
        rounds, args = int(args[1]), args[2:]
    card = smi("name,power.limit")
    print(card, flush=True)
    shapes = [tuple(int(x) for x in s.split(",")) for s in args] or list(SHAPES)
    native.cuda_lib()
    built = build(shapes)
    order = [shape for r in range(rounds) for shape in (shapes if r % 2 == 0 else shapes[::-1])]
    rec = {"card": card, "order": [], "shapes": {},
           "ptxas": {f"{t},{b}": ptxas(built[(t, b)][1]) for t, b in shapes}}
    for key, so in [("port", "port")] + [(f"{t},{b}", built[(t, b)][0]) for t, b in order]:
        r = subprocess.run([sys.executable, "-m", __spec__.name, "--run", so],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:] + r.stderr[-4000:], file=sys.stderr)
            return 1
        rec["order"].append(key)
        rec["shapes"].setdefault(key, []).append(json.loads(r.stdout.strip().splitlines()[-1]))
    port = rec["shapes"]["port"][0]
    bad = sorted({f"{key} {g} {k}" for key, runs in rec["shapes"].items() for run in runs
                  for g in GROUPS for k in run[g] if k.endswith("digest")
                  and run[g][k] != port[g][k]})
    rec["median_comb_ms"] = {key: {g: statistics.median(run[g]["comb_ms"] for run in runs)
                                   for g in GROUPS}
                             for key, runs in rec["shapes"].items()}
    rec["best"] = {g: min((k for k in rec["shapes"] if k != "port"),
                          key=lambda k: rec["median_comb_ms"][k][g]) for g in GROUPS}
    print(json.dumps(rec), flush=True)
    if bad:
        print(f"sweep_curve: outputs differ from the port's kernel: {bad}", file=sys.stderr)
        return 1
    return 0

if __name__ == "__main__":
    sys.exit(main())
