"""The dense Montgomery products side by side on one NVIDIA card: dense.cuh's
CIOS on 64-bit words (the reference) and dense32.cuh's carry-chain product
(kernel 1 over BN254 Fr and BLS12-377 Fr, kernels 8 and 9, and the curve
kernels 10 and 11), over BN254 Fr, BLS12-377 Fr (four words) and BLS12-377
Fq (six).

    python3 -m lambda_elliptic_curves_tpu_torch.tools.dense_mul

Builds ``tools/dense_mul.cu`` with the port's ``nvcc`` flags, then for each
field and product: the SASS instructions of one product and of one
butterfly (``cuobjdump``: a kernel of one a thread, less a kernel that only
loads, combines and stores the same words) and their mix by opcode, the registers and spills of a
kernel that chains products (``-Xptxas -v``), the time of one product in a
chain on one warp (its latency) and products per second over the whole
card (chains on 132 x 8 blocks of 256 threads); and dense32.cuh's product
held bitwise against dense.cuh's over 2^20 random pairs plus the edge
values (:func:`edges`) each against each.  Prints the card's name and
power limit, then one JSON line.  ``chip_smoke.py`` and the card tests
call :func:`build` and :func:`check`; ``chip_smoke.py`` bounds kernel 1 by
:func:`sass_counts`.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys

from .. import native
from ._timing import cuda_ms, smi

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dense_mul.cu")
#: field number in dense.cuh -> (name, modulus, 32-bit limbs, template name)
FIELDS = {
    0: ("bn254_fr", 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001, 8,
        "LwBn254FrParams"),
    2: ("bls12_377_fr", 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001, 8,
        "LwBls12377FrParams"),
    3: ("bls12_377_fq", int("1AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B"
                            "5D44300000008508C00000000001", 16), 12, "LwBls12377FqParams"),
}
#: variant number in dense_mul.cu -> name
VARIANTS = {0: "cios64 (dense.cuh)", 1: "carry chains (dense32.cuh)"}
#: dn_mul_run's kinds that are launched (the others are only compiled, for
#: their SASS)
PAIRS, CHAIN = 0, 1

_built: dict = {}


def build():
    """ctypes entry ``dn_mul_run`` of ``dense_mul.cu`` (built on first use
    into the port's build directory) and the ``-Xptxas -v`` output."""
    if "fn" not in _built:
        flags = native.COMPILE_FLAGS + ["-shared", "-I", native.CSRC_DIR]
        deps = [SRC] + [os.path.join(native.CSRC_DIR, h)
                        for h in ("dense32.cuh", "dense.cuh", "mont.cuh")]
        so = native._tagged_path("libdense_mul", deps, flags)
        log = so + ".log"
        if not os.path.exists(so):
            os.makedirs(native.BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            r = subprocess.run([native._nvcc()] + flags + ["-o", tmp, SRC],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
            with open(log, "w") as fh:
                fh.write(r.stdout + r.stderr)
            os.replace(tmp, so)
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn = ctypes.CDLL(so).dn_mul_run
        fn.argtypes = [I, I, I, P, P, P, L, I, I, I, P]
        fn.restype = ctypes.c_int
        _built.update(fn=fn, so=so, log=open(log).read() if os.path.exists(log) else "")
    return _built["fn"]


def _run(field, kind, variant, a, b, r, n=0, blocks=1, threads=1, iters=0):
    import torch

    err = build()(field, kind, variant, a.data_ptr(), b.data_ptr(), r.data_ptr(), n, blocks,
                  threads, iters, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dn_mul_run: CUDA error {err}")
    return r


def edges(p: int, limbs: int) -> list:
    """0, 1, 2, p - 1, p - 2, (p -+ 1) / 2, R mod p, R^2 mod p (R = 2^(32
    limbs)), and 2^k - 1, 2^k - 2 mod p for k the bit length of p, one
    less, and 32 limbs - 2."""
    R, b = 1 << (32 * limbs), p.bit_length()
    out = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, R % p, R * R % p]
    out += [((1 << k) - d) % p for k in (b, b - 1, 32 * limbs - 2) for d in (1, 2)]
    return out


def operands(field: int, n: int, gen):
    """(a, b): n random canonical values each (uniform below p, drawn on the
    card from ``gen``), then the edge values each against each; entry-major
    int32 ``(count, limbs)``."""
    import torch

    _, p, L, _ = FIELDS[field]
    p_limbs = [(p >> (32 * k)) & 0xFFFFFFFF for k in range(L)]
    top = (1 << p_limbs[-1].bit_length()) - 1

    def draw(m):
        v = torch.randint(0, 1 << 32, (m, L), generator=gen, device=gen.device,
                          dtype=torch.int64)
        v[:, -1] &= top
        return v

    def below_p(v):
        below = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
        equal = torch.ones_like(below)
        for k in reversed(range(L)):
            below |= equal & (v[:, k] < p_limbs[k])
            equal &= v[:, k] == p_limbs[k]
        return below

    def uniform(m):
        v = draw(m)
        while not bool((ok := below_p(v)).all()):
            v[~ok] = draw(int((~ok).sum()))
        return v

    e = edges(p, L)
    ea = torch.tensor([[(x >> (32 * k)) & 0xFFFFFFFF for k in range(L)] for x in e],
                      dtype=torch.int64, device=gen.device)
    a = torch.cat([uniform(n), ea.repeat_interleave(len(e), 0)])
    b = torch.cat([uniform(n), ea.repeat(len(e), 1)])
    return a.to(torch.int32).contiguous(), b.to(torch.int32).contiguous()


def check(field: int, n: int = 1 << 20, seed: int = 5) -> dict:
    """dense32.cuh's products against dense.cuh's on :func:`operands`:
    variant name -> pairs that differ (0 when bitwise equal), and the
    pairs."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, b = operands(field, n, gen)
    count = a.shape[0]
    want = _run(field, PAIRS, 0, a, b, torch.empty_like(a), count, 1024, 256)
    got = _run(field, PAIRS, 1, a, b, torch.empty_like(a), count, 1024, 256)
    return {"pairs": count, VARIANTS[1]: int((got != want).any(dim=1).sum().item())}


def _opcode(op: str) -> str:
    """An instruction's opcode, keeping the .WIDE and .HI that change its
    cost (IMAD.WIDE.U32.X -> IMAD.WIDE)."""
    return op.split(".")[0] + (".WIDE" if ".WIDE" in op else "") + (".HI" if ".HI" in op else "")


def sass_counts() -> dict:
    """``"{field name} {variant name}"`` -> SASS instructions of one
    product and their mix by opcode, and the same key + ``" butterfly"`` ->
    those of one butterfly (u + v and u - v), from ``cuobjdump -sass`` of the
    built library."""
    build()
    cuobjdump = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", _built["so"]], check=True, capture_output=True,
                          text=True).stdout
    bodies = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name = body.split("\n", 1)[0].strip()
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s*(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", body)]
        bodies[name] = ops
    out = {}
    for field, (fname, _, _, tname) in FIELDS.items():
        base = [ops for name, ops in bodies.items() if "dn_copy" in name and tname in name]
        for (v, vname), (kernel, what) in itertools.product(
                VARIANTS.items(), (("dn_mul_one", ""), ("dn_bfly_one", " butterfly"))):
            one = [ops for name, ops in bodies.items()
                   if kernel in name and tname in name and f"Li{v}E" in name]
            if not one or not base:
                continue
            mix = collections.Counter(map(_opcode, one[0]))
            mix.subtract(map(_opcode, base[0]))
            out[f"{fname} {vname}{what}"] = {
                "instructions": len(one[0]) - len(base[0]),
                "mix": {k: c for k, c in sorted(mix.items(), key=lambda kv: -kv[1]) if c}}
    return out


def sass_ops(count: dict) -> tuple:
    """(multiply-adds, logic ops, other) of one :func:`sass_counts` entry,
    as ``chip_smoke.py``'s bounds count instructions: every IMAD (wide,
    high or not) a multiply-add, LOP3 and SHF logic, the rest other."""
    mix = count["mix"]
    mads = sum(c for k, c in mix.items() if k.startswith("IMAD"))
    logic = max(0, sum(c for k, c in mix.items() if k in ("LOP3", "SHF")))
    return mads, logic, count["instructions"] - mads - logic


def registers() -> dict:
    """(field name, variant name) -> registers and spill bytes of the kernel
    that chains products, from the build's ``-Xptxas -v`` output."""
    build()
    out, name = {}, None
    for line in _built["log"].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or re.search(
            r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        if not name or "dn_mul_chain" not in name:
            continue
        key = next((f"{f[0]} {VARIANTS[v]}" for f in FIELDS.values() for v in VARIANTS
                    if f[3] in name and f"Li{v}E" in name), None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if key and m:
            out.setdefault(key, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if key and m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def timings(field: int) -> dict:
    """variant name -> the ns of one product in a chain on one warp, and
    products per second over 132 x 8 blocks of 256 threads (each a chain
    of 32 products), CUDA events, one warm-up call each."""
    import torch

    _, _, L, _ = FIELDS[field]
    gen = torch.Generator(device="cuda").manual_seed(9)
    blocks, threads, iters = 132 * 8, 256, 32
    a, _ = operands(field, 2 * blocks * threads, gen)
    r = torch.empty((blocks * threads, L), dtype=torch.int32, device="cuda")
    out = {}
    for v, vname in VARIANTS.items():
        lat = cuda_ms(lambda: _run(field, CHAIN, v, a, a, r, 0, 1, 32, 256), 5)
        thr = cuda_ms(lambda: _run(field, CHAIN, v, a, a, r, 0, blocks, threads, iters), 5)
        out[vname] = {"chain_ns_per_product": lat * 1e6 / 256,
                      "card_products_per_s": blocks * threads * iters / (thr * 1e-3)}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dense_mul: no CUDA device", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(card, flush=True)
    build()
    rec = {"card": card, "sass": sass_counts(), "registers": registers(), "fields": {}}
    for field, (fname, _, _, _) in FIELDS.items():
        rec["fields"][fname] = {"check": check(field), "timings": timings(field)}
        if any(v for k, v in rec["fields"][fname]["check"].items() if k != "pairs"):
            print(json.dumps(rec))
            print(f"dense_mul: a product differs from dense.cuh's over {fname}", file=sys.stderr)
            return 1
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
