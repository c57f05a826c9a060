"""Compare the machine code (SASS) of the CUDA kernels of two checkouts of
the port: each source (default: every ``csrc/*.cu`` that both checkouts
have) of each checkout is compiled to a cubin
with the port's own ``nvcc`` flags (every compile at once), ``cuobjdump
-sass`` lists its kernels,
and every kernel that both checkouts have is compared instruction by
instruction (addresses, encodings and branch targets left out).  A kernel
name's parameter types are normalised so that a type that became a template
(``LwDnExponent`` -> ``LwDnExponent<8>``), or a kernel that took more
template arguments (``curve_point_op_kernel<G>`` -> ``<G, 256, 1>``), still
pairs with its parent.

    python3 lambda_elliptic_curves_tpu_torch/tools/sass_diff.py --tree DIR [--against DIR]
        [SOURCE ...]

``--against`` defaults to the checkout holding this file.  Needs ``nvcc``
and ``cuobjdump`` (the CUDA toolkit), not a card.  Prints one JSON line:
per kernel, the instruction counts of both and whether they are the same
(the first differing lines when they are not), and the kernels that only
one side has.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _sources(tree: str) -> set:
    csrc = os.path.join(tree, "lambda_elliptic_curves_tpu_torch", "csrc")
    return {f for f in os.listdir(csrc) if f.endswith(".cu")}


def _tool(name: str) -> str:
    found = shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)
    if not os.path.exists(found):
        raise SystemExit(f"{name} not found")
    return found


def _normalise(name: str) -> str:
    name = re.sub(r"LwDnExponentI.*?EE(?=i$)", "LwDnExponent", name)
    # kernel 10's op entry took its launch shape as template arguments
    return re.sub(r"(curve_point_op_kernelI.*?)Li\d+ELi\d+E(?=Evi8LwPoints)", r"\1", name)


def compile_cubin(tree: str, source: str, out_dir: str, tag: str):
    """(cubin path, the running ``nvcc`` that writes it) for ``source`` in
    ``tree``."""
    src = os.path.join(tree, "lambda_elliptic_curves_tpu_torch", "csrc", source)
    cubin = os.path.join(out_dir, f"sass_{source}_{tag}.cubin")
    return cubin, subprocess.Popen([_tool("nvcc"), "-cubin", "-gencode",
                                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-o",
                                    cubin, src])


def kernels_sass(cubin: str) -> dict:
    """Kernel name -> its instructions, for a compiled cubin."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name = body.split("\n", 1)[0].strip()
        lines = []
        for line in body.split("\n")[1:]:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
            if m:
                lines.append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)).strip())
        out[_normalise(name)] = lines
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--against", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("sources", nargs="*")
    args = ap.parse_args()
    args.sources = args.sources or sorted(_sources(args.tree) & _sources(args.against))
    sys.path.insert(0, args.against)
    from lambda_elliptic_curves_tpu_torch import native

    os.makedirs(native.BUILD_DIR, exist_ok=True)
    report = {"tree": os.path.abspath(args.tree), "against": os.path.abspath(args.against),
              "kernels": {}, "only_tree": [], "only_against": []}
    jobs = {(source, tag): compile_cubin(tree, source, native.BUILD_DIR, tag)
            for source in args.sources for tag, tree in (("tree", args.tree),
                                                         ("against", args.against))}
    for (source, tag), (_, proc) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed on {source} ({tag})")
    for source in args.sources:
        a = kernels_sass(jobs[(source, "tree")][0])
        b = kernels_sass(jobs[(source, "against")][0])
        for name in sorted(set(a) & set(b)):
            diff = [(i, x, y) for i, (x, y) in enumerate(zip(a[name], b[name])) if x != y]
            report["kernels"][f"{source}:{name}"] = {
                "instructions": [len(a[name]), len(b[name])], "same": a[name] == b[name],
                "first_differences": diff[:10]}
        report["only_tree"] += [f"{source}:{n}" for n in sorted(set(a) - set(b))]
        report["only_against"] += [f"{source}:{n}" for n in sorted(set(b) - set(a))]
    report["all_same"] = all(k["same"] for k in report["kernels"].values())
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
