"""Native libraries of the port, built at first use into ``build/``.

* the host Keccak-256 (transcripts, Merkle path checks): the port's own C
  source ``csrc/host/keccak.c``, compiled with ``cc``;
* the CUDA kernels ``csrc/*.cu``: one shared library with a plain C
  interface, compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
  source, all started together, then one link) and loaded with ctypes.

Each library's file name carries a hash of its sources and flags, so an
edited source is never served by a stale build, and concurrent builds
write to a private file and rename it into place.

Every kernel launch goes through :func:`launch`, which raises when the C
entry reports a CUDA error and counts the launch in :data:`launches`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
CSRC_DIR = os.path.join(_PKG, "csrc")
HOST_KECCAK_SRC = os.path.join(CSRC_DIR, "host", "keccak.c")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
#: one source to an object; ``-Xptxas -v`` reports each kernel's resources
COMPILE_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"] + ["-Xptxas", "-v"]

#: kernel name -> launches since the last reset (set every count to 0):
#: ``field`` the elementwise ops, ``field_pow`` powers by a host exponent,
#: ``field_inv`` batch inversion (``csrc/batch_inverse.cu``)
launches: dict = {"field": 0, "field_pow": 0, "field_inv": 0, "ntt": 0, "keccak": 0}

#: source file name -> what ``nvcc`` printed while compiling it (with
#: ``-Xptxas -v``: registers, shared memory and spills of each kernel)
build_log: dict = {}

_lock = threading.Lock()
_host = None
_cuda = None


def _tagged_path(stem: str, sources: list, flags: list) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def _compile(cmd_prefix: list, out: str, sources: list) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(cmd_prefix + ["-o", tmp] + sources,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd_prefix[0]} failed:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)


def host_keccak():
    """ctypes handle of the host Keccak-256 library (built on first use)."""
    global _host
    with _lock:
        if _host is None:
            flags = ["cc", "-O2", "-shared", "-fPIC"]
            so = _tagged_path("libkeccak_host", [HOST_KECCAK_SRC], flags)
            if not os.path.exists(so):
                _compile(flags, so, [HOST_KECCAK_SRC])
            lib = ctypes.CDLL(so)
            lib.lw_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.c_char_p]
            lib.lw_keccak256.restype = None
            _host = lib
        return _host


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def cuda_sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _compile_cuda(so: str, srcs: list) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in srcs:
        obj = f"{so}.{os.path.basename(src)}.{os.getpid()}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc] + COMPILE_FLAGS + ["-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in jobs:
        build_log[os.path.basename(src)] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src}:\n{build_log[os.path.basename(src)]}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        _compile([nvcc] + NVCC_FLAGS, so, [obj for _, obj, _ in jobs])
    finally:
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)


def cuda_lib():
    """ctypes handle of the CUDA kernel library (built on first use)."""
    global _cuda
    with _lock:
        if _cuda is None:
            srcs = cuda_sources()
            headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
            so = _tagged_path("liblwt_cuda", srcs + headers, COMPILE_FLAGS)
            if not os.path.exists(so):
                _compile_cuda(so, srcs)
            lib = ctypes.CDLL(so)
            P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
            sigs = {
                "lw_field_op": [I, P, L, L, P, L, L, P, L, P],
                "lw_field_pow": [P, L, L, P, L, P, I, P],
                "lw_field_batch_inverse_plan": [L, P],
                "lw_field_batch_inverse": [P, P, P, L, P],
                "lw_ntt_passes": [P, P, P, P, P, L, I, I, P, I, P],
                "lw_keccak_f": [P, P, L, P],
                "lw_keccak256_words": [P, I, L, I, P, P],
            }
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _cuda = lib
        return _cuda


def launch(kernel: str, entry: str, *args, count: int = 1) -> None:
    """Call C entry ``entry`` of the CUDA library with ``args`` (the stream
    is appended), raise on a CUDA error, count ``count`` launches of
    ``kernel`` (the launches the entry makes)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(cuda_lib(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    launches[kernel] += count
