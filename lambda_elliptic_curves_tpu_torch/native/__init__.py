"""Native libraries of the port, built at first use into ``build/``.

* the host Keccak-256 (transcripts, Merkle path checks) and the host
  proof-of-work search ``lw_grind``: the port's own C source
  ``csrc/host/keccak.c``, compiled with ``cc``;
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
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
CSRC_DIR = os.path.join(_PKG, "csrc")
HOST_KECCAK_SRC = os.path.join(CSRC_DIR, "host", "keccak.c")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
#: one source to an object; ``-Xptxas -v`` reports each kernel's resources
COMPILE_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"] + ["-Xptxas", "-v"]

#: kernel name -> launches since the last reset (set every count to 0):
#: ``field`` the elementwise Stark252 ops, ``field_pow`` powers by a host
#: exponent, ``field_inv`` batch inversion (``csrc/batch_inverse.cu``),
#: ``grind`` the proof-of-work nonce search (``csrc/keccak.cu``),
#: ``small_field`` the Goldilocks / BabyBear and tower ops and their batch
#: inversion (``csrc/small_field.cu``), ``small_ntt`` their NTT passes
#: (``csrc/small_ntt.cu``), ``dense_field`` the BN254 Fr / Fq ops
#: (``csrc/dense_field.cu``), ``dense_program`` their programs of ops (the
#: same source's program entry), ``dense_inv`` their batch inversion
#: (``csrc/dense_inverse.cu``), ``dense_ntt`` BN254 Fr's NTT passes
#: (``csrc/ntt.cu``); ``dense_field_bls12_377``, ``dense_program_bls12_377``,
#: ``dense_inv_bls12_377`` and
#: ``dense_ntt_bls12_377`` the same kernels' BLS12-377 instances (Fq on six
#: words, Fr on four); ``curve_op`` BN254's G1 and G2 group ops and
#: fixed-base combs (``csrc/curve.cu``), ``msm_bucket`` their Pippenger bucket phase
#: (``csrc/msm_bucket.cu``), and ``curve_op_bls12_377`` and
#: ``msm_bucket_bls12_377`` BLS12-377's
launches: dict = {"field": 0, "field_pow": 0, "field_inv": 0, "ntt": 0, "keccak": 0,
                  "grind": 0, "small_field": 0, "small_ntt": 0, "dense_field": 0,
                  "dense_program": 0, "dense_inv": 0, "dense_ntt": 0,
                  "dense_field_bls12_377": 0, "dense_program_bls12_377": 0,
                  "dense_inv_bls12_377": 0, "dense_ntt_bls12_377": 0, "curve_op": 0,
                  "msm_bucket": 0, "curve_op_bls12_377": 0, "msm_bucket_bls12_377": 0}

#: source file name -> what ``nvcc`` printed while compiling it (with
#: ``-Xptxas -v``: registers, shared memory and spills of each kernel), and
#: the seconds from the build's start to its ``nvcc``'s end
build_log: dict = {}
build_seconds: dict = {}

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
            lib.lw_grind.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
                                     ctypes.c_uint64]
            lib.lw_grind.restype = ctypes.c_int64
            _host = lib
        return _host


def grind(inner: bytes, factor: int, start: int, count: int) -> int:
    """The least nonce in ``[start, start + count)`` whose Keccak-256 digest
    of ``inner || nonce_be8`` has ``factor`` leading zero bits, by the host
    loop ``lw_grind``; -1 when the range holds none."""
    return host_keccak().lw_grind(bytes(inner), int(factor), int(start), int(count))


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
    """One ``nvcc -c`` per source, all running at once, then one link; each
    source's output and its seconds go to :data:`build_log` and
    :data:`build_seconds`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    t0 = time.perf_counter()
    for src in srcs:
        obj = f"{so}.{os.path.basename(src)}.{os.getpid()}.o"
        log = open(f"{obj}.log", "w+")
        jobs.append((src, obj, log, subprocess.Popen(
            [nvcc] + COMPILE_FLAGS + ["-c", "-o", obj, src],
            stdout=log, stderr=subprocess.STDOUT, text=True)))
    pending = set(range(len(jobs)))
    while pending:
        for i in list(pending):
            if jobs[i][3].poll() is not None:
                build_seconds[os.path.basename(jobs[i][0])] = time.perf_counter() - t0
                pending.discard(i)
        time.sleep(0.05)
    failed = []
    for src, obj, log, proc in jobs:
        log.seek(0)
        build_log[os.path.basename(src)] = log.read()
        log.close()
        os.remove(f"{obj}.log")
        if proc.returncode != 0:
            failed.append(f"{src}:\n{build_log[os.path.basename(src)]}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        _compile([nvcc] + NVCC_FLAGS, so, [obj for _, obj, _, _ in jobs])
    finally:
        for _, obj, _, _ in jobs:
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
            P, L, I, U = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint64
            sigs = {
                "lw_field_op": [I, P, L, L, P, L, L, P, L, P],
                "lw_field_pow": [P, L, L, P, L, P, I, P],
                "lw_field_batch_inverse_plan": [L, P],
                "lw_field_batch_inverse": [P, P, P, L, P],
                "lw_ntt_passes": [P, P, P, P, P, L, I, I, P, I, P],
                "lw_keccak_f": [P, P, L, P],
                "lw_keccak256_words": [P, I, L, I, P, P],
                "lw_grind_search": [U, U, U, U, I, U, L, P, P],
                "lw_small_field_op": [I, I, I, P, L, L, P, L, L, P, L, U, P, I, P],
                "lw_small_field_info": [I, I, I, P],
                "lw_small_ntt_passes": [I, P, P, P, P, P, P, L, I, I, I, P, P, I, P],
                "lw_small_ntt_info": [I, I, I, P],
                "lw_dense_field_op": [I, I, P, L, L, P, L, L, P, L, P, I, P],
                "lw_dense_field_program": [I, I, P, P, P, I, P, P, P, P, I, P, L, P],
                "lw_dense_inverse": [I, P, P, L, P],
                "lw_dense_inverse_info": [I, L, P],
                "lw_dense_ntt_passes": [I, P, P, P, P, L, I, I, P, P, I, P],
                "lw_dense_ntt_info": [I, I, I, P],
                "lw_curve_op": [I, I, P, P, P, P, L, P],
                "lw_curve_comb": [I, P, P, P, P, L, P],
                "lw_curve_info": [I, I, P],
                "lw_msm_bucket_accumulate": [I, I, P, P],
                "lw_msm_bucket_reduce": [I, P, P],
                "lw_msm_bucket_occupancy": [I, I, I, P],
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
