"""Time the batch-inversion kernel's chunk walk over chunk lengths L at every
batch size n = 2^18 .. 2^24 on one NVIDIA card, beside the length that
``lw_batch_inverse_chunks`` (``csrc/batch_inverse.cuh``) picks; that
function's table of lengths comes from this sweep.

    python3 -m lambda_elliptic_curves_tpu_torch.tools.sweep_batch_inverse

Each length runs the walk of kernel 4 (``csrc/batch_inverse.cu``) with the
chunk count set from the host, through a launch entry that this script
builds with ``nvcc`` beside the port's library (whose entry derives the
count from n).  Each output is held bitwise against the plain version
before it is timed; times are CUDA-event means after one warm-up launch.
Prints the card's name and power limit, one JSON line per size, and as
the last line a JSON object with every size.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

from .. import native
from ._timing import cuda_ms, random_field, smi

LENGTHS = (8, 16, 32, 64, 128, 256, 512)
LOG_SIZES = range(18, 25)

_SRC = r"""
#include <cuda_runtime.h>
#include "batch_inverse.cuh"

__global__ void sweep_kernel(const int32_t* x, int32_t* out, long n, long chunks) {
    long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c < chunks) lw_batch_inverse_chunk(x, out, n, c, chunks);
}

extern "C" long sweep_chunks_for(long n) { return lw_batch_inverse_chunks(n); }

extern "C" int sweep_batch_inverse(const int32_t* x, int32_t* out, long n, long chunks,
                                   void* stream) {
    long blocks = (chunks + LW_INV_THREADS - 1) / LW_INV_THREADS;
    sweep_kernel<<<blocks, LW_INV_THREADS, 0, (cudaStream_t)stream>>>(x, out, n, chunks);
    return (int)cudaGetLastError();
}
"""


def _build():
    """ctypes handle of the sweep's launch entry (built on first use)."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    src = os.path.join(native.BUILD_DIR, "sweep_batch_inverse.cu")
    with open(src, "w") as fh:
        fh.write(_SRC)
    flags = native.NVCC_FLAGS + ["-I", native.CSRC_DIR]
    headers = [os.path.join(native.CSRC_DIR, h) for h in ("batch_inverse.cuh", "mont.cuh")]
    so = native._tagged_path("libsweep_batch_inverse", [src] + headers, flags)
    if not os.path.exists(so):
        native._compile([native._nvcc()] + flags, so, [src])
    lib = ctypes.CDLL(so)
    lib.sweep_chunks_for.argtypes = [ctypes.c_long]
    lib.sweep_chunks_for.restype = ctypes.c_long
    lib.sweep_batch_inverse.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                        ctypes.c_long, ctypes.c_void_p]
    lib.sweep_batch_inverse.restype = ctypes.c_int
    return lib


def sweep(lib, log_n: int, gen) -> dict:
    """ms by chunk length at n = 2^log_n, random values below 2^251 < p."""
    import torch

    from ..ops import limbs

    n = 1 << log_n
    x = random_field((n,), gen)
    want = limbs.batch_inverse_plain(x)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def run(chunks: int) -> None:
        err = lib.sweep_batch_inverse(x.data_ptr(), out.data_ptr(), n, chunks, stream)
        if err != 0:
            raise RuntimeError(f"sweep_batch_inverse: CUDA error {err} at n = 2^{log_n}")

    ms = {}
    for length in LENGTHS:
        chunks = -(-n // length)
        out.zero_()
        run(chunks)
        if not torch.equal(out, want):
            raise RuntimeError(f"L = {length} at n = 2^{log_n} differs from the plain version")
        ms[length] = cuda_ms(lambda: run(chunks), 10 if log_n <= 20 else 3)
    return {"n": f"2^{log_n}", "picked_L": n // lib.sweep_chunks_for(n),
            "fastest_L": min(ms, key=ms.get), "ms_by_L": ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_batch_inverse: no CUDA device", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(card, flush=True)
    lib = _build()
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for log_n in LOG_SIZES:
        rows.append(sweep(lib, log_n, gen))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "sweep": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
