// Stark252 batch inversion by Montgomery's trick on (8, n) limb planes
// (kernel 4).
//
// Replaces XLA code, not a Pallas kernel: the JAX package's
// lambda_elliptic_curves_tpu/ops/limbs.py:895 batch_inverse (an
// associative scan for small n, (C, 64) chunk scans for large n; both
// shapes exist for XLA's compile costs, which the card does not have).
// Same values, bit for bit: each element's inverse in Montgomery form
// (R = 2^256), zeros mapping to zero.
//
// Bound on this card: at large n the 32-bit integer multiply rate.  The
// trick needs 3 Montgomery products per element (forward prefix, and
// inverse times prefix and inverse times element going back), each about
// 170 integer instructions, against 64 bytes read and written; the one
// Fermat inversion per chunk adds 446 products over the chunk's elements.
// At small n, latency: one thread runs about 3L + 446 dependent products.
//
// Design: one thread per chunk walks its elements c, c + C, ... (so that
// neighbouring threads touch neighbouring words of every plane) forward
// with a running product in registers, writing each prefix to out (out
// doubles as scratch, nothing else is allocated), inverts the chunk total
// by Fermat in the same thread, and walks back (batch_inverse.cuh).  The
// chunk length L = n / C is chosen from n (lw_batch_inverse_chunks):
// enough threads to fill the card, and L large enough that the Fermat is
// amortised.  One launch, no synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "batch_inverse.cuh"

__global__ void batch_inverse_kernel(const int32_t* x, int32_t* out, long n,
                                     long chunks) {
    long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= chunks) return;
    lw_batch_inverse_chunk(x, out, n, c, chunks);
}

// (8, n) planes x into out (both contiguous, distinct).
extern "C" int lw_field_batch_inverse(const int32_t* x, int32_t* out, long n,
                                      void* stream) {
    if (n > 0) {
        long chunks = lw_batch_inverse_chunks(n);
        long blocks = (chunks + LW_INV_THREADS - 1) / LW_INV_THREADS;
        batch_inverse_kernel<<<blocks, LW_INV_THREADS, 0, (cudaStream_t)stream>>>(
            x, out, n, chunks);
    }
    return (int)cudaGetLastError();
}
