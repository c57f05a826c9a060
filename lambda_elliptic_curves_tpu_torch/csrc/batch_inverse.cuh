// Montgomery's trick over one strided chunk of a Stark252 batch: the walk
// that each thread of batch_inverse.cu runs, kept in a header so that the
// same code is compiled for the host and checked against Python integers
// without a card (tests/test_torch_batch_inverse.py).
//
// x and out are (8, n) int32 limb planes (plane stride n), values in
// Montgomery form.  Chunk c of C holds the elements c, c + C, c + 2C, ...
// below n, so at each step neighbouring chunks touch neighbouring words of
// every plane.
#pragma once

#include "mont.cuh"

// Threads per block of the kernel.
#define LW_INV_THREADS 128

// Chunks (a thread each) for a batch of n.  A thread runs about 3L + 446
// dependent products for its L elements, and all threads together about
// n (3 + 446 / L).  Below 2^19 elements the walk's latency rules and L is
// 16 (2^14 threads at 2^18); the length then doubles with n up to 256
// (2^16 threads at 2^24), where the one Fermat per chunk adds 1.7 products
// per element to the trick's 3.  The steps are the fastest lengths of a
// sweep over L at every n = 2^18 .. 2^24 on an H100
// (tools/sweep_batch_inverse.py, PERF.md).
LW_HD long lw_batch_inverse_chunks(long n) {
    long len = n < (1L << 19) ? 16
             : n < (1L << 20) ? 32
             : n < (1L << 22) ? 64
             : n < (1L << 23) ? 128 : 256;
    return (n + len - 1) / len;
}

LW_HD void lw_load_plane(const int32_t* x, long n, long i, uint32_t v[LW_LIMBS]) {
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) v[k] = (uint32_t)x[k * n + i];
}

LW_HD void lw_store_plane(int32_t* x, long n, long i, const uint32_t v[LW_LIMBS]) {
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) x[k * n + i] = (int32_t)v[k];
}

// out[:, i] = x[:, i]^-1 (Montgomery form; zero maps to zero) for the
// elements i = c, c + chunks, ... below n.  out doubles as scratch: the
// forward pass writes the running product after each element there, the
// backward pass overwrites it with the inverses.  Zeros count as one.
LW_HD void lw_batch_inverse_chunk(const int32_t* x, int32_t* out, long n,
                                  long c, long chunks) {
    if (c >= n) return;
    uint32_t run[LW_LIMBS], v[LW_LIMBS];
    lw_mont_one(run);
    long last = c;
    for (long i = c; i < n; i += chunks) {
        lw_load_plane(x, n, i, v);
        if (!lw_is_zero(v)) lw_mont_mul(run, v, run);
        lw_store_plane(out, n, i, run);
        last = i;
    }
    // run is a product of nonzero values, so it is not zero: Fermat,
    // run^(p-2) with p - 2 = 2^251 + 2^196 + 2^192 - 1 (252 bits)
    const uint32_t p_minus_2[LW_LIMBS] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                         0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                         16u, 0x08000000u};
    uint32_t inv[LW_LIMBS];
    lw_mont_pow(run, p_minus_2, 252, inv);
    // inv = (product up to element i)^-1; the product before i is the
    // prefix that the forward pass left at i - chunks
    for (long i = last; i >= c; i -= chunks) {
        lw_load_plane(x, n, i, v);
        if (lw_is_zero(v)) {
            const uint32_t zero[LW_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
            lw_store_plane(out, n, i, zero);
            continue;
        }
        if (i == c) {
            lw_store_plane(out, n, i, inv);
            break;
        }
        uint32_t prev[LW_LIMBS], r[LW_LIMBS];
        lw_load_plane(out, n, i - chunks, prev);
        lw_mont_mul(inv, prev, r);
        lw_store_plane(out, n, i, r);
        lw_mont_mul(inv, v, inv);
    }
}
