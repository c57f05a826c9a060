// Batch inversion by a tiled Montgomery trick on (8, n) limb planes over
// Stark252 (kernel 4, lw_field_batch_inverse).  The dense fields have a
// kernel of their own (kernel 9, dense_inverse.cu).
//
// Replaces XLA code, not a Pallas kernel: the JAX package's
// lambda_elliptic_curves_tpu/ops/limbs.py:895 batch_inverse (an
// associative scan for small n, (C, 64) chunk scans for large n; both
// shapes exist for XLA's compile costs, which the card does not have).
// Same values, bit for bit: each element's inverse in Montgomery form
// (R = 2^256), zeros mapping to zero.
//
// Bound on this card: at large n the integer multiply rate, then the
// bytes.  The trick needs 3 Montgomery products per element (a prefix going
// forward; inverse times prefix and inverse times element going back) and
// moves 64 bytes per element at least.  This design stores each prefix in
// out and reads it back (160 bytes per element) rather than rebuild the
// prefixes from x (96 bytes, but a fourth product): on an H100 the
// products run at about 53 G/s, so at 2^24 elements three take 0.95 ms and
// four 1.27 ms, against 0.80 ms and 0.48 ms of bytes (PERF.md).  At small
// n, latency: the walks, the trees and the one inversion (lw_mont_inv).
//
// Design (batch_inverse.cuh): tiles of T x L elements, T = 256 threads per
// block and L elements per thread (8 to 128, growing with n), strided by T
// so that every limb plane is read in runs of T words; each thread loads
// its next element before the product of this one; the threads' totals
// meet in a binary tree in shared memory, and the tile totals form the
// next level, up to a level of one tile, where the one inversion of the
// call happens.  Launches per call: 2 levels - 1 (1 up to one tile, 3 for
// every size the prover inverts, 5 beyond 2^30 elements); the levels above
// the first live in a scratch tensor of 2n / (T L) elements that the
// caller allocates.
#include <cuda_runtime.h>
#include <stdint.h>

#include "batch_inverse.cuh"

// One kernel per mode, so that the up and down passes carry neither the
// inversion's code nor its registers.  A down pass takes its tiles last
// first: the up pass ended on those, and some of their elements and
// prefixes are still in L2.
template <int MODE, class F = LwStark252>
__global__ void __launch_bounds__(LW_INV_THREADS)
batch_inverse_kernel(LwInvLevel V) {
    extern __shared__ uint32_t sm[];
    const long b = MODE == LW_INV_DOWN ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    lw_inv_block<F>(V, MODE, b, threadIdx.x, blockDim.x, sm);
}

// every launch of the call, T threads per block and L elements per thread
// (tools/sweep_batch_inverse.py builds its own entry on it to time others);
// F: the field
template <class F = LwStark252>
static int lw_inv_run(const int32_t* x, int32_t* out, int32_t* scratch, long n, int T, int L,
                      void* stream) {
    if (n < 0 || !lw_inv_shape_ok(T, L)) return (int)cudaErrorInvalidValue;
    const LwInvPlan P = lw_inv_plan(n, T, L, F::LIMBS);
    for (int i = 0; i < P.launches; i++) {
        const LwInvLaunch l = lw_inv_launch(P, i, x, out, scratch, T, L);
        const size_t smem = 4 * lw_inv_smem_words(T, F::LIMBS);
        cudaStream_t st = (cudaStream_t)stream;
        const long blocks = l.lev.tiles;
        if (l.mode == LW_INV_UP)
            batch_inverse_kernel<LW_INV_UP, F><<<blocks, T, smem, st>>>(l.lev);
        else if (l.mode == LW_INV_TOP)
            batch_inverse_kernel<LW_INV_TOP, F><<<blocks, T, smem, st>>>(l.lev);
        else
            batch_inverse_kernel<LW_INV_DOWN, F><<<blocks, T, smem, st>>>(l.lev);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

// Launches that lw_field_batch_inverse makes for n elements, and the int32
// words of scratch it needs.
extern "C" int lw_field_batch_inverse_plan(long n, long* scratch_words) {
    const LwInvPlan P = lw_inv_plan(n, LW_INV_THREADS, lw_inv_walk(n));
    *scratch_words = P.scratch_words;
    return P.launches;
}

// (8, n) planes x into out (both contiguous, distinct), scratch of
// lw_field_batch_inverse_plan's words.
extern "C" int lw_field_batch_inverse(const int32_t* x, int32_t* out, int32_t* scratch, long n,
                                      void* stream) {
    return lw_inv_run(x, out, scratch, n, LW_INV_THREADS, lw_inv_walk(n), stream);
}
