// Kernel 11, msm_bucket_accumulate_kernel and msm_bucket_reduce_kernel:
// Pippenger's bucket phase (msm_bucket.cuh) over the four curve groups of
// curve.cuh, a block a tile of up to 128 leaves with a binary tree over
// them in shared memory, a level a launch.
//
// Replaces XLA code, not a Pallas kernel: what the JAX package's
// bucket_accumulate_chunked (lambda_elliptic_curves_tpu/curves/msm.py:107)
// and its suffix-sum reduction compute, and what the port first ran as a
// Hillis-Steele segmented scan of complete additions (log2 B levels over
// every lane: about 1.9e7 additions for 17 windows of 2^16 points, each
// addition some 47-210 launches of kernel 8).  The bucket phase takes
// about one mixed addition a point and two additions a bucket (and 3
// additions and a doubling a reduce leaf), whatever the skew of the
// scalars.
//
// Bound on this card: operations, the additions of the data's runs (about
// W B mixed additions and 2 W 2^c full ones, at curve.cuh's products),
// against the bytes of W B points read once and the table written once.
// What the design does about the latency of dependent additions: a thread
// walks at most T = 16 positions or m = 16 buckets (the launches that fill
// the card), and everything above a leaf is a tree of log2 P steps inside
// a block, so the small launches at the top of a level (a block a window)
// are chains of a few additions: 2 accumulate and 2 reduce launches for
// 17 windows of 2^16 points at c = 15.
// The kernels and their launchers are in msm_bucket.cuh; this unit builds
// the G1 instances, msm_bucket_g2.cu and msm_bucket_bls12_377_g2.cu the G2
// ones.
#include <cuda_runtime.h>
#include <stdint.h>

#include "msm_bucket.cuh"

// One accumulate level of `group` (curve.cuh's LW_CURVE_*): args as
// lw_bucket_acc_arg reads them; mixed: the points are affine (level 0)
extern "C" int lw_msm_bucket_accumulate(int group, int mixed, const long* args, void* stream) {
    const LwBucketAcc a = lw_bucket_acc_arg(args);
    if (a.W <= 0 || a.S <= 0 || a.T <= 0 || a.N <= 0 || a.P <= 0 || (a.K > 1 && !a.slot_ids))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (group) {
        case LW_CURVE_BN254_G1: return lw_bucket_accumulate_run<LwBn254G1>(a, mixed, s);
        case LW_CURVE_BLS12_377_G1: return lw_bucket_accumulate_run<LwBls12377G1>(a, mixed, s);
        default: return lw_bucket_accumulate_g2(group, a, mixed, s);
    }
}

// One reduce level of `group`: args as lw_bucket_reduce_arg reads them
extern "C" int lw_msm_bucket_reduce(int group, const long* args, void* stream) {
    const LwBucketReduce a = lw_bucket_reduce_arg(args);
    if (a.W <= 0 || a.N <= 0 || a.m < 0 || a.P <= 0 || (a.m & (a.m - 1)) ||
        (a.m == 0 && !a.in_r.p[0]))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (group) {
        case LW_CURVE_BN254_G1: return lw_bucket_reduce_run<LwBn254G1>(a, s);
        case LW_CURVE_BLS12_377_G1: return lw_bucket_reduce_run<LwBls12377G1>(a, s);
        default: return lw_bucket_reduce_g2(group, a, s);
    }
}

// The occupancy of kind 0 (the mixed accumulate), 1 (the accumulate) or 2
// (the reduce) of `group` at blocks of `threads`: out[0] the blocks an SM
// holds at once, out[1] a block's dynamic shared bytes
extern "C" int lw_msm_bucket_occupancy(int group, int kind, int threads, long* out) {
    switch (group) {
        case LW_CURVE_BN254_G1: return lw_bucket_occupancy_run<LwBn254G1>(kind, threads, out);
        case LW_CURVE_BLS12_377_G1:
            return lw_bucket_occupancy_run<LwBls12377G1>(kind, threads, out);
        default: return lw_bucket_occupancy_g2(group, kind, threads, out);
    }
}
