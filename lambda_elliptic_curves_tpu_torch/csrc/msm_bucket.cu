// Kernel 11, msm_bucket_accumulate_kernel and msm_bucket_reduce_kernel:
// Pippenger's bucket phase (msm_bucket.cuh) over the four curve groups of
// curve.cuh, one thread a chunk of T sorted positions (accumulate) or of m
// buckets (reduce), a level a launch.
//
// Replaces XLA code, not a Pallas kernel: what the JAX package's
// bucket_accumulate_chunked (lambda_elliptic_curves_tpu/curves/msm.py:107)
// and its suffix-sum reduction compute, and what the port first ran as a
// Hillis-Steele segmented scan of complete additions (log2 B levels over
// every lane: about 1.9e7 additions for 17 windows of 2^16 points, each
// addition some 47-210 launches of kernel 8).  Here the bucket phase takes
// about one mixed addition a point and two additions a bucket, in about
// log_(T/2) B + log_m 2^c launches; the load of a thread is T or 2 m
// additions whatever the skew of the scalars.
//
// Bound on this card: operations, the additions of the data's runs (about
// W B mixed additions and 2 W 2^c full ones, at curve.cuh's products),
// against the bytes of W B points read once and the table written once.
// The last levels hold few threads (one a window at the end), so their
// additions run one after another: the latency of a few dozen additions.
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
    if (a.W <= 0 || a.S <= 0 || a.T <= 0 || a.N <= 0 || (a.K > 1 && !a.slot_ids))
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
    if (a.W <= 0 || a.N <= 0 || a.m <= 0 || a.dbl < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (group) {
        case LW_CURVE_BN254_G1: return lw_bucket_reduce_run<LwBn254G1>(a, s);
        case LW_CURVE_BLS12_377_G1: return lw_bucket_reduce_run<LwBls12377G1>(a, s);
        default: return lw_bucket_reduce_g2(group, a, s);
    }
}
