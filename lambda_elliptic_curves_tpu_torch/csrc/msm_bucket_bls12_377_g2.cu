// Kernel 11's BLS12-377 G2 instances (msm_bucket.cu holds the kernel's
// entries, msm_bucket_g2.cu the dispatch over the G2 groups): the longest
// instances to build, so a translation unit of their own.
#include <cuda_runtime.h>
#include <stdint.h>

#include "msm_bucket.cuh"

int lw_bucket_accumulate_bls12_377_g2(const LwBucketAcc& a, bool mixed, cudaStream_t s) {
    return lw_bucket_accumulate_run<LwBls12377G2>(a, mixed, s);
}

int lw_bucket_reduce_bls12_377_g2(const LwBucketReduce& a, cudaStream_t s) {
    return lw_bucket_reduce_run<LwBls12377G2>(a, s);
}

int lw_bucket_occupancy_bls12_377_g2(int kind, int threads, long* out) {
    return lw_bucket_occupancy_run<LwBls12377G2>(kind, threads, out);
}
