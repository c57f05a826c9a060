// Kernel 11's BN254 G2 instances, and the dispatch to its BLS12-377 G2
// ones (msm_bucket_bls12_377_g2.cu; msm_bucket.cu holds the kernel's
// entries and its G1 instances): translation units of their own, so that
// nvcc builds them beside the G1 instances.
#include <cuda_runtime.h>
#include <stdint.h>

#include "msm_bucket.cuh"

int lw_bucket_accumulate_g2(int group, const LwBucketAcc& a, bool mixed, cudaStream_t s) {
    switch (group) {
        case LW_CURVE_BN254_G2: return lw_bucket_accumulate_run<LwBn254G2>(a, mixed, s);
        case LW_CURVE_BLS12_377_G2: return lw_bucket_accumulate_bls12_377_g2(a, mixed, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

int lw_bucket_reduce_g2(int group, const LwBucketReduce& a, cudaStream_t s) {
    switch (group) {
        case LW_CURVE_BN254_G2: return lw_bucket_reduce_run<LwBn254G2>(a, s);
        case LW_CURVE_BLS12_377_G2: return lw_bucket_reduce_bls12_377_g2(a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

int lw_bucket_occupancy_g2(int group, int kind, int threads, long* out) {
    switch (group) {
        case LW_CURVE_BN254_G2: return lw_bucket_occupancy_run<LwBn254G2>(kind, threads, out);
        case LW_CURVE_BLS12_377_G2: return lw_bucket_occupancy_bls12_377_g2(kind, threads, out);
        default: return (int)cudaErrorInvalidValue;
    }
}
