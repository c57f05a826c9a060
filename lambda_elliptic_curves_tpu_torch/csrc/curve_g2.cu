// Kernel 10's G2 instances (BN254 G2, BLS12-377 G2; curve.cu holds the
// kernel's entries and its G1 instances): a translation unit of their own, so
// that nvcc builds them beside the G1 instances.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

int lw_curve_op_g2(int group, int op, const LwPoints& a, const LwPoints& b, int32_t* ox,
                   int32_t* oy, int32_t* oz, long n, cudaStream_t s) {
    switch (group) {
        case LW_CURVE_BN254_G2: return lw_curve_op_run<LwBn254G2>(op, a, b, ox, oy, oz, n, s);
        case LW_CURVE_BLS12_377_G2:
            return lw_curve_op_run<LwBls12377G2>(op, a, b, ox, oy, oz, n, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

int lw_curve_comb_g2(int group, const LwComb& a, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                     cudaStream_t s) {
    switch (group) {
        case LW_CURVE_BN254_G2: return lw_curve_comb_run<LwBn254G2>(a, ox, oy, oz, n, s);
        case LW_CURVE_BLS12_377_G2: return lw_curve_comb_run<LwBls12377G2>(a, ox, oy, oz, n, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

int lw_curve_info_g2(int group, int kind, long* out) {
    switch (group) {
        case LW_CURVE_BN254_G2: return lw_curve_info_run<LwBn254G2>(kind, out);
        case LW_CURVE_BLS12_377_G2: return lw_curve_info_run<LwBls12377G2>(kind, out);
        default: return (int)cudaErrorInvalidValue;
    }
}
