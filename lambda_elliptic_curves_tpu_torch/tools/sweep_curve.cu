// Kernel 10's two entries (csrc/curve.cuh: the group op and the fixed-base
// comb) at one launch shape, for tools/sweep_curve.py, which builds this
// source once per shape with -DSW_THREADS=<threads a block>
// -DSW_MIN_BLOCKS=<the launch bound's least blocks an SM>, each in an nvcc
// of its own: the group law's out-of-line functions are compiled under
// the register limit of the kernels that call them, so each shape needs a
// translation unit to itself.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

template <class G>
static int op_run(int op, const long* args, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                  cudaStream_t s) {
    return lw_curve_op_run<G, SW_THREADS, SW_MIN_BLOCKS>(op, lw_points_arg(args),
                                                         lw_points_arg(args + 9), ox, oy, oz, n,
                                                         s);
}

template <class G>
static int comb_run(const long* args, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                    cudaStream_t s) {
    return lw_curve_comb_run<G, SW_THREADS, SW_MIN_BLOCKS>(lw_comb_arg(args), ox, oy, oz, n, s);
}

// lw_curve_op's arguments
extern "C" int sw_op(int group, int op, const long* args, int32_t* ox, int32_t* oy, int32_t* oz,
                     long n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (group) {
        case LW_CURVE_BN254_G1: return op_run<LwBn254G1>(op, args, ox, oy, oz, n, s);
        case LW_CURVE_BN254_G2: return op_run<LwBn254G2>(op, args, ox, oy, oz, n, s);
        case LW_CURVE_BLS12_377_G1: return op_run<LwBls12377G1>(op, args, ox, oy, oz, n, s);
        default: return op_run<LwBls12377G2>(op, args, ox, oy, oz, n, s);
    }
}

// lw_curve_comb's arguments
extern "C" int sw_comb(int group, const long* args, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (group) {
        case LW_CURVE_BN254_G1: return comb_run<LwBn254G1>(args, ox, oy, oz, n, s);
        case LW_CURVE_BN254_G2: return comb_run<LwBn254G2>(args, ox, oy, oz, n, s);
        case LW_CURVE_BLS12_377_G1: return comb_run<LwBls12377G1>(args, ox, oy, oz, n, s);
        default: return comb_run<LwBls12377G2>(args, ox, oy, oz, n, s);
    }
}

// lw_curve_info's arguments
extern "C" int sw_info(int group, int kind, long* out) {
    switch (group) {
        case LW_CURVE_BN254_G1: return lw_curve_info_run<LwBn254G1, SW_THREADS, SW_MIN_BLOCKS>(kind, out);
        case LW_CURVE_BN254_G2: return lw_curve_info_run<LwBn254G2, SW_THREADS, SW_MIN_BLOCKS>(kind, out);
        case LW_CURVE_BLS12_377_G1:
            return lw_curve_info_run<LwBls12377G1, SW_THREADS, SW_MIN_BLOCKS>(kind, out);
        default: return lw_curve_info_run<LwBls12377G2, SW_THREADS, SW_MIN_BLOCKS>(kind, out);
    }
}
