// Kernel 10, curve_point_op_kernel and curve_comb_kernel: one Jacobian
// group op (complete addition, complete mixed addition or doubling) over n
// lanes, and the fixed-base comb (every lane's sum of its windows' table
// entries), for one of the four curve groups of curve.cuh (BN254 G1 and
// G2, BLS12-377 G1 and G2), one thread a lane, the whole formula in
// registers.
//
// Replaces XLA code, not a Pallas kernel: the JAX package's JacobianOps
// (lambda_elliptic_curves_tpu/curves/weierstrass.py add :284, add_mixed
// :322, double :253), which the port first ran as a composition of kernel 8
// launches (about 47 a G1 addition and 210 a G2 addition, every
// intermediate through device memory, the doubling computed on every lane
// and selected away).  Here an op is one launch; the doubling of an
// addition is a branch taken by the lanes that need it.  The comb is the
// port's own route to [s_i] G (the JAX package's setups run one host
// scalar multiplication a point): curves/msm.py's fixed_base_multiples,
// which ran one op launch a window and a gather of the window's table
// entries into new planes before it (31 launches and 93 gathers for 32
// windows, the running sums through device memory every window), is one
// launch: a lane's 31 mixed additions stay in registers, its entries come
// from an entry-major table of at most 1.5 MB (in the 50 MB L2) by 16-byte
// loads, and its point is written once.
//
// Layout: an operand of the op entry is three (ROWS, *batch) int32
// tensors, ROWS = 8 or 12 for G1 and 16 or 24 for G2 (an Fp2 value:
// component 0's limbs, then component 1's), row k of element i of
// coordinate c at k * ls + i * es, so one point broadcast over the batch is
// read with element stride 0 and never materialised.  The output of both
// entries is three contiguous (ROWS, n) planes.
//
// Bound on this card: operations.  A G1 mixed addition is 11 base products
// (a full addition 16), a G2 one 11 Fp2 products of 3 base products each,
// at dense32.cuh's carry-chain product; the op entry moves 2 x 3 + 3
// values of 32 or 48 (G1) and 64 or 96 (G2) bytes a lane, the comb 31
// table entries from L2, its digits and one point.  The base product and the
// group ops are functions of their own (curve.cuh), and the G2 instances
// are built in their own translation unit (curve_g2.cu), so the build
// stays near the other sources' time.  Threads a block and the launch
// bound: curve.cuh's LW_CURVE_THREADS and LW_CURVE_MIN_BLOCKS, from
// tools/sweep_curve.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

// One op (LW_CURVE_ADD, _ADD_MIXED, _DOUBLE) over n lanes of `group`
// (LW_CURVE_*): out = a op b.  args: 18 longs, operand a's and operand b's
// LwPoints (curve.cuh: three pointers, three row strides, three element
// strides; b's are read only by the additions).
extern "C" int lw_curve_op(int group, int op, const long* args, int32_t* ox, int32_t* oy,
                           int32_t* oz, long n, void* stream) {
    if (op < LW_CURVE_ADD || op > LW_CURVE_DOUBLE) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    const LwPoints a = lw_points_arg(args), b = lw_points_arg(args + 9);
    cudaStream_t s = (cudaStream_t)stream;
    switch (group) {
        case LW_CURVE_BN254_G1: return lw_curve_op_run<LwBn254G1>(op, a, b, ox, oy, oz, n, s);
        case LW_CURVE_BLS12_377_G1:
            return lw_curve_op_run<LwBls12377G1>(op, a, b, ox, oy, oz, n, s);
        default: return lw_curve_op_g2(group, op, a, b, ox, oy, oz, n, s);
    }
}

// The fixed-base comb over n lanes of `group`: args as lw_comb_arg reads
// them (7 longs: the entry-major table, its infinity flags, the digits,
// their row stride, c, windows, digit rows)
extern "C" int lw_curve_comb(int group, const long* args, int32_t* ox, int32_t* oy, int32_t* oz,
                             long n, void* stream) {
    const LwComb a = lw_comb_arg(args);
    if (a.c < 1 || a.c > 16 || a.windows < 1 || a.digit_rows < 1) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    switch (group) {
        case LW_CURVE_BN254_G1: return lw_curve_comb_run<LwBn254G1>(a, ox, oy, oz, n, s);
        case LW_CURVE_BLS12_377_G1: return lw_curve_comb_run<LwBls12377G1>(a, ox, oy, oz, n, s);
        default: return lw_curve_comb_g2(group, a, ox, oy, oz, n, s);
    }
}

// kind 0 (the op entry) or 1 (the comb entry) of `group`: threads a block,
// blocks an SM, registers and local bytes a thread (lw_curve_info_run)
extern "C" int lw_curve_info(int group, int kind, long* out) {
    switch (group) {
        case LW_CURVE_BN254_G1: return lw_curve_info_run<LwBn254G1>(kind, out);
        case LW_CURVE_BLS12_377_G1: return lw_curve_info_run<LwBls12377G1>(kind, out);
        default: return lw_curve_info_g2(group, kind, out);
    }
}
