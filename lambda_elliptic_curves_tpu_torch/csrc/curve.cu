// Kernel 10, curve_point_op_kernel: one Jacobian group op (complete
// addition, complete mixed addition or doubling) over n lanes of one of the
// four curve groups of curve.cuh (BN254 G1 and G2, BLS12-377 G1 and G2),
// one thread a lane, the whole formula in registers.
//
// Replaces XLA code, not a Pallas kernel: the JAX package's JacobianOps
// (lambda_elliptic_curves_tpu/curves/weierstrass.py add :284, add_mixed
// :322, double :253), which the port first ran as a composition of kernel 8
// launches (about 47 a G1 addition and 210 a G2 addition, every
// intermediate through device memory, the doubling computed on every lane
// and selected away).  Here an op is one launch; the doubling of an
// addition is a branch taken by the lanes that need it.
//
// Layout: an operand is three (ROWS, *batch) int32 tensors, ROWS = 8 or 12
// for G1 and 16 or 24 for G2 (an Fp2 value: component 0's limbs, then
// component 1's), row k of element i of coordinate c at k * ls + i * es, so
// one point broadcast over the batch is read with element stride 0 and
// never materialised.  The output is three contiguous (ROWS, n) planes.
//
// Bound on this card: operations.  A G1 mixed addition is 11 base products
// (a full addition 16), a G2 one 11 Fp2 products of 3 base products each,
// against 2 x 3 + 3 values of 64 or 96 (G1) and 128 or 192 (G2) bytes.  A
// BLS12-377 G2 point is 36 64-bit words, so an addition holds two of them
// and the temporaries, and the G2 instances spill (ptxas's report is in
// native.build_log["curve_g2.cu"]).  No __launch_bounds__: ptxas may take
// all 255 registers a thread, which keeps the spills few at the cost of
// occupancy.  The base product and the group ops are functions of their
// own (curve.cuh), and the G2 instances are built in their own translation
// unit (curve_g2.cu), so the build stays near the other sources' time.
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
