// Stark252 NTT pass kernel (kernel 1): one launch runs one Stockham pass of
// radix 2^s over (8, rows, N) limb planes; poly/ntt.py runs a transform of
// 2^L points as ceil(L / s_max) such passes, natural order in and out.
//
// Replaces the Pallas kernel lambda_elliptic_curves_tpu/poly/ntt_pallas.py
// :109 _kernel_for (pallas_call at :164; driven by _local_fft :183), which
// runs every butterfly stage of a local transform of n <= 1024 points on a
// VMEM-resident block, and, with it, the four-step split that put the
// transposes and an N-point cross-twiddle multiply around it.
//
// Bound on this card: 32-bit integer operations.  A transform does
// (N/2) log2 N butterflies, each a Montgomery product (about 170 integer
// instructions: 64 widening products of a*b, 24 of m*p) plus an add and a
// subtract, against 64 bytes of device memory per point and pass.  At
// N = 2^22, issued at 128 instructions per clock per SM across the two
// integer pipes, that is 0.30 ms of operations against 0.08 ms of bytes
// per pass.
//
// Design (the block's work is lw_ntt_pass_block in ntt.cuh):
//  * no transposes: the Stockham addressing reads column j's points at
//    stride N/2^s and writes them where the next pass reads them, so each
//    pass reads and writes every point once and the last pass leaves the
//    spectrum in natural order;
//  * a block takes 2^s points from each of C = 8 adjacent columns;
//    neighbouring threads take neighbouring columns, so every limb plane is
//    read and written in runs of C words (32 bytes) whatever the stride;
//  * the tile stays in shared memory for the pass's s stages, run two
//    stages per synchronisation (radix 4: four points in registers);
//  * no table of N twiddles: every root power is one product of two tables
//    of about 2^(L/2) entries (w^e = T_hi[e >> h] * T_lo[e mod 2^h]), read
//    once per block into small per-column tables in shared memory; a point
//    costs one product for its twist and one to apply it;
//  * products are mont.cuh's lw_mont_mul (64-bit multiply-adds, then a
//    carry-chain reduction with p's sparse limbs folded into a few words),
//    sums ntt.cuh's lw_ntt_butterfly in carry-chain instructions; every
//    product and sum reduces strictly, so values stay canonical and the
//    output equals the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt.cuh"

#define LW_NTT_THREADS 256
#define LW_NTT_MIN_BLOCKS 2     // blocks per SM the registers must allow
#define LW_NTT_MAX_SMEM 232448  // bytes a block may use on sm_90
// log2 of the columns a block takes: C = 8, 84 KB of shared memory at radix
// 2^8, two blocks per SM, and every limb plane read and written in 32-byte
// runs (one memory sector).  tools/sweep_ntt.py times C = 4 .. 32 at every
// radix; C = 4 was within 1% of C = 8 at 2^22 points, C = 16 slower.
#define LW_NTT_TILE_COLS_LOG 3

__global__ void __launch_bounds__(LW_NTT_THREADS, LW_NTT_MIN_BLOCKS)
ntt_pass_kernel(LwNttPass P) {
    extern __shared__ uint32_t sm[];
    lw_ntt_pass_block(P, blockIdx.x, threadIdx.x, blockDim.x, sm);
}

// lw_ntt_passes with 2^log_c columns per block (tools/sweep_ntt.py builds
// its own entry on it to time other widths)
static int lw_ntt_run(const int32_t* x, int32_t* out, int32_t* buf, const int32_t* t_lo,
                      const int32_t* t_hi, long rows, int log_n, int ns_log, const int* radix,
                      int npasses, int log_c, void* stream) {
    static bool attr_set = false;
    int total = ns_log;
    for (int i = 0; i < npasses; i++) {
        if (radix[i] < 1) return (int)cudaErrorInvalidValue;
        total += radix[i];
    }
    if (ns_log < 0 || total > log_n || log_n > 30 || log_c < 0 || log_c > 10 || rows < 0
        || (npasses > 1 && buf == nullptr))
        return (int)cudaErrorInvalidValue;
    if (!attr_set) {
        cudaError_t err = cudaFuncSetAttribute(
            ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LW_NTT_MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    const int32_t* src = x;
    for (int i = 0; i < npasses && rows > 0; i++) {
        const int s = radix[i];
        const long cols = rows << (log_n - s);
        int lc = 0;  // ceil(log2(cols)), at most log_c
        while (lc < log_c && (1L << lc) < cols) lc++;
        const long smem = 4 * lw_ntt_pass_smem_words(s, lc);
        if (smem > LW_NTT_MAX_SMEM) return (int)cudaErrorInvalidValue;
        const long blocks = (cols + (1L << lc) - 1) >> lc;
        const long work = (1L << (lc + s)) >> 2;  // radix-4 steps of a block
        const int threads = work >= LW_NTT_THREADS ? LW_NTT_THREADS : (work < 32 ? 32 : (int)work);
        int32_t* dst = (npasses - 1 - i) % 2 == 0 ? out : buf;
        LwNttPass P = {(const uint32_t*)src, (uint32_t*)dst, (const uint32_t*)t_lo,
                       (const uint32_t*)t_hi, rows, log_n, ns_log, s, lc};
        ntt_pass_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(P);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = dst;
        ns_log += s;
    }
    return (int)cudaGetLastError();
}

// The passes of radix 2^radix[0], 2^radix[1], ... after radices multiplying
// to 2^ns_log, one launch each, over (8, rows, 2^log_n) limb planes: x into
// out, through buf when there are two passes or more (the last pass writes
// out; x, out and buf distinct).  t_lo, t_hi: the root tables, entry-major.
// A block takes 2^LW_NTT_TILE_COLS_LOG columns, or fewer when a pass has
// fewer in all.
extern "C" int lw_ntt_passes(const int32_t* x, int32_t* out, int32_t* buf,
                             const int32_t* t_lo, const int32_t* t_hi, long rows,
                             int log_n, int ns_log, const int* radix, int npasses,
                             void* stream) {
    return lw_ntt_run(x, out, buf, t_lo, t_hi, rows, log_n, ns_log, radix, npasses,
                      LW_NTT_TILE_COLS_LOG, stream);
}
