// NTT pass kernel (kernel 1) over Stark252, BN254 Fr and BLS12-377 Fr: one launch
// runs one Stockham pass of radix 2^s over (8, rows, N) limb planes;
// poly/ntt.py runs a transform of 2^L points as ceil(L / s_max) such
// passes, natural order in and out.  Stark252 runs ntt_pass_kernel
// (lw_ntt_passes, the block in ntt.cuh, the product in mont.cuh); the dense
// fields run ntt_dense_pass_kernel (lw_dense_ntt_passes, the block in
// ntt_dense.cuh, the product in dense32.cuh), which computes the same pass.
//
// Replaces the Pallas kernel lambda_elliptic_curves_tpu/poly/ntt_pallas.py
// :109 _kernel_for (pallas_call at :164; driven by _local_fft :183), which
// runs every butterfly stage of a local transform of n <= 1024 points on a
// VMEM-resident block, and, with it, the four-step split that put the
// transposes and an N-point cross-twiddle multiply around it.  The JAX
// package runs that Pallas kernel only from bench.py: its ntt.fft, which
// Plonk calls over BN254 Fr and Groth16's QAP over BLS12-377 Fr (and BN254
// Fr), runs the XLA _fft_pease (poly/ntt.py:327), so the dense entries take
// the place of that, computing the same natural-order transform.
//
// Bound on this card: 32-bit integer operations.  A transform does
// (N/2) log2 N butterflies, each a Montgomery product (about 170 integer
// instructions for Stark252: 64 widening products of a*b, 24 of m*p) plus
// an add and a subtract, against 64 bytes of device memory per point and
// pass.  At N = 2^22, issued at 128 instructions per clock per SM across
// the two integer pipes, that is 0.30 ms of operations against 0.08 ms of
// bytes per pass.
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
//  * Stark252's products are mont.cuh's lw_mont_mul (64-bit multiply-adds,
//    then a carry-chain reduction with p's sparse limbs folded into a few
//    words), its sums lw_mont_butterfly in carry-chain instructions;
//  * every product and sum reduces strictly, so values stay canonical and
//    the output equals the plain version's bit for bit.
//
// The dense fields' pass (ntt_dense.cuh) differs where a product costs
// most: its product is 2 x 64 32-bit multiply-add pairs in carry chains
// (dense32.cuh) instead of CIOS on 64-bit words, about twice Stark252's;
// one table of all N root powers (32 bytes a point read from device memory,
// built once per root and size) gives a twist in one product and the
// DFT's roots in none; and the caller sets the columns per block pass by
// pass, so that the provers' 2^16-2^18-point passes run on at least a
// wave of blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense.cuh"
#include "ntt.cuh"
#include "ntt_dense.cuh"

#define LW_NTT_THREADS 256
#define LW_NTT_MIN_BLOCKS 2     // blocks per SM the registers must allow
#define LW_NTT_MAX_SMEM 232448  // bytes a block may use on sm_90
// log2 of the columns a block takes: C = 8, 84 KB of shared memory at radix
// 2^8, two blocks per SM, and every limb plane read and written in 32-byte
// runs (one memory sector).  tools/sweep_ntt.py times C = 4 .. 32 at every
// radix; C = 4 was within 1% of C = 8 at 2^22 points, C = 16 slower.
#define LW_NTT_TILE_COLS_LOG 3

template <class F>
__global__ void __launch_bounds__(LW_NTT_THREADS, LW_NTT_MIN_BLOCKS)
ntt_pass_kernel(LwNttPass P) {
    extern __shared__ uint32_t sm[];
    lw_ntt_pass_block<F>(P, blockIdx.x, threadIdx.x, blockDim.x, sm);
}

// lw_ntt_passes with 2^log_c columns per block (tools/sweep_ntt.py builds
// its own entry on it to time other widths); F: the field
template <class F = LwStark252>
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
            ntt_pass_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, LW_NTT_MAX_SMEM);
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
        ntt_pass_kernel<F><<<blocks, threads, smem, (cudaStream_t)stream>>>(P);
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

// ---------------------------------------------------------------------------
// The dense entry: kernel 1 over BN254 Fr and BLS12-377 Fr, on its own
// block (ntt_dense.cuh: one power table in place of the per-block twist
// tables) and product (dense32.cuh: 32-bit limbs in carry chains), with
// the columns per block chosen pass by pass by the caller

#define LW_DENSE_NTT_MIN_BLOCKS 2  // blocks per SM the registers must allow

template <class F>
__global__ void __launch_bounds__(LW_NTT_THREADS, LW_DENSE_NTT_MIN_BLOCKS)
ntt_dense_pass_kernel(LwDenseNttPass P) {
    extern __shared__ uint32_t sm[];
    lw_dense_ntt_pass_block<F>(P, blockIdx.x, threadIdx.x, blockDim.x, sm);
}

// threads of a block of radix 2^s and 2^log_c columns: one radix-4 step
// each, up to LW_NTT_THREADS, at least a warp
static int lw_dense_ntt_threads(int s, int log_c) {
    const long work = (1L << (log_c + s)) >> 2;
    return work >= LW_NTT_THREADS ? LW_NTT_THREADS : (work < 32 ? 32 : (int)work);
}

template <class F>
static int lw_dense_ntt_run(const int32_t* x, int32_t* out, int32_t* buf, const int32_t* pw,
                            long rows, int log_n, int ns_log, const int* radix,
                            const int* cols_log, int npasses, void* stream) {
    static bool attr_set = false;
    int total = ns_log;
    for (int i = 0; i < npasses; i++) {
        if (radix[i] < 1 || cols_log[i] < 0 || cols_log[i] > 10) return (int)cudaErrorInvalidValue;
        total += radix[i];
    }
    if (ns_log < 0 || total > log_n || log_n > 30 || rows < 0 || (npasses > 1 && buf == nullptr))
        return (int)cudaErrorInvalidValue;
    if (!attr_set) {
        cudaError_t err = cudaFuncSetAttribute(
            ntt_dense_pass_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            LW_NTT_MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    const int32_t* src = x;
    for (int i = 0; i < npasses && rows > 0; i++) {
        const int s = radix[i], lc = cols_log[i];
        const long smem = 4 * lw_dense_ntt_smem_words(s, lc);
        if (smem > LW_NTT_MAX_SMEM) return (int)cudaErrorInvalidValue;
        const long cols = rows << (log_n - s);
        const long blocks = (cols + (1L << lc) - 1) >> lc;
        int32_t* dst = (npasses - 1 - i) % 2 == 0 ? out : buf;
        LwDenseNttPass P = {(const uint32_t*)src, (uint32_t*)dst, (const uint32_t*)pw, rows,
                            log_n, ns_log, s, lc};
        ntt_dense_pass_kernel<F><<<blocks, lw_dense_ntt_threads(s, lc), smem,
                                   (cudaStream_t)stream>>>(P);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = dst;
        ns_log += s;
    }
    return (int)cudaGetLastError();
}

// The passes of radix 2^radix[i], each on blocks of 2^cols_log[i] columns,
// after radices multiplying to 2^ns_log, one launch each, over (8, rows,
// 2^log_n) limb planes of a dense field with roots of unity (dense.cuh):
// LW_DENSE_BN254_FR (two-adicity 28) or LW_DENSE_BLS12_377_FR (47); x into
// out through buf as lw_ntt_passes.  pw: the powers w^e, e < 2^log_n,
// entry-major.
extern "C" int lw_dense_ntt_passes(int field, const int32_t* x, int32_t* out, int32_t* buf,
                                   const int32_t* pw, long rows, int log_n, int ns_log,
                                   const int* radix, const int* cols_log, int npasses,
                                   void* stream) {
    if (field == LW_DENSE_BN254_FR)
        return lw_dense_ntt_run<LwBn254Fr32>(x, out, buf, pw, rows, log_n, ns_log, radix,
                                             cols_log, npasses, stream);
    if (field == LW_DENSE_BLS12_377_FR)
        return lw_dense_ntt_run<LwBls12377Fr32>(x, out, buf, pw, rows, log_n, ns_log, radix,
                                                cols_log, npasses, stream);
    return (int)cudaErrorInvalidValue;
}

template <class F>
static int lw_dense_ntt_info_of(int s, int log_c, int* info) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, ntt_dense_pass_kernel<F>);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ntt_dense_pass_kernel<F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LW_NTT_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int threads = lw_dense_ntt_threads(s, log_c);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ntt_dense_pass_kernel<F>, threads, 4 * lw_dense_ntt_smem_words(s, log_c));
    info[0] = threads;
    info[1] = blocks;
    info[2] = attr.numRegs;
    info[3] = (int)attr.localSizeBytes;
    return (int)err;
}

// A dense pass of radix 2^s on 2^log_c columns a block: info = {threads a
// block, blocks an SM can hold (the occupancy calculator), registers a
// thread, local (spilled) bytes a thread}
extern "C" int lw_dense_ntt_info(int field, int s, int log_c, int* info) {
    if (s < 1 || log_c < 0 || 4 * lw_dense_ntt_smem_words(s, log_c) > LW_NTT_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    if (field == LW_DENSE_BN254_FR) return lw_dense_ntt_info_of<LwBn254Fr32>(s, log_c, info);
    if (field == LW_DENSE_BLS12_377_FR)
        return lw_dense_ntt_info_of<LwBls12377Fr32>(s, log_c, info);
    return (int)cudaErrorInvalidValue;
}
