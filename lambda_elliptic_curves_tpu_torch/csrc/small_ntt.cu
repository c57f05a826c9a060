// NTT pass kernel over Goldilocks and BabyBear (kernel 7,
// small_ntt_pass_kernel): one launch runs one Stockham pass of radix 2^s
// over (L, rows, N) limb planes; poly/ntt.py runs a transform of 2^k points
// as pass_plan(k) such passes, natural order in and out, as it does for
// Stark252 (csrc/ntt.cu).
//
// Replaces XLA code, not a Pallas kernel: the JAX package transforms these
// fields with lambda_elliptic_curves_tpu/poly/ntt.py:327 _fft_pease, since
// their _lazy_tier is 0 and the Pallas NTT (poly/ntt_pallas.py) does not
// take them.
//
// Bound on this card: bytes, with the arithmetic close behind for
// Goldilocks.  A point is 8 (Goldilocks) or 4 (BabyBear) bytes read and
// written once a pass, 64 MB of Goldilocks values a pass at 2^22 points,
// about 20 us.  A product is about 22 (Goldilocks) or 6 (BabyBear)
// instructions, and a point of a radix-2^6 pass after the first takes
// about 4 (1.25 in the two radix-8 DFTs, 0.77 inner twiddles, the twist's
// product and the step of its power), so a Goldilocks pass's arithmetic is
// of the order of its bytes' time and BabyBear's well below it.
//
// Design (the block's work is lw_sntt_pass_block_s in small_ntt.cuh): the
// radix-2^s DFT as r1 x r2 DFTs of at most 16 points in registers with
// the tile in shared memory between them, so a pass has one barrier (two
// when its output runs are shorter than the tile); twists formed in
// registers from one root-table product a thread; DFT roots from a table
// of 2^8 entries built once per (root, N).  poly/ntt.py sets the plan
// (radix at most 2^6: a radix-2^8 pass holds 16 points a thread in
// 100-128 registers and ran slower) and the columns a block takes pass by
// pass (small_cols_log: up to 32, for 128-byte runs of each BabyBear limb
// plane, fewer while a pass would have too few blocks to fill the card).
#include <cuda_runtime.h>
#include <stdint.h>

#include "small_ntt.cuh"

#define LW_SNTT_MAX_THREADS 256
#define LW_SNTT_MAX_SMEM 232448  // bytes a block may use on sm_90

enum { SNTT_GOLDILOCKS = 0, SNTT_BABYBEAR = 1 };

template <class F, int S>
__global__ void __launch_bounds__(LW_SNTT_MAX_THREADS) small_ntt_pass_kernel(LwSmallNttPass P) {
    extern __shared__ __align__(8) unsigned char sm_bytes[];
    lw_sntt_pass_block_s<F, S>(P, blockIdx.x, threadIdx.x, blockDim.x,
                               reinterpret_cast<typename F::T*>(sm_bytes));
}

template <class F, int S>
static int launch_s(const LwSmallNttPass& P, long blocks, int threads, long smem,
                    cudaStream_t stream) {
    static bool attr_set = false;
    if (!attr_set) {
        cudaError_t err = cudaFuncSetAttribute(small_ntt_pass_kernel<F, S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               LW_SNTT_MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    small_ntt_pass_kernel<F, S><<<blocks, threads, smem, stream>>>(P);
    return (int)cudaGetLastError();
}

template <class F>
static int launch(const LwSmallNttPass& P, long blocks, int threads, long smem,
                  cudaStream_t stream) {
    switch (P.s) {
        case 1: return launch_s<F, 1>(P, blocks, threads, smem, stream);
        case 2: return launch_s<F, 2>(P, blocks, threads, smem, stream);
        case 3: return launch_s<F, 3>(P, blocks, threads, smem, stream);
        case 4: return launch_s<F, 4>(P, blocks, threads, smem, stream);
        case 5: return launch_s<F, 5>(P, blocks, threads, smem, stream);
        case 6: return launch_s<F, 6>(P, blocks, threads, smem, stream);
        case 7: return launch_s<F, 7>(P, blocks, threads, smem, stream);
        case 8: return launch_s<F, 8>(P, blocks, threads, smem, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <class F>
static bool fits(int s, int log_c) {
    return s >= 1 && s <= LW_SNTT_MAX_S && log_c >= 0
           && lw_sntt_threads(s, log_c) <= LW_SNTT_MAX_THREADS
           && (long)sizeof(typename F::T) * lw_sntt_smem_values(s, log_c) <= LW_SNTT_MAX_SMEM;
}

template <class F>
static int run(const int32_t* x, int32_t* out, int32_t* buf, const int32_t* t_lo,
               const int32_t* t_hi, const int32_t* dft, long rows, int log_n, int ns_log,
               int dft_log, const int* radix, const int* cols_log, int npasses,
               cudaStream_t stream) {
    int total = ns_log;
    for (int i = 0; i < npasses; i++) {
        if (!fits<F>(radix[i], cols_log[i]) || radix[i] > dft_log)
            return (int)cudaErrorInvalidValue;
        total += radix[i];
    }
    if (ns_log < 0 || total > log_n || log_n > 32 || dft_log > log_n || rows < 0
        || (npasses > 1 && buf == nullptr))
        return (int)cudaErrorInvalidValue;
    const int32_t* src = x;
    for (int i = 0; i < npasses && rows > 0; i++) {
        const int s = radix[i], lc = cols_log[i];
        const long cols = rows << (log_n - s);
        const long blocks = (cols + (1L << lc) - 1) >> lc;
        const long smem = (long)sizeof(typename F::T) * lw_sntt_smem_values(s, lc);
        int32_t* dst = (npasses - 1 - i) % 2 == 0 ? out : buf;
        LwSmallNttPass P = {src, dst, t_lo, t_hi, dft, rows, log_n, ns_log, s, lc, dft_log};
        const int err = launch<F>(P, blocks, lw_sntt_threads(s, lc), smem, stream);
        if (err) return err;
        src = dst;
        ns_log += s;
    }
    return (int)cudaGetLastError();
}

// The passes of radix 2^radix[0], 2^radix[1], ... after radices multiplying
// to 2^ns_log, one launch each, pass i on 2^cols_log[i] columns a block,
// over (L, rows, 2^log_n) limb planes of `field`: x into out, through buf
// when there are two passes or more (x, out and buf distinct).  t_lo, t_hi:
// the root tables, entry-major; dft: the 2^dft_log DFT roots.
extern "C" int lw_small_ntt_passes(int field, const int32_t* x, int32_t* out, int32_t* buf,
                                   const int32_t* t_lo, const int32_t* t_hi,
                                   const int32_t* dft, long rows, int log_n, int ns_log,
                                   int dft_log, const int* radix, const int* cols_log,
                                   int npasses, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (field) {
        case SNTT_GOLDILOCKS:
            return run<LwGoldilocks>(x, out, buf, t_lo, t_hi, dft, rows, log_n, ns_log, dft_log,
                                     radix, cols_log, npasses, s);
        case SNTT_BABYBEAR:
            return run<LwBabyBear>(x, out, buf, t_lo, t_hi, dft, rows, log_n, ns_log, dft_log,
                                   radix, cols_log, npasses, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <class F, int S>
static int info_s(int log_c, int* info) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, small_ntt_pass_kernel<F, S>);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(small_ntt_pass_kernel<F, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LW_SNTT_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int threads = lw_sntt_threads(S, log_c);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, small_ntt_pass_kernel<F, S>, threads,
        sizeof(typename F::T) * lw_sntt_smem_values(S, log_c));
    info[0] = threads;
    info[1] = blocks;
    info[2] = attr.numRegs;
    info[3] = (int)attr.localSizeBytes;
    return (int)err;
}

template <class F>
static int info_of(int s, int log_c, int* info) {
    if (!fits<F>(s, log_c)) return (int)cudaErrorInvalidValue;
    switch (s) {
        case 1: return info_s<F, 1>(log_c, info);
        case 2: return info_s<F, 2>(log_c, info);
        case 3: return info_s<F, 3>(log_c, info);
        case 4: return info_s<F, 4>(log_c, info);
        case 5: return info_s<F, 5>(log_c, info);
        case 6: return info_s<F, 6>(log_c, info);
        case 7: return info_s<F, 7>(log_c, info);
        default: return info_s<F, 8>(log_c, info);
    }
}

// A pass of radix 2^s on 2^log_c columns a block: info = {threads a block,
// blocks an SM can hold (the occupancy calculator), registers a thread,
// local (spilled) bytes a thread}
extern "C" int lw_small_ntt_info(int field, int s, int log_c, int* info) {
    if (field == SNTT_GOLDILOCKS) return info_of<LwGoldilocks>(s, log_c, info);
    if (field == SNTT_BABYBEAR) return info_of<LwBabyBear>(s, log_c, info);
    return (int)cudaErrorInvalidValue;
}
