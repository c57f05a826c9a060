// Pippenger's bucket phase on curve.cuh's group law, one chunk of work a
// thread: what msm_bucket.cu (kernel 11) runs on the card, block by block,
// and what the host tests (tests/test_torch_curve_kernels.py) build with g++
// and run chunk by chunk.  curves/msm.py holds the plain version, the same
// chunk sequence in PyTorch, and drives the levels of both.
//
// Accumulate (bucket j of window w = the sum of the points whose window-w
// id is j).  The ids of a window are sorted (stably) and walked in chunks
// of T consecutive positions, one thread a chunk, so a thread does at most
// T additions whatever the skew of the ids.  The points are read through
// the sort's permutation: no sorted copy is made.  Id 0 is skipped.  A run
// of equal ids that closes inside the chunk and is not its first is
// complete: it goes straight to the bucket table.  The chunk's first run
// and its last (open) run may continue in the neighbouring chunks: they go
// to two boundary slots, (id, partial sum), id 0 for an empty slot.  The
// slots of a window are again sorted by id (zeros aside), so the same
// function over them, with full additions, merges the partials; each level
// shrinks the sequence T/2-fold, and at the level where one chunk holds a
// window's whole sequence every run is complete.
//
// Reduce (sum_j j B_j of each window).  With A_i = B_(i+1) (A padded with
// the neutral point), sum_j j B_j = sum_t S_t, S_t = sum_(i >= t) A_i.
// Chunk k of m entries, [k m, (k + 1) m), walks down with a running sum
// R_k and the sum of the running sums L_k (2 additions an entry); then
// sum_t S_t = sum_k L_k + m sum_k G_k with G_k = sum_(k' > k) R_k', and
// sum_k G_k = sum_k k R_k is the same problem over the chunk totals: the
// next level, with R in the place of B.  The sums of the L's ride along:
// level l carries C_k = (the sum of the previous level's C's in its
// range) + m^l L_k, m^l L_k by l log2 m doublings; at the level of one
// chunk its C is the window's sum.
//
// Every addition is curve.cuh's complete one, in a fixed order of
// operands, so a chunk's results are bitwise the plain version's.
#pragma once

#include <stdint.h>

#include "curve.cuh"

// One accumulate level.  As C arguments, 22 longs: W (windows), S (ids a
// window), T (the chunk), N (buckets a window), the (W, S) int64 ids, the
// (W, S) int64 permutation or 0 (then entry w S + s is element w S + s of
// the points), the points' LwPoints (9 longs), the table's three (ROWS, W
// N) planes, and the next level's (W, 2 K) int64 slot ids and three (ROWS,
// W 2 K) point planes (0 at the last level, K = 1), K = ceil(S / T).
struct LwBucketAcc {
    long W, S, T, N, K;
    const int64_t* ids;
    const int64_t* order;
    LwPoints in;
    int32_t* table[3];
    int64_t* slot_ids;
    int32_t* slots[3];
};

LW_HD LwBucketAcc lw_bucket_acc_arg(const long* d) {
    LwBucketAcc a;
    a.W = d[0];
    a.S = d[1];
    a.T = d[2];
    a.N = d[3];
    a.K = (a.S + a.T - 1) / a.T;
    a.ids = (const int64_t*)(uintptr_t)d[4];
    a.order = (const int64_t*)(uintptr_t)d[5];
    a.in = lw_points_arg(d + 6);
    for (int c = 0; c < 3; c++) {
        a.table[c] = (int32_t*)(uintptr_t)d[15 + c];
        a.slots[c] = (int32_t*)(uintptr_t)d[19 + c];
    }
    a.slot_ids = (int64_t*)(uintptr_t)d[18];
    return a;
}

template <class G>
LW_HD void lw_bucket_slot(const LwBucketAcc& a, long w, long slot, int64_t id,
                          const typename G::P& pt) {
    const long e = w * 2 * a.K + slot;
    a.slot_ids[e] = id;
    lw_store_point<G>(a.slots, a.W * 2 * a.K, e, pt);
}

// chunk k of window w: positions [k T, min((k + 1) T, S))
template <class G, bool MIXED>
LW_HD void lw_bucket_accumulate_chunk(const LwBucketAcc& a, long w, long k) {
    typedef typename G::P P;
    const bool last_level = a.K == 1;
    const long lo = k * a.T, hi = lo + a.T < a.S ? lo + a.T : a.S;
    const long table_n = a.W * a.N;
    P acc, q;
    int64_t acc_id = 0;
    bool have = false, first_open = true;  // the open run is the chunk's first
    for (long pos = lo; pos < hi; pos++) {
        const int64_t id = a.ids[w * a.S + pos];
        if (id == 0) continue;
        const long e = a.order ? (long)a.order[w * a.S + pos] : w * a.S + pos;
        lw_load_point<G>(a.in, e, q);
        if (have && id == acc_id) {
            if (MIXED) G::add_mixed(acc, q, acc);
            else G::add(acc, q, acc);
            continue;
        }
        if (have) {  // the open run closes
            if (first_open && !last_level) lw_bucket_slot<G>(a, w, 2 * k, acc_id, acc);
            else lw_store_point<G>(a.table, table_n, w * a.N + acc_id, acc);
            first_open = false;
        }
        acc = q;
        acc_id = id;
        have = true;
    }
    if (last_level) {
        if (have) lw_store_point<G>(a.table, table_n, w * a.N + acc_id, acc);
        return;
    }
    P none;
    G::neutral(none);
    if (!have) {
        lw_bucket_slot<G>(a, w, 2 * k, 0, none);
        lw_bucket_slot<G>(a, w, 2 * k + 1, 0, none);
    } else if (first_open) {  // one run: the first slot holds it
        lw_bucket_slot<G>(a, w, 2 * k, acc_id, acc);
        lw_bucket_slot<G>(a, w, 2 * k + 1, 0, none);
    } else {
        lw_bucket_slot<G>(a, w, 2 * k + 1, acc_id, acc);
    }
}

// One reduce level.  As C arguments, 28 longs: W, N (entries a window), m
// (the chunk), dbl (the doublings of L: l log2 m at level l), the entries'
// LwPoints (entry j of window w is element w N + j), the carried C's
// LwPoints (9 longs; a null first pointer at level 0), and the three
// (ROWS, W K) planes of R and of C, K = ceil(N / m).
struct LwBucketReduce {
    long W, N, m, K;
    int dbl;
    LwPoints bk, carry;
    int32_t* r_out[3];
    int32_t* c_out[3];
};

LW_HD LwBucketReduce lw_bucket_reduce_arg(const long* d) {
    LwBucketReduce a;
    a.W = d[0];
    a.N = d[1];
    a.m = d[2];
    a.dbl = (int)d[3];
    a.K = (a.N + a.m - 1) / a.m;
    a.bk = lw_points_arg(d + 4);
    a.carry = lw_points_arg(d + 13);
    for (int c = 0; c < 3; c++) {
        a.r_out[c] = (int32_t*)(uintptr_t)d[22 + c];
        a.c_out[c] = (int32_t*)(uintptr_t)d[25 + c];
    }
    return a;
}

// chunk k of window w: A_i for i in [k m, min((k + 1) m, N - 1)), walked
// down; the carried C's of [k m, min((k + 1) m, N))
template <class G>
LW_HD void lw_bucket_reduce_chunk(const LwBucketReduce& a, long w, long k) {
    typedef typename G::P P;
    P run, acc, t;
    G::neutral(run);
    G::neutral(acc);
    const long lo = k * a.m;
    const long hi = lo + a.m < a.N - 1 ? lo + a.m : a.N - 1;
    for (long i = hi - 1; i >= lo; i--) {
        lw_load_point<G>(a.bk, w * a.N + i + 1, t);
        G::add(run, t, run);
        G::add(acc, run, acc);
    }
    if (a.carry.p[0]) {
        P d;
        G::neutral(d);
        const long khi = lo + a.m < a.N ? lo + a.m : a.N;
        for (long kk = lo; kk < khi; kk++) {
            lw_load_point<G>(a.carry, w * a.N + kk, t);
            G::add(d, t, d);
        }
        for (int j = 0; j < a.dbl; j++) G::dbl(acc, acc);
        G::add(d, acc, acc);
    }
    const long n = a.W * a.K;
    lw_store_point<G>(a.r_out, n, w * a.K + k, run);
    lw_store_point<G>(a.c_out, n, w * a.K + k, acc);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Kernel 11 (msm_bucket.cu): one thread a chunk, a level a launch
template <class G, bool MIXED>
__global__ void msm_bucket_accumulate_kernel(LwBucketAcc a) {
    const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= a.W * a.K) return;
    lw_bucket_accumulate_chunk<G, MIXED>(a, t / a.K, t % a.K);
}

template <class G>
__global__ void msm_bucket_reduce_kernel(LwBucketReduce a) {
    const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= a.W * a.K) return;
    lw_bucket_reduce_chunk<G>(a, t / a.K, t % a.K);
}

static const int kBucketThreads = 64;

template <class G>
int lw_bucket_accumulate_run(const LwBucketAcc& a, bool mixed, cudaStream_t s) {
    const long blocks = (a.W * a.K + kBucketThreads - 1) / kBucketThreads;
    if (mixed) msm_bucket_accumulate_kernel<G, true><<<blocks, kBucketThreads, 0, s>>>(a);
    else msm_bucket_accumulate_kernel<G, false><<<blocks, kBucketThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
}

template <class G>
int lw_bucket_reduce_run(const LwBucketReduce& a, cudaStream_t s) {
    const long blocks = (a.W * a.K + kBucketThreads - 1) / kBucketThreads;
    msm_bucket_reduce_kernel<G><<<blocks, kBucketThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
}

// kernel 11's G2 instances, built in translation units of their own
// beside the G1 instances (msm_bucket.cu): BN254 G2 in msm_bucket_g2.cu,
// BLS12-377 G2, the longest to build, in msm_bucket_bls12_377_g2.cu
int lw_bucket_accumulate_g2(int group, const LwBucketAcc& a, bool mixed, cudaStream_t s);
int lw_bucket_reduce_g2(int group, const LwBucketReduce& a, cudaStream_t s);
int lw_bucket_accumulate_bls12_377_g2(const LwBucketAcc& a, bool mixed, cudaStream_t s);
int lw_bucket_reduce_bls12_377_g2(const LwBucketReduce& a, cudaStream_t s);
#endif
