// Kernel K10: the FBGMM's sequential Gibbs sweep for the fixed-variance
// and diagonal (normal-inverse-chi-squared) families, one launch a sweep.
// Instantiated with the column models of the chain template's policies:
// FixedVarChain<.., kSq> (fixedvar_chain.cu) and DiagExactChain
// (diag_chain.cu).
//
// Replaces the JAX package's sequential sweep
// (segmentalist_tpu/models/fbgmm.py:517-570, a lax.scan with no
// pallas_call; with the delete off, reassign_items at :351-381).  For each
// item i in order, against the statistics the items before it left:
//   1. (delete) x_i leaves its old column k_old[i] (if >= 0);
//   2. every column is scored: lms log(alpha/K + cnt) plus, for an occupied
//      column, log p(x_i | column) (the policy's fit), or the item's prior
//      log density for an empty one;
//   3. the annealed Gumbel-max, ties to the lowest index, a draw on an
//      empty column moved to the first empty one (or K - 1);
//   4. x_i joins the drawn column.
// A column's running sums move by the item (sum + x, sum - x: the JAX
// package's sum + (-1) x) and its tables and terms are re-derived from them
// by the policy's exact operations.  The plain version is
// ops/cuda_item_chain.py::item_chain_plain.
//
// Design.  A chain runs on one thread-block cluster of C CTAs (1 to 16,
// launched by cudaLaunchKernelEx; C from the wrapper's pure-Python plan
// under the card's limits), CTA r the owner of the columns [r K / C,
// (r + 1) K / C): their counts, weight terms, tables, hoisted terms and
// running sums live in its shared memory, so an update makes no round trip
// to device memory (the flagship, K 1000 and D 13, at C 8: 125 columns,
// 30 KB a CTA; D 130 at C 16: 63 columns, 137 KB fixed, 172 KB diag).
// Where no cluster holds them, the tables, terms and sums stay in device
// memory (the global form; the counts, weights and noise stay on chip).  A
// CTA has up to eight scoring warps and two update warps; a scoring thread
// takes a column, except that above D 32 the exact diag policy's fit (a
// division and a log1p a dim) is split over a group of up to four threads
// whose first sums the addends (split_of).  Loop iteration i applies the
// previous draw and item i's delete, then scores item i:
//   - update warp 0 of the owner of k_new[i - 1] adds x_(i-1) to it; update
//     warp 1 of the owner of k_old[i] removes x_i from that one (warp 0
//     both, in that order, where the columns coincide): a lane a dim moves
//     the sums and re-derives the tables and logs, then lanes 0 and 1 sum
//     the logs and the touched column's fit addends for x_i, each in
//     ascending d (the plain version's order), and the column's score
//     joins the warp's entry;
//   - meanwhile the scoring warps score item i against every other column,
//     whose tables no update of the step touches;
//   - every warp reduces its (score_key, 2 k + occupied, first empty) entry
//     with redux.sync and writes it into a slot of every CTA of the cluster
//     (distributed shared memory, double-buffered by parity); one cluster
//     barrier; every warp merges the C W entries into the same k_new
//     (cluster.cuh: a total order, so the draw does not depend on C).
// Item i + 1's row and noise come in by cp.async during step i, waited for
// before its barrier.  One barrier a step, and no CTA barrier.
//
// Every operation runs in the plain version's order, built with
// -fmad=false, so kernel and plain version sample the same ks and end on
// the same bits; the divisions give IEEE's bits through div_fast inside
// its range (common.cuh).
//
// Bound: a step scores every occupied column (4 D + 8 flops; the exact diag
// form D divisions and D log1p more) and re-derives two: a latency chain of
// n dependent steps, far above the bytes (the noise rows) or the flops
// over the card's peaks.  What a step costs (utils/item_probe.py
// --breakdown on an H100, cycles of an updating warp's step): at the
// flagship, the update and its serial sums ~1,400, the cluster barrier
// ~1,000, the merge of the C W entries ~500, the reduce and publish ~300;
// at D 130 the update (5 dims a lane, then 2 x 130 dependent adds)
// ~3,800, and the exact diag policy's split scores ~7,400.  The probe
// build (kProbe) sums clock64()
// cycles of a step's phases (Phase) for lane 0 of every warp, apart on the
// steps in which the warp updated a column and on the others
// (utils/item_probe.py --kernel K10 --breakdown).
#pragma once

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"
#include "diag_family_chain.cuh"

namespace item_chain {

namespace cg = cooperative_groups;
using diag_family_chain::Cols;
using diag_family_chain::cp_async4;
using diag_family_chain::cp_async_commit;
using diag_family_chain::cp_async_wait_all;
using diag_family_chain::score_key;
using diag_family_chain::warp_reduce;

constexpr int kScoreWarps = 8;  // a CTA's scoring warps, at most
constexpr int kMaxThreads = 32 * (kScoreWarps + 2);
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSplitD = 32;  // above this D a column's fit may be split

// A CTA's columns: the largest share.
__host__ __device__ inline int cols_max(int K, int C) {
    return (K + C - 1) / C;
}

// The scoring threads a column: 1 up to D kSplitD, else the most (up to
// the policy's kSplit, a power of two) that keep a thread for every
// column's share within the kScoreWarps scoring warps.  Only the exact
// diag policy splits (its addends are a division and a log1p a dim; the
// fixed policy's are three products, cheaper than the group's sum).
template <class P>
__host__ __device__ inline int split_of(int D, int K, int C) {
    int s = D > kSplitD ? P::kSplit : 1;
    while (s > 1 && s * cols_max(K, C) > 32 * kScoreWarps) s >>= 1;
    return s;
}

// A scoring warp for every 32 scoring threads the share asks (at most
// kScoreWarps) and the two update warps.
template <class P>
__host__ __device__ inline int threads_of(int D, int K, int C) {
    const int w = (cols_max(K, C) * split_of<P>(D, K, C) + 31) / 32;
    return 32 * ((w < kScoreWarps ? w : kScoreWarps) + 2);
}

template <class P>
struct Args {
    const float *X;          // [n, D] the items in chain order
    const float *log_prior;  // [n]
    const float *gumbel;     // [n, K]
    const int *k_old;        // [n] old column, -1 for none
    const int *counts;       // [K]
    typename P::Params pr;   // the statistics ([D, K] sums) and the prior
    float *tab_g;      // global form: tables [kTables, D, K], terms [kTerms, K]
    int *ks;           // [n]
    int *cnt_out;      // [K] final counts
    float *sums_out;   // [kSums, D, K] final running sums (global form: the
                       // running sums throughout)
    long long *probe;  // probe build: [C, W, 2, kPhases + 1]
    int n, D, K;
    float alpha_over_K, lms, temp;
    int use_argmax;
};

// Dynamic shared memory of a CTA in 4-byte words, in the kernel's carving
// order: the entry slots [2][C W] (uint4); in the smem form the tables
// [kTables][D][P], the running sums [kSums][D][P] and the terms
// [kTerms][P]; counts, weight terms and two items' noise [4][P]; x and the
// log prior of three items [3][D + 1]; the prior vectors [kPrior][D]; each
// update warp's logs and fit addends [2][2][D]; where a column's fit is
// split over S threads, each scoring group's fit addends [(W - 2) 32 /
// S][D].  P = cols_max(K, C).
template <class P>
__host__ __device__ inline int64_t smem_words(int D, int K, int C,
                                              bool tab_g) {
    const int64_t Pc = cols_max(K, C);
    const int64_t W = threads_of<P>(D, K, C) / 32;
    const int S = split_of<P>(D, K, C);
    const int64_t cols =
        tab_g ? 0 : ((int64_t)(P::kTables + P::kSums) * D + P::kTerms) * Pc;
    return 8 * C * W + cols + 4 * Pc + 3LL * (D + 1) + (int64_t)P::kPrior * D
           + 4LL * D + (S > 1 ? (W - 2) * 32 / S * D : 0);
}

// The probe build's phases of a step: clock64() cycles summed over the
// steps, per warp two rows of kPhases + 1 words (the steps in which the
// warp updated a column, then the others; the last word counts the steps).
enum Phase : int {
    kScores,    // the scoring loop
    kUpdate,    // an update: the sums, tables, logs and terms
    kFit,       // the touched column's score
    kReduce,    // the warp reduce and the publish
    kWait,      // the next item's rows and the cluster barrier
    kMerge,     // the merge into k_new
    kPrefetch,  // the next item's prefetch, the step's bookkeeping
    kPhases
};

template <bool kOn>
struct Clock {
    long long t;
    __device__ static long long (&rows())[kMaxWarps][3][kPhases + 1] {
        __shared__ long long s[kMaxWarps][3][kPhases + 1];
        return s;
    }
    __device__ void start() {
        if constexpr (kOn) {
            if ((threadIdx.x & 31) == 0) {
                for (int r = 0; r < 3; ++r)
                    for (int p = 0; p <= kPhases; ++p)
                        rows()[threadIdx.x >> 5][r][p] = 0;
                t = clock64();
            }
        }
    }
    __device__ __forceinline__ void lap(int p) {
        if constexpr (kOn) {
            if ((threadIdx.x & 31) == 0) {
                const long long now = clock64();
                rows()[threadIdx.x >> 5][2][p] += now - t;
                t = now;
            }
        }
    }
    // the step's laps to the updating (own) or the other steps' sums
    __device__ __forceinline__ void end_step(bool own) {
        if constexpr (kOn) {
            if ((threadIdx.x & 31) == 0) {
                long long(&r)[3][kPhases + 1] = rows()[threadIdx.x >> 5];
                const int to = own ? 0 : 1;
                for (int p = 0; p < kPhases; ++p) {
                    r[to][p] += r[2][p];
                    r[2][p] = 0;
                }
                r[to][kPhases] += 1;
                t = clock64();
            }
        }
    }
    __device__ void write(long long *out) const {
        if constexpr (kOn) {
            const int w = threadIdx.x >> 5;
            if ((threadIdx.x & 31) == 0)
                for (int r = 0; r < 2; ++r)
                    for (int p = 0; p <= kPhases; ++p)
                        out[((int64_t)w * 2 + r) * (kPhases + 1) + p] =
                            rows()[w][r][p];
        }
    }
};

// The sum of src[0 .. D) in ascending d (one add after another, the plain
// version's order), the next eight loads in flight while eight are added.
__device__ __forceinline__ float serial_sum(const float *src, int D) {
    float s = 0.0f;
    int d = 0;
    if (D >= 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = src[j];
        for (d = 8; d + 8 <= D; d += 8) {
            float w[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) w[j] = src[d + j];
#pragma unroll
            for (int j = 0; j < 8; ++j) s = s + v[j];
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = w[j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) s = s + v[j];
    }
    for (; d < D; ++d) s = s + src[d];
    return s;
}

// kTabG: the tables, terms and running sums in device memory.
template <class P, bool kTabG, bool kProbe>
__global__ void __launch_bounds__(kMaxThreads, 1)
    items_kernel(const Args<P> a) {
    extern __shared__ __align__(16) float sh[];
    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    const int D = a.D, K = a.K, n = a.n;
    const int lo = (int)((int64_t)rank * K / C);
    const int hi = (int)((int64_t)(rank + 1) * K / C);
    const int Pc = cols_max(K, C);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, W = nt >> 5;
    const int nsc = nt - 64;        // the scoring threads
    const int S = split_of<P>(D, K, C);  // in groups of S a column
    const int uw = warp - (W - 2);  // update warp 0 (the add), 1 (the
                                    // delete); < 0: a scoring warp

    // Carve the dynamic shared memory (smem_words' order).  Column k is
    // at kx = ix(k) in the tables, terms and sums (k - lo on chip, k in
    // device memory), at k - lo in the counts, weights and noise.
    uint4 *slots = reinterpret_cast<uint4 *>(sh);  // [2][C W]
    float *p = sh + 8 * C * W;
    Cols c;
    c.D = D;
    float *sums;
    int64_t sld;  // running sum r, dim d of column k at (r D + d) sld + kx
    if constexpr (kTabG) {
        c.K = K;
        c.tab = a.tab_g;
        c.term = a.tab_g + (int64_t)P::kTables * D * K;
        sums = a.sums_out;
        sld = K;
    } else {
        c.K = Pc;
        c.tab = p;
        sums = c.tab + (int64_t)P::kTables * D * Pc;
        c.term = sums + (int64_t)P::kSums * D * Pc;
        p = c.term + (int64_t)P::kTerms * Pc;
        sld = Pc;
    }
    float *cnt = p;
    float *wt = cnt + Pc;
    float *nz = wt + Pc;        // [2][P]: item i's noise at i % 2
    float *xs = nz + 2 * Pc;    // [3][D + 1]: x and log prior, item i at i % 3
    float *prior = xs + 3 * (D + 1);
    float *work = prior + P::kPrior * D;  // [2][2][D]: an update warp's logs
                                          // and fit addends
    float *gft = work + 4 * D;  // [nsc / S][D]: a scoring group's addends
    c.cnt = cnt;
    c.wt = wt;
    c.tslot = nullptr;
    c.prange = nullptr;
    auto ix = [&](int k) { return kTabG ? k : k - lo; };

    // Item i's row and (unless argmax) noise, by cp.async (the scoring
    // threads; nothing past the last item).
    auto prefetch = [&](int i) {
        if (i < n && tid < nsc) {
            float *xd = xs + (i % 3) * (D + 1);
            for (int d = tid; d <= D; d += nsc)
                cp_async4(xd + d, d < D ? a.X + (int64_t)i * D + d
                                        : a.log_prior + i);
            if (!a.use_argmax) {
                float *gd = nz + (i & 1) * Pc;
                const float *gs = a.gumbel + (int64_t)i * K;
                for (int k = lo + tid; k < hi; k += nsc)
                    cp_async4(gd + (k - lo), gs + k);
            }
        }
        cp_async_commit();
    };

    // Every owned column from the statistics: its running sums, tables,
    // terms, count and weight term.
    P::load_prior(a.pr, prior, D, tid, nt);
    prefetch(0);
    __syncthreads();
    for (int k = lo + tid; k < hi; k += nt) {
        const int kx = ix(k);
        const float cn = (float)a.counts[k];
        for (int r = 0; r < P::kSums; ++r) {
            const float *src = P::sums(a.pr, r) + k;
            float *dst = sums + (int64_t)r * D * sld + kx;
            for (int d = 0; d < D; ++d)
                dst[(int64_t)d * sld] = src[(int64_t)d * K];
        }
        P::init_sums(a.pr, prior, c, kx, cn, sums + kx, sld,
                     (int64_t)D * sld);
        cnt[k - lo] = cn;
        wt[k - lo] = a.lms * logf(a.alpha_over_K + cn);
    }
    cp_async_wait_all();
    __syncthreads();
    cluster::sync();  // every CTA runs before any remote store

    Clock<kProbe> clk;
    clk.start();
    int ka = -1;                        // the previous draw, not yet added
    int kd = n > 0 ? a.k_old[0] : -1;  // the column item it leaves
    for (int it = 0; it <= n; ++it) {
        const bool more = it < n;  // item it to score
        const float *x = xs + (it % 3) * (D + 1);        // item it
        const float *xp = xs + ((it + 2) % 3) * (D + 1);  // item it - 1
        const float *nzc = nz + (it & 1) * Pc;  // item it's noise
        const float lp = x[D];
        // the column the next item leaves, read while the step runs
        const int kd_next = it + 1 < n ? a.k_old[it + 1] : -1;
        prefetch(it + 1);  // into item it - 2's slots
        clk.lap(kPrefetch);
        float best_v = NEG_INF;
        int best_i = INT_MAX;  // 2 k + (cnt[k] > 0)
        int first_empty = K;
        // column k's score (count cn, fit f, weight term w) into the
        // thread's best
        auto take = [&](int k, float cn, float f, float w) {
            if (cn <= 0.0f) first_empty = min(first_empty, k);
            const float logit = w + f;
            const float v = a.use_argmax
                                ? logit
                                : (logit == NEG_INF ? NEG_INF
                                                    : div_rn(logit, a.temp)
                                                          + nzc[k - lo]);
            argmax_merge(best_v, best_i, v, 2 * k + (cn > 0.0f));
        };

        bool own = false;
        if (uw >= 0) {
            // an update warp: warp 0 adds x_(it-1) to ka (and removes x_it
            // where kd is ka), warp 1 removes x_it from kd
            const int k = uw == 0 ? ka : (kd != ka ? kd : -1);
            own = k >= lo && k < hi;
            if (own) {
                const float *xa = uw == 0 ? xp : nullptr;
                const float *xd = uw == 1 || kd == ka ? x : nullptr;
                const int kl = k - lo, kx = ix(k);
                const float cn =
                    cnt[kl] + (xa ? 1.0f : 0.0f) - (xd ? 1.0f : 0.0f);
                const typename P::Upd u = P::begin(a.pr, D, cn);
                const float w = a.lms * logf(a.alpha_over_K + cn);
                // a lane a dim: the sums move, the tables are re-derived,
                // and the dim's log and fit addend for x_it (from the new
                // tables, the lane's own writes) are kept; then lanes 0 and
                // 1 sum them in ascending d, and lane 0 takes both
                auto dim = [&](int d, float &lg, float &ad) {
                    float v[P::kSums];
#pragma unroll
                    for (int r = 0; r < P::kSums; ++r)
                        v[r] = sums[((int64_t)r * D + d) * sld + kx];
                    if (xa) P::template move_sums<false>(v, xa[d]);
                    if (xd) P::template move_sums<true>(v, xd[d]);
#pragma unroll
                    for (int r = 0; r < P::kSums; ++r)
                        sums[((int64_t)r * D + d) * sld + kx] = v[r];
                    lg = P::derive_dim(prior, c, u, kx, d, v);
                    ad = more ? P::fit_dim(prior, c, x, kx, d, cn) : 0.0f;
                };
                float *vlog = work + uw * 2 * D, *ft = vlog + D;
                for (int d = lane; d < D; d += 32) dim(d, vlog[d], ft[d]);
                __syncwarp();  // the logs and fit addends are written
                const float s = lane < 2 ? serial_sum(lane ? ft : vlog, D)
                                         : 0.0f;
                const float s_log = s, s_fit = __shfl_sync(0xffffffffu, s, 1);
                clk.lap(kUpdate);
                if (lane == 0) {
                    P::set_terms(a.pr, c, u, kx, s_log);
                    cnt[kl] = cn;
                    wt[kl] = w;
                    if (more)
                        take(k, cn, cn > 0.0f ? P::fit_sum(c, kx, s_fit) : lp,
                             w);
                }
                clk.lap(kFit);
            }
        } else if (more && S == 1) {
            for (int k = lo + tid; k < hi; k += nsc) {
                if (k == ka || k == kd) continue;
                const float cn = cnt[k - lo];
                take(k, cn,
                     cn > 0.0f ? P::fit(a.pr, prior, c, x, ix(k), cn) : lp,
                     wt[k - lo]);
            }
            clk.lap(kScores);
        } else if (more) {
            // a group of S lanes a column: the group splits the fit's
            // addends over its lanes, its first lane sums them in
            // ascending d (the same bits as P::fit)
            const int ng = nsc / S, g = tid / S, gl = tid % S;
            float *ft = gft + (int64_t)g * D;
            for (int k0 = lo; k0 < hi; k0 += ng) {  // a trip count the
                                                    // warp shares
                const int k = k0 + g;
                const bool mine = k < hi && k != ka && k != kd;
                const float cn = mine ? cnt[k - lo] : 0.0f;
                if (cn > 0.0f) {
#pragma unroll 4
                    for (int d = gl; d < D; d += S)
                        ft[d] = P::fit_dim(prior, c, x, ix(k), d, cn);
                }
                __syncwarp();
                if (mine && gl == 0)
                    take(k, cn,
                         cn > 0.0f ? P::fit_sum(c, ix(k), serial_sum(ft, D))
                                   : lp,
                         wt[k - lo]);
                __syncwarp();  // the group's addends are free again
            }
            clk.lap(kScores);
        }
        if (!more) break;

        // the warp's entry, to a slot of every CTA; one cluster barrier
        const int par = it & 1;
        uint4 *sl = slots + par * C * W;
        unsigned key = score_key(best_v);
        warp_reduce(key, best_i, first_empty);
        cluster::publish(cl, sl + rank * W + warp,
                         cluster::entry(key, best_i, first_empty), C, lane);
        clk.lap(kReduce);
        cp_async_wait_all();  // item it + 1's rows are in
        cluster::sync();
        clk.lap(kWait);
        cluster::merge_slots(sl, C * W, K, key, best_i, first_empty);
        ka = cluster::draw(best_i, first_empty, K);
        if (rank == 0 && tid == 0) a.ks[it] = ka;
        kd = kd_next;
        clk.lap(kMerge);
        clk.end_step(own);
    }

    // every owned column's final count and (smem form) running sums
    __syncthreads();
    for (int k = lo + tid; k < hi; k += nt) {
        a.cnt_out[k] = (int)cnt[k - lo];
        if constexpr (!kTabG) {
            for (int r = 0; r < P::kSums; ++r)
                for (int d = 0; d < D; ++d)
                    a.sums_out[((int64_t)r * D + d) * K + k] =
                        sums[((int64_t)r * D + d) * sld + k - lo];
        }
    }
    if constexpr (kProbe)
        clk.write(a.probe + (int64_t)rank * W * 2 * (kPhases + 1));
}

// Launches the chain on a cluster of C CTAs of `threads` (threads_of),
// the probe build where a.probe is set.
template <class P, bool kTabG>
cudaError_t launch(const Args<P> &a, int C, int threads,
                   cudaStream_t stream) {
    const bool pow2 = C > 0 && (C & (C - 1)) == 0;
    if (!pow2 || C > cluster::kMaxCluster || C > a.K || a.D < 1
        || threads != threads_of<P>(a.D, a.K, C))
        return cudaErrorInvalidValue;
    if (a.n == 0) return cudaGetLastError();
    const int smem = (int)(4 * smem_words<P>(a.D, a.K, C, kTabG));
    return a.probe ? cluster::launch(items_kernel<P, kTabG, true>, a, C,
                                     threads, smem, stream)
                   : cluster::launch(items_kernel<P, kTabG, false>, a, C,
                                     threads, smem, stream);
}

// The dynamic shared memory a CTA may take on the current device (the
// opt-in limit less the forms' static shared memory), and the largest
// cluster the card schedules at the block size's bound and that much (or
// minus a CUDA error code).
template <class PS, class PG>
int smem_limit() {
    return diag_family_chain::smem_limit(
        {(const void *)items_kernel<PS, false, false>,
         (const void *)items_kernel<PG, true, false>});
}

template <class PS, class PG>
int max_cluster() {
    const int limit = smem_limit<PS, PG>();
    if (limit < 0) return limit;
    const cluster::Inst inst[2] = {
        {(const void *)items_kernel<PS, false, false>, kMaxThreads},
        {(const void *)items_kernel<PG, true, false>, kMaxThreads}};
    return cluster::max_cluster(inst, 2, limit);
}

}  // namespace item_chain
