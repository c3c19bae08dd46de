// The within-utterance assignment chain shared by the diagonal-family
// mixtures: kernels K3 / K4 (fixedvar_chain.cu, fixed variance) and K6 /
// K7 (diag_chain.cu, normal-inverse-chi-squared), each a policy of one
// kernel template.
//
// For each utterance b, its valid segments are assigned in order, each
// conditioning on the statistics updated by the previous ones:
//
//   logit[k] = w[k] + (cnt[k] > 0 ? P::fit(x, k) : log_prior_e[b, s])
//   k_draw   = argmax_k(logit[k] / temp + gumbel[b, s, k])  (or argmax_k logit)
//   k_new    = cnt[k_draw] > 0 ? k_draw : first empty column, else K - 1
//
// with the mixture-weight term
//
//   K3 / K6: w[k] = lms log(alpha/K + cnt[k])
//   K4 / K7: w[k] = the bigram-LM weight of bigram_lm.cuh, conditioned on
//            the previous valid segment's draw
//
// and ties to the LOWEST index.  Column k_new then takes x: its running
// sums, tables and hoisted terms are re-derived from the new statistics by
// an exact select, never an add-of-difference.  The policy P is the column
// model:
//
//   P::kTables  [D][K] tables (K3: mu and pp, or mu alone; K6: mu, den)
//   P::kTerms   hoisted per-column terms (K3: c0 + lpp/2; K6: a, hv)
//   P::kPrior   prior vectors [D] staged in shared memory
//   P::kSums    running sums [D] of a column (K3: sx; K6: sx, ssq)
//   P::init     a column's tables and terms from its leave-out sums
//   P::fit      log p(x | column) of an occupied column
//   P::begin, P::update_dim, P::finish
//               the update of column k_new: its count-only terms, one dim's
//               sums, tables and log (a lane a dim), then its terms from the
//               logs summed in ascending d (the owner lane)
//
// Every operation follows the plain versions' order and the library is
// built with -fmad=false, so kernel and plain version sample the same ks.
//
// What bounds it on the H100: the chain is sequential over segments, so
// the cost is n_b dependent steps, each a K-wide score and an argmax
// across the utterance; the bytes the function must move are small (the
// noise rows).  Each step's latency is the cost, and the design keeps what
// a step touches on chip and the step to one barrier:
//
// - Column ownership.  One CTA of up to 1024 threads an utterance; thread
//   t owns columns t, t + T, ... for the whole chain: their tables as
//   [kTables][D][K] in dynamic shared memory (k fastest: conflict-free),
//   and cnt, the hoisted terms, the weight, the touched slot (bigram: the
//   old-pair range) and the noise in [K] arrays.  Only the owner (and, in
//   its update, the owner's warp) touches them, so they need no block
//   barrier.  Init reads the leave-out statistics directly.
// - Hoisting.  The policy's terms, the Dirichlet weight and the bigram
//   weight's unigram half are computed once a column at init and again only
//   when the column is updated: the same operations on the same values, so
//   the same bits.
// - One barrier a step.  Each warp reduces (score key, 2k + occupied) and
//   the first empty column by three redux.sync reductions (score_key keeps
//   argmax_merge's order); lane 0 writes them to arrays double-buffered by
//   step parity; after the barrier every warp merges all warps' entries
//   the same way (a total order, so every thread gets the same k_new).
//   The owner's warp then updates column k_new, a lane a dim, and the
//   owner lane sets its terms (__syncwarp between); the last step's draw
//   is not applied, since nothing reads it.  The step is bound by
//   instruction throughput: the owner warp's update runs while the other
//   warps score the next step, and its lag sets the barrier, so the
//   reductions and the fit are kept to few instructions.
// - Prefetch.  Step i + 2's x, log prior and noise row go out with
//   cp.async right after step i's barrier, before the update, into the
//   slots steps i - 1 and i are done with (x triple-, noise
//   double-buffered), and are waited for just before step i + 1's
//   barrier.
// - The update's running sums.  A column's sums come from the leave-out
//   statistics on first touch, else from the touched-column table [B, S,
//   kSums, D] in device memory (one slot a step).  The owner's warp starts
//   cp.async copies of all of k_new's dims right after the barrier, then
//   the prefetch, then waits for its copies only: one round trip an
//   update at any D.
// - IEEE bits without nvcc's `/`: the policies divide by div_fast inside
//   its range and `/` outside it (common.cuh), checking the range once a
//   batch of dims, not a branch a quotient.
// - The bigram weight: each column keeps the range of the utterance's pair
//   list (in shared memory) whose current id is that column, found once at
//   init; a step counts (j_prev, k) pairs inside that range only.
//
// The policies' column models also run the FBGMM's item chain, kernel K10
// (item_chain.cuh: a cluster of column owners, a kernel of its own).
//
// Where the tables do not fit one CTA (D 130, K 1000), the global form
// keeps them, and the column arrays, in device memory the wrapper
// allocates ([B, kTables, D, K], [B, col_arrays(true), K]) and reads the
// noise directly: every step re-reads the occupied columns' tables.  The
// launch plans (ops/cuda_chain.py, ops/cuda_diag_chain.py) pick the form
// from (D, K, S): the smem form where smem_words fit the card's opt-in
// shared memory less the kernel's static arrays, else the global form.
#pragma once

#include <climits>
#include <cstdint>
#include <initializer_list>

#include "bigram_lm.cuh"
#include "common.cuh"

namespace diag_family_chain {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

// The column arrays: cnt, P::kTerms hoisted terms, the weight term (K4 /
// K7: its unigram half), the touched slot and (bigram) the old-pair range.
template <class P>
__host__ __device__ constexpr int col_arrays(bool bigram) {
    return 3 + P::kTerms + (bigram ? 1 : 0);
}

// Dynamic shared memory of the CTA, in 4-byte words, in the kernel's
// carving order.  Smem form: the tables [kTables][D][K], the column arrays
// [col_arrays][K] and the noise double buffer [2][K].  Both forms: x and
// log prior [3][D + 1]; the prior vectors, the updated column's logs and
// its running sums [kPrior + 1 + kSums][D]; the valid steps [S]; bigram:
// the old pairs [2][S].
template <class P>
__host__ __device__ inline int64_t smem_words(bool global, bool bigram,
                                              int D, int S, int K) {
    const int64_t per_col =
        (int64_t)P::kTables * D + col_arrays<P>(bigram) + 2;
    return (global ? 0 : per_col * K) + 3LL * (D + 1)
           + (P::kPrior + 1LL + P::kSums) * D + S + (bigram ? 2LL * S : 0);
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits for all but the newest committed group.
__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// An order-preserving key of a score for the warps' argmax: a larger score
// gives a larger key, -0 ranks as +0 and a NaN below -inf, so the order is
// argmax_merge's (a NaN never wins).
__device__ __forceinline__ unsigned score_key(float v) {
    const unsigned u = __float_as_uint(v + 0.0f);
    return v != v ? 0u : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Warp-wide argmax of (key, index), the lowest index among equal keys, and
// the first-empty min, by three warp reductions; every lane ends with the
// result.
__device__ __forceinline__ void warp_reduce(unsigned &key, int &i, int &e) {
    const unsigned mine = key;
    key = __reduce_max_sync(0xffffffffu, mine);
    i = __reduce_min_sync(0xffffffffu, mine == key ? i : INT_MAX);
    e = __reduce_min_sync(0xffffffffu, e);
}

// One utterance's columns: table j, row d of column k at
// tab[(j D + d) K + k] (in the global form, rows of device memory); term j
// of column k at term[j K + k].
struct Cols {
    float *tab, *cnt, *term, *wt;
    int *tslot, *prange;
    int D, K;
    __device__ float *table(int j) const {
        return tab + (int64_t)j * D * K;
    }
};

template <class P>
struct Args {
    const int *embeds;         // [B, S]
    const float *Xe;           // [B, S, D]
    const float *log_prior_e;  // [B, S]
    const float *gumbel;       // [B, S, K]
    const int *counts;         // [B, K]
    typename P::Params pr;     // the leave-out sums and the prior
    float *touched;            // [B, S, kSums, D] running sums, a slot a step
    float *tab_g;              // global form: [B, kTables, D, K]
    float *col_g;              // global form: [B, col_arrays(true), K]
    int *ks;                   // [B, S]
    int S, D, K;
    float alpha_over_K, lms, temp;
    int use_argmax;
    BigramLM lm;
};

template <class P, bool kBigram, bool kGlob>
__global__ void __launch_bounds__(kMaxThreads, 1)
    chain_kernel(const Args<P> a) {
    extern __shared__ float sh[];
    __shared__ unsigned red_v[2][kMaxWarps];  // score_key of the warp's best
    __shared__ int red_i[2][kMaxWarps];
    __shared__ int red_e[2][kMaxWarps];
    __shared__ int s_part[kMaxWarps];
    __shared__ int s_n;

    const int D = a.D, S = a.S, K = a.K;
    const int T = blockDim.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
    const int b = blockIdx.x;
    const int64_t bS = (int64_t)b * S, bK = (int64_t)b * K;
    const int64_t bDK = bK * D;

    // Carve the dynamic shared memory (smem_words' order); the global
    // form's tables and column arrays are this utterance's device memory.
    float *p = sh;
    Cols c;
    c.D = D;
    c.K = K;
    if constexpr (kGlob) {
        c.tab = a.tab_g + bDK * P::kTables;
        c.cnt = a.col_g + bK * col_arrays<P>(true);
    } else {
        c.tab = p;
        c.cnt = p + (int64_t)P::kTables * D * K;
    }
    c.term = c.cnt + K;
    c.wt = c.term + (int64_t)P::kTerms * K;  // K4 / K7: the unigram half
    c.tslot = reinterpret_cast<int *>(c.wt + K);
    c.prange = c.tslot + K;  // bigram only
    float *gbuf = reinterpret_cast<float *>(c.prange + (kBigram ? K : 0));
    if constexpr (!kGlob) p = gbuf + 2 * K;
    float *xs = p;
    float *prior = xs + 3 * (D + 1);
    float *vlog = prior + P::kPrior * D;
    float *stage = vlog + D;  // the updated column's running sums
    int *steps = reinterpret_cast<int *>(stage + P::kSums * D);
    int *s_cj = steps + S;  // bigram only: the old pairs
    int *s_ci = s_cj + S;

    // Phase 1: the prior vectors, the old pairs and n_uni (bigram), ks =
    // -1, and the list of valid steps (ascending).
    const int *emb = a.embeds + bS;
    int *kout = a.ks + bS;
    P::load_prior(a.pr, prior, D, tid, T);
    for (int s = tid; s < S; s += T) kout[s] = -1;
    if constexpr (kBigram) {
        for (int s = tid; s < S; s += T) {
            s_cj[s] = a.lm.corr_j[bS + s];
            s_ci[s] = a.lm.corr_i[bS + s];
        }
        int part = 0;
        for (int k = tid; k < K; k += T) part += a.lm.uni[bK + k];
        for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) s_part[warp] = part;
    }
    if (warp == 0) {
        int n = 0;
        for (int s0 = 0; s0 < S; s0 += 32) {
            const int s = s0 + lane;
            const bool ok = s < S && emb[s] >= 0;
            const unsigned m = __ballot_sync(0xffffffffu, ok);
            if (ok) steps[n + __popc(m & ((1u << lane) - 1u))] = s;
            n += __popc(m);
        }
        if (lane == 0) s_n = n;
    }
    __syncthreads();
    const int n_steps = s_n;
    // The bigram unigram denominators n_uni + a and its log (n_uni an
    // integer sum, exact in any order).
    float uni_den = 0.0f, log_uni_den = 0.0f;
    if constexpr (kBigram) {
        int n_uni = 0;
        for (int w = 0; w < W; ++w) n_uni += s_part[w];
        uni_den = (float)n_uni + a.lm.a;
        log_uni_den = logf(uni_den);
    }

    // Step i's x, log prior (xs slot i % 3) and, in the smem form, noise
    // (gbuf slot i % 2), as one cp.async group (empty past the last step).
    auto prefetch = [&](int i) {
        if (i < n_steps) {
            const int64_t row = bS + steps[i];
            float *xd = xs + (i % 3) * (D + 1);
            for (int d = tid; d <= D; d += T)
                cp_async4(xd + d, d < D ? a.Xe + row * D + d
                                        : a.log_prior_e + row);
            if (!kGlob && !a.use_argmax) {
                float *gd = gbuf + (i & 1) * K;
                const float *gs = a.gumbel + row * K;
                for (int k = tid; k < K; k += T) cp_async4(gd + k, gs + k);
            }
        }
        cp_async_commit();
    };
    prefetch(0);
    prefetch(1);

    // Phase 2: every owned column from the leave-out statistics.
    for (int k = tid; k < K; k += T) {
        const float cn = (float)a.counts[bK + k];
        P::init(a.pr, prior, c, bDK, k, cn);
        c.cnt[k] = cn;
        c.tslot[k] = -1;
        if constexpr (kBigram) {
            c.wt[k] = bigram_uni_half(a.lm, (float)a.lm.uni[bK + k],
                                      uni_den, DivRn());
            int lo = S, hi = -1;  // the pairs whose current id is k
            for (int s = 0; s < S; ++s) {
                if (s_ci[s] == k) {
                    lo = min(lo, s);
                    hi = s;
                }
            }
            c.prange[k] = (int)((unsigned)lo | ((unsigned)hi << 16));
        } else {
            c.wt[k] = a.lms * logf(a.alpha_over_K + cn);
        }
    }
    cp_async_wait_all();
    __syncthreads();

    int j_prev = -1;  // the previous valid segment's draw (block-uniform)
    for (int it = 0; it < n_steps; ++it) {
        const int s = steps[it];
        const int par = it & 1;
        const float *x = xs + (it % 3) * (D + 1);
        const float lp = x[D];
        const float *g = kGlob ? a.gumbel + (bS + s) * K : gbuf + par * K;
        const int *brow = nullptr;
        float uni_jb = 0.0f;
        if (kBigram && j_prev >= 0) {
            brow = a.lm.big + (int64_t)j_prev * K;
            uni_jb = (float)a.lm.uni[bK + j_prev] + a.lm.b;
        }

        float best_v = NEG_INF;
        int best_i = INT_MAX;  // 2 k + (cnt[k] > 0)
        int first_empty = K;
        for (int k = tid; k < K; k += T) {
            const int bk = kBigram && j_prev >= 0 ? brow[k] : 0;
            const float gk = a.use_argmax ? 0.0f : g[k];
            const float cn = c.cnt[k];
            float fit;  // log p(x | k), or the prior for an empty column
            if (cn > 0.0f) {
                fit = P::fit(a.pr, prior, c, x, k, cn);
            } else {
                fit = lp;
                first_empty = min(first_empty, k);
            }
            float wk = c.wt[k];
            if constexpr (kBigram) {
                if (j_prev >= 0) {
                    const int pr = c.prange[k];
                    const int hi = pr >> 16;
                    int corr = 0;
                    for (int m = pr & 0xffff; m <= hi; ++m)
                        corr += s_ci[m] == k && s_cj[m] == j_prev;
                    wk = bigram_pair_weight(a.lm, wk, (float)(bk - corr),
                                            uni_jb, a.lms, DivRn());
                } else {
                    wk = bigram_first_weight(a.lm, (float)a.lm.uni[bK + k],
                                             log_uni_den, a.lms);
                }
            }
            const float logit = wk + fit;
            const float v = a.use_argmax ? logit
                            : (logit == NEG_INF ? NEG_INF
                                                : div_rn(logit, a.temp) + gk);
            argmax_merge(best_v, best_i, v, 2 * k + (cn > 0.0f));
        }
        unsigned best_key = score_key(best_v);
        warp_reduce(best_key, best_i, first_empty);
        if (lane == 0) {
            red_v[par][warp] = best_key;
            red_i[par][warp] = best_i;
            red_e[par][warp] = first_empty;
        }
        cp_async_wait_all();  // step it + 1's rows are in
        __syncthreads();

        // Every warp merges all warps' entries and gets the same k_new.
        best_key = 0u;
        best_i = INT_MAX;
        first_empty = K;
        if (lane < W) {
            best_key = red_v[par][lane];
            best_i = red_i[par][lane];
            first_empty = red_e[par][lane];
        }
        warp_reduce(best_key, best_i, first_empty);
        const int k_new = best_i == INT_MAX ? 0
                          : (best_i & 1) ? best_i >> 1
                          : (first_empty < K ? first_empty : K - 1);
        if (tid == 0) kout[s] = k_new;
        j_prev = k_new;
        if (it + 1 == n_steps) break;  // no step reads the last update

        const int own = k_new % T;  // the owner thread of k_new
        const bool owner_warp = own >> 5 == warp;
        if (owner_warp) {
            // Column k_new's running sums, all dims at once: from the
            // leave-out statistics on first touch, else from its touched
            // slot; lane l copies dims l, l + 32, ...
            const int ts = c.tslot[k_new];
            const int64_t stride = ts < 0 ? K : 1;
            for (int r = 0; r < P::kSums; ++r) {
                const float *src =
                    ts < 0 ? P::sums(a.pr, r) + bDK + k_new
                           : a.touched + ((bS + ts) * P::kSums + r) * D;
                for (int d = lane; d < D; d += 32)
                    cp_async4(stage + r * D + d, src + d * stride);
            }
            cp_async_commit();
        }
        prefetch(it + 2);  // into the slots steps it - 1 and it are done with
        if (owner_warp) {
            // The owner's warp re-derives column k_new with x added: lane l
            // takes dims l, l + 32, ...; the owner lane sets the column's
            // terms.
            cp_async_wait_prior();  // this thread's share of the sums
            const int k = k_new;
            const typename P::Upd u = P::begin(a.pr, D, c.cnt[k] + 1.0f);
            const float *src = stage;
            float *dst = a.touched + (bS + s) * P::kSums * D;
            for (int d = lane; d < D; d += 32) {
                float v[P::kSums];
#pragma unroll
                for (int r = 0; r < P::kSums; ++r) v[r] = src[r * D + d];
                P::update_dim(prior, c, u, k, d, x[d], v, vlog);
#pragma unroll
                for (int r = 0; r < P::kSums; ++r) dst[r * D + d] = v[r];
            }
            __syncwarp();  // the column and vlog are written
            if (lane == (own & 31)) {
                P::finish(a.pr, c, u, k, vlog);
                c.tslot[k] = s;
                c.cnt[k] = u.c_new;
                if constexpr (!kBigram)
                    c.wt[k] = a.lms * logf(a.alpha_over_K + u.c_new);
            }
        }
    }
}

// Launches one form with the dynamic shared memory smem_words gives (the
// kernel's limit is raised once a process, for the largest size asked).
template <class P, bool kBigram, bool kGlob>
cudaError_t launch_form(const Args<P> &a, int B, int threads,
                        cudaStream_t stream) {
    auto kern = chain_kernel<P, kBigram, kGlob>;
    const int smem = (int)(4 * smem_words<P>(kGlob, kBigram, a.D, a.S, a.K));
    static int allowed = -1;
    if (smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        allowed = smem;
    }
    kern<<<B, threads, smem, stream>>>(a);
    return cudaGetLastError();
}

// The launch's shapes as the kernels take them: a whole number of warps
// up to kMaxThreads, and S below 2^15 (the old-pair ranges pack two
// 16-bit step indices).
inline cudaError_t check_launch(int threads, int S) {
    return threads < 32 || threads > kMaxThreads || threads % 32 != 0
                   || S >= (1 << 15)
               ? cudaErrorInvalidValue
               : cudaSuccess;
}

// The dynamic shared memory a CTA of the given kernels may take on the
// current device: its opt-in limit a block less the kernels' largest
// static shared memory; minus a CUDA error code on error.
inline int smem_limit(std::initializer_list<const void *> kernels) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    size_t fixed = 0;
    for (const void *k : kernels) {
        cudaFuncAttributes at;
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, k);
        if (err == cudaSuccess && at.sharedSizeBytes > fixed)
            fixed = at.sharedSizeBytes;
    }
    return err == cudaSuccess ? optin - (int)fixed : -(int)err;
}

}  // namespace diag_family_chain
