// Within-utterance fixed-variance assignment chains: kernel K3 (Dirichlet
// mixture weights) and kernel K4 (bigram-LM mixture weights), the
// fixed-variance policy of the chain template diag_family_chain.cuh (which
// holds the chain, its structure and what bounds it; K6 / K7 are its
// normal-inverse-chi-squared policy).
//
// Replaces the Pallas kernels of segmentalist_tpu/ops/pallas_chain.py:
// K3 fixedvar_chain (:152, pallas_call :327) and K4 bigram_fixedvar_chain
// (:360, pallas_call :571).  Per column k the chain carries cnt, sx[d],
// mu[d], pp[d] and lpp = sum_d log pp[d] (positive pp only):
//
//   derive(c, sx): prec_n = prec0 + c prec
//                  mu = (p0m0 + prec sx) / prec_n
//                  pp = prec_n prec / (prec_n + prec)
//   fit = (c0 + 0.5 lpp) - 0.5 sum_d (x_d - mu[d])^2 pp[d]   (ascending d)
//
// with p0m0 = prec0 mu0 and c0 = -D log(2 pi) / 2 (pallas_chain.py:240-307).
// The policy's hoisted term is c0 + 0.5 lpp, so a step's fit is that less
// half the Mahalanobis sum.  pp[d] depends on d and the count alone, so a
// column's pp can be stored as a table or recomputed from cnt in registers
// with the same operations (the same bits): FixedVarChain<kStorePP>.  The
// smem form stores it (on an H100 at D 13 the shared loads beat D
// quotients a column a step); the global form recomputes it, which halves
// the bytes a step streams (at D 130, 33 against 56 us a step).  The
// divisions give IEEE `/`'s bits through div_fast inside its range and `/`
// outside it (common.cuh), checked once a batch of dims.
//
// The same policy with kSq (the sums sx and ssq, ssq carried for the
// model's statistics) runs the item chain K10 of the fixed-variance FBGMM
// (items_kernel, item_chain.cuh), the JAX package's
// sequential sweep (segmentalist_tpu/models/fbgmm.py:517-570, a lax.scan)
// with components_fixedvar's predictive: the same fit as K3 to the
// rounding of the operation order.

#include <cstdint>

#include "diag_family_chain.cuh"
#include "item_chain.cuh"

namespace {

using diag_family_chain::Args;
using diag_family_chain::Cols;

struct FixedVarParams {
    const float *sum_xT;  // [B, D, K]
    const float *sum_sqT;  // [B, D, K] (kSq only)
    const float *prec;    // [D] 1 / var
    const float *prec0;   // [D] 1 / var_0
    const float *p0m0;    // [D] prec0 mu_0
    float c0;             // -D log(2 pi) / 2
};

// Dims the fit and the init take at a time: one range check of the
// quotients and kBatch loads in flight a thread.
constexpr int kBatch = 8;

// The fixed-variance column model: tables mu (kStorePP: and pp); the term
// c0 + 0.5 lpp; prior vectors prec, prec0, p0m0; running sums sx (kSq:
// and ssq).
template <bool kStorePP, bool kSq = false>
struct FixedVarChain {
    static constexpr int kTables = kStorePP ? 2 : 1;
    static constexpr int kTerms = 1, kPrior = 3, kSums = kSq ? 2 : 1;
    static constexpr int kSplit = 1;  // K10: a thread a column's fit
    using Params = FixedVarParams;
    struct Upd {
        float c_new;
    };

    __device__ static const float *sums(const Params &p, int r) {
        return r ? p.sum_sqT : p.sum_xT;
    }

    __device__ static void load_prior(const Params &p, float *prior, int D,
                                      int tid, int T) {
        for (int d = tid; d < D; d += T) {
            prior[d] = p.prec[d];
            prior[D + d] = p.prec0[d];
            prior[2 * D + d] = p.p0m0[d];
        }
    }

    // pp's numerator prec_n prec and denominator prec_n + prec at dim d
    // for count cn; prec_n is returned too.
    __device__ static float pp_terms(const float *prior, int D, int d,
                                     float cn, float &num, float &den) {
        const float pr = prior[d], prec_n = prior[D + d] + cn * pr;
        num = prec_n * pr;
        den = prec_n + pr;
        return prec_n;
    }

    // Dims d .. d + kN - 1 of a column (count cn) from its running sums v:
    // mu and pp stored, log pp (positive only) added to lpp in ascending d.
    template <int kN>
    __device__ static void derive_batch(const float *prior, const Cols &c,
                                        int k, int d, float cn,
                                        const float (&v)[kN], float &lpp) {
        const int D = c.D;
        float nm[kN], dm[kN], np[kN], dp[kN], m[kN], pp[kN];
        bool ok = true;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
            dm[j] = pp_terms(prior, D, d + j, cn, np[j], dp[j]);
            nm[j] = prior[2 * D + d + j] + prior[d + j] * v[j];
            ok &= div_fast_ok(nm[j], dm[j]) && div_fast_ok(np[j], dp[j]);
        }
        if (ok) {
#pragma unroll
            for (int j = 0; j < kN; ++j) {
                m[j] = div_fast(nm[j], dm[j]);
                pp[j] = div_fast(np[j], dp[j]);
            }
        } else {
#pragma unroll
            for (int j = 0; j < kN; ++j) {
                m[j] = nm[j] / dm[j];
                pp[j] = np[j] / dp[j];
            }
        }
#pragma unroll
        for (int j = 0; j < kN; ++j) {
            const int64_t i = (int64_t)(d + j) * c.K + k;
            c.tab[i] = m[j];
            if constexpr (kStorePP) c.table(1)[i] = pp[j];
            lpp = lpp + (pp[j] > 0.0f ? logf(pp[j]) : 0.0f);
        }
    }

    // A column from its running sums, sx of dim d at s[d ld] (ssq, at s +
    // rs, is carried only): its tables and term.
    __device__ static void init_sums(const Params &p, const float *prior,
                                     const Cols &c, int k, float cn,
                                     const float *s, int64_t ld, int64_t) {
        float lpp = 0.0f;
        int d = 0;
        for (; d + kBatch <= c.D; d += kBatch) {
            float v[kBatch];
#pragma unroll
            for (int j = 0; j < kBatch; ++j) v[j] = s[(d + j) * ld];
            derive_batch<kBatch>(prior, c, k, d, cn, v, lpp);
        }
        for (; d < c.D; ++d) {
            const float v[1] = {s[d * ld]};
            derive_batch<1>(prior, c, k, d, cn, v, lpp);
        }
        set_terms(p, c, Upd{cn}, k, lpp);
    }

    // K3 / K4: a column from the leave-out sums [D, K] at bDK.
    __device__ static void init(const Params &p, const float *prior,
                                const Cols &c, int64_t bDK, int k,
                                float cn) {
        init_sums(p, prior, c, k, cn, p.sum_xT + bDK + k, c.K, 0);
    }

    // Dims d .. d + kN - 1 of the Mahalanobis sum of a column (count cn):
    // (x - mu)^2 pp added in ascending d, pp from the table or from cn.
    // mu and pp point at the column's row d; rows are ld apart.
    template <int kN>
    __device__ static void maha_batch(float &acc, const float *prior, int D,
                                      const float *x, const float *mu,
                                      const float *pp, int ld, int d,
                                      float cn) {
        float dl[kN], p[kN];
#pragma unroll
        for (int j = 0; j < kN; ++j) {
            dl[j] = x[d + j] - mu[j * ld];
            if constexpr (kStorePP) p[j] = pp[j * ld];
        }
        if constexpr (!kStorePP) {
            float np[kN], dp[kN];
            bool ok = true;
#pragma unroll
            for (int j = 0; j < kN; ++j) {
                pp_terms(prior, D, d + j, cn, np[j], dp[j]);
                ok &= div_fast_ok(np[j], dp[j]);
            }
            if (ok) {
#pragma unroll
                for (int j = 0; j < kN; ++j) p[j] = div_fast(np[j], dp[j]);
            } else {
#pragma unroll
                for (int j = 0; j < kN; ++j) p[j] = np[j] / dp[j];
            }
        }
#pragma unroll
        for (int j = 0; j < kN; ++j) acc = acc + dl[j] * dl[j] * p[j];
    }

    __device__ static float fit(const Params &, const float *prior,
                                const Cols &c, const float *x, int k,
                                float cn) {
        const int D = c.D, K = c.K;
        const float *mu = c.tab + k;
        const float *pp = kStorePP ? c.table(1) + k : nullptr;
        float acc = 0.0f;
        int d = 0;
        for (; d + kBatch <= D; d += kBatch) {
            maha_batch<kBatch>(acc, prior, D, x, mu, pp, K, d, cn);
            mu += kBatch * K;
            if constexpr (kStorePP) pp += kBatch * K;
        }
        for (; d + 4 <= D; d += 4) {
            maha_batch<4>(acc, prior, D, x, mu, pp, K, d, cn);
            mu += 4 * K;
            if constexpr (kStorePP) pp += 4 * K;
        }
        for (; d < D; ++d) {
            maha_batch<1>(acc, prior, D, x, mu, pp, K, d, cn);
            mu += K;
            if constexpr (kStorePP) pp += K;
        }
        return c.term[k] - 0.5f * acc;
    }

    __device__ static Upd begin(const Params &, int, float c_new) {
        return Upd{c_new};
    }

    // x joins (kDel: leaves) the running sums v: sum + x, sum - x (the JAX
    // package's sum + (-1) x).
    template <bool kDel>
    __device__ static void move_sums(float (&v)[kSums], float xd) {
        v[0] = kDel ? v[0] - xd : v[0] + xd;
        if constexpr (kSq) v[1] = kDel ? v[1] - xd * xd : v[1] + xd * xd;
    }

    // Dim d of the column from its new running sums v: its tables; returns
    // its log pp (positive only).
    __device__ static float derive_dim(const float *prior, const Cols &c,
                                       const Upd &u, int k, int d,
                                       const float (&v)[kSums]) {
        const float sx[1] = {v[0]};
        float lpp = 0.0f;
        derive_batch<1>(prior, c, k, d, u.c_new, sx, lpp);
        return lpp;
    }

    __device__ static void update_dim(const float *prior, const Cols &c,
                                      const Upd &u, int k, int d, float xd,
                                      float (&v)[kSums], float *vlog) {
        move_sums<false>(v, xd);
        vlog[d] = derive_dim(prior, c, u, k, d, v);
    }

    // The column's term from its logs' sum lpp (ascending d).
    __device__ static void set_terms(const Params &p, const Cols &c,
                                     const Upd &, int k, float lpp) {
        c.term[k] = p.c0 + 0.5f * lpp;
    }

    __device__ static void finish(const Params &p, const Cols &c,
                                  const Upd &u, int k, const float *vlog) {
        float lpp = 0.0f;
        for (int d = 0; d < c.D; ++d) lpp = lpp + vlog[d];
        set_terms(p, c, u, k, lpp);
    }

    // K10's fit split: the addend of dim d of the Mahalanobis sum (as
    // maha_batch forms it) and the fit from the sum of the addends in
    // ascending d.
    __device__ static float fit_dim(const float *prior, const Cols &c,
                                    const float *x, int k, int d, float cn) {
        const int64_t i = (int64_t)d * c.K + k;
        const float dl = x[d] - c.tab[i];
        float pp;
        if constexpr (kStorePP) {
            pp = c.table(1)[i];
        } else {
            float np, dp;
            pp_terms(prior, c.D, d, cn, np, dp);
            pp = div_rn(np, dp);
        }
        return dl * dl * pp;
    }

    __device__ static float fit_sum(const Cols &c, int k, float acc) {
        return c.term[k] - 0.5f * acc;
    }
};

// The smem form stores pp beside mu; the global form recomputes it (half
// the bytes a step streams).
using SmemChain = FixedVarChain<true>;
using GlobalChain = FixedVarChain<false>;
using SmemItems = FixedVarChain<true, true>;
using GlobalItems = FixedVarChain<false, true>;

// The smem form with SmemChain, the global form with GlobalChain.
template <bool kBigram>
int launch(const FixedVarParams &pr, const int *embeds, const float *Xe,
           const float *log_prior_e, const float *gumbel, const int *counts,
           float *touched, float *tab_g, float *col_g, int *ks, int B, int S,
           int D, int K, int global, int threads, float alpha_over_K,
           float lms, float temp, int use_argmax, const BigramLM &lm,
           cudaStream_t stream) {
    namespace dfc = diag_family_chain;
    cudaError_t err = dfc::check_launch(threads, S);
    if (err != cudaSuccess || B == 0 || S == 0)
        return (int)(err == cudaSuccess ? cudaGetLastError() : err);
    if (global) {
        const Args<GlobalChain> a{embeds, Xe, log_prior_e, gumbel, counts, pr,
                                  touched, tab_g, col_g, ks, S, D, K,
                                  alpha_over_K, lms, temp, use_argmax, lm};
        return (int)dfc::launch_form<GlobalChain, kBigram, true>(a, B, threads,
                                                                 stream);
    }
    const Args<SmemChain> a{embeds, Xe, log_prior_e, gumbel, counts, pr,
                            touched, tab_g, col_g, ks, S, D, K, alpha_over_K,
                            lms, temp, use_argmax, lm};
    return (int)dfc::launch_form<SmemChain, kBigram, false>(a, B, threads,
                                                            stream);
}

}  // namespace

extern "C" int fixedvar_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const int *counts, const float *sum_xT,
    const float *prec, const float *prec0, const float *p0m0, float *touched,
    float *tab_g, float *col_g, int *ks, int B, int S, int D, int K,
    int global, int threads, float alpha_over_K, float lms, float temp,
    float c0, int use_argmax, cudaStream_t stream) {
    return launch<false>(
        FixedVarParams{sum_xT, nullptr, prec, prec0, p0m0, c0}, embeds, Xe,
        log_prior_e, gumbel, counts, touched, tab_g, col_g, ks, B, S, D, K,
        global, threads, alpha_over_K, lms, temp, use_argmax, BigramLM{},
        stream);
}

extern "C" int bigram_fixedvar_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const int *counts, const float *sum_xT,
    const float *prec, const float *prec0, const float *p0m0,
    const int *uni, const int *big, const int *corr_j, const int *corr_i,
    float *touched, float *tab_g, float *col_g, int *ks, int B, int S, int D,
    int K, int global, int threads, float a_over_K, float a, float b_over_K,
    float b, float lam, float one_minus_lam, float lms, float temp, float c0,
    cudaStream_t stream) {
    return launch<true>(
        FixedVarParams{sum_xT, nullptr, prec, prec0, p0m0, c0}, embeds, Xe,
        log_prior_e, gumbel, counts, touched, tab_g, col_g, ks, B, S, D, K,
        global, threads, 0.0f, lms, temp, 0,
        BigramLM{uni, big, corr_j, corr_i, a_over_K, a, b_over_K, b, lam,
                 one_minus_lam},
        stream);
}

// The dynamic shared memory, in bytes, that the kernel's CTA reserves in
// the given form (the launch plan's smem_bytes must give exactly this).
extern "C" long long fixedvar_chain_smem_bytes(int global, int bigram,
                                               int D, int S, int K) {
    namespace dfc = diag_family_chain;
    return 4 * (global ? dfc::smem_words<GlobalChain>(true, bigram != 0, D,
                                                      S, K)
                       : dfc::smem_words<SmemChain>(false, bigram != 0, D,
                                                    S, K));
}

// The dynamic shared memory a CTA of the kernel may take on the current
// device: its opt-in limit a block less the kernel's static shared memory
// (the most of the four instantiations); minus a CUDA error code on error.
extern "C" int fixedvar_chain_smem_limit() {
    using diag_family_chain::chain_kernel;
    return diag_family_chain::smem_limit(
        {(const void *)chain_kernel<SmemChain, false, false>,
         (const void *)chain_kernel<SmemChain, true, false>,
         (const void *)chain_kernel<GlobalChain, false, true>,
         (const void *)chain_kernel<GlobalChain, true, true>});
}

// Kernel K10 (fixed variance, item_chain.cuh): the sequential sweep over n
// items of one model on a cluster of `cluster` CTAs of `threads`.  k_old
// [n] each item's old column (-1: none); counts [K], sum_xT, sum_sqT [D,
// K] its statistics; outputs ks [n], cnt_out [K] and sums_out [2, D, K]
// (sx, ssq).  tab_global: the tables, terms and running sums in device
// memory (tab_g [D + 1, K] scratch, sums_out the running sums).  probe
// [C, W, 2, kPhases + 1] (or null) takes the probe build's cycles.
extern "C" int fixedvar_items_launch(
    const float *X, const float *log_prior, const float *gumbel,
    const int *k_old, const int *counts, const float *sum_xT,
    const float *sum_sqT, const float *prec, const float *prec0,
    const float *p0m0, float *tab_g, int *ks, int *cnt_out, float *sums_out,
    long long *probe, int n, int D, int K, int cluster, int tab_global,
    int threads, float alpha_over_K, float lms, float temp, float c0,
    int use_argmax, cudaStream_t stream) {
    const FixedVarParams pr{sum_xT, sum_sqT, prec, prec0, p0m0, c0};
    if (tab_global) {
        if (tab_g == nullptr) return (int)cudaErrorInvalidValue;
        const item_chain::Args<GlobalItems> a{
            X,  log_prior, gumbel,       k_old, counts, pr,  tab_g, ks,
            cnt_out, sums_out, probe, n, D, K,  alpha_over_K, lms,  temp,
            use_argmax};
        return (int)item_chain::launch<GlobalItems, true>(a, cluster,
                                                          threads, stream);
    }
    const item_chain::Args<SmemItems> a{
        X,  log_prior, gumbel,       k_old, counts, pr,  nullptr, ks,
        cnt_out, sums_out, probe, n, D, K,  alpha_over_K, lms,    temp,
        use_argmax};
    return (int)item_chain::launch<SmemItems, false>(a, cluster, threads,
                                                     stream);
}

// K10's dynamic shared memory in bytes a CTA (the launch plan's must give
// exactly this), and its block size, at a cluster of `cluster` CTAs.
extern "C" long long fixedvar_items_smem_bytes(int D, int K, int cluster,
                                               int tab_global) {
    return 4 * (tab_global
                    ? item_chain::smem_words<GlobalItems>(D, K, cluster, true)
                    : item_chain::smem_words<SmemItems>(D, K, cluster,
                                                        false));
}

extern "C" int fixedvar_items_threads(int D, int K, int cluster) {
    return item_chain::threads_of<SmemItems>(D, K, cluster);
}

// The dynamic shared memory a CTA of K10 (fixed variance) may take on the
// current device, and the largest cluster the card schedules (minus a
// CUDA error code on error).
extern "C" int fixedvar_items_smem_limit() {
    return item_chain::smem_limit<SmemItems, GlobalItems>();
}

extern "C" int fixedvar_items_max_cluster() {
    return item_chain::max_cluster<SmemItems, GlobalItems>();
}
