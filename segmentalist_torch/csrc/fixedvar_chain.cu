// Within-utterance fixed-variance assignment chains: kernel K3 (Dirichlet
// mixture weights) and kernel K4 (bigram-LM mixture weights).
//
// Replaces the Pallas kernels of segmentalist_tpu/ops/pallas_chain.py:
// K3 fixedvar_chain (:152, pallas_call :327) and K4 bigram_fixedvar_chain
// (:360, pallas_call :571).  For each utterance b, segments s = 0 .. n_b - 1
// are assigned in order, each conditioning on the statistics updated by the
// previous ones:
//
//   logit[k] = w[k] + (n_k > 0
//                ? c0 + 0.5 lpp[k] - 0.5 sum_d (x_d - mu[d,k])^2 pp[d,k]
//                : log_prior_e[b, s])
//   k_draw   = argmax_k(logit[k] / temp + gumbel[b, s, k])   (or argmax_k logit)
//   k_new    = n_{k_draw} > 0 ? k_draw : first empty slot, else K - 1
//
// with the mixture-weight term
//
//   K3: w[k] = lms log(alpha/K + n_k)
//   K4: w[k] = the bigram-LM weight of bigram_lm.cuh, conditioned on the
//              previous valid segment's draw j_prev
//
// Then column k_new of (counts, sum_x) takes
// the segment and (mu, pp, lpp) of that column are re-derived from the new
// statistics: an exact select of derive(<statistics>), never an
// add-of-difference (pallas_chain.py:291-307).  The argmax breaks ties to
// the LOWEST index (Mosaic broke them to the last, pallas_chain.py:276-281).
//
// What bounds it on the H100: the chain is sequential over segments, so
// the cost is n_b dependent steps of a K-wide score + block-wide argmax
// (plus the launch).  This simple design runs one block per utterance,
// looping to that utterance's own segment count, so no step bound is
// shared between utterances.  Threads stride over k; the per-utterance
// tables (counts, sum_x, mu, pp: [D, K]; lpp: [K]) live in global scratch
// the wrapper allocates (at D = 130 they do not fit in shared memory); at
// D = 13 they stay L2-resident, at D = 130 (195 MB for 125 utterances)
// they stream from HBM and the Mahalanobis loads bound a step.  A block is
// one utterance and a launch has ~125 blocks, so the kernel declares one
// block per SM (__launch_bounds__(256, 1)): under the default bound ptxas
// held it to 40 registers, too few to keep the batched loads in flight
// (on an H100 at D = 130: K3 10.9 -> 5.6 ms, K4 27 -> 6 ms a launch).
// K4 reads row j_prev of the int32 bigram table directly (4 MB at
// K = 1000; the Pallas kernel's [K, K] one-hot matvec was an MXU device),
// sums n_uni as an exact integer block reduction, and gathers the old
// pairs that start at j_prev into a shared list (at most S entries) once
// per step, so corr[k] costs a scan of that list rather than of all S
// pairs.

#include <cstdint>

#include "bigram_lm.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// sum_d (x_d - mu[d, k])^2 pp[d, k], accumulated in ascending d (the plain
// version's order).  The loads go out in batches of kLoadBatch, so a thread
// keeps 2 * kLoadBatch of them in flight: at D = 130 the tables come from
// L2 or HBM and the loop is bound by load latency.  Left to itself the
// compiler interleaved K4's loads with the arithmetic in one register.
constexpr int kLoadBatch = 16;

__device__ __forceinline__ float mahalanobis(const float *xs,
                                             const float *__restrict__ mu,
                                             const float *__restrict__ pp,
                                             int k, int K, int D) {
    float maha = 0.0f;
    int d0 = 0;
    for (; d0 + kLoadBatch <= D; d0 += kLoadBatch) {
        float m[kLoadBatch], p[kLoadBatch];
#pragma unroll
        for (int j = 0; j < kLoadBatch; ++j) {
            const int64_t i = (int64_t)(d0 + j) * K + k;
            m[j] = mu[i];
            p[j] = pp[i];
        }
#pragma unroll
        for (int j = 0; j < kLoadBatch; ++j) {
            const float dl = xs[d0 + j] - m[j];
            maha += dl * dl * p[j];
        }
    }
    for (; d0 < D; ++d0) {
        const int64_t i = (int64_t)d0 * K + k;
        const float dl = xs[d0] - mu[i];
        maha += dl * dl * pp[i];
    }
    return maha;
}

template <bool kBigram>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(
    const int *__restrict__ embeds, const float *__restrict__ Xe,
    const float *__restrict__ log_prior_e, const float *__restrict__ gumbel,
    const int *__restrict__ counts, const float *__restrict__ sum_xT,
    const float *__restrict__ prec, const float *__restrict__ prec0,
    const float *__restrict__ p0m0, float *__restrict__ cnt_s,
    float *__restrict__ sumx_s, float *__restrict__ mu_s,
    float *__restrict__ pp_s, float *__restrict__ lpp_s,
    int *__restrict__ ks, int S, int D, int K, float alpha_over_K, float lms,
    float temp, float c0, int use_argmax, BigramLM lm) {
    // x [D], log pp of the updated column [D]; K4: the old successors of
    // j_prev [S]
    extern __shared__ float sh[];
    float *xs = sh;
    float *plog = sh + D;
    int *succ = reinterpret_cast<int *>(sh + 2 * D);
    __shared__ float red_v[kWarps];
    __shared__ int red_i[kWarps];
    __shared__ int red_e[kWarps];
    __shared__ int s_n, s_k, s_nsucc, s_nuni;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int64_t bK = (int64_t)b * K, bDK = (int64_t)b * D * K;
    const int *emb = embeds + (int64_t)b * S;
    float *cnt = cnt_s + bK;
    float *sx = sumx_s + bDK;
    float *mu = mu_s + bDK;
    float *pp = pp_s + bDK;
    float *lpp = lpp_s + bK;
    int *kout = ks + (int64_t)b * S;
    const int *uni = kBigram ? lm.uni + bK : nullptr;
    const int *cj = kBigram ? lm.corr_j + (int64_t)b * S : nullptr;
    const int *ci = kBigram ? lm.corr_i + (int64_t)b * S : nullptr;

    // Step count: one past the last valid segment.
    if (tid == 0) {
        s_n = 0;
        s_nsucc = 0;
        s_nuni = 0;
    }
    __syncthreads();
    for (int s = tid; s < S; s += blockDim.x) {
        kout[s] = -1;
        if (emb[s] >= 0) atomicMax(&s_n, s + 1);
    }

    // Tables from the leave-out statistics; K4 also sums n_uni (integer,
    // so exact and independent of the order).
    int uni_part = 0;
    for (int k = tid; k < K; k += blockDim.x) {
        const float c = (float)counts[bK + k];
        cnt[k] = c;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d) {
            const int64_t i = (int64_t)d * K + k;
            const float v = sum_xT[bDK + i];
            sx[i] = v;
            const float prec_n = prec0[d] + c * prec[d];
            mu[i] = (p0m0[d] + prec[d] * v) / prec_n;
            const float p = prec_n * prec[d] / (prec_n + prec[d]);
            pp[i] = p;
            acc += p > 0.0f ? logf(p) : 0.0f;
        }
        lpp[k] = acc;
        if (kBigram) uni_part += uni[k];
    }
    if (kBigram) {
        for (int off = 16; off > 0; off >>= 1)
            uni_part += __shfl_xor_sync(0xffffffffu, uni_part, off);
        if (lane == 0) atomicAdd(&s_nuni, uni_part);
    }
    __syncthreads();
    const int n_steps = s_n;
    // K4's unigram denominators: n_uni + a and its log.
    const float uni_den = kBigram ? (float)s_nuni + lm.a : 0.0f;
    const float log_uni_den = kBigram ? logf(uni_den) : 0.0f;

    int j_prev = -1;  // K4: the previous valid segment's draw (block-uniform)
    for (int s = 0; s < n_steps; ++s) {
        const int64_t row = (int64_t)b * S + s;
        for (int d = tid; d < D; d += blockDim.x) xs[d] = Xe[row * D + d];
        if (kBigram && j_prev >= 0)
            bigram_successors(cj, ci, S, j_prev, succ, &s_nsucc);
        const float lp = log_prior_e[row];
        const float *g = gumbel + row * K;
        __syncthreads();
        const int n_succ = s_nsucc;
        const int *brow = kBigram && j_prev >= 0
                              ? lm.big + (int64_t)j_prev * K : nullptr;
        const float uni_j = kBigram && j_prev >= 0 ? (float)uni[j_prev]
                                                   : 0.0f;

        float best_v = NEG_INF;
        int best_i = 0x7fffffff;
        int first_empty = K;
        for (int k = tid; k < K; k += blockDim.x) {
            const float c = cnt[k];
            float fit;  // log p(x | k), or the prior for an empty slot
            if (c > 0.0f) {
                fit = (c0 + 0.5f * lpp[k]) - 0.5f * mahalanobis(xs, mu, pp, k,
                                                                K, D);
            } else {
                fit = lp;
                first_empty = min(first_empty, k);
            }
            const float wk =
                kBigram ? bigram_weight(lm, (float)uni[k], k, j_prev, brow,
                                        succ, n_succ, uni_den, log_uni_den,
                                        uni_j, lms)
                        : lms * logf(alpha_over_K + c);
            const float logit = wk + fit;
            const float v = use_argmax ? logit
                            : (logit == NEG_INF ? NEG_INF : logit / temp + g[k]);
            argmax_merge(best_v, best_i, v, k);
        }
        for (int off = 16; off > 0; off >>= 1) {
            const float v2 = __shfl_xor_sync(0xffffffffu, best_v, off);
            const int i2 = __shfl_xor_sync(0xffffffffu, best_i, off);
            argmax_merge(best_v, best_i, v2, i2);
            first_empty = min(first_empty,
                              __shfl_xor_sync(0xffffffffu, first_empty, off));
        }
        if (lane == 0) {
            red_v[warp] = best_v;
            red_i[warp] = best_i;
            red_e[warp] = first_empty;
        }
        __syncthreads();
        if (tid == 0) {
            for (int i = 1; i < kWarps; ++i) {
                argmax_merge(best_v, best_i, red_v[i], red_i[i]);
                first_empty = min(first_empty, red_e[i]);
            }
            if (best_i >= K) best_i = 0;  // only an all-NaN row gets here
            const int k_new = cnt[best_i] > 0.0f ? best_i
                              : (first_empty < K ? first_empty : K - 1);
            const int k_out = emb[s] >= 0 ? k_new : -1;
            kout[s] = k_out;
            s_k = k_out;
            s_nsucc = 0;
        }
        __syncthreads();

        const int k = s_k;
        if (k >= 0) {
            const float c_new = cnt[k] + 1.0f;
            for (int d = tid; d < D; d += blockDim.x) {
                const int64_t i = (int64_t)d * K + k;
                const float v = sx[i] + xs[d];
                sx[i] = v;
                const float prec_n = prec0[d] + c_new * prec[d];
                mu[i] = (p0m0[d] + prec[d] * v) / prec_n;
                const float p = prec_n * prec[d] / (prec_n + prec[d]);
                pp[i] = p;
                plog[d] = p > 0.0f ? logf(p) : 0.0f;
            }
            __syncthreads();
            if (tid == 0) {
                float acc = 0.0f;
                for (int d = 0; d < D; ++d) acc += plog[d];
                lpp[k] = acc;
                cnt[k] = c_new;
            }
            j_prev = k;
        }
        __syncthreads();
    }
}

template <bool kBigram>
int launch(const int *embeds, const float *Xe, const float *log_prior_e,
           const float *gumbel, const int *counts, const float *sum_xT,
           const float *prec, const float *prec0, const float *p0m0,
           float *cnt_s, float *sumx_s, float *mu_s, float *pp_s,
           float *lpp_s, int *ks, int B, int S, int D, int K,
           float alpha_over_K, float lms, float temp, float c0,
           int use_argmax, const BigramLM &lm, cudaStream_t stream) {
    if (B > 0 && S > 0) {
        const size_t smem = sizeof(float) * 2 * D + sizeof(int) * S;
        chain_kernel<kBigram><<<B, kThreads, smem, stream>>>(
            embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec, prec0, p0m0,
            cnt_s, sumx_s, mu_s, pp_s, lpp_s, ks, S, D, K, alpha_over_K, lms,
            temp, c0, use_argmax, lm);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fixedvar_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const int *counts, const float *sum_xT,
    const float *prec, const float *prec0, const float *p0m0, float *cnt_s,
    float *sumx_s, float *mu_s, float *pp_s, float *lpp_s, int *ks, int B,
    int S, int D, int K, float alpha_over_K, float lms, float temp, float c0,
    int use_argmax, cudaStream_t stream) {
    return launch<false>(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                         prec, prec0, p0m0, cnt_s, sumx_s, mu_s, pp_s, lpp_s,
                         ks, B, S, D, K, alpha_over_K, lms, temp, c0,
                         use_argmax, BigramLM{}, stream);
}

extern "C" int bigram_fixedvar_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const int *counts, const float *sum_xT,
    const float *prec, const float *prec0, const float *p0m0,
    const int *uni, const int *big, const int *corr_j, const int *corr_i,
    float *cnt_s, float *sumx_s, float *mu_s, float *pp_s, float *lpp_s,
    int *ks, int B, int S, int D, int K, float a_over_K, float a,
    float b_over_K, float b, float lam, float one_minus_lam, float lms,
    float temp, float c0, cudaStream_t stream) {
    const BigramLM lm{uni, big, corr_j, corr_i, a_over_K, a,
                      b_over_K, b, lam, one_minus_lam};
    return launch<true>(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                        prec, prec0, p0m0, cnt_s, sumx_s, mu_s, pp_s, lpp_s,
                        ks, B, S, D, K, 0.0f, lms, temp, c0, 0, lm, stream);
}
