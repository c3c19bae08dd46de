// Within-utterance fixed-variance assignment chain (kernel K3).
//
// Replaces the Pallas kernel of segmentalist_tpu/ops/pallas_chain.py
// (fixedvar_chain :152, pallas_call :327).  For each utterance b, segments
// s = 0 .. n_b - 1 are assigned in order, each conditioning on the
// statistics updated by the previous ones:
//
//   logit[k] = lms log(alpha/K + n_k) + (n_k > 0
//                ? c0 + 0.5 lpp[k] - 0.5 sum_d (x_d - mu[d,k])^2 pp[d,k]
//                : log_prior_e[b, s])
//   k_draw   = argmax_k(logit[k] / temp + gumbel[b, s, k])   (or argmax_k logit)
//   k_new    = n_{k_draw} > 0 ? k_draw : first empty slot, else K - 1
//
// then column k_new of (counts, sum_x) takes the segment and (mu, pp, lpp)
// of that column are re-derived from the new statistics: an exact select
// of derive(<statistics>), never an add-of-difference
// (pallas_chain.py:291-307).  The argmax breaks ties to the LOWEST index
// (Mosaic broke them to the last, pallas_chain.py:276-281).
//
// What bounds it on the H100: the chain is sequential over segments, so
// the cost is n_b dependent steps of a K-wide score + block-wide argmax
// (plus the launch).  This simple design runs one block per utterance,
// looping to that utterance's own segment count, so no step bound is
// shared between utterances.  Threads stride over k; the per-utterance
// tables (counts, sum_x, mu, pp: [D, K]; lpp: [K]) live in global scratch
// the wrapper allocates (at D = 130 they do not fit in shared memory) and
// stay L1/L2-resident.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) fixedvar_chain_kernel(
    const int *__restrict__ embeds, const float *__restrict__ Xe,
    const float *__restrict__ log_prior_e, const float *__restrict__ gumbel,
    const int *__restrict__ counts, const float *__restrict__ sum_xT,
    const float *__restrict__ prec, const float *__restrict__ prec0,
    const float *__restrict__ p0m0, float *__restrict__ cnt_s,
    float *__restrict__ sumx_s, float *__restrict__ mu_s,
    float *__restrict__ pp_s, float *__restrict__ lpp_s,
    int *__restrict__ ks, int S, int D, int K, float alpha_over_K, float lms,
    float temp, float c0, int use_argmax) {
    extern __shared__ float sh[];  // x [D], log pp of the updated column [D]
    float *xs = sh;
    float *plog = sh + D;
    __shared__ float red_v[kWarps];
    __shared__ int red_i[kWarps];
    __shared__ int red_e[kWarps];
    __shared__ int s_n, s_k;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int64_t bK = (int64_t)b * K, bDK = (int64_t)b * D * K;
    const int *emb = embeds + (int64_t)b * S;
    float *cnt = cnt_s + bK;
    float *sx = sumx_s + bDK;
    float *mu = mu_s + bDK;
    float *pp = pp_s + bDK;
    float *lpp = lpp_s + bK;
    int *kout = ks + (int64_t)b * S;

    // Step count: one past the last valid segment.
    if (tid == 0) s_n = 0;
    __syncthreads();
    for (int s = tid; s < S; s += blockDim.x) {
        kout[s] = -1;
        if (emb[s] >= 0) atomicMax(&s_n, s + 1);
    }

    // Tables from the leave-out statistics.
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
    }
    __syncthreads();
    const int n_steps = s_n;

    const int lane = tid & 31, warp = tid >> 5;
    for (int s = 0; s < n_steps; ++s) {
        const int64_t row = (int64_t)b * S + s;
        for (int d = tid; d < D; d += blockDim.x) xs[d] = Xe[row * D + d];
        const float lp = log_prior_e[row];
        const float *g = gumbel + row * K;
        __syncthreads();

        float best_v = NEG_INF;
        int best_i = 0x7fffffff;
        int first_empty = K;
        for (int k = tid; k < K; k += blockDim.x) {
            const float c = cnt[k];
            const float wk = lms * logf(alpha_over_K + c);
            float logit;
            if (c > 0.0f) {
                float maha = 0.0f;
                for (int d = 0; d < D; ++d) {
                    const float dl = xs[d] - mu[(int64_t)d * K + k];
                    maha += dl * dl * pp[(int64_t)d * K + k];
                }
                logit = wk + ((c0 + 0.5f * lpp[k]) - 0.5f * maha);
            } else {
                logit = wk + lp;
                first_empty = min(first_empty, k);
            }
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
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int fixedvar_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const int *counts, const float *sum_xT,
    const float *prec, const float *prec0, const float *p0m0, float *cnt_s,
    float *sumx_s, float *mu_s, float *pp_s, float *lpp_s, int *ks, int B,
    int S, int D, int K, float alpha_over_K, float lms, float temp, float c0,
    int use_argmax, cudaStream_t stream) {
    if (B > 0 && S > 0) {
        const size_t smem = sizeof(float) * 2 * D;
        fixedvar_chain_kernel<<<B, kThreads, smem, stream>>>(
            embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec, prec0, p0m0,
            cnt_s, sumx_s, mu_s, pp_s, lpp_s, ks, S, D, K, alpha_over_K, lms,
            temp, c0, use_argmax);
    }
    return (int)cudaGetLastError();
}
