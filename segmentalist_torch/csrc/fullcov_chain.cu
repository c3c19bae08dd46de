// Within-utterance full-covariance (NIW) assignment chains over touched-slot
// tables: kernel K9, with Dirichlet mixture weights or (kBigram) bigram-LM
// weights.
//
// Replaces the Pallas kernel of segmentalist_tpu/ops/pallas_chain.py
// (fullcov_chain_pallas, entry :1323, pallas_call :1725, body :1513-1678,
// bigram mode :1549-1567), whose XLA twin is
// segmentalist_tpu/segmenters/fullcov.py::fullcov_chain.  For each
// utterance b, segments s = 0 .. n_b - 1 are assigned in order.  The
// utterance carries T = T0 + S touched slots (m[D], invP[D*D], ldP,
// component tk; T0 from the inputs, -1 = free) and, per component k, its
// running count cnt[k] and slot_of[k] (-1 = untouched), the dense map that
// takes the place of the TPU kernel's slot one-hot table.  A step:
//
//   1. live slot t (n = cnt[tk]):  delta = x - m,  U = invP delta,
//        mahaP = max(U . delta, 0),  k_n = k0 + n,  v = v0 + n - D + 1,
//        s = (k_n + 1) / (k_n v),  ld = ldP + D log s,
//        c[t] = ((glr(v) - D/2 (log v + log pi)) - ld/2)
//               - ((v + D)/2) log1p((mahaP / s) / v)
//      glr = lgamma((v + D)/2) - lgamma(v/2), the Stirling series
//      (special.cuh);
//   2. logit[k] = w[k] + (cnt[k] > 0 ? (slot_of[k] >= 0 ? c[slot_of[k]]
//                                        : base[b, s, k]) : log_prior_e)
//      with w = lms log(alpha/K + cnt) or the bigram-LM weight
//      (bigram_lm.cuh, conditioned on the previous valid segment's draw);
//   3. Gumbel-max (or argmax) with ties to the LOWEST index, first-empty
//      birth (else K - 1);
//   4. the drawn component's slot, or the first free slot, which pulls the
//      component's GLOBAL factors g_m / g_invP / g_ldP exactly (an untouched
//      component's leave-out factors are the global ones), takes the
//      rank-1 Sherman-Morrison step of adding x:
//        beta = k_n / (k_n + 1),  dv = x - m,  u = invP dv,
//        denom = 1 + beta (u . dv), taken as 1 unless > 0 (pad guard),
//        invP -= (beta / denom) u u^T,  ldP += log denom,
//        m = (k_n m + x) / (k_n + 1).
//
// Every matrix-vector and dot product sums in ascending order, every
// expression keeps the plain version's operation order
// (ops/cuda_fullcov_chain.py), and the library is built with -fmad=false,
// so kernel and plain version round alike and sample identical chains.
// The divisions are per slot and per step, so IEEE `/` costs little here.
//
// What bounds it on the H100: the chain is sequential over segments; a
// step is a K-wide read of base and gumbel (the bytes the flagship's ~20 MB
// of inputs are) plus, per live slot, a D x D matrix-vector product.  One
// block per utterance; the step's slot scores go one warp per live slot
// (lanes over rows, each row in ascending order), the K-wide logits and
// the block argmax as in K6.  The slot tables (T (D^2 + D + 2) floats,
// ~30 KB at D = 13 and T = 40) live in shared memory when they fit; at
// D = 130 (16 MB an utterance at N_max 120) they live in device-memory
// scratch the wrapper allocates, and each step re-reads the live slots'
// D x D tables.

#include <cstdint>

#include "bigram_lm.cuh"
#include "common.cuh"
#include "special.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct FullPrior {
    float k0, v0;
    float half_D;  // D / 2
    float log_pi;
};

// The utterance's inputs and its working slot tables.
struct Slots {
    const float *m0, *iP0, *ld0;  // [B, T0, D], [B, T0, D*D], [B, T0]
    const int *tk0;               // [B, T0]
    float *m, *iP, *ld;           // scratch [B, T, D], [B, T, D*D], [B, T]
    int *tk;                      // scratch [B, T]
};

template <bool kBigram>
__global__ void __launch_bounds__(kThreads) fullcov_chain_kernel(
    const int *__restrict__ embeds, const float *__restrict__ Xe,
    const float *__restrict__ log_prior_e, const float *__restrict__ gumbel,
    const float *__restrict__ base, const int *__restrict__ counts,
    Slots sl, const float *__restrict__ g_m, const float *__restrict__ g_iP,
    const float *__restrict__ g_ld, FullPrior pr, float *__restrict__ cnt_s,
    int *__restrict__ slot_s, int *__restrict__ ks, int S, int D, int K,
    int T0, int in_smem, float alpha_over_K, float lms, float temp,
    int use_argmax, BigramLM lm) {
    // x, dv, u [D]; per-warp delta and U [kWarps, D]; slot scores [T]; K7's
    // old successors [S]; then, with in_smem, the slot tables.
    extern __shared__ float sh[];
    const int T = T0 + S;
    const int DD = D * D;
    float *xs = sh;
    float *dv = xs + D;
    float *uv = dv + D;
    float *wdel = uv + D;
    float *wU = wdel + kWarps * D;
    float *cslot = wU + kWarps * D;
    int *succ = reinterpret_cast<int *>(cslot + T);
    __shared__ float red_v[kWarps];
    __shared__ int red_i[kWarps];
    __shared__ int red_e[kWarps];
    __shared__ int s_n, s_k, s_slot, s_have, s_nsucc, s_nuni;
    __shared__ float s_coef, s_kn;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int64_t bK = (int64_t)b * K;
    const int *emb = embeds + (int64_t)b * S;
    float *cnt = cnt_s + bK;
    int *slot_of = slot_s + bK;
    int *kout = ks + (int64_t)b * S;
    float *tm, *tiP, *tld;
    int *tk;
    if (in_smem) {
        tm = reinterpret_cast<float *>(succ + S);
        tiP = tm + T * D;
        tld = tiP + T * DD;
        tk = reinterpret_cast<int *>(tld + T);
    } else {
        tm = sl.m + (int64_t)b * T * D;
        tiP = sl.iP + (int64_t)b * T * DD;
        tld = sl.ld + (int64_t)b * T;
        tk = sl.tk + (int64_t)b * T;
    }
    const int *uni = kBigram ? lm.uni + bK : nullptr;
    const int *cj = kBigram ? lm.corr_j + (int64_t)b * S : nullptr;
    const int *ci = kBigram ? lm.corr_i + (int64_t)b * S : nullptr;
    const float Df = (float)D;

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
    // Working slot tables: the T0 input slots, then S free ones.
    const float *m0 = sl.m0 + (int64_t)b * T0 * D;
    const float *iP0 = sl.iP0 + (int64_t)b * T0 * DD;
    for (int i = tid; i < T0 * D; i += blockDim.x) tm[i] = m0[i];
    for (int64_t i = tid; i < (int64_t)T0 * DD; i += blockDim.x) tiP[i] = iP0[i];
    for (int t = tid; t < T; t += blockDim.x) {
        tld[t] = t < T0 ? sl.ld0[(int64_t)b * T0 + t] : 0.0f;
        tk[t] = t < T0 ? sl.tk0[(int64_t)b * T0 + t] : -1;
    }
    int uni_part = 0;
    for (int k = tid; k < K; k += blockDim.x) {
        cnt[k] = (float)counts[bK + k];
        slot_of[k] = -1;
        if (kBigram) uni_part += uni[k];
    }
    if (kBigram) {
        for (int off = 16; off > 0; off >>= 1)
            uni_part += __shfl_xor_sync(0xffffffffu, uni_part, off);
        if (lane == 0) atomicAdd(&s_nuni, uni_part);
    }
    __syncthreads();
    for (int t = tid; t < T0; t += blockDim.x) {
        if (tk[t] >= 0) slot_of[tk[t]] = t;  // live components are distinct
    }
    __syncthreads();
    const int n_steps = s_n;
    const float uni_den = kBigram ? (float)s_nuni + lm.a : 0.0f;
    const float log_uni_den = kBigram ? logf(uni_den) : 0.0f;

    int j_prev = -1;  // K9 bigram: the previous valid segment's draw
    for (int s = 0; s < n_steps; ++s) {
        const int64_t row = (int64_t)b * S + s;
        for (int d = tid; d < D; d += blockDim.x) xs[d] = Xe[row * D + d];
        if (kBigram && j_prev >= 0)
            bigram_successors(cj, ci, S, j_prev, succ, &s_nsucc);
        __syncthreads();

        // 1. Scores of the live slots, one warp a slot.
        float *del = wdel + warp * D;
        float *U = wU + warp * D;
        for (int t = warp; t < T; t += kWarps) {
            const int kt = tk[t];
            if (kt < 0) continue;
            const float *m = tm + t * D;
            const float *A = tiP + (int64_t)t * DD;
            for (int e = lane; e < D; e += 32) del[e] = xs[e] - m[e];
            __syncwarp();
            for (int d = lane; d < D; d += 32) {
                const float *r = A + d * D;
                float acc = 0.0f;
                for (int e = 0; e < D; ++e) acc = acc + r[e] * del[e];
                U[d] = acc;
            }
            __syncwarp();
            if (lane == 0) {
                float mp = 0.0f;
                for (int d = 0; d < D; ++d) mp = mp + U[d] * del[d];
                mp = mp < 0.0f ? 0.0f : mp;
                const float n = cnt[kt];
                const float k_n = pr.k0 + n;
                const float v = ((pr.v0 + n) - Df) + 1.0f;
                const float sc = (k_n + 1.0f) / (k_n * v);
                const float ld = tld[t] + Df * logf(sc);
                cslot[t] = ((lgamma_ratio(v, Df)
                             - pr.half_D * (logf(v) + pr.log_pi))
                            - 0.5f * ld)
                           - (0.5f * (v + Df)) * log1pf((mp / sc) / v);
            }
            __syncwarp();
        }
        __syncthreads();

        // 2-3. The K-wide logits and the draw.
        const int n_succ = s_nsucc;
        const int *brow = kBigram && j_prev >= 0
                              ? lm.big + (int64_t)j_prev * K : nullptr;
        const float uni_j = kBigram && j_prev >= 0 ? (float)uni[j_prev]
                                                   : 0.0f;
        const float lp = log_prior_e[row];
        const float *g = gumbel + row * K;
        const float *bs = base + row * K;
        float best_v = NEG_INF;
        int best_i = 0x7fffffff;
        int first_empty = K;
        for (int k = tid; k < K; k += blockDim.x) {
            const float c = cnt[k];
            float fit;
            if (c > 0.0f) {
                const int t = slot_of[k];
                fit = t >= 0 ? cslot[t] : bs[k];
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
            if (k_out >= 0) {
                int t = slot_of[k_out];
                s_have = t >= 0;
                if (t < 0) {
                    t = 0;
                    while (tk[t] >= 0) ++t;  // T0 + S slots: one is free
                }
                s_slot = t;
            }
        }
        __syncthreads();

        // 4. The rank-1 update of the drawn component's slot.
        const int k = s_k;
        if (k >= 0) {
            const int t = s_slot;
            const bool have = s_have;
            const float *m_src = have ? tm + t * D : g_m + (int64_t)k * D;
            const float *A_src = have ? tiP + (int64_t)t * DD
                                      : g_iP + (int64_t)k * DD;
            for (int e = tid; e < D; e += blockDim.x) dv[e] = xs[e] - m_src[e];
            __syncthreads();
            for (int d = tid; d < D; d += blockDim.x) {
                const float *r = A_src + d * D;
                float acc = 0.0f;
                for (int e = 0; e < D; ++e) acc = acc + r[e] * dv[e];
                uv[d] = acc;
            }
            __syncthreads();
            if (tid == 0) {
                float du = 0.0f;
                for (int d = 0; d < D; ++d) du = du + uv[d] * dv[d];
                const float c_row = cnt[k];
                const float k_n = pr.k0 + c_row;
                const float beta = k_n / (k_n + 1.0f);
                float denom = 1.0f + beta * du;
                denom = denom > 0.0f ? denom : 1.0f;
                s_coef = beta / denom;
                s_kn = k_n;
                tld[t] = (have ? tld[t] : g_ld[k]) + logf(denom);
                tk[t] = k;
                slot_of[k] = t;
                cnt[k] = c_row + 1.0f;
            }
            __syncthreads();
            const float coef = s_coef, k_n = s_kn;
            float *A_dst = tiP + (int64_t)t * DD;
            for (int i = tid; i < DD; i += blockDim.x) {
                const int d = i / D, e = i - d * D;
                A_dst[i] = A_src[i] - coef * (uv[d] * uv[e]);
            }
            for (int d = tid; d < D; d += blockDim.x)
                tm[t * D + d] = (k_n * m_src[d] + xs[d]) / (k_n + 1.0f);
            j_prev = k;
        }
        __syncthreads();
    }
}

template <bool kBigram>
int launch(const int *embeds, const float *Xe, const float *log_prior_e,
           const float *gumbel, const float *base, const int *counts,
           const Slots &sl, const float *g_m, const float *g_iP,
           const float *g_ld, const FullPrior &pr, float *cnt_s, int *slot_s,
           int *ks, int B, int S, int D, int K, int T0, int in_smem,
           int smem, float alpha_over_K, float lms, float temp,
           int use_argmax, const BigramLM &lm, cudaStream_t stream) {
    if (B > 0 && S > 0) {
        fullcov_chain_kernel<kBigram><<<B, kThreads, smem, stream>>>(
            embeds, Xe, log_prior_e, gumbel, base, counts, sl, g_m, g_iP,
            g_ld, pr, cnt_s, slot_s, ks, S, D, K, T0, in_smem, alpha_over_K,
            lms, temp, use_argmax, lm);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fullcov_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const float *base, const int *counts,
    const float *t_m0, const float *t_iP0, const float *t_ld0,
    const int *tk0, const float *g_m, const float *g_iP, const float *g_ld,
    float k0, float v0, float half_D, float log_pi, float *cnt_s,
    int *slot_s, float *tm_s, float *tiP_s, float *tld_s, int *tk_s, int *ks,
    int B, int S, int D, int K, int T0, int in_smem, int smem,
    float alpha_over_K, float lms, float temp, int use_argmax,
    cudaStream_t stream) {
    const Slots sl{t_m0, t_iP0, t_ld0, tk0, tm_s, tiP_s, tld_s, tk_s};
    const FullPrior pr{k0, v0, half_D, log_pi};
    return launch<false>(embeds, Xe, log_prior_e, gumbel, base, counts, sl,
                         g_m, g_iP, g_ld, pr, cnt_s, slot_s, ks, B, S, D, K,
                         T0, in_smem, smem, alpha_over_K, lms, temp,
                         use_argmax, BigramLM{}, stream);
}

extern "C" int bigram_fullcov_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const float *base, const int *counts,
    const float *t_m0, const float *t_iP0, const float *t_ld0,
    const int *tk0, const float *g_m, const float *g_iP, const float *g_ld,
    float k0, float v0, float half_D, float log_pi, const int *uni,
    const int *big, const int *corr_j, const int *corr_i, float *cnt_s,
    int *slot_s, float *tm_s, float *tiP_s, float *tld_s, int *tk_s, int *ks,
    int B, int S, int D, int K, int T0, int in_smem, int smem,
    float a_over_K, float a, float b_over_K, float b, float lam,
    float one_minus_lam, float lms, float temp, cudaStream_t stream) {
    const Slots sl{t_m0, t_iP0, t_ld0, tk0, tm_s, tiP_s, tld_s, tk_s};
    const FullPrior pr{k0, v0, half_D, log_pi};
    const BigramLM lm{uni, big, corr_j, corr_i, a_over_K, a,
                      b_over_K, b, lam, one_minus_lam};
    return launch<true>(embeds, Xe, log_prior_e, gumbel, base, counts, sl,
                        g_m, g_iP, g_ld, pr, cnt_s, slot_s, ks, B, S, D, K,
                        T0, in_smem, smem, 0.0f, lms, temp, 0, lm, stream);
}
