// Fused full-covariance candidate scoring with touched-slot corrections
// (kernel K8).
//
// Replaces the Pallas kernel of segmentalist_tpu/ops/pallas_score.py
// (fullcov_log_margs, entry :422, pallas_call :630; XLA twin
// components_full.log_post_pred_batch + segmenters/fullcov.py
// corrected_candidate_post):
//
//   maha_g[m, k] = |L[k] x[m] - Lmu[k]|^2
//   post_g       = ck[k] - vh[k] log1p(maha_g vinv[k])
//   c_t[m, s]    = the same against the utterance's touched-slot tables
//   post[m, k]   = tslot[k] >= 0 ? c_t[m, tslot[k]] : post_g[m, k]
//   out[b, m]    = logsumexp_k( w[k] + (counts[k] > 0 ? post : prior_c[m]) )
//
// L is the inverse Cholesky factor of the predictive scale matrix (packed
// lower triangle, row-major: lane f of row d holds L[d, e] for e = 0..d),
// so maha = (x - mu)^T A (x - mu).  The reference expands that into
// x^T A x - 2 x . A mu + mu . A mu, whose terms cancel: they are each far
// larger than the distance once the candidates lie a few prototype spreads
// from the origin, and in float32 two summation orders of the expanded form
// differed by 1.3e-4 relative at D = 130 (above chip_smoke.SCORE_TOL).  The
// whitened form cancels only in L x - Lmu, a difference of vectors the
// size of the whitened candidate, so everything stays in float32; the plain
// version (ops/cuda_fullcov_score.py) evaluates the same form with matrix
// products and differs only in summation order.  Rows m >= valid_m[b] are
// written as -inf unscored, as in K1 and K5.
//
// What bounds it on the H100: arithmetic.  Each (live row, active
// component) pair costs D(D+1)/2 + D fused multiply-adds (~1 GFLOP at the
// flagship's live rows and active components, ~1.5 TFLOP at N_max 120,
// D 130) against a few MB of inputs.  The design keeps every operand on
// chip: one block per (utterance, tile of kCands candidate rows) stages the
// rows in shared memory, transposed so that one 16-byte load feeds four
// rows; threads stride over k, so a warp reads 32 neighbouring k of the
// feature-major tables (LT is 364 KB at D = 13 and stays in L2), and each
// table value feeds kCands fused multiply-adds.  The touched-slot scores
// c_t (S <= N_max slots an utterance) are formed first into shared memory,
// one (slot, row) pair a thread with the rows fastest, so a warp reads two
// slots' tables; they are read back for the touched k, whose global form
// is skipped.  The logits never leave registers (an online logsumexp per
// row, then a block reduction).  CUDA cores only, explicit fma.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCands = 16;
constexpr int kWarps = kThreads / 32;

struct Tables {
    const float *L, *Lmu, *ck, *vinv, *vh;
};

__device__ __forceinline__ float student_t(float maha, float ck, float vh,
                                           float vinv) {
    return ck - vh * log1pf(maha * vinv);
}

__global__ void __launch_bounds__(kThreads) fullcov_scores_kernel(
    const float *__restrict__ Xc, const float *__restrict__ prior_c,
    Tables g, Tables t, const int *__restrict__ tslot,
    const float *__restrict__ w, const int *__restrict__ counts,
    const int *__restrict__ valid_m, float *__restrict__ out, int M, int D,
    int K, int S) {
    extern __shared__ float4 sh4[];
    float *xsT = reinterpret_cast<float *>(sh4);  // [D, kCands] rows
    float *ct = xsT + D * kCands;                 // [S, kCands] slot scores
    __shared__ float red_m[kWarps][kCands];
    __shared__ float red_s[kWarps][kCands];

    const int b = blockIdx.y;
    const int m0 = blockIdx.x * kCands;
    const int n_c = min(kCands, M - m0);
    const int vm = valid_m ? min(valid_m[b], M) : M;
    const int n_live = max(0, min(n_c, vm - m0));
    const int tid = threadIdx.x;
    float *orow = out + (int64_t)b * M + m0;
    if (n_live == 0) {
        for (int c = tid; c < n_c; c += blockDim.x) orow[c] = NEG_INF;
        return;
    }
    const int F = D * (D + 1) / 2;

    const float *xrow = Xc + ((int64_t)b * M + m0) * D;
    for (int i = tid; i < D * kCands; i += blockDim.x) {
        const int e = i / kCands, c = i % kCands;
        xsT[i] = c < n_live ? xrow[c * D + e] : 0.0f;
    }
    __syncthreads();

    // Touched-slot scores, one (slot, row) pair a thread, rows fastest.
    for (int i = tid; i < S * n_live; i += blockDim.x) {
        const int s = i / n_live, c = i % n_live;
        const int64_t bs = (int64_t)b * S + s;
        const float *L = t.L + bs * F;
        const float *Lmu = t.Lmu + bs * D;
        float q = 0.0f;
        int f = 0;
        for (int d = 0; d < D; ++d) {
            float acc = 0.0f;
            for (int e = 0; e <= d; ++e, ++f)
                acc = fmaf(L[f], xsT[e * kCands + c], acc);
            const float y = acc - Lmu[d];
            q = fmaf(y, y, q);
        }
        ct[s * kCands + c] = student_t(q, t.ck[bs], t.vh[bs], t.vinv[bs]);
    }
    __syncthreads();

    float pc[kCands], run_m[kCands], run_s[kCands];
#pragma unroll
    for (int c = 0; c < kCands; ++c) {
        pc[c] = c < n_live ? prior_c[(int64_t)b * M + m0 + c] : 0.0f;
        run_m[c] = NEG_INF;
        run_s[c] = 0.0f;
    }

    const int64_t bk = (int64_t)b * K;
    for (int k = tid; k < K; k += blockDim.x) {
        const float wk = w[bk + k];
        const int slot = counts[bk + k] > 0 ? tslot[bk + k] : -2;
        if (slot == -2) {
#pragma unroll
            for (int c = 0; c < kCands; ++c)
                if (c < n_live) lse_push(run_m[c], run_s[c], wk + pc[c]);
            continue;
        }
        if (slot >= 0) {
#pragma unroll
            for (int c = 0; c < kCands; ++c)
                if (c < n_live)
                    lse_push(run_m[c], run_s[c], wk + ct[slot * kCands + c]);
            continue;
        }
        float q[kCands];
#pragma unroll
        for (int c = 0; c < kCands; ++c) q[c] = 0.0f;
        const float *Lk = g.L + k;
        int64_t f = 0;
        for (int d = 0; d < D; ++d) {
            float acc[kCands];
#pragma unroll
            for (int c = 0; c < kCands; ++c) acc[c] = 0.0f;
#pragma unroll 4
            for (int e = 0; e <= d; ++e, ++f) {
                const float lv = __ldg(Lk + f * K);
                const float4 *xe =
                    reinterpret_cast<const float4 *>(xsT + e * kCands);
#pragma unroll
                for (int j = 0; j < kCands / 4; ++j) {
                    const float4 xv = xe[j];
                    acc[4 * j] = fmaf(lv, xv.x, acc[4 * j]);
                    acc[4 * j + 1] = fmaf(lv, xv.y, acc[4 * j + 1]);
                    acc[4 * j + 2] = fmaf(lv, xv.z, acc[4 * j + 2]);
                    acc[4 * j + 3] = fmaf(lv, xv.w, acc[4 * j + 3]);
                }
            }
            const float lm = __ldg(g.Lmu + (int64_t)d * K + k);
#pragma unroll
            for (int c = 0; c < kCands; ++c) {
                const float y = acc[c] - lm;
                q[c] = fmaf(y, y, q[c]);
            }
        }
        const float ck = g.ck[k], vh = g.vh[k], vinv = g.vinv[k];
#pragma unroll
        for (int c = 0; c < kCands; ++c)
            if (c < n_live)
                lse_push(run_m[c], run_s[c],
                         wk + student_t(q[c], ck, vh, vinv));
    }

    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int c = 0; c < kCands; ++c) {
        float m = run_m[c], s = run_s[c];
        for (int off = 16; off > 0; off >>= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
            const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
            lse_merge(m, s, m2, s2);
        }
        if (lane == 0) {
            red_m[warp][c] = m;
            red_s[warp][c] = s;
        }
    }
    __syncthreads();
    if (tid < n_c) {
        const int c = tid;
        float v = NEG_INF;
        if (c < n_live) {
            float m = NEG_INF, s = 0.0f;
            for (int i = 0; i < kWarps; ++i) lse_merge(m, s, red_m[i][c], red_s[i][c]);
            v = m == NEG_INF ? NEG_INF : logf(s) + m;
        }
        orow[c] = v;
    }
}

}  // namespace

extern "C" int fullcov_scores_launch(
    const float *Xc, const float *prior_c, const float *gLT,
    const float *gLmuT, const float *gck, const float *gvinv,
    const float *gvh, const float *tL, const float *tLmu, const float *tck,
    const float *tvinv, const float *tvh, const int *tslot, const float *w,
    const int *counts, const int *valid_m, float *out, int B, int M, int D,
    int K, int S, cudaStream_t stream) {
    if (B > 0 && M > 0) {
        dim3 grid((M + kCands - 1) / kCands, B);
        const size_t smem = sizeof(float) * kCands * (D + S);
        fullcov_scores_kernel<<<grid, kThreads, smem, stream>>>(
            Xc, prior_c, Tables{gLT, gLmuT, gck, gvinv, gvh},
            Tables{tL, tLmu, tck, tvinv, tvh}, tslot, w, counts, valid_m,
            out, M, D, K, S);
    }
    return (int)cudaGetLastError();
}
