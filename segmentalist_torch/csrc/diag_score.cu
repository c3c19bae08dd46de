// Fused diagonal-covariance candidate scoring (kernel K5).
//
// Replaces the Pallas kernel of segmentalist_tpu/ops/pallas_score.py
// (_diag_dispatch, pallas_call at :352; entries diag_log_margs :380 and
// diag_log_margs_T :406):
//
//   out[b, m] = logsumexp_k( w[b, k] + (counts[b, k] > 0
//                  ? cst[b, k] - vh[b, k] acc[b, m, k]
//                  : prior_c[b, m]) )
//
// the product-of-Student-t predictive with its count-dependent constants
// (cst = D (lgamma((v+1)/2) - lgamma(v/2) - log(v)/2 - log(pi)/2)
// - log_prod_var / 2, vh = (v+1)/2) formed outside the kernel, and
// r_d = (x_d - muT[b, d, k])^2 ivvT[b, d, k], ivvT = inv_var / v, in one of
// two compositions of acc (template flag kExact):
//
//   grouped (FFBS):   acc = sum_{g = 0, 4, 8, ...} log( prod_{d = g}^{g+3} (1 + r_d) )
//                     -- the TPU kernel's contiguous 4-dim groups, each
//                     product in ascending d, groups summed in order;
//   exact (Viterbi):  acc = sum_d log1p(r_d), ascending d -- the composition
//                     of components_diag._log_prod_students_t, for the
//                     deterministic argmax DP that must not see the
//                     grouped form's rounding.
//
// The [M, K] logits never reach device memory, and rows m >= valid_m[b]
// (past the utterance's candidate prefix) are written as -inf unscored.
//
// What bounds it on the H100: at the flagship shapes (B = 125, M = 120,
// K = 1000, D = 13) the work is ~0.2 G (m, k, d) terms, at N_max = 120 and
// D = 130 ~12 G: arithmetic (5 flops a term) and transcendentals (one log a
// group, or one log1p a term in the exact form) on the CUDA cores, with the
// per-utterance [D, K] tables (L2-resident at D = 13) re-read once per
// candidate chunk.  As K1 (fixedvar_score.cu): one block per (utterance,
// chunk of kCands candidates), threads striding over k (coalesced table
// reads), an online logsumexp per candidate in registers and a block
// reduction.  Plain fp32, no tensor cores.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCands = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // dims per log in the grouped composition

template <bool kExact>
__global__ void __launch_bounds__(kThreads) diag_scores_kernel(
    const float *__restrict__ Xc, const float *__restrict__ prior_c,
    const float *__restrict__ muT, const float *__restrict__ ivvT,
    const float *__restrict__ cst, const float *__restrict__ vh,
    const float *__restrict__ w, const int *__restrict__ counts,
    const int *__restrict__ valid_m, float *__restrict__ out, int M, int D,
    int K) {
    extern __shared__ float xs[];  // [kCands, D] candidate vectors
    __shared__ float red_m[kWarps][kCands];
    __shared__ float red_s[kWarps][kCands];

    const int b = blockIdx.y;
    const int m0 = blockIdx.x * kCands;
    const int n_c = min(kCands, M - m0);
    const int vm = valid_m ? min(valid_m[b], M) : M;
    const int n_live = max(0, min(n_c, vm - m0));
    float *orow = out + (int64_t)b * M + m0;
    if (n_live == 0) {
        for (int c = threadIdx.x; c < n_c; c += blockDim.x) orow[c] = NEG_INF;
        return;
    }

    const float *xrow = Xc + ((int64_t)b * M + m0) * D;
    for (int i = threadIdx.x; i < n_live * D; i += blockDim.x) xs[i] = xrow[i];
    __syncthreads();

    float pc[kCands], run_m[kCands], run_s[kCands];
#pragma unroll
    for (int c = 0; c < kCands; ++c) {
        pc[c] = c < n_live ? prior_c[(int64_t)b * M + m0 + c] : 0.0f;
        run_m[c] = NEG_INF;
        run_s[c] = 0.0f;
    }

    const int64_t bk = (int64_t)b * K;
    const float *mT = muT + (int64_t)b * D * K;
    const float *iT = ivvT + (int64_t)b * D * K;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const float wk = w[bk + k];
        if (counts[bk + k] > 0) {
            float acc[kCands], prod[kCands];
#pragma unroll
            for (int c = 0; c < kCands; ++c) {
                acc[c] = 0.0f;
                prod[c] = 1.0f;
            }
            for (int d = 0; d < D; ++d) {
                const float mu = mT[(int64_t)d * K + k];
                const float ivv = iT[(int64_t)d * K + k];
                const bool close = !kExact && (d % kGroup == kGroup - 1
                                               || d == D - 1);
#pragma unroll
                for (int c = 0; c < kCands; ++c) {
                    if (c < n_live) {
                        const float dl = xs[c * D + d] - mu;
                        const float r = dl * dl * ivv;
                        if (kExact) {
                            acc[c] += log1pf(r);
                        } else {
                            prod[c] = prod[c] * (1.0f + r);
                            if (close) {
                                acc[c] += logf(prod[c]);
                                prod[c] = 1.0f;
                            }
                        }
                    }
                }
            }
            const float ck = cst[bk + k], vk = vh[bk + k];
#pragma unroll
            for (int c = 0; c < kCands; ++c) {
                if (c < n_live)
                    lse_push(run_m[c], run_s[c], wk + (ck - vk * acc[c]));
            }
        } else {
#pragma unroll
            for (int c = 0; c < kCands; ++c)
                if (c < n_live) lse_push(run_m[c], run_s[c], wk + pc[c]);
        }
    }

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
    if (threadIdx.x < n_c) {
        const int c = threadIdx.x;
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

extern "C" int diag_scores_launch(
    const float *Xc, const float *prior_c, const float *muT,
    const float *ivvT, const float *cst, const float *vh, const float *w,
    const int *counts, const int *valid_m, float *out, int B, int M, int D,
    int K, int exact, cudaStream_t stream) {
    if (B > 0 && M > 0) {
        dim3 grid((M + kCands - 1) / kCands, B);
        const size_t smem = sizeof(float) * kCands * D;
        if (exact)
            diag_scores_kernel<true><<<grid, kThreads, smem, stream>>>(
                Xc, prior_c, muT, ivvT, cst, vh, w, counts, valid_m, out, M,
                D, K);
        else
            diag_scores_kernel<false><<<grid, kThreads, smem, stream>>>(
                Xc, prior_c, muT, ivvT, cst, vh, w, counts, valid_m, out, M,
                D, K);
    }
    return (int)cudaGetLastError();
}
