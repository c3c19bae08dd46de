// Fused fixed-variance candidate scoring (kernel K1).
//
// Replaces the Pallas kernel of segmentalist_tpu/ops/pallas_score.py
// (_fixedvar_dispatch, pallas_call at :185; entry fixedvar_log_margs_T :243):
//
//   out[b, m] = logsumexp_k( w[b, k] + (counts[b, k] > 0
//                  ? c0 + 0.5 log_prod[b, k] - 0.5 maha[b, m, k]
//                  : prior_c[b, m]) )
//   maha[b, m, k] = sum_d (x_d - muT[b, d, k])^2 precT[b, d, k],
//   x = Xc[b, m, :]
//
// The [M, K] logits never reach device memory.  Rows m >= valid_m[b] (past
// the utterance's valid candidate prefix) are written as -inf without
// being scored; every such slot is masked downstream anyway.
//
// The Pallas kernel expands maha into x^2 . prec - 2 x . (mu prec) + const
// to ride the TPU's matrix unit.  In float32 that form cancels badly once
// |x| is a few units (x^2 prec ~ 1e4 against a difference ~ 10), so this
// kernel sums (x - mu)^2 prec directly, in ascending d -- the order of the
// plain PyTorch version, which then agrees with it up to the order of the
// logsumexp over k.
//
// What bounds it on the H100: at the flagship shapes (B = 125, M = 120,
// K = 1000, D = 13) the work is ~0.8 GFLOP, nothing for the card; the cost
// is re-reading each utterance's [D, K] tables (104 KB, L2-resident) once
// per candidate chunk, plus the launch.  This simple design gives each
// block one utterance and kCands candidates, so a table is read M / kCands
// times; threads stride over k (coalesced table reads), keep an online
// logsumexp per candidate in registers, and a block reduction combines
// them.  Plain fp32 arithmetic on the CUDA cores: no tensor cores, so no
// TF32.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCands = 16;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) fixedvar_scores_kernel(
    const float *__restrict__ Xc, const float *__restrict__ prior_c,
    const float *__restrict__ muT, const float *__restrict__ precT,
    const float *__restrict__ log_prod, const float *__restrict__ w,
    const int *__restrict__ counts, const int *__restrict__ valid_m,
    float *__restrict__ out, int M, int D, int K, float c0) {
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
    const float *pT = precT + (int64_t)b * D * K;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const float wk = w[bk + k];
        if (counts[bk + k] > 0) {
            float maha[kCands];
#pragma unroll
            for (int c = 0; c < kCands; ++c) maha[c] = 0.0f;
            for (int d = 0; d < D; ++d) {
                const float mu = mT[(int64_t)d * K + k];
                const float p = pT[(int64_t)d * K + k];
#pragma unroll
                for (int c = 0; c < kCands; ++c) {
                    if (c < n_live) {
                        const float dl = xs[c * D + d] - mu;
                        maha[c] += dl * dl * p;
                    }
                }
            }
            const float base = c0 + 0.5f * log_prod[bk + k];
#pragma unroll
            for (int c = 0; c < kCands; ++c) {
                if (c < n_live)
                    lse_push(run_m[c], run_s[c], wk + (base - 0.5f * maha[c]));
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

extern "C" int fixedvar_scores_launch(
    const float *Xc, const float *prior_c, const float *muT,
    const float *precT, const float *log_prod, const float *w,
    const int *counts, const int *valid_m, float *out, int B, int M, int D,
    int K, float c0, cudaStream_t stream) {
    if (B > 0 && M > 0) {
        dim3 grid((M + kCands - 1) / kCands, B);
        const size_t smem = sizeof(float) * kCands * D;
        fixedvar_scores_kernel<<<grid, kThreads, smem, stream>>>(
            Xc, prior_c, muT, precT, log_prod, w, counts, valid_m, out, M, D,
            K, c0);
    }
    return (int)cudaGetLastError();
}
