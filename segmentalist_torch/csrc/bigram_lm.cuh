// The bigram-LM mixture weights of the bigram assignment chains: K4
// (fixedvar_chain.cu) and K7 (diag_chain.cu) compute them with these
// functions, so the two cannot drift apart.
//
//   w[k] = j_prev < 0 ? lms (log(uni[k] + a/K) - log(n_uni + a))
//          : lms log(lam (uni[k] + a/K) / (n_uni + a)
//                    + (1 - lam) ((big[j_prev, k] - corr[k]) + b/K)
//                      / (uni[j_prev] + b))
//
// uni [B, K] are the leave-out unigram counts (n_uni their sum), big [K, K]
// the global bigram table, corr[k] the number of the utterance's own OLD
// pairs (j_prev, k) (the reference strips the utterance's LM counts before
// sampling it) and j_prev the previous valid segment's draw
// (segmentalist_tpu/ops/pallas_chain.py:463-555, :1176-1197).  The operation
// order is that of the plain versions (ops/cuda_chain.py).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Inputs and constants of the bigram-LM weights.  The constants are float32
// values rounded once on the host, exactly those the plain versions use
// (ops/cuda_chain.py::bigram_constants).
struct BigramLM {
    const int *uni;     // [B, K] leave-out unigram counts
    const int *big;     // [K, K] global bigram counts
    const int *corr_j;  // [B, S] the utterance's old pairs: previous id
    const int *corr_i;  // [B, S] the utterance's old pairs: current id
    float a_over_K, a, b_over_K, b, lam, one_minus_lam;
};

// Collects into succ the current ids of the utterance's old pairs
// (j_prev, .), counting them in *n_succ (zero on entry).  Block-wide; the
// caller synchronises before reading succ.
__device__ __forceinline__ void bigram_successors(const int *cj,
                                                  const int *ci, int S,
                                                  int j_prev, int *succ,
                                                  int *n_succ) {
    for (int s2 = threadIdx.x; s2 < S; s2 += blockDim.x) {
        if (cj[s2] == j_prev && ci[s2] >= 0) succ[atomicAdd(n_succ, 1)] = ci[s2];
    }
}

// The weight of slot k.  u = uni[k]; brow = row j_prev of big (unused when
// j_prev < 0); succ / n_succ from bigram_successors; uni_den = n_uni + a and
// log_uni_den its log; uni_j = uni[j_prev].
__device__ __forceinline__ float bigram_weight(const BigramLM &lm, float u,
                                               int k, int j_prev,
                                               const int *brow,
                                               const int *succ, int n_succ,
                                               float uni_den,
                                               float log_uni_den, float uni_j,
                                               float lms) {
    if (j_prev >= 0) {
        int corr = 0;
        for (int m = 0; m < n_succ; ++m) corr += succ[m] == k;
        const float rowk = (float)(brow[k] - corr);
        const float p = lm.lam * ((u + lm.a_over_K) / uni_den)
                        + (lm.one_minus_lam * (rowk + lm.b_over_K))
                              / (uni_j + lm.b);
        return lms * logf(p);
    }
    return lms * (logf(u + lm.a_over_K) - log_uni_den);
}
