// Segmentation-DP forward filter (kernel K2).
//
// Replaces the Pallas kernel of segmentalist_tpu/ops/pallas_dp.py
// (_forward_kernel :40, pallas_call :122, entry forward_alphas :98):
//
//   alpha[0] = 0
//   alpha[t] = logsumexp_j( rev[t-1, j] + alpha[t-W+j] ) + lpc   (sample)
//   alpha[t] = max_j( rev[t-1, j] + alpha[t-W+j] )               (viterbi)
//
// for t = 1 .. N-1, -inf for t >= length; out[b] = [W x -inf, alpha[0..N-1]].
// The -inf guard of the Pallas kernel (pallas_dp.py:54-60) is kept: an
// all -inf window gives -inf, never NaN.
//
// What bounds it on the H100: the recursion is sequential in t, so the cost
// is N dependent steps of W loads + W exps, a few microseconds at the
// flagship shapes (N = 20, W = 6, B = 125); the launch dominates.  This
// simple design runs one thread per utterance and sums the window in
// ascending j, the order of the plain PyTorch version; the window is read
// back from the thread's own output row (L1-resident).

#include <cstdint>

#include "common.cuh"

namespace {

__global__ void forward_alphas_kernel(const float *__restrict__ rev,
                                      const int *__restrict__ lengths,
                                      const float *__restrict__ lpc_ptr,
                                      float *__restrict__ out, int B, int N,
                                      int W, int use_max) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    float *a = out + (int64_t)b * (W + N);
    const float *sc = rev + (int64_t)b * N * W;
    for (int j = 0; j < W; ++j) a[j] = NEG_INF;
    a[W] = 0.0f;
    const int len = lengths[b];
    const float lpc = *lpc_ptr;
    for (int t = 1; t < N; ++t) {
        const float *row = sc + (int64_t)(t - 1) * W;
        const float *win = a + t;  // alpha[t-W .. t-1]
        float mx = NEG_INF;
        for (int j = 0; j < W; ++j) mx = fmaxf(mx, row[j] + win[j]);
        float val;
        if (use_max) {
            val = mx;
        } else if (mx == NEG_INF) {
            val = NEG_INF;
        } else {
            float s = 0.0f;
            for (int j = 0; j < W; ++j) s += expf((row[j] + win[j]) - mx);
            val = (logf(s) + mx) + lpc;
        }
        a[W + t] = t < len ? val : NEG_INF;
    }
}

}  // namespace

extern "C" int forward_alphas_launch(const float *rev, const int *lengths,
                                     const float *lpc, float *out, int B,
                                     int N, int W, int use_max,
                                     cudaStream_t stream) {
    if (B > 0) {
        const int threads = 128;
        forward_alphas_kernel<<<(B + threads - 1) / threads, threads, 0,
                                stream>>>(rev, lengths, lpc, out, B, N, W,
                                          use_max);
    }
    return (int)cudaGetLastError();
}
