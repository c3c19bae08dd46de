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
// cst = D (lgamma((v+1)/2) - lgamma(v/2) - log(v)/2 - log(pi)/2)
// - log_prod_var / 2 and vh = (v+1)/2, and r_d = (x_d - muT[b, d, k])^2
// ivv[b, d, k], ivv = inv_varT / v, in one of two compositions of acc
// (policy flag kExact):
//
//   grouped (FFBS):   acc = sum_{g = 0, 4, 8, ...} log( prod_{d = g}^{g+3} (1 + r_d) )
//                     -- the TPU kernel's contiguous 4-dim groups, each
//                     product in ascending d, groups summed in order;
//   exact (Viterbi):  acc = sum_d log1p(r_d), ascending d -- the composition
//                     of components_diag._log_prod_students_t, for the
//                     deterministic argmax DP that must not see the
//                     grouped form's rounding.
//
// The scorer is diag_family_score.cuh's (its notes say what bounds it and
// how the design meets that); this policy is its Student-t fold.  The
// kernel forms its own tables from the predictive parameters: ivv as each
// staged inv_var is stored (an IEEE division, div_rn, so r has the plain
// version's bits), cst and vh once a pass for the pass's columns.

#include "diag_family_score.cuh"

namespace {

using diag_family::kPass;

constexpr float kHalfLogPi = 0.57236494292470008f;

// cst of a column with v degrees of freedom; out of line, so that the
// lgamma code's registers do not press on the scoring loop's (it runs once
// a column a pass, on one thread of the column's two).
__device__ __noinline__ float student_t_cst(float v, float lpv, float D) {
    return D * (lgammaf((v + 1.0f) / 2.0f) - lgammaf(v / 2.0f)
                - 0.5f * logf(v) - kHalfLogPi)
           - 0.5f * lpv;
}

template <bool kExact>
struct Diag {
    const float *v, *lpv;  // [B, K] degrees of freedom, log prod var
    float D;
    struct Col {
        float v, lpv;
    };

    __device__ Col load_col(int64_t bk, bool ok) const {
        return ok ? Col{v[bk], lpv[bk]} : Col{1.0f, 0.0f};
    }

    __device__ float stage(float inv_var, const Col &col, float &) const {
        return div_rn(inv_var, col.v);
    }

    // slots 1, 2: cst, vh
    __device__ void consts(const Col &col, float, int h, float *c) const {
        if (h != 0) return;
        c[kPass] = student_t_cst(col.v, col.lpv, D);
        c[2 * kPass] = (col.v + 1.0f) / 2.0f;
    }

    __device__ float post(float acc, const float *c) const {
        return c[kPass] - c[2 * kPass] * acc;
    }

    static __device__ __forceinline__ void term(float &acc, float &prod,
                                                float dl, float ivv,
                                                bool first, bool close) {
        const float r = dl * dl * ivv;
        if (kExact) {
            acc = acc + log1pf(r);
        } else {
            prod = (first ? 1.0f : prod) * (1.0f + r);
            if (close) acc = acc + logf(prod);
        }
    }

    // closes a group that D ends before its 4th dim
    static __device__ __forceinline__ void close(float &acc, float &prod) {
        if (!kExact) acc = acc + logf(prod);
    }
};

}  // namespace

extern "C" int diag_scores_launch(
    const float *Xc, const float *prior_c, const float *muT,
    const float *inv_varT, const float *lpv, const float *v, const float *w,
    const int *counts, const int *valid_m, float *out, int B, int M, int D,
    int K, int exact, cudaStream_t stream) {
    if (exact)
        return diag_family::launch(Diag<true>{v, lpv, (float)D}, Xc, prior_c,
                                   muT, inv_varT, w, counts, valid_m, out, B,
                                   M, D, K, stream);
    return diag_family::launch(Diag<false>{v, lpv, (float)D}, Xc, prior_c,
                               muT, inv_varT, w, counts, valid_m, out, B, M,
                               D, K, stream);
}
