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
// D 130) against a few MB of inputs; the factor table LT is 34 MB at D 130.
// The design makes each loaded factor value feed many rows and keeps the
// warps on one kind of column:
//
// - One block per (utterance, tile of 8 x warps candidate rows); a warp
//   owns 8 rows for the whole kernel.  The tile's rows are staged in shared
//   memory transposed ([D][rows]), so two 16-byte broadcast loads give a
//   warp's 8 rows of one feature.
// - The three kinds of column are separated once a block.  Empty columns
//   (counts <= 0) contribute w[k] + prior_c[m]: their weights are folded
//   into one logsumexp E (every warp reduces a share of K, then merges the
//   warps' partials in a fixed order), so a row starts from (prior_c + E).
//   Touched columns (counts > 0, a touched slot) and global ones (counts >
//   0, no slot) go into two ascending lists that warp 0 compacts with
//   ballots.  Each list is then scored by the same register tile, 128
//   entries a pass: a lane takes 4 consecutive entries, so a thread holds
//   8 rows x 4 components of L x - Lmu (32 accumulators) and of the
//   squared sum, and each factor value it reads feeds 8 rows.  The pass's
//   packed factor lanes (never the upper triangle) go through a ring of
//   three 16-lane chunks in shared memory, every thread of the block
//   loading a share with cp.async while the warps work on the chunk
//   before: one barrier a chunk, and each factor value crosses the memory
//   system once a block of 32 / 64 rows.  Global columns read LT [F, K] at
//   a stride of K, touched ones their slot's packed row [F] at a stride of
//   1; Lmu of the next factor row is loaded while the current one runs.
// - Each thread keeps an online logsumexp of its 8 rows in registers; a
//   warp merges its lanes' states with shuffles in a fixed order and lane 0
//   writes the rows.  No atomics: the result does not depend on timing.
// - CUDA cores, full float32: explicit fmaf (-fmad=false keeps every other
//   product and sum rounded on its own).
//
// The launch plan (ops/cuda_fullcov_score.py::launch_plan) takes 64 rows a
// block, or 32 where the shared memory (the ring, the rows, both lists and
// the warps' partials) of 64 would exceed the card's opt-in limit.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRowsPerWarp = 8;
constexpr int kCompsPerLane = 4;
constexpr int kPass = 32 * kCompsPerLane;  // list entries a pass
constexpr int kChunkF = 16;  // packed lanes a staged chunk
constexpr int kStages = 3;
constexpr int kMaxWarps = 8;  // 64 rows: the register tile needs ~150 registers

struct Tables {
    const float *L, *Lmu, *ck, *vinv, *vh;
};

// Dynamic shared memory of a block, in 4-byte words, in the kernel's
// carving order: the factor ring [stages][kChunkF][kPass], the rows
// [D][rows], the global and touched column lists [K] each and the per-warp
// partial logsumexps of the empty columns [2][warps].
__host__ __device__ inline int64_t smem_words(int D, int K, int rows) {
    return (int64_t)D * rows + 2LL * K + 2LL * (rows / kRowsPerWarp)
           + (int64_t)kStages * kChunkF * kPass;
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

__device__ __forceinline__ float student_t(float maha, float ck, float vh,
                                           float vinv) {
    return ck - vh * log1pf(maha * vinv);
}

// Scores list[0 .. n) for the block's rows and pushes w[k] + score into
// each live warp's per-row logsumexp states.  kTouched: the component of
// entry k is its touched slot tslot[k] (tables t, packed row of stride 1);
// else k itself (tables g, LT at stride K).  A pass takes 128 entries (4 a
// lane); its packed factor lanes go through the ring in chunks of 16,
// every thread of the block loading a share with cp.async, one barrier a
// chunk.  The whole block runs every pass (n is block-uniform).
template <bool kTouched>
__device__ __forceinline__ void score_list(
    const int *list, int n, const Tables &tab, const int *tslot,
    const float *w, int64_t slot0, int K, int D, const float *xsT,
    float *ring, int rows, int r0, bool live,
    float (&rm)[kRowsPerWarp], float (&rs)[kRowsPerWarp]) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int F = D * (D + 1) / 2;
    const int64_t sf = kTouched ? 1 : K;  // stride between packed lanes
    const int nch = (F + kChunkF - 1) / kChunkF;
    const int jj = tid & (kPass - 1);        // the entry this thread loads
    const int fr0 = tid / kPass, fstep = blockDim.x / kPass;
    for (int j0 = 0; j0 < n; j0 += kPass) {
        const bool lok = j0 + jj < n;
        int64_t lbase = 0;
        if (lok) {
            const int k = list[j0 + jj];
            lbase = kTouched ? (slot0 + tslot[k]) * F : (int64_t)k;
        }
        auto issue = [&](int ch) {
            float *dst = ring + (ch % kStages) * (kChunkF * kPass) + jj;
            const int f0 = ch * kChunkF;
            if (lok)
                for (int fr = fr0; fr < kChunkF && f0 + fr < F; fr += fstep)
                    cp_async4(dst + fr * kPass,
                              tab.L + lbase + (int64_t)(f0 + fr) * sf);
            cp_async_commit();
        };
        issue(0);
        if (nch > 1) issue(1);

        int64_t ci[kCompsPerLane];  // each component's table row
        int kk[kCompsPerLane];
        bool ok[kCompsPerLane];
        float lm[kCompsPerLane];  // Lmu of the current factor row
#pragma unroll
        for (int c = 0; c < kCompsPerLane; ++c) {
            const int j = j0 + lane * kCompsPerLane + c;
            ok[c] = live && j < n;
            kk[c] = ok[c] ? list[j] : 0;
            ci[c] = kTouched ? slot0 + (ok[c] ? tslot[kk[c]] : 0)
                             : (int64_t)kk[c];
        }
        auto load_lm = [&](int d) {
#pragma unroll
            for (int c = 0; c < kCompsPerLane; ++c)
                lm[c] = !ok[c] ? 0.0f
                        : kTouched ? __ldg(tab.Lmu + ci[c] * D + d)
                                   : __ldg(tab.Lmu + (int64_t)d * K + ci[c]);
        };
        load_lm(0);
        float q[kRowsPerWarp][kCompsPerLane], acc[kRowsPerWarp][kCompsPerLane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
            for (int c = 0; c < kCompsPerLane; ++c) q[i][c] = acc[i][c] = 0.0f;
        int d = 0, e = 0;  // the factor row and lane of the next packed lane
        for (int ch = 0; ch < nch; ++ch) {
            if (ch + 1 < nch)
                cp_async_wait<1>();
            else
                cp_async_wait<0>();
            __syncthreads();  // chunk ch is in; chunk ch - 1 is read
            if (ch + 2 < nch) issue(ch + 2);
            if (!live) continue;
            const float *Lc = ring + (ch % kStages) * (kChunkF * kPass)
                              + lane * kCompsPerLane;
            const int fc = min(kChunkF, F - ch * kChunkF);
            for (int fr = 0; fr < fc; ++fr) {
                const float4 l4 =
                    *reinterpret_cast<const float4 *>(Lc + fr * kPass);
                const float l[kCompsPerLane] = {l4.x, l4.y, l4.z, l4.w};
                const float4 *xe =
                    reinterpret_cast<const float4 *>(xsT + e * rows + r0);
                const float4 xa = xe[0], xb = xe[1];
                const float xv[kRowsPerWarp] = {xa.x, xa.y, xa.z, xa.w,
                                                xb.x, xb.y, xb.z, xb.w};
#pragma unroll
                for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
                    for (int c = 0; c < kCompsPerLane; ++c)
                        acc[i][c] = fmaf(l[c], xv[i], acc[i][c]);
                if (++e > d) {  // factor row d is complete
#pragma unroll
                    for (int c = 0; c < kCompsPerLane; ++c)
#pragma unroll
                        for (int i = 0; i < kRowsPerWarp; ++i) {
                            const float y = acc[i][c] - lm[c];
                            q[i][c] = fmaf(y, y, q[i][c]);
                            acc[i][c] = 0.0f;
                        }
                    e = 0;
                    if (++d < D) load_lm(d);
                }
            }
        }
        __syncthreads();  // the ring is free for the next pass
#pragma unroll
        for (int c = 0; c < kCompsPerLane; ++c) {
            if (!ok[c]) continue;
            const float ck = tab.ck[ci[c]], vh = tab.vh[ci[c]];
            const float vinv = tab.vinv[ci[c]];
            const float wk = w[kk[c]];
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i)
                lse_push(rm[i], rs[i], wk + student_t(q[i][c], ck, vh, vinv));
        }
    }
}

__global__ void __launch_bounds__(kMaxWarps * 32) fullcov_scores_kernel(
    const float *__restrict__ Xc, const float *__restrict__ prior_c,
    Tables g, Tables t, const int *__restrict__ tslot,
    const float *__restrict__ w, const int *__restrict__ counts,
    const int *__restrict__ valid_m, float *__restrict__ out, int M, int D,
    int K, int S) {
    extern __shared__ __align__(16) float sh[];
    __shared__ int s_ng, s_nt;

    const int rows = blockDim.x / 32 * kRowsPerWarp;
    const int nw = blockDim.x / 32;
    const int b = blockIdx.y;
    const int m0 = blockIdx.x * rows;
    const int n_c = min(rows, M - m0);
    const int vm = valid_m ? min(valid_m[b], M) : M;
    const int n_live = max(0, min(n_c, vm - m0));
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float *orow = out + (int64_t)b * M + m0;
    if (n_live == 0) {
        for (int c = tid; c < n_c; c += blockDim.x) orow[c] = NEG_INF;
        return;
    }
    float *ring = sh;                          // [stages][kChunkF][kPass]
    float *xsT = ring + kStages * kChunkF * kPass;         // [D][rows]
    int *glist = reinterpret_cast<int *>(xsT + D * rows);  // [K]
    int *tlist = glist + K;                                // [K]
    float *part_m = reinterpret_cast<float *>(tlist + K);  // [warps]
    float *part_s = part_m + nw;
    const int64_t bK = (int64_t)b * K;
    const int *cnt = counts + bK;
    const int *ts = tslot + bK;
    const float *wb = w + bK;

    const float *xrow = Xc + ((int64_t)b * M + m0) * D;
    for (int i = tid; i < D * rows; i += blockDim.x) {
        const int e = i / rows, c = i - e * rows;
        xsT[i] = c < n_live ? xrow[(int64_t)c * D + e] : 0.0f;
    }
    if (warp == 0) {
        // The ascending lists of global and touched active columns.
        int ng = 0, nt = 0;
        for (int k0 = 0; k0 < K; k0 += 32) {
            const int k = k0 + lane;
            const bool act = k < K && cnt[k] > 0;
            const bool tch = act && ts[k] >= 0;
            const unsigned below = (1u << lane) - 1u;
            const unsigned mg = __ballot_sync(0xffffffffu, act && !tch);
            const unsigned mt = __ballot_sync(0xffffffffu, tch);
            if (act && !tch) glist[ng + __popc(mg & below)] = k;
            if (tch) tlist[nt + __popc(mt & below)] = k;
            ng += __popc(mg);
            nt += __popc(mt);
        }
        if (lane == 0) {
            s_ng = ng;
            s_nt = nt;
        }
    }
    // The empty columns' weights: every warp a share of K.
    {
        float em = NEG_INF, es = 0.0f;
        for (int k = tid; k < K; k += blockDim.x)
            if (cnt[k] <= 0) lse_push(em, es, wb[k]);
        for (int o = 16; o > 0; o >>= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, em, o);
            const float s2 = __shfl_xor_sync(0xffffffffu, es, o);
            lse_merge(em, es, m2, s2);
        }
        if (lane == 0) {
            part_m[warp] = em;
            part_s[warp] = es;
        }
    }
    __syncthreads();

    const int r0 = warp * kRowsPerWarp;
    const bool live = r0 < n_live;  // dead warps still load and sync
    // Lane 0 starts its rows from the empty columns' term, the other lanes
    // from nothing (the warp merges all lanes' states at the end).
    float em = NEG_INF, es = 0.0f;
    if (lane == 0)
        for (int i = 0; i < nw; ++i) lse_merge(em, es, part_m[i], part_s[i]);
    float rm[kRowsPerWarp], rs[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pc = r0 + i < n_live ? prior_c[(int64_t)b * M + m0 + r0 + i]
                                         : 0.0f;
        rm[i] = em == NEG_INF ? NEG_INF : pc + em;
        rs[i] = em == NEG_INF ? 0.0f : es;
    }
    score_list<true>(tlist, s_nt, t, ts, wb, (int64_t)b * S, K, D, xsT, ring,
                     rows, r0, live, rm, rs);
    score_list<false>(glist, s_ng, g, ts, wb, 0, K, D, xsT, ring, rows, r0,
                      live, rm, rs);
    if (!live) {  // rows past valid_m only
        if (lane < kRowsPerWarp && r0 + lane < n_c) orow[r0 + lane] = NEG_INF;
        return;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        float m = rm[i], s = rs[i];
        for (int o = 16; o > 0; o >>= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
            const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
            lse_merge(m, s, m2, s2);
        }
        rm[i] = m;
        rs[i] = s;
    }
    if (lane < kRowsPerWarp) {
        float v = NEG_INF;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
            if (i == lane) v = rm[i] == NEG_INF ? NEG_INF : logf(rs[i]) + rm[i];
        const int c = r0 + lane;
        if (c < n_c) orow[c] = c < n_live ? v : NEG_INF;
    }
}

}  // namespace

extern "C" int fullcov_scores_launch(
    const float *Xc, const float *prior_c, const float *gLT,
    const float *gLmuT, const float *gck, const float *gvinv,
    const float *gvh, const float *tL, const float *tLmu, const float *tck,
    const float *tvinv, const float *tvh, const int *tslot, const float *w,
    const int *counts, const int *valid_m, float *out, int B, int M, int D,
    int K, int S, int rows, cudaStream_t stream) {
    if (rows != 32 && rows != 64)  // 128 or 256 threads: whole passes
        return (int)cudaErrorInvalidValue;
    if (B == 0 || M == 0) return (int)cudaGetLastError();
    const int smem = (int)(4 * smem_words(D, K, rows));
    static int allowed = -1;
    if (smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            fullcov_scores_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        allowed = smem;
    }
    dim3 grid((M + rows - 1) / rows, B);
    fullcov_scores_kernel<<<grid, rows / kRowsPerWarp * 32, smem, stream>>>(
        Xc, prior_c, Tables{gLT, gLmuT, gck, gvinv, gvh},
        Tables{tL, tLmu, tck, tvinv, tvh}, tslot, w, counts, valid_m, out, M,
        D, K, S);
    return (int)cudaGetLastError();
}

// The dynamic shared memory, in bytes, of a block of `rows` candidate rows
// (the launch plan's smem_bytes must give exactly this).
extern "C" long long fullcov_scores_smem_bytes(int D, int K, int rows) {
    return 4 * smem_words(D, K, rows);
}

// The dynamic shared memory a block of the kernel may take on the current
// device: its opt-in limit less the kernel's static shared memory; minus a
// CUDA error code on error.
extern "C" int fullcov_scores_smem_limit() {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes at;
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(&at, fullcov_scores_kernel);
    return err == cudaSuccess ? optin - (int)at.sharedSizeBytes : -(int)err;
}
