// The candidate scorer shared by the fixed-variance (K1, fixedvar_score.cu)
// and diagonal-covariance (K5, diag_score.cu) families.
//
//   out[b, m] = logsumexp_k( w[b, k] + (counts[b, k] > 0
//                  ? post(acc[b, m, k], k) : prior_c[b, m]) )
//   acc[b, m, k] = the policy's fold over d = 0 .. D-1, ascending, of
//                  dl = x_d - t0[b, d, k] and t1[b, d, k], x = Xc[b, m, :]
//
// A policy P names the fold (P::term), what a staged t1 value becomes
// (P::stage: K1 keeps the precision and sums its log, K5 divides inv_var by
// v), the per-column constants of a pass (P::consts) and the epilogue
// (P::post).  Rows m >= valid_m[b] come back -inf unscored.
//
// What bounds it on the H100: arithmetic, 4-5 float32 operations a (row,
// active column, feature) term plus K5's logs, against a few MB of inputs.
// The design makes each loaded table value feed 8 rows and each row value
// 4 columns, and keeps the warps on active columns only:
//
// - One block per (utterance, tile of 64 candidate rows), 8 warps; a warp
//   owns 8 rows for the whole kernel.  The rows are staged in shared memory
//   transposed ([D][rows]), so two 16-byte broadcast loads give a warp's 8
//   rows of one feature.
// - Empty columns (counts <= 0) contribute w[k] + prior_c[m]: their weights
//   are folded into one logsumexp E (every thread a share of K, the warps'
//   partials merged in a fixed order), which lane 0 of each warp merges
//   into its rows as prior_c + E.  The active columns are compacted, in
//   windows of 8 x threads columns, into one ascending list (ballots: each
//   warp counts its segment, then writes after the warps before it; the
//   same loads give E).
// - The list is scored 128 entries a pass: a lane takes 4 consecutive
//   entries and holds 8 rows x 4 columns of accumulators (K5's grouped
//   form 8 x 4 more for the open products).  A pass's t0 / t1 columns go
//   through two shared buffers in chunks of 16 features: every thread
//   starts cp.async copies of its share of chunk s + 1 while the warps work
//   on chunk s, then waits for its own copies and transforms its t1 values
//   in place (P::stage: no registers hold a chunk in flight); one barrier a
//   chunk.  Each table value crosses the memory system once a block of 64
//   rows, and the stream runs across passes, so a D of one chunk overlaps
//   too.
// - Each thread keeps an online logsumexp of its 8 rows; a warp merges its
//   lanes' states with shuffles in a fixed order and one lane writes each
//   row.  No atomics: the result does not depend on timing.
// - Exactness: each (row, column) accumulator takes the plain version's
//   operations in its order (the build's -fmad=false keeps every product
//   rounded, as torch's elementwise kernels do), so only the order of the
//   logsumexp over K and the per-column constants differ from it.
//
// The launch plan (ops/cuda_score.py::launch_plan) checks that a block's
// shared memory fits the card's opt-in limit: on the H100 it does up to D
// 512, the widest rows the wrappers take.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace diag_family {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // candidate rows a block
constexpr int kCompsPerLane = 4;
constexpr int kPass = 32 * kCompsPerLane;  // list entries a pass
constexpr int kChunk = 16;                 // features a staged chunk
constexpr int kGroup = 4;                  // K5 grouped: dims per log
constexpr int kConsts = 3;                 // per-column constants a pass
constexpr int kSegPerLane = 8;             // compaction: columns a lane
constexpr int kWin = kThreads * kSegPerLane;  // columns compacted at a time
constexpr int kPhases = kThreads / kPass;  // threads staging a column
static_assert(kPhases == 2, "P::consts fills slots 1 and 2 from 2 phases");

// Dynamic shared memory of a block, in 4-byte words, in the kernel's
// carving order: the table ring [2 buffers][2 tables][kChunk][kPass], the
// per-column constants [2 passes][kConsts][kPass], the rows [D][kRows], the
// list [min(K, kWin)] and the warps' partial logsumexps of the empty
// columns [2][kWarps].
__host__ __device__ inline int64_t smem_words(int D, int K) {
    return 2LL * 2 * kChunk * kPass + 2LL * kConsts * kPass
           + (int64_t)D * kRows + (K < kWin ? K : kWin) + 2LL * kWarps;
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

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// At least 16 warps an SM (128 registers a thread): K5's grouped form
// would take ~160 and one block of 8 warps an SM.
template <class P>
__global__ void __launch_bounds__(kThreads, 2) scores_kernel(
    P pol, const float *__restrict__ Xc, const float *__restrict__ prior_c,
    const float *__restrict__ t0, const float *__restrict__ t1,
    const float *__restrict__ w, const int *__restrict__ counts,
    const int *__restrict__ valid_m, float *__restrict__ out, int M, int D,
    int K) {
    constexpr int kStage = kChunk / kPhases;   // features a thread stages
    constexpr int kBuf = 2 * kChunk * kPass;   // one ring buffer, 2 tables
    extern __shared__ __align__(16) float sh[];
    __shared__ int s_wcount[kWarps];

    const int b = blockIdx.y;
    const int m0 = blockIdx.x * kRows;
    const int n_c = min(kRows, M - m0);
    const int vm = valid_m ? min(valid_m[b], M) : M;
    const int n_live = max(0, min(n_c, vm - m0));
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float *orow = out + (int64_t)b * M + m0;
    if (n_live == 0) {
        for (int c = tid; c < n_c; c += kThreads) orow[c] = NEG_INF;
        return;
    }
    float *ring = sh;                                // [2][2][kChunk][kPass]
    float *cc = ring + 2 * kBuf;                     // [2][kConsts][kPass]
    float *xsT = cc + 2 * kConsts * kPass;           // [D][kRows]
    int *list = reinterpret_cast<int *>(xsT + D * kRows);  // [min(K, kWin)]
    float *part_m = reinterpret_cast<float *>(list + min(K, kWin));
    float *part_s = part_m + kWarps;
    const int64_t bK = (int64_t)b * K;
    const int *cnt = counts + bK;
    const float *wb = w + bK;
    const float *t0b = t0 + bK * D, *t1b = t1 + bK * D;

    {  // the rows, transposed; 4 loads a thread in flight
        const float *xrow = Xc + ((int64_t)b * M + m0) * D;
        for (int i0 = tid; i0 < D * kRows; i0 += 4 * kThreads) {
            float v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int i = i0 + u * kThreads, e = i / kRows;
                const int c = i - e * kRows;
                v[u] = i < D * kRows && c < n_live ? xrow[(int64_t)c * D + e]
                                                   : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (i0 + u * kThreads < D * kRows) xsT[i0 + u * kThreads] = v[u];
        }
    }

    const int r0 = warp * kRowsPerWarp;
    const bool live = r0 < n_live;  // dead warps still load and sync
    // Each lane's logsumexp state of its 8 rows over its columns; lane 0
    // adds the empty columns' term at the end, and the warp merges its
    // lanes' states.
    float rm[kRowsPerWarp], rs[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
        rm[i] = NEG_INF;
        rs[i] = 0.0f;
    }
    float em = NEG_INF, es = 0.0f;  // this thread's empty columns' weights

    const int nch = (D + kChunk - 1) / kChunk;
    const int jj = tid % kPass, h = tid / kPass;  // the column this thread
                                                   // stages, its phase
    for (int kw0 = 0; kw0 < K; kw0 += kWin) {
        // The window's active columns, ascending: each warp ballots its
        // segment, then writes after the warps before it; the empty ones'
        // weights go into this thread's logsumexp.
        unsigned bal[kSegPerLane];
        int nw = 0;
        const int kseg = kw0 + warp * 32 * kSegPerLane + lane;
        {
            int cv[kSegPerLane];
            float wv[kSegPerLane];
#pragma unroll
            for (int i = 0; i < kSegPerLane; ++i) {
                const int k = kseg + 32 * i;
                cv[i] = k < K ? cnt[k] : 1;
                wv[i] = k < K ? wb[k] : NEG_INF;
            }
#pragma unroll
            for (int i = 0; i < kSegPerLane; ++i) {
                if (cv[i] <= 0) lse_push(em, es, wv[i]);
                bal[i] = __ballot_sync(0xffffffffu,
                                       kseg + 32 * i < K && cv[i] > 0);
                nw += __popc(bal[i]);
            }
        }
        if (lane == 0) s_wcount[warp] = nw;
        __syncthreads();
        int off = 0, n = 0;
        for (int i = 0; i < kWarps; ++i) {
            off += i < warp ? s_wcount[i] : 0;
            n += s_wcount[i];
        }
#pragma unroll
        for (int i = 0; i < kSegPerLane; ++i) {
            if ((bal[i] >> lane) & 1u)
                list[off + __popc(bal[i] & ((1u << lane) - 1u))] =
                    kseg + 32 * i;
            off += __popc(bal[i]);
        }
        __syncthreads();
        if (n == 0) continue;

        // The stream of (pass, chunk) steps.  issue(s) starts this thread's
        // cp.async copies of its share of step s; finish(s) waits for them
        // and transforms its t1 values in place (P::stage), and at a pass's
        // last chunk stores the pass's column constants.
        const int steps = (n + kPass - 1) / kPass * nch;
        float wcol = 0.0f, aux = 0.0f;
        typename P::Col col;
        int kcol = 0;
        bool sok = false;
        auto issue = [&](int s) {
            const int p = s / nch, ch = s - p * nch;
            if (ch == 0) {
                const int j = p * kPass + jj;
                sok = j < n;
                kcol = sok ? list[j] : 0;
                wcol = sok ? wb[kcol] : 0.0f;
                col = pol.load_col(bK + kcol, sok);
                aux = 0.0f;
            }
            float *r = ring + (s & 1) * kBuf + jj;
#pragma unroll
            for (int i = 0; i < kStage; ++i) {
                const int fr = h + i * kPhases, d = ch * kChunk + fr;
                if (sok && d < D) {
                    const int64_t at = (int64_t)d * K + kcol;
                    cp_async4(r + fr * kPass, t0b + at);
                    cp_async4(r + (kChunk + fr) * kPass, t1b + at);
                }
            }
            cp_async_commit();
        };
        auto finish = [&](int s) {
            const int p = s / nch, ch = s - p * nch;
            float *r = ring + (s & 1) * kBuf + (kChunk * kPass) + jj;
            cp_async_wait_all();
#pragma unroll
            for (int i = 0; i < kStage; ++i) {
                const int fr = h + i * kPhases;
                if (sok && ch * kChunk + fr < D)
                    r[fr * kPass] = pol.stage(r[fr * kPass], col, aux);
            }
            if (ch == nch - 1) {
                float *c = cc + (p & 1) * (kConsts * kPass) + jj;
                if (h == 0) c[0] = wcol;
                pol.consts(col, aux, h, c);
            }
        };

        issue(0);
        finish(0);
        __syncthreads();
        float acc[kRowsPerWarp][kCompsPerLane];
        float prod[kRowsPerWarp][kCompsPerLane];
        for (int s = 0, p = 0, ch = 0; s < steps; ++s) {
            if (s + 1 < steps) issue(s + 1);
            if (live) {
                if (ch == 0) {
#pragma unroll
                    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
                        for (int c = 0; c < kCompsPerLane; ++c)
                            acc[i][c] = prod[i][c] = 0.0f;
                }
                const float *r0p = ring + (s & 1) * kBuf
                                   + lane * kCompsPerLane;
                const float *r1p = r0p + kChunk * kPass;
                const int d0 = ch * kChunk;
                const int fc = min(kChunk, D - d0);
#pragma unroll
                for (int fr = 0; fr < kChunk; ++fr) {
                    if (fr < fc) {
                        const float4 m4 =
                            *reinterpret_cast<const float4 *>(r0p + fr * kPass);
                        const float4 t4 =
                            *reinterpret_cast<const float4 *>(r1p + fr * kPass);
                        const float4 *xe = reinterpret_cast<const float4 *>(
                            xsT + (d0 + fr) * kRows + r0);
                        const float4 xa = xe[0], xb = xe[1];
                        const float mu[kCompsPerLane] = {m4.x, m4.y, m4.z,
                                                         m4.w};
                        const float tv[kCompsPerLane] = {t4.x, t4.y, t4.z,
                                                         t4.w};
                        const float xv[kRowsPerWarp] = {xa.x, xa.y, xa.z,
                                                        xa.w, xb.x, xb.y,
                                                        xb.z, xb.w};
#pragma unroll
                        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
                            for (int c = 0; c < kCompsPerLane; ++c)
                                P::term(acc[i][c], prod[i][c], xv[i] - mu[c],
                                        tv[c], fr % kGroup == 0,
                                        fr % kGroup == kGroup - 1);
                    }
                }
                if (fc % kGroup != 0) {  // D's last group, not full
#pragma unroll
                    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
                        for (int c = 0; c < kCompsPerLane; ++c)
                            P::close(acc[i][c], prod[i][c]);
                }
                if (ch == nch - 1) {  // the pass's epilogue
                    const float *ccol = cc + (p & 1) * (kConsts * kPass)
                                        + lane * kCompsPerLane;
#pragma unroll
                    for (int c = 0; c < kCompsPerLane; ++c) {
                        if (p * kPass + lane * kCompsPerLane + c < n) {
                            const float wk = ccol[c];
#pragma unroll
                            for (int i = 0; i < kRowsPerWarp; ++i)
                                lse_push(rm[i], rs[i],
                                         wk + pol.post(acc[i][c], ccol + c));
                        }
                    }
                }
            }
            if (s + 1 < steps) finish(s + 1);
            __syncthreads();
            if (++ch == nch) {
                ch = 0;
                ++p;
            }
        }
    }

    // The empty columns' term E: the warps' shares merged in a fixed order.
    for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, em, o);
        const float s2 = __shfl_xor_sync(0xffffffffu, es, o);
        lse_merge(em, es, m2, s2);
    }
    if (lane == 0) {
        part_m[warp] = em;
        part_s[warp] = es;
    }
    __syncthreads();
    if (!live) {  // rows past valid_m only
        if (lane < kRowsPerWarp && r0 + lane < n_c) orow[r0 + lane] = NEG_INF;
        return;
    }
    if (lane == 0) {
        em = NEG_INF;
        es = 0.0f;
        for (int i = 0; i < kWarps; ++i) lse_merge(em, es, part_m[i], part_s[i]);
        if (em != NEG_INF) {
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
                const float pc = r0 + i < n_live
                                     ? prior_c[(int64_t)b * M + m0 + r0 + i]
                                     : 0.0f;
                lse_merge(rm[i], rs[i], pc + em, es);
            }
        }
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

// Launches the kernel on `stream`; returns a CUDA error code.
template <class P>
int launch(const P &pol, const float *Xc, const float *prior_c,
           const float *t0, const float *t1, const float *w,
           const int *counts, const int *valid_m, float *out, int B, int M,
           int D, int K, cudaStream_t stream) {
    if (B == 0 || M == 0) return (int)cudaGetLastError();
    const int smem = (int)(4 * smem_words(D, K));
    static int allowed = -1;
    if (smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            scores_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return (int)err;
        allowed = smem;
    }
    dim3 grid((M + kRows - 1) / kRows, B);
    scores_kernel<P><<<grid, kThreads, smem, stream>>>(
        pol, Xc, prior_c, t0, t1, w, counts, valid_m, out, M, D, K);
    return (int)cudaGetLastError();
}

// The dynamic shared memory a block of the policy's kernel may take on the
// current device: its opt-in limit less the kernel's static shared memory
// (s_wcount, the same in every policy's instantiation); minus a CUDA error
// code on error.
template <class P>
int smem_limit() {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes a;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, scores_kernel<P>);
    if (err != cudaSuccess) return -(int)err;
    return optin - (int)a.sharedSizeBytes;
}

}  // namespace diag_family
