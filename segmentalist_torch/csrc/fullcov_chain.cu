// Within-utterance full-covariance (NIW) assignment chains over touched-slot
// tables: kernel K9, with Dirichlet mixture weights or (kBigram) bigram-LM
// weights.
//
// Replaces the Pallas kernel of segmentalist_tpu/ops/pallas_chain.py
// (fullcov_chain_pallas, entry :1323, pallas_call :1725, body :1513-1678,
// bigram mode :1549-1567), whose XLA twin is
// segmentalist_tpu/segmenters/fullcov.py::fullcov_chain.  For each
// utterance b, its valid segments are assigned in order.  The utterance
// carries T = T0 + S touched slots (m[D], invP[D*D], ldP, component tk; T0
// from the inputs, -1 = free) and, per component k, its running count
// cnt[k] and slot_of[k] (-1 = untouched).  A step:
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
// (ops/cuda_fullcov_chain.py), divisions give IEEE `/`'s bits (div_rn) and
// the library is built with -fmad=false, so kernel and plain version round
// alike and sample identical chains.
//
// What bounds it on the H100: the chain is sequential over segments; a
// step is a K-wide read of base and gumbel plus, per live slot, a D x D
// matrix-vector product.  At D = 13 the tables fit on chip and each step's
// latency is the cost; at D = 130 (67.6 KB a table) each step must stream
// every live slot's table from device memory, so the least time is those
// bytes at the HBM rate.  The design:
//
// - Transposed tables.  A working table holds element (d, e) at e*D + d, so
//   threads on neighbouring rows d read neighbouring words (conflict-free in
//   shared memory, one line in device memory) and each still sums its row
//   over e in ascending order.  The copy-in transposes the T0 input slots;
//   a claimed slot reads its component's global factors row-major as they
//   are (one matrix-vector product and one copy a claim).
// - No one-thread serial work in a step.  The count-only terms of a slot's
//   score (the two lgamma series, its logs and ld) are hoisted: computed
//   when the slot is set up or updated, by one thread, while the next step
//   runs.  The "smem" form scores one (slot, row) pair a thread over the
//   whole block; the owner thread of a column with a slot sums the slot's
//   ascending dot over d, so different slots run in different threads.  The
//   argmax merge is K6's: each warp reduces (value, 2k + occupied) and the
//   first empty column, and after one barrier every warp merges all warps'
//   entries (a total order), so all threads agree on k_new.  A drawn slot's
//   u and u . dv are its score's U and unclamped mahaP (the same operations
//   on the same values), so an update needs no barrier of its own; a claim
//   takes one for its matrix-vector product.  A free slot comes from an
//   ascending free list (slots are only ever claimed within a chain, so it
//   is a queue).  Barriers a step: three (phase A | slot dots and logits |
//   argmax merge, update | next step), four on a claim.
// - Shared memory up to the card's opt-in limit (227 KB on the H100,
//   cudaFuncSetAttribute): the "smem" form keeps every table on chip (D 13,
//   N_max 120: 225 KB).  The launch plan (ops/cuda_fullcov_chain.py::
//   launch_plan) picks the form from (D, K, S, T0) under the limit that
//   fullcov_chain_smem_limit reports.
// - The "stream" form (tables that do not fit, D 130) keeps the slot
//   records (m, then the transposed invP, each padded to 16 bytes) in
//   device memory and streams each live slot's record through a ring of 2
//   or 3 record buffers in shared memory with bulk asynchronous copies
//   (cp.async.bulk, completion on an mbarrier a buffer).  The first D
//   threads (the consumers, a row each) form U from the buffer and write U
//   to device memory and U_d delta_d to a double buffer; after a named
//   barrier of the consumers and one more warp, that warp's lane 0 refills
//   the buffer with the slot 2 or 3 ahead and sums the slot's mahaP and
//   score while the consumers work on the next.  (Chunks of 8 KB through
//   a ring of up to 32 buffers, released chunk by chunk, measured slower
//   on the H100; PERF.md keeps the times.)  Writes of records through
//   ordinary stores are fenced (fence.proxy.async.global) before a block
//   barrier, so the next bulk copies see them.

#include <climits>
#include <cstdint>

#include "bigram_lm.cuh"
#include "common.cuh"
#include "special.cuh"

namespace {

// At most 512 threads a block: at 1024 the 64-register cap made the
// bigram stream instantiation spill in its row loop, and the smem form's
// steps were shorter with 512 (fewer warps to reduce and wait for).
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxRing = 3;  // record buffers of the stream form

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Words of one streamed slot record: m, then invP (transposed), each padded
// to a multiple of 4 words (bulk copies move multiples of 16 bytes).
__host__ __device__ inline int rec_words(int D) {
    return round4(D) + round4(D * D);
}

// Dynamic shared memory of the block, in 4-byte words, in the kernel's
// carving order.  Smem form: the tables invP [T][D*D], m [T][D] and U
// [T][D]; stream form: the ring [ring][rec_words] and U delta [2][D].
// Both: a claim's u [D]; cnt, w, slot_of (bigram: the pair range) [K];
// the noise and base double buffers [4][K]; eight slot arrays [T]; the
// live and free lists [2][T]; x and the log prior [3][D + 1]; the valid
// steps [S]; bigram: the old pairs [2][S].
__host__ __device__ inline int64_t smem_words(bool stream, bool bigram,
                                              int D, int S, int T0, int K,
                                              int ring) {
    const int64_t T = (int64_t)T0 + S;
    const int64_t tables = stream
        ? (int64_t)ring * rec_words(D) + 2LL * D
        : T * ((int64_t)D * D + 2LL * D);
    return tables + D + (bigram ? 4LL : 3LL) * K + 4LL * K + 10 * T
           + 3LL * (D + 1) + S + (bigram ? 2LL * S : 0);
}

__device__ __forceinline__ unsigned smem_addr(const void *p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(count)
                 : "memory");
}



// One thread: expect `bytes` on bar, then copy them from device memory.
__device__ __forceinline__ void bulk_load(float *dst, const float *src,
                                          unsigned bytes, uint64_t *bar) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t *bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@p bra.uni DONE;\n"
        "bra.uni WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Warp-wide (value, index) argmax and first-empty min; every lane ends
// with the result.
__device__ __forceinline__ void warp_reduce(float &v, int &i, int &e) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
        argmax_merge(v, i, v2, i2);
        e = min(e, __shfl_xor_sync(0xffffffffu, e, off));
    }
}

struct ChainArgs {
    const int *embeds;         // [B, S]
    const float *Xe;           // [B, S, D]
    const float *log_prior_e;  // [B, S]
    const float *gumbel;       // [B, S, K]
    const float *base;         // [B, S, K]
    const int *counts;         // [B, K]
    const float *m0, *iP0, *ld0;  // [B, T0, D], [B, T0, D, D], [B, T0]
    const int *tk0;               // [B, T0]
    const float *g_m, *g_iP, *g_ld;  // [K, D], [K, D, D], [K]
    float k0, v0, half_D, log_pi;
    float *recs;  // stream form: [B, T, rec_words] slot records
    float *Ug;    // stream form: [B, T, D] U of each live slot
    int *ks;      // [B, S]
    int S, D, K, T0, ring;
    float alpha_over_K, lms, temp;
    int use_argmax;
    BigramLM lm;
};

template <bool kBigram, bool kStream>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fullcov_chain_kernel(const ChainArgs a) {
    extern __shared__ __align__(16) float sh[];
    __shared__ float red_v[2][kMaxWarps];
    __shared__ int red_i[2][kMaxWarps];
    __shared__ int red_e[2][kMaxWarps];
    __shared__ int s_part[kMaxWarps];
    __shared__ int s_n, s_nlive;
    __shared__ __align__(8) uint64_t full[kMaxRing];

    const int D = a.D, S = a.S, K = a.K, T0 = a.T0, T = T0 + S;
    const int DD = D * D;
    const int NT = blockDim.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, W = NT >> 5;
    const int b = blockIdx.x;
    const int64_t bS = (int64_t)b * S, bK = (int64_t)b * K;
    const int64_t RS = rec_words(D);
    const int Dm = round4(D);  // stream form: A's offset in a record
    const int nc = (D + 31) & ~31;  // stream form: the consumer threads
    // The thread that applies a step's slot update while the next step
    // runs: the summer in the stream form (it reads the slot's terms),
    // else the last thread (phase A's pairs start at thread 0).
    const int writer = kStream ? nc : NT - 1;
    const float Df = (float)D;

    // Carve the dynamic shared memory (smem_words' order).
    float *p = sh;
    float *ring = nullptr, *Pd = nullptr, *tA = nullptr, *tM = nullptr,
          *Us = nullptr;
    if constexpr (kStream) {
        ring = p;
        p += a.ring * RS;
        Pd = p;
        p += 2 * D;
    } else {
        tA = p;
        p += T * DD;
        tM = p;
        p += T * D;
        Us = p;
        p += T * D;
    }
    float *uc = p;
    p += D;
    float *cnt = p;
    float *wt = cnt + K;  // Dirichlet: the weight; K7-style: unigram half
    int *slot_of = reinterpret_cast<int *>(wt + K);
    int *prange = slot_of + K;  // bigram only
    float *gbuf = reinterpret_cast<float *>(prange + (kBigram ? K : 0));
    float *bbuf = gbuf + 2 * K;
    float *s_ld = bbuf + 2 * K;
    float *s_c0 = s_ld + T;  // hoisted score terms of each slot
    float *s_hv = s_c0 + T;
    float *s_sc = s_hv + T;
    float *s_v = s_sc + T;
    float *s_mp = s_v + T;  // this step's unclamped mahaP
    float *s_cs = s_mp + T;  // stream form: this step's score
    int *s_tk = reinterpret_cast<int *>(s_cs + T);
    int *live = s_tk + T;
    int *freel = live + T;
    float *xs = reinterpret_cast<float *>(freel + T);
    int *steps = reinterpret_cast<int *>(xs + 3 * (D + 1));
    int *s_cj = steps + S;  // bigram only: the old pairs
    int *s_ci = s_cj + S;

    float *rec = kStream ? a.recs + (int64_t)b * T * RS : nullptr;
    float *Ugb = kStream ? a.Ug + (int64_t)b * T * D : nullptr;
    auto tableA = [&](int t) -> float * {
        return kStream ? rec + t * RS + Dm : tA + t * DD;
    };
    auto tableM = [&](int t) -> float * {
        return kStream ? rec + t * RS : tM + t * D;
    };
    // The count-only terms of slot t's score at count n and logdet ldP.
    auto slot_terms = [&](int t, float n, float ldP) {
        const float k_n = a.k0 + n;
        const float v = ((a.v0 + n) - Df) + 1.0f;
        const float sc = div_rn(k_n + 1.0f, k_n * v);
        const float ld = ldP + Df * logf(sc);
        s_c0[t] = (lgamma_ratio(v, Df) - a.half_D * (logf(v) + a.log_pi))
                  - 0.5f * ld;
        s_hv[t] = 0.5f * (v + Df);
        s_sc[t] = sc;
        s_v[t] = v;
    };
    auto slot_score = [&](int t, float mp) {
        mp = mp < 0.0f ? 0.0f : mp;
        return s_c0[t]
               - s_hv[t] * log1pf(div_rn(div_rn(mp, s_sc[t]), s_v[t]));
    };

    // Phase 1: ks = -1, the valid steps, the live and free slot lists,
    // the slot and column arrays, K7's pairs and n_uni, the tables.
    const int *emb = a.embeds + bS;
    int *kout = a.ks + bS;
    const int *tk0 = a.tk0 + (int64_t)b * T0;
    if constexpr (kStream) {
        if (tid == 0) {
            for (int i = 0; i < a.ring; ++i) mbar_init(&full[i], 1);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
    }
    for (int s = tid; s < S; s += NT) kout[s] = -1;
    if constexpr (kBigram) {
        for (int s = tid; s < S; s += NT) {
            s_cj[s] = a.lm.corr_j[bS + s];
            s_ci[s] = a.lm.corr_i[bS + s];
        }
        int part = 0;
        for (int k = tid; k < K; k += NT) part += a.lm.uni[bK + k];
        for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) s_part[warp] = part;
    }
    if (warp == 0) {
        int n = 0;
        for (int s0 = 0; s0 < S; s0 += 32) {
            const int s = s0 + lane;
            const bool ok = s < S && emb[s] >= 0;
            const unsigned m = __ballot_sync(0xffffffffu, ok);
            if (ok) steps[n + __popc(m & ((1u << lane) - 1u))] = s;
            n += __popc(m);
        }
        int nl = 0, nf = 0;
        for (int t0 = 0; t0 < T; t0 += 32) {
            const int t = t0 + lane;
            const bool in = t < T;
            const bool lv = in && t < T0 && tk0[t] >= 0;
            const unsigned ml = __ballot_sync(0xffffffffu, lv);
            const unsigned mf = __ballot_sync(0xffffffffu, in && !lv);
            const unsigned below = (1u << lane) - 1u;
            if (lv) live[nl + __popc(ml & below)] = t;
            if (in && !lv) freel[nf + __popc(mf & below)] = t;
            nl += __popc(ml);
            nf += __popc(mf);
        }
        if (lane == 0) {
            s_n = n;
            s_nlive = nl;
        }
    }
    for (int t = tid; t < T; t += NT) {
        s_tk[t] = t < T0 ? tk0[t] : -1;
        s_ld[t] = t < T0 ? a.ld0[(int64_t)b * T0 + t] : 0.0f;
    }
    for (int k = tid; k < K; k += NT) {
        const float c = (float)a.counts[bK + k];
        cnt[k] = c;
        slot_of[k] = -1;
        if constexpr (!kBigram) wt[k] = a.lms * logf(a.alpha_over_K + c);
    }
    {
        const float *iP0 = a.iP0 + (int64_t)b * T0 * DD;
        const float *m0 = a.m0 + (int64_t)b * T0 * D;
        for (int64_t i = tid; i < (int64_t)T0 * DD; i += NT) {
            const int t = (int)(i / DD);
            if (tk0[t] < 0) continue;
            const int r = (int)(i - (int64_t)t * DD);
            const int d = r / D, e = r - d * D;
            tableA(t)[e * D + d] = iP0[i];
        }
        for (int i = tid; i < T0 * D; i += NT) {
            const int t = i / D;
            if (tk0[t] >= 0) tableM(t)[i - t * D] = m0[i];
        }
        if constexpr (kStream)
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
    __syncthreads();
    const int n_steps = s_n;
    int nlive = s_nlive;

    // Step i's x, log prior (xs slot i % 3), noise and base rows (slot
    // i % 2).
    auto prefetch = [&](int i) {
        const int64_t row = bS + steps[i];
        float *xd = xs + (i % 3) * (D + 1);
        for (int d = tid; d <= D; d += NT)
            cp_async4(xd + d, d < D ? a.Xe + row * D + d
                                    : a.log_prior_e + row);
        float *gd = gbuf + (i & 1) * K, *bd = bbuf + (i & 1) * K;
        const float *gs = a.gumbel + row * K, *bs = a.base + row * K;
        for (int k = tid; k < K; k += NT) {
            if (!a.use_argmax) cp_async4(gd + k, gs + k);
            cp_async4(bd + k, bs + k);
        }
        cp_async_commit();
    };
    if (n_steps > 0) prefetch(0);

    // Phase 2: K7's unigram denominators, weights and pair ranges; the
    // live input slots' components and hoisted terms.
    float uni_den = 0.0f, log_uni_den = 0.0f;
    if constexpr (kBigram) {
        int n_uni = 0;
        for (int w = 0; w < W; ++w) n_uni += s_part[w];
        uni_den = (float)n_uni + a.lm.a;
        log_uni_den = logf(uni_den);
        for (int k = tid; k < K; k += NT) {
            wt[k] = bigram_uni_half(a.lm, (float)a.lm.uni[bK + k], uni_den,
                                    DivRn());
            int lo = S, hi = -1;  // the pairs whose current id is k
            for (int s = 0; s < S; ++s) {
                if (s_ci[s] == k) {
                    lo = min(lo, s);
                    hi = s;
                }
            }
            prange[k] = (int)((unsigned)lo | ((unsigned)hi << 16));
        }
    }
    for (int j = tid; j < nlive; j += NT) {
        const int t = live[j];
        const int k = s_tk[t];  // live components are distinct
        slot_of[k] = t;
        slot_terms(t, cnt[k], s_ld[t]);
    }
    cp_async_wait_all();
    __syncthreads();

    int j_prev = -1;    // the previous valid segment's draw (block-uniform)
    int n_claimed = 0;  // free-list entries taken
    unsigned ph = 0;    // stream form: each ring buffer's mbarrier phase
    // The writer's pending slot update (applied after the step's last
    // barrier, while the next step runs).
    int pk = -1, pt = 0;
    bool phave = false;
    float pc = 0.0f, pden = 1.0f;
    for (int it = 0; it < n_steps; ++it) {
        const int s = steps[it];
        const int par = it & 1;
        if (it + 1 < n_steps) prefetch(it + 1);
        const float *x = xs + (it % 3) * (D + 1);
        const float lp = x[D];
        if (tid == writer && pk >= 0) {
            const float ld = (phave ? s_ld[pt] : a.g_ld[pk]) + logf(pden);
            const float c_new = pc + 1.0f;
            s_ld[pt] = ld;
            s_tk[pt] = pk;
            slot_of[pk] = pt;
            cnt[pk] = c_new;
            if constexpr (!kBigram)
                wt[pk] = a.lms * logf(a.alpha_over_K + c_new);
            slot_terms(pt, c_new, ld);
        }

        // Phase A: U = invP (x - m) of every live slot.
        if constexpr (kStream) {
            // Live slot j's record goes through ring buffer j % ring; the
            // buffer's mbarrier completes a phase when it lands.  The
            // summer refills a buffer once the named barrier shows every
            // consumer done with it.
            const int nbar = nc + 32;
            const int R = a.ring;
            const unsigned bytes = (unsigned)(RS * 4);
            if (tid == nc) {
                for (int j = 0; j < min(R, nlive); ++j)
                    bulk_load(ring + j * RS, rec + live[j] * RS, bytes,
                              &full[j]);
            }
            for (int j = 0; j < nlive; ++j) {
                const int st = j % R;
                if (tid < nc) {
                    mbar_wait(&full[st], (ph >> st) & 1u);
                    ph ^= 1u << st;
                    if (tid < D) {
                        const float *m = ring + st * RS;
                        const float *A = m + Dm;
                        float acc = 0.0f;
                        for (int e = 0; e < D; ++e)
                            acc = acc + A[e * D + tid] * (x[e] - m[e]);
                        Ugb[live[j] * D + tid] = acc;
                        Pd[(j & 1) * D + tid] = acc * (x[tid] - m[tid]);
                    }
                }
                if (tid < nbar) named_sync(1, nbar);
                if (tid == nc) {  // the summer
                    if (j + R < nlive)
                        bulk_load(ring + st * RS, rec + live[j + R] * RS,
                                  bytes, &full[st]);
                    const float *Pv = Pd + (j & 1) * D;
                    float mp = 0.0f;
                    for (int d = 0; d < D; ++d) mp = mp + Pv[d];
                    const int t = live[j];
                    s_mp[t] = mp;
                    s_cs[t] = slot_score(t, mp);
                }
            }
        } else {
            for (int i = tid; i < nlive * D; i += NT) {
                const int j = i / D, d = i - j * D;
                const int t = live[j];
                const float *A = tA + t * DD + d;
                const float *m = tM + t * D;
                float acc = 0.0f;
                for (int e = 0; e < D; ++e)
                    acc = acc + A[e * D] * (x[e] - m[e]);
                Us[t * D + d] = acc;
            }
        }
        __syncthreads();

        // Phase C: the slots' scores (smem form) and the K-wide logits.
        const float *g = gbuf + par * K;
        const float *bs = bbuf + par * K;
        const int *brow = nullptr;
        float uni_jb = 0.0f;
        if (kBigram && j_prev >= 0) {
            brow = a.lm.big + (int64_t)j_prev * K;
            uni_jb = (float)a.lm.uni[bK + j_prev] + a.lm.b;
        }
        float best_v = NEG_INF;
        int best_i = INT_MAX;  // 2 k + (cnt[k] > 0)
        int first_empty = K;
        for (int k = tid; k < K; k += NT) {
            const int bk = kBigram && j_prev >= 0 ? brow[k] : 0;
            const float c = cnt[k];
            const int t = slot_of[k];
            float sslot = 0.0f;
            if (t >= 0) {
                if constexpr (kStream) {
                    sslot = s_cs[t];
                } else {
                    const float *U = Us + t * D;
                    const float *m = tM + t * D;
                    float mp = 0.0f;
                    for (int d = 0; d < D; ++d)
                        mp = mp + U[d] * (x[d] - m[d]);
                    s_mp[t] = mp;
                    sslot = slot_score(t, mp);
                }
            }
            float fit;
            if (c > 0.0f) {
                fit = t >= 0 ? sslot : bs[k];
            } else {
                fit = lp;
                first_empty = min(first_empty, k);
            }
            float wk = wt[k];
            if constexpr (kBigram) {
                if (j_prev >= 0) {
                    const int pr = prange[k];
                    const int hi = pr >> 16;
                    int corr = 0;
                    for (int m = pr & 0xffff; m <= hi; ++m)
                        corr += s_ci[m] == k && s_cj[m] == j_prev;
                    wk = bigram_pair_weight(a.lm, wk, (float)(bk - corr),
                                            uni_jb, a.lms, DivRn());
                } else {
                    wk = bigram_first_weight(a.lm, (float)a.lm.uni[bK + k],
                                             log_uni_den, a.lms);
                }
            }
            const float logit = wk + fit;
            const float v = a.use_argmax ? logit
                            : (logit == NEG_INF ? NEG_INF
                                                : div_rn(logit, a.temp) + g[k]);
            argmax_merge(best_v, best_i, v, 2 * k + (c > 0.0f));
        }
        warp_reduce(best_v, best_i, first_empty);
        if (lane == 0) {
            red_v[par][warp] = best_v;
            red_i[par][warp] = best_i;
            red_e[par][warp] = first_empty;
        }
        cp_async_wait_all();  // step it + 1's rows are in
        __syncthreads();

        // Every warp merges all warps' entries and gets the same k_new.
        best_v = NEG_INF;
        best_i = INT_MAX;
        first_empty = K;
        if (lane < W) {
            best_v = red_v[par][lane];
            best_i = red_i[par][lane];
            first_empty = red_e[par][lane];
        }
        warp_reduce(best_v, best_i, first_empty);
        const int birth = first_empty < K ? first_empty : K - 1;
        // An all-NaN row leaves the sentinel: component 0 if occupied.
        const int k = best_i == INT_MAX ? (cnt[0] > 0.0f ? 0 : birth)
                      : (best_i & 1) ? best_i >> 1 : birth;
        if (tid == 0) kout[s] = k;

        // Phase D: the rank-1 update of k's slot (or a claimed one).
        const int t_have = slot_of[k];
        const bool have = t_have >= 0;
        const float c_row = cnt[k];
        const float *gA = a.g_iP + (int64_t)k * DD;
        const float *gm = a.g_m + (int64_t)k * D;
        int t;
        float du;
        const float *u;
        if (have) {
            t = t_have;
            du = s_mp[t];
            u = kStream ? Ugb + t * D : Us + t * D;
        } else {
            t = freel[n_claimed++];
            for (int d = tid; d < D; d += NT) {
                const float *r = gA + (int64_t)d * D;
                float acc = 0.0f;
                for (int e = 0; e < D; ++e) acc = acc + r[e] * (x[e] - gm[e]);
                uc[d] = acc;
            }
            if (tid == 0) live[nlive] = t;
            ++nlive;
            __syncthreads();
            du = 0.0f;
            for (int d = 0; d < D; ++d) du = du + uc[d] * (x[d] - gm[d]);
            u = uc;
        }
        const float k_n = a.k0 + c_row;
        const float beta = div_rn(k_n, k_n + 1.0f);
        float denom = 1.0f + beta * du;
        denom = denom > 0.0f ? denom : 1.0f;
        const float coef = div_rn(beta, denom);
        float *A = tableA(t);
        for (int i = tid; i < DD; i += NT) {
            const int e = i / D, d = i - e * D;
            const float src = have ? A[i] : gA[d * D + e];
            A[i] = src - coef * (u[d] * u[e]);
        }
        float *m = tableM(t);
        for (int d = tid; d < D; d += NT)
            m[d] = div_rn(k_n * (have ? m[d] : gm[d]) + x[d], k_n + 1.0f);
        if constexpr (kStream)
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
        pk = k;
        pt = t;
        phave = have;
        pc = c_row;
        pden = denom;
        __syncthreads();
        j_prev = k;
    }
}

// Launches one form with smem bytes of dynamic shared memory (the
// kernel's limit is raised once a process, for the largest size asked).
template <bool kBigram, bool kStream>
cudaError_t launch_form(const ChainArgs &a, int B, int threads, int smem,
                        cudaStream_t stream) {
    auto kern = fullcov_chain_kernel<kBigram, kStream>;
    static int allowed = -1;
    if (smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        allowed = smem;
    }
    kern<<<B, threads, smem, stream>>>(a);
    return cudaGetLastError();
}

// The plan's form (stream or smem), threads and ring buffers; the block's
// shared memory follows from them and the shapes (smem_words).
template <bool kBigram>
int launch(const ChainArgs &a, int B, int stream_form, int threads,
           cudaStream_t stream) {
    const int nc = (a.D + 31) & ~31;
    if (threads < 64 || threads > kMaxThreads || threads % 32 != 0
        || a.S >= (1 << 15)
        || (stream_form && (a.ring < 2 || a.ring > kMaxRing
                            || nc + 32 > threads)))
        return (int)cudaErrorInvalidValue;
    if (B == 0 || a.S == 0) return (int)cudaGetLastError();
    const int smem = (int)(4 * smem_words(stream_form != 0, kBigram, a.D,
                                          a.S, a.T0, a.K, a.ring));
    return (int)(stream_form
                     ? launch_form<kBigram, true>(a, B, threads, smem, stream)
                     : launch_form<kBigram, false>(a, B, threads, smem,
                                                   stream));
}

}  // namespace

extern "C" int fullcov_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const float *base, const int *counts,
    const float *t_m0, const float *t_iP0, const float *t_ld0,
    const int *tk0, const float *g_m, const float *g_iP, const float *g_ld,
    float k0, float v0, float half_D, float log_pi, float *recs, float *Ug,
    int *ks, int B, int S, int D, int K, int T0, int stream_form,
    int threads, int ring, float alpha_over_K, float lms, float temp,
    int use_argmax, cudaStream_t stream) {
    const ChainArgs a{embeds, Xe, log_prior_e, gumbel, base, counts, t_m0,
                      t_iP0, t_ld0, tk0, g_m, g_iP, g_ld, k0, v0, half_D,
                      log_pi, recs, Ug, ks, S, D, K, T0, ring,
                      alpha_over_K, lms, temp, use_argmax, BigramLM{}};
    return launch<false>(a, B, stream_form, threads, stream);
}

extern "C" int bigram_fullcov_chain_launch(
    const int *embeds, const float *Xe, const float *log_prior_e,
    const float *gumbel, const float *base, const int *counts,
    const float *t_m0, const float *t_iP0, const float *t_ld0,
    const int *tk0, const float *g_m, const float *g_iP, const float *g_ld,
    float k0, float v0, float half_D, float log_pi, const int *uni,
    const int *big, const int *corr_j, const int *corr_i, float *recs,
    float *Ug, int *ks, int B, int S, int D, int K, int T0, int stream_form,
    int threads, int ring, float a_over_K, float a, float b_over_K,
    float b, float lam, float one_minus_lam, float lms, float temp,
    cudaStream_t stream) {
    const ChainArgs args{
        embeds, Xe, log_prior_e, gumbel, base, counts, t_m0, t_iP0, t_ld0,
        tk0, g_m, g_iP, g_ld, k0, v0, half_D, log_pi, recs, Ug, ks, S, D, K,
        T0, ring, 0.0f, lms, temp, 0,
        BigramLM{uni, big, corr_j, corr_i, a_over_K, a, b_over_K, b, lam,
                 one_minus_lam}};
    return launch<true>(args, B, stream_form, threads, stream);
}

// The dynamic shared memory, in bytes, that the kernel's block reserves in
// the given form (the launch plan's smem_bytes must give exactly this).
extern "C" long long fullcov_chain_smem_bytes(int stream_form, int bigram,
                                              int D, int S, int T0, int K,
                                              int ring) {
    return 4 * smem_words(stream_form != 0, bigram != 0, D, S, T0, K,
                          ring);
}

// The dynamic shared memory a block of the kernel may take on the current
// device: its opt-in limit a block less the kernel's static shared memory
// (the most of the four instantiations); minus a CUDA error code on error.
extern "C" int fullcov_chain_smem_limit() {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    size_t fixed = 0;
    const void *kernels[] = {
        (const void *)fullcov_chain_kernel<false, false>,
        (const void *)fullcov_chain_kernel<false, true>,
        (const void *)fullcov_chain_kernel<true, false>,
        (const void *)fullcov_chain_kernel<true, true>};
    for (const void *k : kernels) {
        cudaFuncAttributes at;
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, k);
        if (err == cudaSuccess && at.sharedSizeBytes > fixed)
            fixed = at.sharedSizeBytes;
    }
    return err == cudaSuccess ? optin - (int)fixed : -(int)err;
}
