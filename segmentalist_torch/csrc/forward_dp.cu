// Segmentation DP (kernel K2): the forward filter and, fused behind it, the
// backward draws and the chain walk.
//
// Replaces the Pallas kernel of segmentalist_tpu/ops/pallas_dp.py
// (_forward_kernel :40-95, pallas_call :122, entry forward_alphas
// :98-137) and the XLA backward pass that segmentalist_tpu/ops/dp.py:130-232
// (segment_dp) runs after it, in one launch (segment_dp_launch).  With
// rev[t, j] = scores[t, W - 1 - j] (-inf where W - j < n_slices_min):
//
//   alpha[0] = 0
//   alpha[t] = logsumexp_j( rev[t-1, j] + alpha[t-W+j] ) + lpc   (sample)
//   alpha[t] = max_j( rev[t-1, j] + alpha[t-W+j] )               (viterbi)
//
// for t = 1 .. N-1, -inf for t >= length; alphas_pad[b] = [W x -inf,
// alpha[0..N-1]].  The -inf guard of the Pallas kernel (pallas_dp.py:54-60)
// is kept: an all -inf window gives -inf, never NaN.  Then at every node v
// = 1 .. N, with l[j] = rev[v-1, j] + alphas_pad[v + j]:
//
//   pick = argmax_j( l[j] == -inf ? -inf : l[j] / temp + noise[v-1, j] )
//          (sample; ties to the first index), or the last index of
//          argmax_j l[j] (viterbi: ties toward shorter segments)
//   p[v] = v - (W - pick) if some l[j] is finite, else v - 1 (the
//          backtracking fallback); p[0] = 0
//
// and the chain length -> p(length) -> ... -> 0 is visited; the output
// boundary at v is visited & (samplable | v == length | v starts a
// segment), and log_prob sums rev[v-1, pick] over the visited samplable
// nodes in ascending v.  This is segmentalist_torch/ops/dp.py's
// segment_dp_plain (forward_alphas_plain, then backward_sample) in one
// launch; the noise comes in as an input (no generator in the kernel), so
// the two agree on shared noise.
//
// What bounds it on the H100: not bytes (the function reads B N W scores
// and noise values once, 0.1 us at the flagship) and not operations, but a
// latency chain: the forward filter is N - 1 dependent steps, each a
// window reduction whose result the next step reads, and the chain walk
// after it is sequential too.  A step is an exp a window entry, a sum, a
// log: ~45 dependent instructions, ~160 issued.  The design keeps the
// chain on chip and short, and takes the rest of the DP off the launch
// path:
//
// - A warp an utterance, up to kMaxWarps warps a CTA, so a batch of 125
//   spreads over 32 SMs with one warp on each SM sub-partition (the first
//   design ran a thread an utterance, the batch on one SM, and read its
//   window back from device memory).
// - The utterance's score rows, and its noise rows behind them, are staged
//   into shared memory by cp.async at the start (two commit groups: the
//   forward filter waits for the scores only); the alpha row, the
//   pointers, the picked scores and the boundary flags live there too.
//   Where the rows do not fit (ops/cuda_dp.py::launch_plan), the "global"
//   form reads them from device memory with the same arithmetic.
// - A window of up to kSerialW (8; the segmenters' n_slices_max is 6): every
//   lane runs the recursion on its own registers (forward_serial), with no
//   branch, predicate or lane exchange in a step; the rows are first
//   rewritten reversed, masked and padded to 8 (pad_rows).  A wider window
//   (forward_warp): lanes take its entries, the max is one redux.sync, and
//   lane 0 sums the exps and stores the alpha the lanes read next step.
//   Either way the max is exact in any order (a NaN anywhere makes it NaN,
//   as torch.amax), the exps are summed in ascending j, the plain version's
//   order, and with -fmad=false the alphas are the plain version's bits.
// - The backward pass: lanes take the nodes v (several a lane at N > 32),
//   each a sequential argmax over its window, the division IEEE-rounded;
//   then lane 0 walks the chain once through shared memory, marking the
//   boundaries and collecting the samplable nodes' picked scores, which it
//   sums in ascending v, and the lanes write the boundaries.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 4;
constexpr int kSerialW = 8;  // the widest window of forward_serial
constexpr unsigned kFull = 0xffffffffu;

struct DpArgs {
    const float *scores;   // [B, N, W] score rows (not reversed)
    const float *noise;    // [B, N, W] standard Gumbel noise, or null
    const int *lengths;    // [B]
    const float *lpc;      // [1] log p(continue) (sample mode)
    float *alphas;         // [B, W + N], or null
    float *log_prob;       // [B] (backward pass)
    unsigned char *bounds; // [B, N] bool (backward pass)
    int B, N, W, n_min, use_max;
    float temp;
};

// A warp's shared memory, in 4-byte words, each array on a 16-byte
// boundary: the staged score and noise rows [N W] (smem form), the padded
// rows of forward_serial [N kSerialW] (W <= kSerialW), the alpha row
// [W + N], the window's exps [W], the pointers p, the picked scores, the
// boundary flags and the walk's picked scores [N + 1].
struct Layout {
    int sc, nz, pr, a, e, p, contrib, bnd, cs, words;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline Layout layout(int N, int W, bool staged,
                                         bool noise) {
    Layout L;
    int o = 0;
    L.sc = o;
    o += staged ? round4(N * W) : 0;
    L.nz = o;
    o += staged && noise ? round4(N * W) : 0;
    L.pr = o;
    o += W <= kSerialW ? N * kSerialW : 0;
    L.a = o;
    o += round4(W + N);
    L.e = o;
    o += round4(W);
    L.p = o;
    o += round4(N + 1);
    L.contrib = o;
    o += round4(N + 1);
    L.bnd = o;
    o += round4(N + 1);
    L.cs = o;
    o += round4(N + 1);
    L.words = o;
    return L;
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies n floats to a 16-byte aligned dst, 16 bytes a copy where src is
// aligned too (a warp's copies coalesced), else 4.
__device__ __forceinline__ void stage(float *dst, const float *src, int n,
                                      int lane) {
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
        for (int i = 4 * lane; i < n; i += 128) cp_async16(dst + i, src + i);
    } else {
        for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
    }
}

// An unsigned key in the floats' order (-0 below +0), for redux.sync.
__device__ __forceinline__ unsigned order_key(float v) {
    const unsigned u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// max that keeps a NaN, as torch.amax does (max.NaN, sm_80 on)
__device__ __forceinline__ float fmax_nan(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

// The warp's max of v; NaN if any lane's v is NaN.
__device__ __forceinline__ float warp_max(float v) {
    const unsigned k = __reduce_max_sync(kFull, order_key(v));
    return __any_sync(kFull, v != v) ? CUDART_NAN_F : key_value(k);
}

// torch.argmax's order scanned in ascending j: the first NaN, else the
// first of the largest values ...
__device__ __forceinline__ bool beats_first(float v, float best) {
    return v > best || (v != v && best == best);
}

// ... and W - 1 - argmax of the flipped row: the last NaN, else the last of
// the largest values.
__device__ __forceinline__ bool beats_last(float v, float best) {
    return v != v || v >= best;
}

// rev[t, j] of a row of scores
__device__ __forceinline__ float rev_at(const float *row, int j, int W,
                                        int n_min) {
    return W - j >= n_min ? row[W - 1 - j] : NEG_INF;
}

// x, or -inf where the mask is set (one LOP3, no predicate)
__device__ __forceinline__ float neg_inf_where(float x, unsigned mask) {
    return __uint_as_float((__float_as_uint(x) & ~mask)
                           | (__float_as_uint(NEG_INF) & mask));
}

// The forward filter of a window of up to kSerialW: every lane runs the
// whole recursion on the same values, so no lane waits for another.  The
// rows come reversed, masked and padded on the left to kSerialW with -inf
// (pad_rows), so the step has no branch and no predicate: two 16-byte
// loads of the next row a step ahead, a shift register of alphas whose pad
// slots are masked to -inf, a tree of NaN-keeping maxes (exact in any
// order), independent exps, and their sum in ascending j (the pads' zeros
// first, which leave it exact); lane 0 stores each alpha for the backward
// pass.
__device__ __forceinline__ void forward_serial(const float *pr, float *a,
                                               int N, int W, int len,
                                               float lpc, bool sample,
                                               int lane) {
    static_assert(kSerialW == 8, "two float4 a row, a max tree of 8");
    float win[kSerialW];
    unsigned pad[kSerialW];
#pragma unroll
    for (int j = 0; j < kSerialW; ++j) {  // a[1 .. W]; alpha[0] = a[W] = 0
        win[j] = j == kSerialW - 1 ? 0.0f : NEG_INF;
        pad[j] = j < kSerialW - W ? ~0u : 0u;
    }
    const float4 *rows4 = reinterpret_cast<const float4 *>(pr);
    float4 r0 = rows4[0], r1 = rows4[1];
    for (int t = 1; t < N; ++t) {
        const float rw[kSerialW] = {r0.x, r0.y, r0.z, r0.w,
                                    r1.x, r1.y, r1.z, r1.w};
        float x[kSerialW];
#pragma unroll
        for (int j = 0; j < kSerialW; ++j)
            x[j] = neg_inf_where(rw[j] + win[j], pad[j]);
        r0 = rows4[2 * t];  // row t, step t + 1's (row N - 1 is the last)
        r1 = rows4[2 * t + 1];
        const float m =
            fmax_nan(fmax_nan(fmax_nan(x[0], x[1]), fmax_nan(x[2], x[3])),
                     fmax_nan(fmax_nan(x[4], x[5]), fmax_nan(x[6], x[7])));
        float val = m;
        if (sample) {
            const bool dead = m == NEG_INF;
            const float ms = dead ? 0.0f : m;
            float s = expf(x[0] - ms);
#pragma unroll
            for (int j = 1; j < kSerialW; ++j) s += expf(x[j] - ms);
            val = (dead ? NEG_INF : logf(s) + ms) + lpc;
        }
        val = t < len ? val : NEG_INF;
#pragma unroll
        for (int j = 0; j < kSerialW - 1; ++j) win[j] = win[j + 1];
        win[kSerialW - 1] = val;
        if (lane == 0) a[W + t] = val;
    }
}

// pad_rows[t][k] = rev[t, k - (kSerialW - W)], -inf for k < kSerialW - W:
// the rows reversed, masked and padded for forward_serial, a lane an entry.
__device__ __forceinline__ void pad_rows(float *pr, const float *rows, int N,
                                         int W, int n_min, int lane) {
    for (int i = lane; i < N * kSerialW; i += 32) {
        const int t = i / kSerialW, j = i % kSerialW - (kSerialW - W);
        pr[i] = j < 0 ? NEG_INF
                      : rev_at(rows + (int64_t)t * W, j, W, n_min);
    }
}

// The forward filter of a wider window: lanes take the window's j (chunks
// of 32 above W = 32), the max is one redux.sync, each lane takes its
// exps, and lane 0 sums them in ascending j, takes the log and stores the
// alpha that the lanes read at the next step.
__device__ __forceinline__ void forward_warp(const float *rows, float *a,
                                             float *e, int N, int W,
                                             int n_min, int len,
                                             float lpc, bool sample,
                                             int lane) {
    float r = lane < W ? rev_at(rows, lane, W, n_min) : NEG_INF;
    for (int t = 1; t < N; ++t) {
        const float *row = rows + (int64_t)(t - 1) * W;
        const float x = lane < W ? r + a[t + lane] : NEG_INF;
        float m = x;
        for (int j = lane + 32; j < W; j += 32)
            m = fmax_nan(m, rev_at(row, j, W, n_min) + a[t + j]);
        if (lane < W) r = rev_at(row + W, lane, W, n_min);
        m = warp_max(m);
        float val = m;
        if (sample) {
            const bool dead = m == NEG_INF;
            const float ms = dead ? 0.0f : m;
            if (lane < W) e[lane] = expf(x - ms);
            for (int j = lane + 32; j < W; j += 32)
                e[j] = expf((rev_at(row, j, W, n_min) + a[t + j]) - ms);
            __syncwarp();
            if (lane == 0) {
                float s = e[0];
                for (int j = 1; j < W; ++j) s += e[j];
                val = (dead ? NEG_INF : logf(s) + ms) + lpc;
            }
        }
        if (lane == 0) a[W + t] = t < len ? val : NEG_INF;
        __syncwarp();
    }
}

// The forward filter, then the backward pass; kStaged: the rows staged on
// chip (the smem form); kSerial: a window of up to kSerialW, run by every
// lane.
template <bool kStaged, bool kSerial>
__global__ void __launch_bounds__(kMaxWarps * 32)
    segment_dp_kernel(const DpArgs g) {
    extern __shared__ float4 smem4[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= g.B) return;  // warps work alone: no block barrier below
    const int N = g.N, W = g.W, n_min = g.n_min;
    const bool sample = !g.use_max;  // the backward draws take noise
    const Layout L = layout(N, W, kStaged, sample);
    float *ws = reinterpret_cast<float *>(smem4) + (int64_t)warp * L.words;
    const float *g_rows = g.scores + (int64_t)b * N * W;
    const float *g_noise = sample ? g.noise + (int64_t)b * N * W : nullptr;
    if (kStaged) {
        stage(ws + L.sc, g_rows, N * W, lane);
        cp_async_commit();
        if (sample) stage(ws + L.nz, g_noise, N * W, lane);
        cp_async_commit();
    }
    const float *rows = kStaged ? ws + L.sc : g_rows;
    float *a = ws + L.a, *e = ws + L.e;
    for (int j = lane; j < W; j += 32) a[j] = NEG_INF;
    if (lane == 0) a[W] = 0.0f;
    const int len = g.lengths[b];
    const float lpc = sample ? *g.lpc : 0.0f;
    if (kStaged) cp_async_wait<1>();  // the score rows
    __syncwarp();

    if (kSerial) {
        pad_rows(ws + L.pr, rows, N, W, n_min, lane);
        __syncwarp();
        forward_serial(ws + L.pr, a, N, W, len, lpc, sample, lane);
    } else
        forward_warp(rows, a, e, N, W, n_min, len, lpc, sample, lane);
    __syncwarp();

    const float *noise = kStaged ? ws + L.nz : g_noise;
    int *pe = reinterpret_cast<int *>(ws + L.p);
    int *bnd = reinterpret_cast<int *>(ws + L.bnd);
    float *contrib = ws + L.contrib, *cs = ws + L.cs;
    if (kStaged) {
        cp_async_wait<0>();  // the noise rows
        __syncwarp();
    }
    // per-node draws, a lane a node: pe[v] = p(v) where some logit is
    // finite, else ~(v - 1) (the fallback's p, negative: unsamplable)
    const bool unit_temp = g.temp == 1.0f;
    for (int v = lane + 1; v <= N; v += 32) {
        const float *row = rows + (int64_t)(v - 1) * W;
        const float *nrow = sample ? noise + (int64_t)(v - 1) * W : nullptr;
        bool samp = false;
        float best = 0.0f;
        int pick = 0;
        for (int j = 0; j < W; ++j) {
            const float l = rev_at(row, j, W, n_min) + a[v + j];
            samp |= isfinite(l);
            float key = l;
            if (sample) {  // l / 1 is l in IEEE division
                const float s = l == NEG_INF ? NEG_INF
                                : unit_temp ? l : __fdiv_rn(l, g.temp);
                key = s == NEG_INF ? NEG_INF : s + nrow[j];
            }
            if (j == 0 || (sample ? beats_first(key, best)
                                  : beats_last(key, best))) {
                best = key;
                pick = j;
            }
        }
        contrib[v] = rev_at(row, pick, W, n_min);
        pe[v] = samp ? v - (W - pick) : ~(v - 1);
        bnd[v] = 0;
    }
    __syncwarp();
    // the chain walk, lane 0: a visited node is a boundary where it is
    // samplable, is the end, or starts the segment of the samplable
    // node walked before it; the picked scores of the samplable nodes
    // are summed in ascending v (p strictly decreases to 0 on valid
    // inputs; the guard only keeps a malformed row inside the arrays)
    if (lane == 0) {
        int n = 0;
        if (len >= 1 && len <= N) {
            bool after_samp = true;  // the end is a boundary
            for (int v = len; v > 0;) {
                const int e = pe[v];
                const bool samp = e >= 0;
                if (samp || after_samp) bnd[v] = 1;
                if (samp) cs[n++] = contrib[v];
                after_samp = samp;
                const int next = samp ? e : ~e;
                if (next < 0 || next >= v) break;
                v = next;
            }
        }
        float lp = 0.0f;
        for (int i = n - 1; i >= 0; --i) lp += cs[i];
        g.log_prob[b] = lp;
    }
    __syncwarp();
    for (int v = lane + 1; v <= N; v += 32)
        g.bounds[(int64_t)b * N + v - 1] = (unsigned char)bnd[v];
    if (g.alphas)
        for (int i = lane; i < W + N; i += 32)
            g.alphas[(int64_t)b * (W + N) + i] = a[i];
}

constexpr int kMaxDevices = 64;  // devices whose opt-in size is tracked

// Launches one form with `warps` utterances a CTA.  The kernel's shared
// memory limit is raised on each device for the largest size asked there
// (on every launch above the default on a device past kMaxDevices).
template <bool kStaged, bool kSerial>
int launch_form(const DpArgs &g, int warps, cudaStream_t stream) {
    auto kern = segment_dp_kernel<kStaged, kSerial>;
    const int64_t smem =
        4LL * layout(g.N, g.W, kStaged, !g.use_max).words * warps;
    if (smem > INT32_MAX) return (int)cudaErrorInvalidValue;
    static int64_t allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const bool tracked = dev >= 0 && dev < kMaxDevices;
    if (smem > (tracked ? allowed[dev] : 48 * 1024)) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        if (tracked) allowed[dev] = smem;
    }
    kern<<<(g.B + warps - 1) / warps, 32 * warps, (int)smem, stream>>>(g);
    return (int)cudaGetLastError();
}

}  // namespace

// A warp's dynamic shared memory in bytes (the plan multiplies it by the
// warps a CTA).
extern "C" long long segment_dp_smem_bytes(int N, int W, int staged,
                                           int noise) {
    return 4LL * layout(N, W, staged != 0, noise != 0).words;
}

// The dynamic shared memory a CTA may take on the current device: the
// opt-in limit a block (the kernels have no static shared memory); minus a
// CUDA error code on error.
extern "C" int segment_dp_smem_limit() {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return err == cudaSuccess ? optin : -(int)err;
}

// The whole DP: scores [B, N, W] as the caller has them (the kernel
// reverses and masks), noise [B, N, W] (sample mode; ignored in Viterbi),
// log_prob [B], bounds [B, N] bool, and alphas [B, W + N] where not null.
extern "C" int segment_dp_launch(const float *scores, const float *noise,
                                 const int *lengths, const float *lpc,
                                 float *alphas, float *log_prob,
                                 unsigned char *bounds, int B, int N, int W,
                                 int n_min, int use_max, float temp,
                                 int staged, int warps, cudaStream_t stream) {
    if (!use_max && noise == nullptr) return (int)cudaErrorInvalidValue;
    if (warps < 1 || warps > kMaxWarps || N < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    const DpArgs g{scores, noise, lengths, lpc, alphas, log_prob, bounds,
                   B, N, W, n_min, use_max, temp};
    if (W <= kSerialW)
        return staged ? launch_form<true, true>(g, warps, stream)
                      : launch_form<false, true>(g, warps, stream);
    return staged ? launch_form<true, false>(g, warps, stream)
                  : launch_form<false, false>(g, warps, stream);
}
