// The merge of a block's statistics into the global ones (the merge
// kernel, stage 4 of a block step).
//
// Replaces no Pallas kernel: it replaces the XLA one-hot dots of
// segmentalist_tpu/segmenters/common.py flat_contrib (the block's old and
// new segments summed per component as [K, B S] @ [B S, lanes] products)
// and merge_flat (global + (new - old)), which the port first carried over
// as one-hot matrix products.  For every component k that a member of the
// block's old or new segments belongs to (an item (b, s) with embeds >= 0,
// 0 <= ks < K and valid[b]):
//
//   counts[k] += n_cnt - o_cnt
//   sum_x[k]   = sum_x[k]  + (n - o)      n, o: the new / old members'
//   sum_sq[k]  = sum_sq[k] + (n2 - o2)    vectors and their squares
//
// Each side's members are summed in increasing flat item order b S + s,
// from 0, each product rounded before it is added (x_d * x_e, then the
// sum; -fmad=false and the explicit __fmul_rn / __fadd_rn), the order of
// the one-hot product's non-zero terms (cuBLAS sums that product in
// another order, so the two agree to rounding); the delta n - o is then
// added to the old value as merge_flat adds it.  sum_sq is
// [K, D] (fixed and diag families: D lanes of squares) or [K, D, D] (full:
// the D (D + 1) / 2 packed upper-triangle lanes of ops/stats.py sym_pack,
// each computed once and written to (d, e) and (e, d), each position
// added to its own old value, as merge_flat does after unpack_sym's
// mirror).  Rows of components the block does not touch are neither read
// nor written.  No float atomics: the result does not depend on timing.
// The plain version is ops/cuda_merge.py merge_stats_plain.
//
// What bounds it on the H100: bytes.  It reads and writes the touched
// rows (a [D, D] row is 67.6 KB at D 130; a block touches ~50-150
// components) and reads the members' rows once a lane chunk, a few tens
// of MB a block at most (~10 us at 3.35 TB/s).  The one-hot products it
// replaces did ~1,000 times the needed additions (42.6 GFLOP a call at
// the full family's flagship shape) and passed the whole [K, D, D] table
// four times.  On the H100 a merge takes 40-50 us inside a sweep: what
// holds it above the bound is latency, a CTA's scan passes and staged
// chunks being a chain of round trips to device memory.
//
// - merge_keys_kernel: one thread an item of either side writes its
//   component, or -1, and counts the side's members of each component with
//   integer atomics (exact in any order).
// - merge_stats_kernel: a CTA per (component, chunk of kLanesPerCta
//   lanes); the grid is static for a shape (graph-safe), and a CTA whose
//   component has no member returns at once.  Each side's members are
//   found in item order by a scan of the keys, kPass a pass (a thread
//   reads kItems consecutive keys in four 16-byte loads; an exclusive scan
//   of the threads' counts places its members), and the scan stops once
//   the histogram's count of them is found.  Their rows are staged in
//   shared memory chunk_rows at a time by cp.async, every copy of a chunk
//   in flight at once; a thread owns up to kLanesPerThread lanes
//   (consecutive lanes on consecutive threads) and adds each staged row's
//   term to its register sums in row order, then writes each lane once.

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                   // keys a thread a scan pass
constexpr int kPass = kThreads * kItems;     // keys a scan pass
constexpr int kLanesPerThread = 4;
constexpr int kLanesPerCta = kThreads * kLanesPerThread;
constexpr int kMaxChunkRows = 64;
// dynamic shared memory a CTA: under the 48 KB that needs no opt-in, less
// room for the static offsets
constexpr int kSmemBudget = 48 * 1024 - 256;

__global__ void __launch_bounds__(kThreads) merge_keys_kernel(
    const int *__restrict__ embeds_o, const int *__restrict__ ks_o,
    const int *__restrict__ embeds_n, const int *__restrict__ ks_n,
    const unsigned char *__restrict__ valid, int M, int Mp, int S, int K,
    int *__restrict__ keys, int *__restrict__ hist) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= 2 * Mp) return;
    const int side = i >= Mp, n = i - side * Mp;
    bool ok = false;
    int k = -1;
    if (n < M) {
        const int e = (side ? embeds_n : embeds_o)[n];
        k = (side ? ks_n : ks_o)[n];
        ok = e >= 0 && k >= 0 && k < K && valid[n / S] != 0;
    }
    keys[i] = ok ? k : -1;
    if (ok) atomicAdd(hist + side * K + k, 1);
}

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::
                     : "memory");
}

// Row d and column e >= d of packed upper-triangle lane f (row-major, row
// d starting at d D - d (d - 1) / 2).
__device__ void packed_lane(int f, int D, int &d, int &e) {
    auto start = [D](long long r) { return r * D - r * (r - 1) / 2; };
    const double b = 2.0 * D + 1.0;
    long long r = (long long)floor(0.5 * (b - sqrt(b * b - 8.0 * f)));
    r = r < 0 ? 0 : r > D - 1 ? D - 1 : r;
    while (r > 0 && start(r) > f) --r;
    while (r + 1 < D && start(r + 1) <= f) ++r;
    d = (int)r;
    e = (int)(r + (f - start(r)));
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads) merge_stats_kernel(
    const int *__restrict__ keys, const int *__restrict__ hist,
    const float *__restrict__ rows_o, const float *__restrict__ rows_n,
    int Mp, int D, int K, int n_lanes, int chunk_rows, int *counts,
    float *sum_x, float *sum_sq) {
    const int k = blockIdx.x;
    const int need_o = hist[k], need_n = hist[K + k];
    if (need_o == 0 && need_n == 0) return;
    if (blockIdx.y == 0 && threadIdx.x == 0)
        counts[k] = counts[k] + (need_n - need_o);

    extern __shared__ float smem[];
    float *xs = smem;                                           // [rows][D]
    int *idx = reinterpret_cast<int *>(smem + chunk_rows * D);  // [kPass]
    __shared__ int offs[kWarps + 1];

    const int t = threadIdx.x, w = t >> 5, lane = t & 31;
    // a lane: sum_x's d (e < 0), a square's (d, e), or dead (d < 0)
    int dd[kLanesPerThread], ee[kLanesPerThread];
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
        const int l = blockIdx.y * kLanesPerCta + j * kThreads + t;
        dd[j] = ee[j] = -1;
        if (l < D) {
            dd[j] = l;
        } else if (l < n_lanes) {
            if (kFull)
                packed_lane(l - D, D, dd[j], ee[j]);
            else
                dd[j] = ee[j] = l - D;
        }
    }
    float acc[2][kLanesPerThread];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
#pragma unroll
        for (int j = 0; j < kLanesPerThread; ++j) acc[side][j] = 0.0f;
        const int *key = keys + (size_t)side * Mp;
        const float *rows = side ? rows_n : rows_o;
        const int need = side ? need_n : need_o;
        for (int base = 0, found = 0; base < Mp && found < need;
             base += kPass) {
            // this thread's kItems consecutive keys (Mp is a multiple of
            // 4, so a 16-byte load lies wholly inside or outside)
            const int first = base + t * kItems;
            unsigned mine = 0;
#pragma unroll
            for (int q = 0; q < kItems / 4; ++q) {
                const int n = first + 4 * q;
                const int4 v = n < Mp
                                   ? *reinterpret_cast<const int4 *>(key + n)
                                   : make_int4(-1, -1, -1, -1);
                mine |= (unsigned)(v.x == k) << (4 * q)
                        | (unsigned)(v.y == k) << (4 * q + 1)
                        | (unsigned)(v.z == k) << (4 * q + 2)
                        | (unsigned)(v.w == k) << (4 * q + 3);
            }
            // exclusive scan of the threads' counts in thread order, which
            // is item order
            const int c = __popc(mine);
            int s = c;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, s, o);
                if (lane >= o) s += y;
            }
            if (lane == 31) offs[w] = s;
            __syncthreads();
            if (t == 0) {
                int run = 0;
#pragma unroll
                for (int v = 0; v < kWarps; ++v) {
                    const int x = offs[v];
                    offs[v] = run;
                    run += x;
                }
                offs[kWarps] = run;
            }
            __syncthreads();
            int at = offs[w] + s - c;
            for (unsigned m = mine; m; m &= m - 1)
                idx[at++] = first + __ffs(m) - 1;
            const int total = offs[kWarps];
            __syncthreads();
            for (int c0 = 0; c0 < total; c0 += chunk_rows) {
                const int nr = min(chunk_rows, total - c0);
                for (int q = t; q < nr * D; q += kThreads) {
                    const int r = q / D;
                    cp_async4(xs + q,
                              rows + (size_t)idx[c0 + r] * D + (q - r * D));
                }
                cp_async_wait_all();
                __syncthreads();
#pragma unroll 4
                for (int r = 0; r < nr; ++r) {
                    const float *x = xs + r * D;
#pragma unroll
                    for (int j = 0; j < kLanesPerThread; ++j) {
                        if (dd[j] < 0) continue;
                        const float v = ee[j] < 0
                                            ? x[dd[j]]
                                            : __fmul_rn(x[dd[j]], x[ee[j]]);
                        acc[side][j] = __fadd_rn(acc[side][j], v);
                    }
                }
                __syncthreads();
            }
            found += total;
        }
    }
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
        const int d = dd[j], e = ee[j];
        if (d < 0) continue;
        const float delta = __fsub_rn(acc[1][j], acc[0][j]);
        float *p = e < 0    ? sum_x + (size_t)k * D + d
                   : kFull ? sum_sq + ((size_t)k * D + d) * D + e
                           : sum_sq + (size_t)k * D + d;
        *p = __fadd_rn(*p, delta);
        if (kFull && e > d) {
            float *q = sum_sq + ((size_t)k * D + e) * D + d;
            *q = __fadd_rn(*q, delta);
        }
    }
}

// Rows a chunk of staged members at width D (0 where not even one fits).
int chunk_rows_for(int D) {
    const int rows = (kSmemBudget - kPass * (int)sizeof(int)) /
                     (D * (int)sizeof(float));
    return rows < kMaxChunkRows ? rows : kMaxChunkRows;
}

}  // namespace

// The block's merge, in place on counts [K], sum_x [K, D] and sum_sq
// ([K, D] unless full, else [K, D, D]): embeds / ks [B, S] int32 and rows
// [B, S, D] of the old (o) and new (n) segments, valid [B] bool; keys [2,
// Mp] (Mp = B S rounded up to a multiple of 4) and hist [2, K] int32 are
// scratch.
extern "C" int merge_stats_launch(
    const int *embeds_o, const int *ks_o, const float *rows_o,
    const int *embeds_n, const int *ks_n, const float *rows_n,
    const unsigned char *valid, int B, int S, int D, int K, int full,
    int *keys, int *hist, int *counts, float *sum_x, float *sum_sq,
    cudaStream_t stream) {
    if (B < 0 || S < 0 || D < 1 || K < 0) return (int)cudaErrorInvalidValue;
    const int M = B * S, Mp = (M + 3) & ~3;
    if (M == 0 || K == 0) return (int)cudaGetLastError();
    const int chunk_rows = chunk_rows_for(D);
    if (chunk_rows < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(hist, 0, 2 * (size_t)K * sizeof(int),
                                      stream);
    if (err != cudaSuccess) return (int)err;
    merge_keys_kernel<<<(2 * Mp + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(embeds_o, ks_o, embeds_n, ks_n, valid, M,
                                  Mp, S, K, keys, hist);
    const long long n_lanes = D + (full ? (long long)D * (D + 1) / 2 : D);
    const dim3 grid(K, (unsigned)((n_lanes + kLanesPerCta - 1) /
                                  kLanesPerCta));
    const size_t smem = ((size_t)chunk_rows * D + kPass) * sizeof(float);
    if (full)
        merge_stats_kernel<true><<<grid, kThreads, smem, stream>>>(
            keys, hist, rows_o, rows_n, Mp, D, K, (int)n_lanes, chunk_rows,
            counts, sum_x, sum_sq);
    else
        merge_stats_kernel<false><<<grid, kThreads, smem, stream>>>(
            keys, hist, rows_o, rows_n, Mp, D, K, (int)n_lanes, chunk_rows,
            counts, sum_x, sum_sq);
    return (int)cudaGetLastError();
}
