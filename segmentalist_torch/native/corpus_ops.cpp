// Native host-side corpus operations.
//
// TPU-native counterpart of the reference's only native component, the Cython
// scalar kernels (_cython_utils.pyx): on TPU the hot math moved to XLA/Pallas,
// so the native layer instead owns the host-side corpus preparation that is
// Python-loop bound at scale:
//
//   * random boundary initialisation with rejection resampling on the
//     n_slices_min/max constraints (reference utterances.py:136-157) -- a
//     data-dependent loop per utterance that cannot be jitted;
//   * batch segmentation queries (reference utterances.py:159-216);
//   * dense windowed packing of triangular vec_ids/durations rows
//     (the [U, N_max, W] layout consumed by the device sweeps).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <random>

extern "C" {

// xorshift-based deterministic RNG so results are reproducible from a seed.
static inline double next_uniform(uint64_t *state) {
    uint64_t x = *state;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    *state = x;
    return (double)(x >> 11) * (1.0 / 9007199254740992.0);
}

// Decode a boundary row into segment (start, end-inclusive) pairs.
// Returns the number of segments.
static int decode_segments(const uint8_t *bounds, int length,
                           int *starts, int *ends) {
    int n = 0;
    int j_prev = 0;
    for (int j = 0; j < length; ++j) {
        if (bounds[j]) {
            starts[n] = j_prev;
            ends[n] = j;
            j_prev = j + 1;
            ++n;
        }
    }
    return n;
}

// vec_ids triangular index of span [start : end+1).
static inline int64_t tri_index(int64_t end_excl, int64_t start) {
    return end_excl * (end_excl - 1) / 2 + start;
}

// Random boundary initialisation with rejection resampling
// (reference utterances.py:136-157).  boundaries: [n_utt, n_max] uint8 (out);
// vec_ids: [n_utt, n_max*(n_max+1)/2] int64; lengths: [n_utt] int64.
void init_boundaries_random(
    const int64_t *lengths, const int64_t *vec_ids, int64_t n_utt,
    int64_t n_max, double p_boundary_init, int64_t n_slices_min,
    int64_t n_slices_max, uint64_t seed, uint8_t *boundaries) {
    const int64_t T = n_max * (n_max + 1) / 2;
    int *starts = new int[n_max];
    int *ends = new int[n_max];
    uint64_t rng = seed ? seed : 0x9E3779B97F4A7C15ull;

    for (int64_t u = 0; u < n_utt; ++u) {
        const int64_t N = lengths[u];
        uint8_t *row = boundaries + u * n_max;
        const int64_t *vrow = vec_ids + u * T;
        for (;;) {
            for (int64_t j = 0; j < N; ++j)
                row[j] = next_uniform(&rng) < p_boundary_init ? 1 : 0;
            row[N - 1] = 1;

            int n_seg = decode_segments(row, (int)N, starts, ends);
            // Reject if every segment's embedding is missing.
            bool any_embed = false;
            int span_max = 0, span_min = (int)N + 1;
            for (int s = 0; s < n_seg; ++s) {
                int span = ends[s] - starts[s] + 1;
                if (span > span_max) span_max = span;
                if (span < span_min) span_min = span;
                int64_t k = tri_index(ends[s] + 1, starts[s]);
                if (vrow[k] != -1) any_embed = true;
            }
            if (!any_embed) continue;
            if ((span_max <= n_slices_max && span_min >= n_slices_min) ||
                N <= n_slices_min)
                break;
        }
    }
    delete[] starts;
    delete[] ends;
}

// Batch segmentation query: embedding ids of the current segmentation
// (reference get_segmented_embeds_i, utterances.py:159-174).
// out_ids: [n_utt, n_max] int64, padded with -2 beyond the segment count
// (-1 is a legitimate "missing embedding" value).
void segmented_embeds(
    const uint8_t *boundaries, const int64_t *vec_ids, const int64_t *lengths,
    int64_t n_utt, int64_t n_max, int64_t *out_ids) {
    const int64_t T = n_max * (n_max + 1) / 2;
    for (int64_t u = 0; u < n_utt; ++u) {
        const uint8_t *row = boundaries + u * n_max;
        const int64_t *vrow = vec_ids + u * T;
        int64_t *orow = out_ids + u * n_max;
        int64_t n = 0;
        int64_t j_prev = 0;
        for (int64_t j = 0; j < lengths[u]; ++j) {
            if (row[j]) {
                orow[n++] = vrow[tri_index(j + 1, j_prev)];
                j_prev = j + 1;
            }
        }
        for (; n < n_max; ++n) orow[n] = -2;
    }
}

// Dense windowed packing: seg_ids[u, t, w] = vec_ids[u, tri(t+1, t-w)]
// (the device layout, see segmentalist_tpu/corpus.py).
void pack_dense(
    const int64_t *vec_ids, const double *durations, const int64_t *lengths,
    int64_t n_utt, int64_t n_max, int64_t W,
    int64_t *seg_ids, double *seg_durs) {
    const int64_t T = n_max * (n_max + 1) / 2;
    const double nan_v = std::nan("");
    for (int64_t u = 0; u < n_utt; ++u) {
        const int64_t *vrow = vec_ids + u * T;
        const double *drow = durations + u * T;
        const int64_t N = lengths[u];
        for (int64_t t = 0; t < n_max; ++t) {
            int64_t *srow = seg_ids + (u * n_max + t) * W;
            double *durw = seg_durs + (u * n_max + t) * W;
            for (int64_t w = 0; w < W; ++w) {
                if (t < N && w <= t) {
                    int64_t k = tri_index(t + 1, t - w);
                    srow[w] = vrow[k];
                    durw[w] = drow[k];
                } else {
                    srow[w] = -1;
                    durw[w] = nan_v;
                }
            }
        }
    }
}

}  // extern "C"
