// Special functions of the port's kernels.
//
// lgamma_stirling is the recurrence-lifted Stirling series of
// segmentalist_tpu/ops/pallas_chain.py::_lgamma_stirling (:604-623), in the
// operation order of its plain version (ops/special.py): lift z by 6 with
// shift = 0 + log z + log(z + 1) + ... + log(z + 5), then the series at
// z + 6 summed left to right.  The constants are float32 values rounded
// once from doubles, as the plain version's Python floats are.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float lgamma_stirling(float z) {
    constexpr float kHalfLog2Pi = (float)0.91893853320467274178;  // log(2 pi)/2
    constexpr float kInv12 = (float)(1.0 / 12.0);
    constexpr float kInv360 = (float)(1.0 / 360.0);
    constexpr float kInv1260 = (float)(1.0 / 1260.0);
    float shift = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) shift = shift + logf(z + (float)i);
    const float z6 = z + 6.0f;
    const float inv = 1.0f / z6;
    const float inv2 = inv * inv;
    float series = (z6 - 0.5f) * logf(z6);
    series = series - z6;
    series = series + kHalfLog2Pi;
    series = series + inv * kInv12;
    series = series - (inv * inv2) * kInv360;
    series = series + ((inv * inv2) * inv2) * kInv1260;
    return series - shift;
}

// lgamma((v + a) / 2) - lgamma(v / 2): the count-dependent Student-t
// constant of the diag chains (a = 1) and of the full-covariance chain
// (a = D).
__device__ __forceinline__ float lgamma_ratio(float v, float a = 1.0f) {
    return lgamma_stirling((v + a) / 2.0f) - lgamma_stirling(v / 2.0f);
}
