// Median-anchored trimmed mean over the client axis: (n, d) f32 -> (d,).
//
// Replaces the TPU kernel attacking_federate_learning_tpu/ops/
// pallas_defense.py:pallas_trimmed_mean_of (_trim_kernel).  Per column:
// med = the median as jnp.median computes it ((lo + hi) * 0.5 of the two
// middle order statistics, one value for odd n); dev = x - med; keep the
// k entries of smallest |dev| in a STABLE order (ties go to the lower
// row, as argsort(..., stable=True) does; ALIE's f identical rows make
// ties the normal case); return sum(kept dev) / k + med.
//
// Bound by bytes on an H100: one read of the (n, d) matrix.  The design
// (radix selection on order-preserving keys, one warp per column, no
// sort) is coord_select.cuh's, shared with the median and masked kernels.

#include "coord_select.cuh"

// G: (n, d) f32 row-major on the device; out: (d,).  1 <= k <= n, and
// n <= 25,600 (one column's staging must fit a block's shared memory).
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int fl_trimmed_mean(const float* G, int n, long long d, int k,
                               float* out, void* stream) {
    if (n <= 0 || d <= 0 || k < 1 || k > n) return (int)cudaErrorInvalidValue;
    // Every row alive: e = n, and k = n - (n - k).
    return (int)fl::coord_select<fl::kTrim, false>(G, nullptr, nullptr, n, d,
                                                   n - k, out, stream);
}
