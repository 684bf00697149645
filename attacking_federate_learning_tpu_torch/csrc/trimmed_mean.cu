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
// Bound on an H100 by instruction issue, before bytes (one read of the
// (n, d) matrix, 9.5 us at n = 100, d = 79,510).  Two routes, chosen in
// Python (ops/defense_kernels.py:trim_plan) and passed as `padded`:
// n <= 128 sorts each column in one thread's registers (trim_sort.cuh,
// padded rows = 32, 36, ..., 128); n > 128 (padded = 0) selects by radix
// on one warp a column (coord_select.cuh's kTrim branch).  Both are shared
// with the masked kernel.

#include "trim_sort.cuh"

// G: (n, d) f32 row-major on the device; out: (d,).  1 <= k <= n;
// padded = 32, 36, ..., 128 (the sort: n <= padded, d < 2^30) or 0 (radix
// selection: n <= 25,600, as one column's staging must fit a block's
// shared memory).
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int fl_trimmed_mean(const float* G, int n, long long d, int k,
                               int padded, float* out, void* stream) {
    if (n <= 0 || d <= 0 || k < 1 || k > n) return (int)cudaErrorInvalidValue;
    // Every row alive: e = n, and k = n - (n - k).
    return (int)fl::select_route<fl::kTrim, false, false>(
        G, nullptr, nullptr, n, d, n - k, padded, out, stream);
}
