// Coordinate-wise median over the client axis: (n, d) f32 -> (d,).
//
// Replaces the TPU kernel attacking_federate_learning_tpu/ops/
// pallas_defense.py:pallas_median_of (_median_kernel): jnp.median along
// the clients, the midpoint (lo + hi) * 0.5 of the two middle order
// statistics for even n.
//
// Bound on an H100 by instruction issue, before bytes (one read of the
// (n, d) matrix, 31.8 MB at n = 100, d = 79,510: 9.5 us at 3.35 TB/s).
// Two routes, chosen in Python (ops/defense_kernels.py:trim_plan, the
// trimmed means' plan) and passed as `padded`: n <= 128 sorts each column
// in one thread's registers and picks the two middle keys (trim_sort.cuh,
// padded rows = 32, 36, ..., 128); n > 128 (padded = 0) selects the two
// keys by radix on one warp a column (coord_select.cuh).  Both pick the
// same keys, so they agree bit for bit.  Both are shared with the masked
// kernel.

#include "trim_sort.cuh"

// G: (n, d) f32 row-major on the device; out: (d,).  padded = 32, 36,
// ..., 128 (the sort: n <= padded, d < 2^30) or 0 (radix selection:
// n <= 25,600, as one column's staging must fit a block's shared memory).
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int fl_median(const float* G, int n, long long d, int padded,
                         float* out, void* stream) {
    return (int)fl::select_route<fl::kMedian, false, false>(
        G, nullptr, nullptr, n, d, 0, padded, out, stream);
}
