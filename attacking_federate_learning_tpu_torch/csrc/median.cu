// Coordinate-wise median over the client axis: (n, d) f32 -> (d,).
//
// Replaces the TPU kernel attacking_federate_learning_tpu/ops/
// pallas_defense.py:pallas_median_of (_median_kernel): jnp.median along
// the clients, the midpoint (lo + hi) * 0.5 of the two middle order
// statistics for even n.
//
// Bound by bytes on an H100: one read of the (n, d) matrix (31.8 MB at
// n = 100, d = 79,510: 9.5 us at 3.35 TB/s).  The design is
// coord_select.cuh's: the two order statistics by radix selection on
// order-preserving keys, one warp per column, no sort.

#include "coord_select.cuh"

// G: (n, d) f32 row-major on the device; out: (d,); n <= 25,600.
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int fl_median(const float* G, int n, long long d, float* out,
                         void* stream) {
    return (int)fl::coord_select<fl::kMedian, false>(G, nullptr, nullptr, n,
                                                     d, 0, out, stream);
}
