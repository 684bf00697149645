// Mask-aware coordinate-wise median: (n, d) f32, (n,) mask, (n,) weights
// -> (d,).
//
// Replaces the TPU kernel attacking_federate_learning_tpu/ops/
// pallas_defense.py:pallas_masked_median (_masked_median_kernel, through
// _masked_coord_call).  Per column, over the alive rows only: the median
// (srt[(e-1)//2] + srt[e//2]) / 2 of the e alive values, or with
// `weighted` the LOWER weighted median, the smallest alive value v whose
// alive weight at or below it reaches half the alive weight.  e = 0 gives
// +inf, as the Pallas kernel's picks of its +inf sentinels do.
//
// Bound by bytes on an H100: one read of the (n, d) matrix.  The design
// is coord_select.cuh's: order statistics, and for the weighted median a
// radix selection on summed weights, over order-preserving keys, one
// warp per column, no sort.

#include "coord_select.cuh"

// G: (n, d) f32 row-major; mask: (n,) bytes, nonzero = alive; w: (n,) f32
// (read only when `weighted`); out: (d,).  n <= 25,600.
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int fl_masked_median(const float* G, const unsigned char* mask,
                                const float* w, int n, long long d,
                                int weighted, float* out, void* stream) {
    if (mask == nullptr || (weighted && w == nullptr))
        return (int)cudaErrorInvalidValue;
    return (int)(weighted
        ? fl::coord_select<fl::kMedian, true>(G, mask, w, n, d, 0, out,
                                              stream)
        : fl::coord_select<fl::kMedian, false>(G, mask, nullptr, n, d, 0,
                                               out, stream));
}
