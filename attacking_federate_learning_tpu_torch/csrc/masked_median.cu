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
// Bound on an H100 by instruction issue, before bytes (one read of the
// (n, d) matrix).  The routes are median.cu's: n <= 128 sorts each column
// in one thread's registers (trim_sort.cuh; the weighted median then
// bisects over the sorted keys, one row-order pass over the column a
// step), n > 128 selects by radix on one warp a column (coord_select.cuh).
// With every row alive it does the unmasked kernel's arithmetic in the
// same order, so its output is bit for bit fl_median's.

#include "trim_sort.cuh"

// G: (n, d) f32 row-major; mask: (n,) bytes, nonzero = alive; w: (n,) f32
// (read only when `weighted`); out: (d,).  padded as for fl_median.
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int fl_masked_median(const float* G, const unsigned char* mask,
                                const float* w, int n, long long d,
                                int weighted, int padded, float* out,
                                void* stream) {
    if (mask == nullptr || (weighted && w == nullptr))
        return (int)cudaErrorInvalidValue;
    return (int)(weighted
        ? fl::select_route<fl::kMedian, true, true>(G, mask, w, n, d, 0,
                                                    padded, out, stream)
        : fl::select_route<fl::kMedian, true, false>(G, mask, nullptr, n, d,
                                                     0, padded, out,
                                                     stream));
}
