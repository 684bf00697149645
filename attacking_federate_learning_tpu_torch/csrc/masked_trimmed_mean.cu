// Mask-aware median-anchored trimmed mean: (n, d) f32, (n,) mask, (n,)
// weights -> (d,).
//
// Replaces the TPU kernel attacking_federate_learning_tpu/ops/
// pallas_defense.py:pallas_masked_trimmed_mean (_masked_trim_kernel,
// through _masked_coord_call).  Per column, over the alive rows only: med
// = the alive median (unweighted); dev = x - med; keep the k = max(e -
// k_delta, 1) alive entries of smallest |dev| in stable row order, e the
// alive count; return sum(kept dev) / k + med, or with `weighted`
// sum(w dev) / max(sum w, 1e-12) + med over the same kept set.  k_delta
// is f + 1 for TrimmedMean and 2f + 1 for Bulyan's tail.  e and k come
// from the mask inside the kernel: no device-to-host read per call.
//
// Bound on an H100 by instruction issue, before bytes (one read of the
// (n, d) matrix).  The routes are trimmed_mean.cu's: n <= 128 sorts each
// column in one thread's registers (trim_sort.cuh), n > 128 selects by
// radix on one warp a column (coord_select.cuh).  Dead rows enter no sum
// and sort last, which is what the Pallas kernel's +inf keys achieve
// (k <= e whenever e >= 1).  With every row alive it does the unmasked
// kernel's arithmetic in the same order, so its output is bit for bit
// fl_trimmed_mean's.

#include "trim_sort.cuh"

// G: (n, d) f32 row-major; mask: (n,) bytes, nonzero = alive; w: (n,) f32
// (read only when `weighted`); out: (d,).  k_delta >= 0; padded as for
// fl_trimmed_mean.  Launches on `stream`; returns the CUDA error code (0
// on success).
extern "C" int fl_masked_trimmed_mean(const float* G,
                                      const unsigned char* mask,
                                      const float* w, int n, long long d,
                                      int k_delta, int weighted, int padded,
                                      float* out, void* stream) {
    if (mask == nullptr || k_delta < 0 || (weighted && w == nullptr))
        return (int)cudaErrorInvalidValue;
    return (int)(weighted
        ? fl::select_route<fl::kTrim, true, true>(G, mask, w, n, d,
                                                  k_delta, padded, out,
                                                  stream)
        : fl::select_route<fl::kTrim, true, false>(G, mask, nullptr, n, d,
                                                   k_delta, padded, out,
                                                   stream));
}
