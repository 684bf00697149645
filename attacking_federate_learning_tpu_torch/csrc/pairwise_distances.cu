// Pairwise Euclidean distances over the client axis: (n, d) f32 or bf16
// -> (n, n) f32.
//
// Replaces the TPU kernel attacking_federate_learning_tpu/ops/
// pallas_distances.py:pallas_pairwise_distances (_dist_kernel): a tiled
// Gram G.G^T with the epilogue sqrt(max(sq_i + sq_j - 2*acc, 0)) fused on
// the output tile and an exact zero diagonal.  Two routes:
//
// fl_pairwise_distances, f32: the Gram on the FMA units (gram_tile.cuh;
// TF32 is off limits).  What bounds it on an H100: operations, n(n-1)*d
// + 2*n*d flops of fp32 FMA: 0.80 GFLOP at the main path's n = 100, d =
// 79,510, 12 us at 67 TFLOP/s, against 31.8 MB of input (9.5 us at 3.35
// TB/s).  The design does little more work than that at any n: only the
// Gram tiles on or above the diagonal, and in them only the 8 x 8 thread
// tiles that hold such an output inside n (0.93 GFLOP at n = 100; 80.1
// GFLOP at n = 1,000 against 79.6 needed), split over d so that every SM
// has work even when n gives one tile.  Stage 1 writes S partial tiles
// and their diagonals to a workspace (20.5 MB at n = 100 with S = 311,
// 26.0 MB at n = 1,000 with S = 11; the 50 MB L2 holds either); stage 2
// sums them in a fixed order, takes the row norms from the summed
// diagonal, and writes each distance to both of its places.
//
// fl_pairwise_distances_bf16, the Pallas kernel's bf16 operand route (a
// bf16 tile product accumulated in f32, f32 norms): stage 1 on the tensor
// cores (gram_mma.cuh: wgmma on bf16 operands, f32 accumulators), the
// same epilogue.  What bounds it: bytes up to about n = 150 (2 n d bytes,
// 4.7 us at n = 100), operations above (79.7 GFLOP at n = 1,000, 81 us
// at 989 TFLOP/s dense bf16).
//
// The model axis of the mesh (parallel/mesh.py) splits d over its
// positions, so the two stages are entry points of their own too:
// fl_gram_partials (and _bf16) runs stage 1 on one position's (n, d_j)
// column block into that position's workspace; fl_gram_epilogue runs
// stage 2 on the positions' workspaces laid end to end in position order
// (every position's partial tiles, then every position's diagonals), so
// the sum runs over the partials in position order and, within a
// position, in slice order, and the norms come from the summed diagonal:
// identical rows stay exactly 0 apart across positions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_mma.cuh"
#include "gram_tile.cuh"

// G: (n, d) f32 row-major on the device; ws: f32 scratch of
// S * (tiles * 128 * 128 + nt * 128) floats, tiles = nt(nt+1)/2,
// nt = ceil(n / 128); D: (n, n) out.  The plan (S slices of cps chains of
// 256, kg k groups) comes from the caller (ops/distances.py:gram_plan).
// Launches on `stream` and returns the CUDA error code of the launches
// (0 on success).
extern "C" int fl_pairwise_distances(const float* G, int n, long long d,
                                     int S, int cps, int kg, float* ws,
                                     float* D, void* stream) {
    if (!fl::plan_ok(n, d, S, cps, kg)) return (int)cudaErrorInvalidValue;
    return (int)fl::gram_distances(G, n, d, S, cps, kg, ws, D,
                                   static_cast<cudaStream_t>(stream));
}

// As fl_pairwise_distances, with G (n, d) bf16 (its 16-bit words) and the
// tensor cores' plan (ops/distances.py:mma_plan): S slices of cps chains
// of 256, stage_k k a pipeline stage.
extern "C" int fl_pairwise_distances_bf16(const uint16_t* G, int n,
                                          long long d, int S, int cps,
                                          int stage_k, float* ws, float* D,
                                          void* stream) {
    if (!fl::mma::mma_plan_ok(n, d, S, cps, stage_k))
        return (int)cudaErrorInvalidValue;
    return (int)fl::gram_distances_bf16(G, n, d, S, cps, stage_k, ws, D,
                                        static_cast<cudaStream_t>(stream));
}

// Stage 1 alone: G (n, d) f32 (one model position's column block) into
// ws, S * (tiles * 128 * 128 + nt * 128) floats.  Plan as for
// fl_pairwise_distances.
extern "C" int fl_gram_partials(const float* G, int n, long long d, int S,
                                int cps, int kg, float* ws, void* stream) {
    if (!fl::plan_ok(n, d, S, cps, kg)) return (int)cudaErrorInvalidValue;
    return (int)fl::gram_partials(G, n, d, S, cps, kg, ws,
                                  static_cast<cudaStream_t>(stream));
}

// Stage 1 alone on the bf16 route: G (n, d) bf16 into ws (the same
// layout); plan as for fl_pairwise_distances_bf16.
extern "C" int fl_gram_partials_bf16(const uint16_t* G, int n, long long d,
                                     int S, int cps, int stage_k, float* ws,
                                     void* stream) {
    if (!fl::mma::mma_plan_ok(n, d, S, cps, stage_k))
        return (int)cudaErrorInvalidValue;
    return (int)fl::gram_partials_bf16(G, n, d, S, cps, stage_k, ws,
                                       static_cast<cudaStream_t>(stream));
}

// Stage 2 alone: ws holds S partials of an n-row Gram (S * tiles partial
// tiles, then S diagonals of nt * 128 floats), D (n, n) out.
extern "C" int fl_gram_epilogue(const float* ws, int n, int S, float* D,
                                void* stream) {
    if (n <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
    return (int)fl::gram_epilogue(ws, n, S, D,
                                  static_cast<cudaStream_t>(stream));
}
