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
// positions, so the Gram has entry points of its own there
// (gram_split.cuh): fl_gram_partials (and _bf16) runs stage 1 on one
// position's (n, d_j) column block and leaves that block's (n, n) f32
// Gram, its slices summed on the card in thread block clusters;
// fl_gram_epilogue reads the m positions' Grams where they lie and sums
// them in position order, the norms from the summed diagonal, so
// identical rows stay exactly 0 apart across positions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_mma.cuh"
#include "gram_split.cuh"
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

// Stage 1 of the split route: G (n, d) f32 (one model position's column
// block) into its Gram, gram (n, n) f32.  The plan
// (ops/distances.py:split_plan): S slices of chains of `chain` k in
// clusters of `cluster` blocks, kg k groups; mid: f32 scratch of
// tiles * S / cluster * 128 * 128 floats where S > cluster (else unused).
extern "C" int fl_gram_partials(const float* G, int n, long long d, int S,
                                int chain, int cluster, int kg, float* mid,
                                float* gram, void* stream) {
    if (!fl::split_plan_ok(n, d, S, chain, cluster) || chain % fl::kBK
        || chain > fl::kChainProducts || !fl::kgroups_ok(n, kg))
        return (int)cudaErrorInvalidValue;
    return (int)fl::gram_split(G, n, d, S, chain, cluster, kg, mid, gram,
                               static_cast<cudaStream_t>(stream));
}

// Stage 1 of the split route on the bf16 operands (their 16-bit words),
// as fl_gram_partials; stage_k k a pipeline stage, chains of a whole
// number of stages (256 k where chains are stacked, n <= 32).
extern "C" int fl_gram_partials_bf16(const uint16_t* G, int n, long long d,
                                     int S, int chain, int cluster,
                                     int stage_k, float* mid, float* gram,
                                     void* stream) {
    const int groups = fl::mma::mma_groups(n);
    if (!fl::split_plan_ok(n, d, S, chain, cluster)
        || !fl::mma::stage_ok(n, stage_k)
        || (groups > 1 ? chain != fl::mma::kChainK
                       : chain % stage_k || chain > fl::mma::kChainK)
        || fl::split_mma_smem(n, stage_k) > (size_t)fl::mma::kMaxSmem)
        return (int)cudaErrorInvalidValue;
    return (int)fl::gram_split_bf16(G, n, d, S, chain, cluster, stage_k,
                                    mid, gram,
                                    static_cast<cudaStream_t>(stream));
}

// Stage 2 of the split route: grams, a host array of the m model
// positions' (n, n) f32 Grams on the device (at most fl::kMaxGrams), in
// position order; D (n, n) out.
extern "C" int fl_gram_epilogue(const float* const* grams, int m, int n,
                                float* D, void* stream) {
    if (n <= 0 || m <= 0 || m > fl::kMaxGrams)
        return (int)cudaErrorInvalidValue;
    return (int)fl::gram_sum_epilogue(grams, m, n, D,
                                      static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` blocks of a split stage 1 the card holds
// at once (one block an SM), or minus the CUDA error.
extern "C" int fl_cluster_slots(int cluster) {
    return fl::cluster_slots(cluster);
}
