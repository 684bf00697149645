// Pairwise Euclidean distances over the client axis: (n, d) f32 -> (n, n).
//
// Replaces the TPU kernel attacking_federate_learning_tpu/ops/
// pallas_distances.py:pallas_pairwise_distances (_dist_kernel): a tiled
// Gram G.G^T with the epilogue sqrt(max(sq_i + sq_j - 2*acc, 0)) fused on
// the output tile and an exact zero diagonal.
//
// What bounds it on an H100: the Gram's fp32 FMA work outside the tensor
// cores (tensor cores would mean TF32, which the port's fp32 parity
// forbids).  The function needs n(n-1)/2 dot products, n(n-1)*d + 2*n*d
// flops with the row norms: 0.80 GFLOP at the main path's n = 100,
// d = 79,510, against 31.8 MB of input, far above the card's
// operations-per-byte balance.  The kernel computes both halves of the
// symmetric Gram (2*n^2*d), twice that; skipping the tiles below the
// diagonal is room for a later speed-up.  The design: row norms summed in
// the Gram's own order (so identical rows are exactly 0 apart), then one
// cluster of S blocks per (BM rows x 128 columns) output tile
// (gram_tile.cuh).  At small n there are few tiles (n = 100 has 128 x 100
// outputs in all), so the tile plan splits d over a cluster of up to 8
// blocks, whose partial tiles are summed through distributed shared
// memory, and each block splits its slice again across its warps; at
// large n, BM grows to 32 and every warp keeps a 4 x 4 register tile of
// its own rows.  The epilogue runs on the summed tile, each block of the
// cluster on its share of the outputs, and writes each distance once; the
// Gram never reaches device memory.

#include <cuda_runtime.h>

#include "gram_tile.cuh"

namespace fl {

// Grid: x = column tile * S + rank (clusters of S along x), y = row tile.
template <int BM>
__global__ void __launch_bounds__(kThreads)
pairwise_distances_kernel(const float* __restrict__ G, int n, long long d,
                          const float* __restrict__ sq,
                          float* __restrict__ D) {
    __shared__ __align__(16) GramSmem<BM> s;
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    const unsigned rank = cluster.block_rank();
    const unsigned ranks = cluster.num_blocks();
    const int col0 = blockIdx.x / ranks * kBN;
    const int row0 = blockIdx.y * BM;
    long long k0, k1;
    slice_bounds(d, rank, ranks, k0, k1);
    gram_tile<BM>(G, n, d, k0, k1, row0, col0, s);
    cluster.sync();
    for (int o = rank * kThreads + threadIdx.x; o < BM * kBN;
         o += ranks * kThreads) {
        const int i = row0 + o / kBN;
        const int j = col0 + o % kBN;
        if (i < n && j < n) {
            const float d2 = sq[i] + sq[j] - 2.0f * cluster_sum(cluster, s, o);
            D[(long long)i * n + j] = (i == j) ? 0.0f : sqrtf(fmaxf(d2, 0.0f));
        }
    }
    cluster.sync();     // no block leaves while another reads its tile
}

template <int BM>
cudaError_t launch(const float* G, int n, long long d, float* sq, float* D,
                   int ranks, cudaStream_t stream) {
    row_sqnorms_kernel<BM><<<n, kThreads, 0, stream>>>(G, d, ranks, sq);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kBN - 1) / kBN * ranks, (n + BM - 1) / BM);
    err = launch_clusters(pairwise_distances_kernel<BM>, grid, ranks, 0,
                          stream, G, n, d, (const float*)sq, D);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace fl

// G: (n, d) f32 row-major on the device; sq: (n,) scratch; D: (n, n) out.
// The tile plan (fl::tile_plan) follows n and the card's SM count.
// Launches on `stream` and returns the CUDA error code of the launches
// (0 on success).
extern "C" int fl_pairwise_distances(const float* G, int n, long long d,
                                     float* sq, float* D, void* stream) {
    if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    int bm = 0, ranks = 0;
    const cudaError_t err =
        fl::tile_plan(n, (n + fl::kBN - 1) / fl::kBN, bm, ranks);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (bm) {
        case 4: return (int)fl::launch<4>(G, n, d, sq, D, ranks, st);
        case 8: return (int)fl::launch<8>(G, n, d, sq, D, ranks, st);
        case 16: return (int)fl::launch<16>(G, n, d, sq, D, ranks, st);
        default: return (int)fl::launch<32>(G, n, d, sq, D, ranks, st);
    }
}
