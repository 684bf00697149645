// The Gram split over d across the model axis of a mesh: stage 1 on one
// model position's (n, d_j) column block ends in that block's (n, n) f32
// Gram, and the epilogue reads the m positions' Grams where they lie.
// Used by pairwise_distances.cu's fl_gram_partials (and _bf16) and
// fl_gram_epilogue only; the fused kernels 1 and 2 do not launch any of
// it.
//
// Replaces no TPU kernel of its own: the two halves of
// attacking_federate_learning_tpu/ops/pallas_distances.py:
// pallas_pairwise_distances (_dist_kernel) where the JAX package shards
// d over the model axis and XLA sums the Gram across it.
//
// What bounds stage 1 on an H100: as the fused stage 1 (gram_tile.cuh,
// gram_mma.cuh), operations on the f32 route (n(n-1) d + 2 n d flops,
// 5.9 us at n = 100, d = 39,755), bytes on the bf16 route up to about
// n = 150 (2 n d, 2.4 us); its output is 4 n^2 bytes (40 KB at n = 100).
// The design.  The fused route's plan fills the card with S slices and
// writes S partial tiles (64 KB each at n = 100) for a second launch to
// sum; the split route's plan (ops/distances.py:split_plan) keeps S, but
// runs the slices in thread block clusters of C blocks, a cluster's
// blocks taking C consecutive slices of one tile (block = tile * S + s).
// After its main loop each block holds its partial tile in its own shared
// memory (the f32 route in a tile beside its ring, the bf16 route in its
// ring, which the loop no longer needs).  cluster_sum then sums the C
// tiles through distributed shared memory in rank order, the block of
// rank r taking rows r, r + C, ... of the tile, so only S / C partial
// tiles reach device memory (none where S = C: the cluster writes the
// Gram itself), and gram_tail_kernel sums those R = S / C in order into
// the Gram, in a second launch of the same entry point.  The Gram is
// written whole, each entry (i, j) and (j, i) from the one sum of the
// upper-triangle entry, so it is symmetric bit for bit.
//
// The epilogue, gram_sum_epilogue_kernel, one launch: the m positions'
// Grams, their device pointers passed by value (GramPtrs, at most
// kMaxGrams), summed in position order for each entry and for the two
// norms (the summed diagonal), then sqrt(max(sq_i + sq_j - 2 g, 0)) with
// an exact zero diagonal.  What bounds it: bytes, the m Grams read and D
// written, 4 n^2 (m + 1) (120 KB at n = 100, m = 2: 36 ns at 3.35 TB/s);
// a launch costs more.
//
// Summation order (gram_tile.cuh's note for the main loop): the slice's
// chains added in order into its partial (the first stored); the C
// partials of a cluster in rank order; the R cluster sums in order; the m
// positions' Grams in position order.  No float atomics, so two launches
// give the same bits, and every entry of a tile, diagonal included, is
// summed the same way, so two bit-identical rows i, j give g_ij == g_ii ==
// g_jj and their distance is exactly 0 (ALIE's crafted rows).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "gram_mma.cuh"
#include "gram_tile.cuh"

namespace fl {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;   // 16 needs the non-portable attribute
constexpr int kPortableCluster = 8;
constexpr int kMaxGrams = 32;     // positions the epilogue reads
constexpr int kTileFloats = kT * kT;

// Shared memory of the f32 split kernel: stage 1's, then the block's
// partial tile.
template <int KG>
constexpr size_t split_smem() {
    return stage1_smem<KG>() + kTileFloats * sizeof(float);
}

// After stage 1's main loop: the C blocks of the cluster hold the partial
// tiles of C consecutive slices of tile `tile` in their shared memory
// (`part`, [128][128]).  The block of rank r sums rows r, r + C, ... of
// the tile across the C tiles in rank order and writes each sum once: to
// mid[tile][s / C] (R = S / C > 1), or, where the cluster is the tile's
// only one, into the Gram at (i, j) and (j, i).  Only the entries inside
// n, and on a diagonal tile those on or above its diagonal, are read.
__device__ __forceinline__ void cluster_sum(const float* part, int n,
                                            int nt, int S,
                                            float* __restrict__ mid,
                                            float* __restrict__ gram) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                 // every tile of the cluster is staged
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int tile = blockIdx.x / S;
    const int R = S / C;
    const int rs = (blockIdx.x % S) / C;     // the cluster's run
    int ti, tj;
    tile_coords(tile, nt, ti, tj);
    const bool diag = ti == tj;
    const int row0 = ti * kT, col0 = tj * kT;
    const int rows = min(kT, n - row0), cols = min(kT, n - col0);
    const int mine = (rows - rank + C - 1) / C;
    for (int e = threadIdx.x; e < mine * kT; e += blockDim.x) {
        const int i = rank + C * (e / kT);
        const int j = e % kT;
        if (j >= cols || (diag && j < i)) continue;
        const int at = i * kT + j;
        // Every rank's entry is loaded before the first add, so the loads
        // wait on distributed shared memory once, not C times.
        float x[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
            x[q] = q < C ? *cluster.map_shared_rank(part + at, q) : 0.0f;
        float v = x[0];
#pragma unroll
        for (int q = 1; q < kMaxCluster; ++q)
            if (q < C) v += x[q];
        if (R == 1) {
            gram[(long long)(row0 + i) * n + col0 + j] = v;
            gram[(long long)(col0 + j) * n + row0 + i] = v;
        } else {
            mid[((long long)(tile * R + rs) * kT + i) * kT + j] = v;
        }
    }
    cluster.sync();                 // no tile goes while another reads it
}

// The split route's f32 stage 1: grid tiles * S blocks in clusters of C,
// S a multiple of C; chains of cpc chunks of 32 k.  Dynamic shared
// memory: split_smem<KG>().
template <int KG, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
gram_split_kernel(const float* __restrict__ G, int n, long long d, int nt,
                  int S, int cpc, float* __restrict__ mid,
                  float* __restrict__ gram) {
    constexpr size_t kPartAt = stage1_smem<KG>() / sizeof(float);
    extern __shared__ float4 split_smem4[];
    float* part = reinterpret_cast<float*>(split_smem4) + kPartAt;
    gram_tile_partial<KG, VEC, true>(G, n, d, nt, 0, part, S, cpc);
    cluster_sum(part, n, nt, S, mid, gram);
}

// The split route's bf16 stage 1 on the tensor cores: as
// gram_split_kernel, chains of chain_steps k16 steps.  Dynamic shared
// memory: split_mma_smem(n, stage_k).
template <int WGS, int N, int KS>
__global__ void __launch_bounds__(WGS * 128, 1)
gram_mma_split_kernel(const uint16_t* __restrict__ G, int n, long long d,
                      int nt, int S, int chain_steps, int stage_k,
                      float* __restrict__ mid, float* __restrict__ gram) {
    const float* part = mma::mma_tile_partial<WGS, N, KS, true>(
        G, n, d, nt, 0, stage_k, nullptr, S, chain_steps);
    cluster_sum(part, n, nt, S, mid, gram);
}

// The bf16 split kernel's shared memory: the ring, or the partial tile
// where the ring is smaller.
inline size_t split_mma_smem(int n, int stage_k) {
    const size_t ring = mma::ring_smem(n, stage_k);
    const size_t tile = kTileFloats * sizeof(float) + mma::kAlign;
    return ring > tile ? ring : tile;
}

// The tail: Gram entry (i, j), i <= j, as the sum of its tile's R cluster
// sums in order, written to (i, j) and (j, i).  One thread an entry of the
// (n, n) Gram, row by row, so a warp's reads of a cluster sum are one
// line; the threads below the diagonal have nothing to do.
__global__ void __launch_bounds__(kThreads)
gram_tail_kernel(const float* __restrict__ mid, int n, int nt, int R,
                 float* __restrict__ gram) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= (long long)n * n) return;
    const int i = (int)(e / n), j = (int)(e % n);
    if (j < i) return;
    const int ti = i / kT, tj = j / kT;
    const float* p = mid
        + ((long long)tile_index(ti, tj, nt) * R * kT + (i - ti * kT)) * kT
        + (j - tj * kT);
    float v = p[0];
#pragma unroll 32
    for (int r = 1; r < R; ++r) v += p[(long long)r * kTileFloats];
    gram[e] = v;
    gram[(long long)j * n + i] = v;
}

// The m positions' Grams, passed by value.
struct GramPtrs {
    const float* p[kMaxGrams];
};

// Stage 2 of the split route: D (n, n) from the m Grams summed in
// position order, the norms from the summed diagonal, an exact zero
// diagonal.  One thread an entry (i, j), i <= j, row by row as the tail;
// it writes D[i][j] and D[j][i] from one value.
__global__ void __launch_bounds__(kThreads)
gram_sum_epilogue_kernel(const __grid_constant__ GramPtrs grams, int m,
                         int n, float* __restrict__ D) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= (long long)n * n) return;
    const int i = (int)(e / n), j = (int)(e % n);
    if (j < i) return;
    if (i == j) {
        D[e] = 0.0f;
        return;
    }
    const long long ii = (long long)i * n + i, jj = (long long)j * n + j;
    float g = grams.p[0][e], sq_i = grams.p[0][ii], sq_j = grams.p[0][jj];
    for (int q = 1; q < m; ++q) {
        g += grams.p[q][e];
        sq_i += grams.p[q][ii];
        sq_j += grams.p[q][jj];
    }
    const float val = sqrtf(fmaxf(sq_i + sq_j - 2.0f * g, 0.0f));
    D[e] = val;
    D[(long long)j * n + i] = val;
}

// Checks a split plan from the wrapper: S slices, a multiple of the
// cluster C (1 to 16, a power of two), at most one a chain of `chain` k,
// so that none is empty.
inline bool split_plan_ok(int n, long long d, int S, int chain,
                          int cluster) {
    if (n <= 0 || d <= 0 || S <= 0 || chain <= 0) return false;
    if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1))
        || S % cluster)
        return false;
    return (long long)S <= (d + chain - 1) / chain;
}

// A launch of Kernel on `blocks` blocks of `threads` in clusters of
// `cluster`.  The kernel's attributes (the largest dynamic shared memory
// a block may take, clusters of 16) are set once a device.
template <auto Kernel, typename... Args>
cudaError_t launch_clusters(int blocks, int threads, int smem, int cluster,
                            cudaStream_t stream, Args... args) {
    static std::atomic<unsigned> ready{0};   // bit d: set on device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32 || !((ready.load() >> dev) & 1u)) {
        err = cudaFuncSetAttribute(
            Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            mma::kMaxSmem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
        if (dev < 32) ready.fetch_or(1u << dev);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, Kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// The tail where R = S / C > 1.
inline cudaError_t launch_tail(const float* mid, int n, int nt, int R,
                               float* gram, cudaStream_t stream) {
    if (R == 1) return cudaSuccess;
    const long long total = (long long)n * n;
    gram_tail_kernel<<<(int)((total + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(mid, n, nt, R, gram);
    return cudaGetLastError();
}

template <int KG>
cudaError_t launch_split(const float* G, int n, long long d, int nt, int S,
                         int cpc, int cluster, float* mid, float* gram,
                         cudaStream_t stream) {
    const int smem = (int)split_smem<KG>();
    const int blocks = nt * (nt + 1) / 2 * S;
    const unsigned long long base = reinterpret_cast<unsigned long long>(G);
    if (base % 16 == 0 && d % 4 == 0)
        return launch_clusters<gram_split_kernel<KG, 4>>(
            blocks, kThreads, smem, cluster, stream, G, n, d, nt, S, cpc,
            mid, gram);
    if (base % 8 == 0 && d % 2 == 0)
        return launch_clusters<gram_split_kernel<KG, 2>>(
            blocks, kThreads, smem, cluster, stream, G, n, d, nt, S, cpc,
            mid, gram);
    return launch_clusters<gram_split_kernel<KG, 1>>(
        blocks, kThreads, smem, cluster, stream, G, n, d, nt, S, cpc, mid,
        gram);
}

// The f32 split route's stage 1 on `stream`: the Gram of G (n, d) into
// gram (n, n), through mid (tiles * S / C partial tiles) where S > C.
inline cudaError_t gram_split(const float* G, int n, long long d, int S,
                              int chain, int cluster, int kg, float* mid,
                              float* gram, cudaStream_t stream) {
    const int nt = (n + kT - 1) / kT;
    const int cpc = chain / kBK;
    const cudaError_t err =
        kg == 4   ? launch_split<4>(G, n, d, nt, S, cpc, cluster, mid, gram,
                                    stream)
        : kg == 2 ? launch_split<2>(G, n, d, nt, S, cpc, cluster, mid, gram,
                                    stream)
                  : launch_split<1>(G, n, d, nt, S, cpc, cluster, mid, gram,
                                    stream);
    if (err != cudaSuccess) return err;
    return launch_tail(mid, n, nt, S / cluster, gram, stream);
}

template <int WGS, int N, int KS>
cudaError_t launch_mma_split(const uint16_t* G, int n, long long d, int nt,
                             int S, int chain, int cluster, int stage_k,
                             float* mid, float* gram, cudaStream_t stream) {
    return launch_clusters<gram_mma_split_kernel<WGS, N, KS>>(
        nt * (nt + 1) / 2 * S, WGS * 128, (int)split_mma_smem(n, stage_k),
        cluster, stream, G, n, d, nt, S, chain / mma::kStepK, stage_k, mid,
        gram);
}

// The bf16 split route's stage 1 on `stream`, as gram_split.
inline cudaError_t gram_split_bf16(const uint16_t* G, int n, long long d,
                                   int S, int chain, int cluster,
                                   int stage_k, float* mid, float* gram,
                                   cudaStream_t stream) {
    const int nt = (n + kT - 1) / kT;
    const int groups = mma::mma_groups(n);
    const cudaError_t err =
        groups == 4 ? launch_mma_split<1, 64, 4>(G, n, d, nt, S, chain,
                                                 cluster, stage_k, mid, gram,
                                                 stream)
        : groups == 2 ? launch_mma_split<1, 64, 2>(G, n, d, nt, S, chain,
                                                   cluster, stage_k, mid,
                                                   gram, stream)
        : mma::mma_cols(n) == 64
            ? launch_mma_split<1, 64, 1>(G, n, d, nt, S, chain, cluster,
                                         stage_k, mid, gram, stream)
            : launch_mma_split<2, 128, 1>(G, n, d, nt, S, chain, cluster,
                                          stage_k, mid, gram, stream);
    if (err != cudaSuccess) return err;
    return launch_tail(mid, n, nt, S / cluster, gram, stream);
}

// Stage 2 of the split route on `stream`: D (n, n) from the m <=
// kMaxGrams Grams at grams[0 .. m).
inline cudaError_t gram_sum_epilogue(const float* const* grams, int m, int n,
                                     float* D, cudaStream_t stream) {
    GramPtrs ptrs = {};
    for (int q = 0; q < m; ++q) ptrs.p[q] = grams[q];
    const long long total = (long long)n * n;
    gram_sum_epilogue_kernel<<<(int)((total + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(ptrs, m, n, D);
    return cudaGetLastError();
}

// How many clusters of `cluster` blocks of the f32 split kernel (one
// block an SM) the card holds at once: cudaOccupancyMaxActiveClusters,
// or minus the CUDA error.
inline int cluster_slots(int cluster) {
    auto kernel = gram_split_kernel<2, 1>;
    const int smem = (int)split_smem<2>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && cluster > kPortableCluster)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, (void*)kernel, &cfg);
    return err == cudaSuccess ? count : -(int)err;
}

}  // namespace fl
