// Shared pieces of the two distance kernels (pairwise_distances.cu and
// krum_scores.cu): the tile plan, one block's fp32 Gram tile, and the row
// norms summed in the Gram's own order.
//
// A block computes the (BM x 128) tile  acc[r][c] = sum_k G[row0+r][k] *
// G[col0+c][k]  over one slice [k0, k1) of the contraction axis, with plain
// fp32 FMA (no tensor cores, so no TF32).  The slice is walked in chunks
// of 32 staged through shared
// memory, with the next chunk's global loads issued into registers
// before the current chunk is consumed.  The 8 warps of the block are
// split into BM/4 row groups of 4 rows and 8/(BM/4) k groups: at small
// BM (small n, few blocks) most warps split the contraction and their
// partial tiles are summed through shared memory in a fixed order, at
// BM = 32 every warp owns 4 rows outright.  Each lane holds a 4 x 4
// register tile: 4 rows x the columns lane, lane+32, lane+64, lane+96.
//
// Summation order.  A warp's FMA chain restarts after kChainProducts = 256
// products (256 / KPW chunks, KPW = its share of a chunk) and is added to
// a running total, so the totals add at most ceil(d / 256) chains: the
// longest sequential dependency of any output is under 256 + ceil(d/256)
// + 8 + 8 roundings, whatever the plan (the last two terms: the k-group
// and cluster-rank sums).  The restart matters at large n, where a plan
// of one block per tile and one k group would otherwise sum all of d in
// one chain, with rounding error growing as its square root.  Every
// output is summed in the same order whatever its
// position in the tile, so acc[i][j] == acc[j][i] bit for bit and the
// distance matrix comes out exactly symmetric; row_sqnorms_kernel sums
// sq[i] in that order too, so for two identical rows sq_i == sq_j ==
// acc[i][j] and their distance is exactly 0 (ALIE's crafted rows), not
// the square root of cancellation noise.
//
// Rows and columns beyond n, and k beyond k1, read as 0, so ragged n and
// d never read out of bounds.
//
// A cluster of S blocks shares one output tile: block rank q sums the
// q-th slice of d (slice_bounds), and cluster_sum adds the S partial
// tiles in rank order through distributed shared memory, so the split
// keeps the symmetry and never writes a partial sum to device memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace fl {

constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;              // tile columns
constexpr int kBK = 32;               // d-chunk per shared-memory stage
constexpr int kBNPad = kBN + 1;       // conflict-free transposed stores
constexpr int kChainProducts = 256;   // products per FMA chain (see above)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// (rows per tile bm, blocks per cluster ranks) of the two distance kernels.
// A cluster of `ranks` blocks computes one tile of bm rows, each block over
// 1/ranks of d.  The card reads G once per row tile, so the tallest tile
// comes first, with the smallest cluster that gives three quarters of the
// SMs a block (`col_tiles` tiles share a row tile's rows); at small n,
// where even 8 do not, the shortest tile with 8.
inline cudaError_t tile_plan(int n, int col_tiles, int& bm, int& ranks) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    for (int b = 32; b >= 8; b /= 2)
        for (int r = 1; r <= 8; r *= 2)
            if (4LL * ((n + b - 1) / b) * col_tiles * r >= 3LL * sms) {
                bm = b;
                ranks = r;
                return cudaSuccess;
            }
    bm = 4;
    ranks = 8;
    return cudaSuccess;
}

// Shared memory a gram tile needs (floats), as one static block.
template <int BM>
struct GramSmem {
    static_assert(BM == 4 || BM == 8 || BM == 16 || BM == 32, "BM");
    // [k][row] in groups of 4 rows; group g of k sits at slot g ^ (k % RG)
    // so the transposed stores spread over banks, and a 16-byte group
    // read stays one aligned float4.
    float a[kBK * BM];
    float b[kBK * kBNPad];             // [k][col], padded
    float red[kWarps * 4 * kBN];       // partial tiles; tile result in [0, BM*kBN)
};

// [k0, k1) of the contraction axis for block `rank` of `ranks`: whole
// chunks of kBK, so every tile splits d at the same places.
__device__ __forceinline__ void slice_bounds(long long d, unsigned rank,
                                             unsigned ranks, long long& k0,
                                             long long& k1) {
    const long long chunks = (d + kBK - 1) / kBK;
    const long long per = (chunks + ranks - 1) / ranks * kBK;
    k0 = per * rank;
    k1 = k0 + per < d ? k0 + per : d;
}

// sq[i] = sum_k G[i][k]^2 in f32, summed in exactly the order gram_tile<BM>
// with `ranks` blocks per cluster sums acc[i][j]: per rank slice and k
// group, FMA chains of kChainProducts products added in chunk order to a
// total starting at 0; the KG totals added in k-group order; the rank
// sums added in rank order to 0.
//
// One block per row.  A row's chains are numbered by (rank, span of CPS
// chunks, k group), k group fastest, and thread t of a batch runs chain
// base + t.  A warp's 32 chains cover 32 / KG spans, which it stages
// through shared memory KG chunks at a time (32 coalesced loads a lane)
// so that each lane can walk its own chain in order.  Thread kg then
// folds k group kg's chains of the batch, in order, into its rank's
// total.  Entries past a slice's end read as 0, as in the Gram.
template <int BM>
__global__ void __launch_bounds__(kThreads)
row_sqnorms_kernel(const float* __restrict__ G, long long d, int ranks,
                   float* __restrict__ sq) {
    constexpr int KG = kWarps / (BM / 4);
    constexpr int KPW = kBK / KG;
    constexpr int CPS = kChainProducts / KPW;      // chunks per chain
    constexpr int SPW = 32 / KG;                   // spans per warp
    // Row jj * KG + ci of a warp's stage holds chunk ci of span jj; the
    // span stride is padded so a lane's reads hit distinct banks.
    constexpr int kSpan = KG * (kBK + 1) + (KG > 1 ? 1 : 0);
    __shared__ float stage[kWarps][SPW * kSpan];
    __shared__ long long span_k[kWarps][SPW][2];   // [k start, k end)
    __shared__ float part[kThreads];
    __shared__ int part_rank[kThreads];
    __shared__ float tot[8][KG];
    __shared__ long long first_span[9];   // of each rank; [ranks] = all

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const float* g = G + (long long)blockIdx.x * d;
    if (threadIdx.x == 0) {
        first_span[0] = 0;
        for (int q = 0; q < ranks; ++q) {
            long long k0, k1;
            slice_bounds(d, q, ranks, k0, k1);
            const long long nchunks =
                k1 > k0 ? (k1 - k0 + kBK - 1) / kBK : 0;
            first_span[q + 1] = first_span[q] + (nchunks + CPS - 1) / CPS;
        }
    }
    if (threadIdx.x < 8 * KG) tot[threadIdx.x / KG][threadIdx.x % KG] = 0.f;
    __syncthreads();

    const long long chains = first_span[ranks] * KG;
    for (long long base = 0; base < chains; base += kThreads) {
        const long long s0 = (base + warp * 32) / KG;   // warp's first span
        if (lane < SPW) {            // where the warp's span `lane` lies
            const long long sp = s0 + lane;
            int q = 0;
            while (q < ranks && first_span[q + 1] <= sp) ++q;
            long long k0 = 0, k1 = 0;
            if (q < ranks) {
                slice_bounds(d, q, ranks, k0, k1);
                k0 += (sp - first_span[q]) * CPS * kBK;
            }
            span_k[warp][lane][0] = k0;
            span_k[warp][lane][1] = k1;
            for (int kg = 0; kg < KG; ++kg)
                part_rank[warp * 32 + lane * KG + kg] = q;
        }
        __syncwarp();
        const int span = lane / KG, kg = lane % KG;    // this lane's chain
        float* st = stage[warp];
        float acc = 0.f;
        for (int c0 = 0; c0 < CPS; c0 += KG) {
            // All 32 loads first, then the stores, so the loads overlap.
            float v[SPW][KG];
#pragma unroll
            for (int jj = 0; jj < SPW; ++jj) {
                const long long ks = span_k[warp][jj][0];
                const long long ke = span_k[warp][jj][1];
#pragma unroll
                for (int ci = 0; ci < KG; ++ci) {
                    const long long k = ks + (c0 + ci) * kBK + lane;
                    v[jj][ci] = k < ke ? __ldg(g + k) : 0.f;
                }
            }
#pragma unroll
            for (int jj = 0; jj < SPW; ++jj)
#pragma unroll
                for (int ci = 0; ci < KG; ++ci)
                    st[jj * kSpan + ci * (kBK + 1) + lane] = v[jj][ci];
            __syncwarp();
#pragma unroll
            for (int ci = 0; ci < KG; ++ci)
#pragma unroll
                for (int kk = 0; kk < KPW; ++kk) {
                    const float v =
                        st[span * kSpan + ci * (kBK + 1) + kg * KPW + kk];
                    acc = fmaf(v, v, acc);
                }
            __syncwarp();
        }
        part[threadIdx.x] = acc;
        __syncthreads();
        if (threadIdx.x < KG) {
            const long long left = chains - base;
            const int m = left < kThreads ? (int)left : kThreads;
            for (int i = threadIdx.x; i < m; i += KG)
                tot[part_rank[i]][threadIdx.x] += part[i];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        float total = 0.f;
        for (int q = 0; q < ranks; ++q) {
            float w = tot[q][0];
#pragma unroll
            for (int kg = 1; kg < KG; ++kg) w += tot[q][kg];
            total += w;
        }
        sq[blockIdx.x] = total;
    }
}

// Computes the gram tile of rows [row0, row0+BM) x cols [col0, col0+kBN)
// over k in [k0, k1) into s.red[r * kBN + c].  Must be called by all
// kThreads threads; ends with a __syncthreads so the tile is readable by
// every thread.
template <int BM>
__device__ void gram_tile(const float* __restrict__ G, int n, long long d,
                          long long k0, long long k1, int row0, int col0,
                          GramSmem<BM>& s) {
    constexpr int RG = BM / 4;             // row groups
    constexpr int KG = kWarps / RG;        // k groups
    constexpr int KPW = kBK / KG;          // k per warp per chunk
    constexpr int CPS = kChainProducts / KPW;   // chunks per FMA chain
    constexpr int kElems = (BM + kBN) * kBK;
    constexpr int kLoads = (kElems + kThreads - 1) / kThreads;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int rg = warp % RG;
    const int kg = warp / RG;

    // This thread's 16 outputs in its k group's partial tile red[kg], which
    // hold the running totals of its restarted FMA chains (in shared
    // memory, so the totals cost no registers).  Only this thread touches
    // them until the barrier after the loop.
    float* part = s.red + kg * (BM * kBN) + rg * 4 * kBN + lane;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            acc[r][q] = 0.f;
            part[r * kBN + 32 * q] = 0.f;
        }

    // Loader: element e = tid + i*kThreads; staged row e/32, k = e%32 = lane
    // (kThreads is a multiple of 32), so a warp reads 128 contiguous bytes
    // of one row.  Rows [0, BM) come from the row block, the rest from the
    // column block.
    float pf[kLoads];
    auto load = [&](long long kbase) {
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
            const int e = tid + i * kThreads;
            const int r = e >> 5;
            const long long k = kbase + lane;
            float v = 0.f;
            if (e < kElems && k < k1) {
                const int g = r < BM ? row0 + r : col0 + (r - BM);
                if (g < n) v = G[(long long)g * d + k];
            }
            pf[i] = v;
        }
    };
    auto store = [&]() {
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
            const int e = tid + i * kThreads;
            if (e < kElems) {
                const int r = e >> 5;
                if (r < BM)
                    s.a[lane * BM + (((r >> 2) ^ (lane % RG)) << 2)
                        + (r & 3)] = pf[i];
                else s.b[lane * kBNPad + (r - BM)] = pf[i];
            }
        }
    };

    const long long nchunks = k1 > k0 ? (k1 - k0 + kBK - 1) / kBK : 0;
    if (nchunks > 0) load(k0);
    for (long long c0 = 0; c0 < nchunks; c0 += CPS) {      // one FMA chain
        const long long c1 = c0 + CPS < nchunks ? c0 + CPS : nchunks;
        for (long long c = c0; c < c1; ++c) {
            store();
            __syncthreads();
            if (c + 1 < nchunks) load(k0 + (c + 1) * kBK);
#pragma unroll
            for (int kk = 0; kk < KPW; ++kk) {
                const int k = kg * KPW + kk;
                const float4 a =
                    *reinterpret_cast<const float4*>(
                        &s.a[k * BM + ((rg ^ (k % RG)) << 2)]);
                const float* brow = &s.b[k * kBNPad + lane];
                const float av[4] = {a.x, a.y, a.z, a.w};
                float bv[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) bv[q] = brow[32 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                part[r * kBN + 32 * q] += acc[r][q];
                acc[r][q] = 0.f;
            }
    }

    // The partial tiles red[kg][row][col] are complete; with several k
    // groups, sum them over kg in order into red[0][row][col] (each output
    // is read and written by one thread only, so the in-place sum is
    // race-free).
    __syncthreads();
    if (KG > 1) {
        for (int o = tid; o < BM * kBN; o += kThreads) {
            float v = s.red[o];
#pragma unroll
            for (int g = 1; g < KG; ++g) v += s.red[g * (BM * kBN) + o];
            s.red[o] = v;
        }
        __syncthreads();
    }
}

// Output o (< BM * kBN) of the cluster's tile: the S partial tiles of
// the cluster's blocks summed in rank order.  Call between two
// cluster.sync()s: after every block's gram_tile, and before any block
// reuses its s.red.
template <int BM>
__device__ __forceinline__ float cluster_sum(
        cooperative_groups::cluster_group& cluster, GramSmem<BM>& s, int o) {
    float v = 0.f;
    for (unsigned q = 0; q < cluster.num_blocks(); ++q)
        v += cluster.map_shared_rank(s.red, q)[o];
    return v;
}

// Launches kernel<<<grid, kThreads, smem, stream>>> in clusters of
// `ranks` blocks along x (grid.x must be a multiple of ranks).
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, dim3 grid, unsigned ranks,
                            size_t smem, cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace fl
