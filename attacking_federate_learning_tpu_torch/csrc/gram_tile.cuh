// Shared pieces of the two distance kernels (pairwise_distances.cu and
// krum_scores.cu): the fp32 Gram of an (n, d) f32 matrix on the FMA units,
// split over d across every SM, and the epilogue that turns it into
// distances.  The epilogue also serves the bf16 operand route, whose
// stage 1 runs on the tensor cores (gram_mma.cuh) and writes its partial
// tiles in the layout below.
//
// What bounds them on an H100: operations.  The function needs the
// n(n-1)/2 dot products of the symmetric Gram plus the row norms,
// n(n-1)*d + 2*n*d flops: 0.80 GFLOP at n = 100, d = 79,510, 12 us against
// the 67 TFLOP/s of fp32 FMA outside the tensor cores (tensor cores would
// mean TF32, which the port's fp32 parity forbids), against 31.8 MB of
// input, 9.5 us at 3.35 TB/s.
//
// Stage 1, gram_partials_kernel.  The padded Gram is cut into 128 x 128
// tiles and only the nt(nt+1)/2 tiles on or above the diagonal are
// computed (nt = ceil(n / 128)).  d is cut into S slices of `cps` whole
// chains of 256 products; the grid is tiles x S blocks, and block
// (tile, s) writes its partial tile to the workspace, ws[s][tile][128][128],
// and the diagonal of a diagonal tile also to dg[s][nt * 128], so that the
// epilogue reads the row norms contiguously.  The plan (cps, S) is made
// by the wrapper (ops/distances.py:gram_plan) from the card's SM count,
// so that tiles x S fills every SM in whole waves.  A block is 256
// threads, each with an 8 x 8 register tile; it has an SM to itself (up
// to 255 registers a thread, which the tile and its operands fill).  The
// operands reach shared memory through a ring of three stages of 32 k
// with asynchronous copies (cp.async), so the next chunks' loads overlap
// this chunk's FMAs; on a diagonal tile the two operands are the same
// rows and are loaded once.
// A stage holds [row][32 k], the 16-byte quads of a row permuted by its
// thread tile (staged()), so that a warp's copies write whole rows and a
// warp's 16-byte reads of 16 thread tiles take the minimum two
// wavefronts.  The copies are as wide as every row start allows: 8 bytes
// at d = 79,510, whose odd rows start at 8 mod 16 bytes (a TMA tensor map
// or a 16-byte copy would need 16), 4 bytes for odd d, 16 where d is a
// multiple of 4.  Rows past n and k past d are zero-filled by the copy
// (src-size 0), so nothing out of bounds is read and G is never padded.
//
// Only the thread tiles that hold an output on or above the diagonal and
// inside n are computed: the block numbers them and gives them to its
// first threads, so whole warps past the count skip the FMAs.  At
// n = 100 the single tile has 91 such thread tiles of 8 x 8 (0.93 GFLOP in
// all instead of the padded tile's 2.6).  Where the Gram is one tile and
// half the threads or more would idle, the block's threads form KG = 2 or
// 4 k groups that split each chunk's 32 k between them (n = 100: KG = 2,
// six warps); at a chain's end the groups' sums are added in group order
// through shared memory before they reach the partial.
//
// Stage 2, gram_epilogue_kernel (one launch).  Each output's S partials
// are summed in a fixed order; the row norm sq_i is the summed Gram
// diagonal acc[i][i], so no second pass over G is needed.  D[i][j] and
// D[j][i] are written from one value, sqrt(max(sq_i + sq_j - 2 acc, 0)),
// with an exact zero diagonal.
//
// Summation order.  Every output is summed the same way whatever its
// position: per k group, FMA chains of its 256 / KG products of a 256-k
// chain in k order from 0; the groups' chains added in group order; each
// chain added in order to its slice's partial (the first one stored); the
// S partials summed in kGroups runs of ceil(S / kGroups) in order, and the
// runs' sums added in order.  The longest sequential chain of roundings
// is at most 256 + ceil(d / 256) + 8 (ops/distances.py:
// GramPlan.rounding_chain).  So two bit-identical rows i, j give
// acc[i][j] == acc[i][i] == acc[j][j] bit for bit, and their distance
// (x + x) - 2x is exactly 0 (ALIE's crafted rows), not the square root of
// cancellation noise.  Partials are combined in a fixed order, never by
// float atomics, so two launches on the same input give the same bits.
//
// The split route over a mesh's model axis (gram_split.cuh) runs the same
// main loop (gram_tile_partial, SPLIT true) with chains of 64, 128 or 256
// products, a slice's chains added in order into a partial tile in the
// block's shared memory; then its cluster tail: the C partials of a
// cluster summed in rank order through distributed shared memory, the
// R = S / C cluster sums in order (gram_tail_kernel), and, in the
// epilogue, the m positions' Grams in position order
// (ops/distances.py:SplitPlan.rounding_chain counts stage 1's roundings).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fl {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kT = 128;                 // Gram tile edge
constexpr int kTT = 8;                  // thread tile edge
constexpr int kTG = kT / kTT;           // thread tiles per tile edge
constexpr int kBK = 32;                 // k per shared-memory stage
constexpr int kStages = 3;              // cp.async ring depth
constexpr int kChainProducts = 256;     // products per FMA chain
constexpr int kChunksPerChain = kChainProducts / kBK;
constexpr int kStageFloats = 2 * kT * kBK;   // A and B of one stage
constexpr int kGroups = kWarps;         // epilogue runs of partials

static_assert(kThreads == kTG * kTG, "one thread per thread tile");
static_assert(kChainProducts % kBK == 0, "chains are whole chunks");

// Shared memory of stage 1: the ring, and the k groups' exchange of their
// chain sums, [KG - 1][64 entries][256 / KG threads] f32.
template <int KG>
__host__ __device__ constexpr size_t stage1_smem() {
    return (kStages * kStageFloats
            + (KG - 1) * kTT * kTT * (kThreads / KG)) * sizeof(float);
}

// Four consecutive staged floats (one quad, 4-float aligned).
__device__ __forceinline__ float4 load_quad(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Tile t of the upper triangle of nt x nt tiles, row by row:
// (0,0), (0,1), ..., (0,nt-1), (1,1), ...
__device__ __forceinline__ void tile_coords(int t, int nt, int& ti,
                                            int& tj) {
    ti = 0;
    int len = nt;
    while (t >= len) {
        t -= len;
        ++ti;
        --len;
    }
    tj = ti + t;
}

__device__ __forceinline__ int tile_index(int ti, int tj, int nt) {
    return ti * nt - ti * (ti - 1) / 2 + (tj - ti);
}

// Where k (0..31) of staged row r (0..127) sits: rows of 32 floats, their
// 16-byte quads permuted by the row's thread tile, so that thread tiles
// 0..7 read one quad index from eight distinct bank groups.
__device__ __forceinline__ int staged(int r, int k) {
    return r * kBK + (((k >> 2) ^ ((r >> 3) & 7)) << 2) + (k & 3);
}

// BYTES (4, 8 or 16) from src to dst, or zeros where !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The k range [k0, k1) of slice s of S on the split route: the d / chain
// chains (the last one short) dealt out in S runs as even as they go,
// slice s taking chains [s T / S, (s + 1) T / S); none is empty where
// S <= T.
__host__ __device__ __forceinline__ void split_slice(long long d, int chain,
                                                     int S, int s,
                                                     long long& k0,
                                                     long long& k1) {
    const long long T = (d + chain - 1) / chain;
    k0 = (long long)s * T / S * chain;
    const long long kend = (long long)(s + 1) * T / S * chain;
    k1 = kend < d ? kend : d;
}

// Stage 1 for one block.  The block's threads form KG k groups of 256 /
// KG; group g takes k [32g/KG, 32(g+1)/KG) of every chunk.  Every tile of
// a launch must have at most 256 / KG live thread tiles.  Copies move VEC
// floats (G's base and row stride must allow 4 VEC-byte copies).
//
// Fused (SPLIT false, gram_partials_kernel): grid tiles * S blocks, block
// = s * tiles + tile, slice s cps chains of 256; ws: (S, tiles, 128, 128)
// f32, then dg: (S, nt * 128); only the entries of computed thread tiles
// are written.  Split (SPLIT true, gram_split.cuh): grid tiles * S
// blocks, block = tile * S + s, slice s split_slice's run of chains of
// cpc chunks (cps unused); ws is the block's partial tile in its own
// shared memory, [128][128], and nothing goes to device memory here.
template <int KG, int VEC, bool SPLIT>
__device__ __forceinline__ void gram_tile_partial(
        const float* __restrict__ G, int n, long long d, int nt, int cps,
        float* __restrict__ ws, int S, int cpc) {
    constexpr int kPer = kThreads / KG;      // threads per k group
    constexpr int kQ = kBK / 4 / KG;         // k quads per group per chunk
    constexpr int kRowCopies = kBK / VEC;    // copies per staged row
    constexpr int kCopies = kT * kRowCopies / kThreads;   // per thread
    static_assert(VEC == 1 || VEC == 2 || VEC == 4, "a copy is in a quad");
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* xch = smem + kStages * kStageFloats;
    const int tiles = nt * (nt + 1) / 2;
    const int tile = SPLIT ? blockIdx.x / S : blockIdx.x % tiles;
    const int s = SPLIT ? blockIdx.x % S : blockIdx.x / tiles;
    int ti, tj;
    tile_coords(tile, nt, ti, tj);
    const bool diag = ti == tj;
    const int row0 = ti * kT, col0 = tj * kT;
    long long k0, k1;
    if constexpr (SPLIT) {
        split_slice(d, cpc * kBK, S, s, k0, k1);
    } else {
        k0 = (long long)s * cps * kChainProducts;
        const long long kend = k0 + (long long)cps * kChainProducts;
        k1 = kend < d ? kend : d;
    }
    const int nchunks = (int)((k1 - k0 + kBK - 1) / kBK);
    // Chunks per chain.
    const int chain_chunks = SPLIT ? cpc : kChunksPerChain;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;

    // This thread's k group and thread tile (a, b) among the block's live
    // ones.
    const int g = tid / kPer;
    const int idx = tid % kPer;
    const int mr = min(kTG, (n - row0 + kTT - 1) / kTT);
    const int mc = min(kTG, (n - col0 + kTT - 1) / kTT);
    const int live = diag ? mr * (mr + 1) / 2 : mr * mc;
    const bool thread_live = idx < live;
    int a = 0, b = 0;
    {
        const int t = thread_live ? idx : 0;
        if (diag) {
            int rem = t;
            while (rem >= mr - a) {
                rem -= mr - a;
                ++a;
            }
            b = a + rem;
        } else {
            a = t / mc;
            b = t % mc;
        }
    }
    const bool warp_live = warp * 32 % kPer < live;     // warp-uniform

    // Copier: copy e = tid + i * 256 is row e / kRowCopies, k VEC * (e %
    // kRowCopies) of the chunk, so a warp's copies cover whole rows.
    auto load_chunk = [&](int c, int st) {
        float* A = smem + st * kStageFloats;
        float* B = A + kT * kBK;
        const long long kc = k0 + (long long)c * kBK;
#pragma unroll
        for (int i = 0; i < kCopies; ++i) {
            const int e = tid + i * kThreads;
            const int r = e / kRowCopies;
            const int k = (e % kRowCopies) * VEC;
            const long long kg = kc + k;
            const int slot = staged(r, k);
            const bool kin = kg < k1;
            const bool va = kin && row0 + r < n;
            cp_async<4 * VEC>(A + slot,
                              va ? G + (long long)(row0 + r) * d + kg : G,
                              va);
            if (!diag) {
                const bool vb = kin && col0 + r < n;
                cp_async<4 * VEC>(B + slot,
                                  vb ? G + (long long)(col0 + r) * d + kg
                                     : G,
                                  vb);
            }
        }
    };

    float acc[kTT][kTT];
#pragma unroll
    for (int i = 0; i < kTT; ++i)
#pragma unroll
        for (int j = 0; j < kTT; ++j) acc[i][j] = 0.f;

    float* out = SPLIT ? ws : ws + ((long long)s * tiles + tile) * (kT * kT);
    float* dg = ws + (long long)gridDim.x * (kT * kT)
                + (long long)s * nt * kT + row0;
    const int sa = (a & 7) << 2, sb = (b & 7) << 2;   // staged() swizzle

#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
        if (c < nchunks) load_chunk(c, c);
        cp_async_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
        cp_async_wait<kStages - 2>();
        __syncthreads();          // chunk c landed; chunk c-1 consumed
        if (c + kStages - 1 < nchunks)
            load_chunk(c + kStages - 1, (c + kStages - 1) % kStages);
        cp_async_commit();
        if (warp_live) {
            const float* st = smem + (c % kStages) * kStageFloats;
            const float* A = st + a * kTT * kBK;
            const float* B = (diag ? st : st + kT * kBK) + b * kTT * kBK;
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
                const int k4 = (g * kQ + q) << 2;
                float4 av[kTT];
#pragma unroll
                for (int i = 0; i < kTT; ++i)
                    av[i] = load_quad(A + i * kBK + (k4 ^ sa));
#pragma unroll
                for (int j = 0; j < kTT; ++j) {
                    const float4 bv = load_quad(B + j * kBK + (k4 ^ sb));
#pragma unroll
                    for (int i = 0; i < kTT; ++i) {
                        float v = acc[i][j];
                        v = fmaf(av[i].x, bv.x, v);
                        v = fmaf(av[i].y, bv.y, v);
                        v = fmaf(av[i].z, bv.z, v);
                        acc[i][j] = fmaf(av[i].w, bv.w, v);
                    }
                }
            }
        }
        // A chain ends (block-uniform): add the k groups' chains in group
        // order, add that to the slice's partial (the first chain is
        // stored), and restart from 0.
        if ((c + 1) % chain_chunks == 0 || c + 1 == nchunks) {
            if (KG > 1) {
                if (g > 0 && thread_live) {
#pragma unroll
                    for (int i = 0; i < kTT; ++i)
#pragma unroll
                        for (int j = 0; j < kTT; ++j)
                            xch[((g - 1) * kTT * kTT + i * kTT + j) * kPer
                                + idx] = acc[i][j];
                }
                __syncthreads();
                if (g == 0 && thread_live) {
#pragma unroll
                    for (int h = 1; h < KG; ++h)
#pragma unroll
                        for (int i = 0; i < kTT; ++i)
#pragma unroll
                            for (int j = 0; j < kTT; ++j)
                                acc[i][j] += xch[((h - 1) * kTT * kTT
                                                  + i * kTT + j) * kPer
                                                 + idx];
                }
            }
            if (g == 0 && thread_live) {
                const bool first = c < chain_chunks;
#pragma unroll
                for (int i = 0; i < kTT; ++i) {
                    float4* p = reinterpret_cast<float4*>(
                        out + (a * kTT + i) * kT + b * kTT);
                    float4 lo = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                            acc[i][3]);
                    float4 hi = make_float4(acc[i][4], acc[i][5], acc[i][6],
                                            acc[i][7]);
                    if (!first) {
                        const float4 plo = p[0], phi = p[1];
                        lo = make_float4(plo.x + lo.x, plo.y + lo.y,
                                         plo.z + lo.z, plo.w + lo.w);
                        hi = make_float4(phi.x + hi.x, phi.y + hi.y,
                                         phi.z + hi.z, phi.w + hi.w);
                    }
                    p[0] = lo;
                    p[1] = hi;
                }
                if (!SPLIT && diag && a == b) {
                    // The same sums again, beside the other slices'.
#pragma unroll
                    for (int i = 0; i < kTT; ++i) {
                        float* q = dg + a * kTT + i;
                        *q = first ? acc[i][i] : *q + acc[i][i];
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < kTT; ++i)
#pragma unroll
                for (int j = 0; j < kTT; ++j) acc[i][j] = 0.f;
        }
    }
    cp_async_wait<0>();
}

// Stage 1 of the fused route (gram_tile_partial's note): the S slices'
// partial tiles and their diagonals into ws.  Dynamic shared memory:
// stage1_smem<KG>().
template <int KG, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
gram_partials_kernel(const float* __restrict__ G, int n, long long d,
                     int nt, int cps, float* __restrict__ ws) {
    gram_tile_partial<KG, VEC, false>(G, n, d, nt, cps, ws, 0, 0);
}

// The sums over partials [s0, s1), in order, of p0[s * st0], p1[s * st1]
// and p2[s * st1]; the three run together so that their loads overlap.
__device__ __forceinline__ void partial_sums(const float* p0, long long st0,
                                             const float* p1,
                                             const float* p2, long long st1,
                                             int s0, int s1, float& v0,
                                             float& v1, float& v2) {
    v0 = p0[s0 * st0];
    v1 = p1[s0 * st1];
    v2 = p2[s0 * st1];
#pragma unroll 4
    for (int s = s0 + 1; s < s1; ++s) {
        v0 += p0[s * st0];
        v1 += p1[s * st1];
        v2 += p2[s * st1];
    }
}

// Stage 2.  Grid: tiles * 128 * 4 blocks, block = (tile * 128 + r) * 4 + q;
// a block takes row r of the tile and its 32 columns [32 q, 32 q + 32),
// and writes D[i][j] and D[j][i] for every i <= j among them.  The S
// partials fall into kGroups runs of ceil(S / kGroups) (the last may be
// short); warp w sums run w of each output and of the two norms in slice
// order, and warp 0 adds the runs' sums in run order, so every output,
// the diagonal ones included, is summed the same way.
__global__ void __launch_bounds__(kThreads)
gram_epilogue_kernel(const float* __restrict__ ws, int n, int nt, int S,
                     float* __restrict__ D) {
    __shared__ float part[kGroups][2][32];     // outputs, column norms
    __shared__ float part_r[kGroups];          // the row's norm
    const int tiles = nt * (nt + 1) / 2;
    const int q = blockIdx.x % 4;
    const int r = (blockIdx.x / 4) % kT;
    const int tile = blockIdx.x / (4 * kT);
    int ti, tj;
    tile_coords(tile, nt, ti, tj);
    const int c0 = 32 * q;
    const int i = ti * kT + r;
    // Block-uniform: the row is past n, the columns are, or all of them
    // lie below the diagonal.
    if (i >= n || tj * kT + c0 >= n || (ti == tj && c0 + 31 < r)) return;

    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int gsz = (S + kGroups - 1) / kGroups;
    const int runs = (S + gsz - 1) / gsz;
    const int c = c0 + lane;
    const int j = tj * kT + c;
    if (w < runs) {
        // Every lane sums its entries, live or not (a dead entry is in
        // bounds and never read back).
        const long long st0 = (long long)tiles * (kT * kT);
        const float* dg = ws + (long long)S * st0;
        float g, sq_c, sq_r;
        partial_sums(ws + (long long)tile * (kT * kT) + r * kT + c, st0,
                     dg + tj * kT + c, dg + ti * kT + r, (long long)nt * kT,
                     w * gsz, min(S, (w + 1) * gsz), g, sq_c, sq_r);
        part[w][0][lane] = g;
        part[w][1][lane] = sq_c;
        if (lane == 0) part_r[w] = sq_r;
    }
    __syncthreads();
    if (w != 0 || j >= n || (ti == tj && r > c)) return;
    float g = part[0][0][lane], sq_c = part[0][1][lane], sq_r = part_r[0];
    for (int v = 1; v < runs; ++v) {
        g += part[v][0][lane];
        sq_c += part[v][1][lane];
        sq_r += part_r[v];
    }
    const float d2 = sq_r + sq_c - 2.0f * g;
    const float val = i == j ? 0.0f : sqrtf(fmaxf(d2, 0.0f));
    D[(long long)i * n + j] = val;
    D[(long long)j * n + i] = val;
}

// k groups only where the Gram is one tile with at most 256 / kg live
// thread tiles.
inline bool kgroups_ok(int n, int kg) {
    if (kg != 1 && kg != 2 && kg != 4) return false;
    const int mr = (n + kTT - 1) / kTT;
    return kg == 1 || (n <= kT && mr * (mr + 1) / 2 <= kThreads / kg);
}

// Checks a plan from the wrapper: S slices of cps chains cover [0, d),
// the last one not empty; k groups as kgroups_ok allows.
inline bool plan_ok(int n, long long d, int S, int cps, int kg) {
    if (n <= 0 || d <= 0 || S <= 0 || cps <= 0) return false;
    if (!kgroups_ok(n, kg)) return false;
    const long long per = (long long)cps * kChainProducts;
    return (long long)S * per >= d && (long long)(S - 1) * per < d;
}

template <int KG, int VEC>
cudaError_t launch_partials(const float* G, int n, long long d, int nt,
                            int S, int cps, float* ws, cudaStream_t stream) {
    constexpr int smem = (int)stage1_smem<KG>();
    const cudaError_t err = cudaFuncSetAttribute(
        gram_partials_kernel<KG, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int tiles = nt * (nt + 1) / 2;
    gram_partials_kernel<KG, VEC>
        <<<tiles * S, kThreads, smem, stream>>>(G, n, d, nt, cps, ws);
    return cudaGetLastError();
}

// The widest copy (at most a quad) that every row start allows.
template <int KG>
cudaError_t launch_partials(const float* G, int n, long long d, int nt,
                            int S, int cps, float* ws, cudaStream_t stream) {
    const unsigned long long base = reinterpret_cast<unsigned long long>(G);
    if (base % 16 == 0 && d % 4 == 0)
        return launch_partials<KG, 4>(G, n, d, nt, S, cps, ws, stream);
    if (base % 8 == 0 && d % 2 == 0)
        return launch_partials<KG, 2>(G, n, d, nt, S, cps, ws, stream);
    return launch_partials<KG, 1>(G, n, d, nt, S, cps, ws, stream);
}

// Stage 1 on `stream`: the S slices' Gram partials and their diagonals
// into ws.  Returns the launch error.
inline cudaError_t gram_partials(const float* G, int n, long long d, int S,
                                 int cps, int kg, float* ws,
                                 cudaStream_t stream) {
    const int nt = (n + kT - 1) / kT;
    return kg == 4   ? launch_partials<4>(G, n, d, nt, S, cps, ws, stream)
           : kg == 2 ? launch_partials<2>(G, n, d, nt, S, cps, ws, stream)
                     : launch_partials<1>(G, n, d, nt, S, cps, ws, stream);
}

// Stage 2 on `stream`: the distances into D from the S partials in ws
// (S * tiles partial tiles, then S diagonals), summed in slice order.
inline cudaError_t gram_epilogue(const float* ws, int n, int S, float* D,
                                 cudaStream_t stream) {
    const int nt = (n + kT - 1) / kT;
    const int tiles = nt * (nt + 1) / 2;
    gram_epilogue_kernel<<<tiles * kT * 4, kThreads, 0, stream>>>(ws, n, nt,
                                                                  S, D);
    return cudaGetLastError();
}

// Both stages on `stream`: the Gram partials into ws, the distances into
// D.  Returns the first launch error.
inline cudaError_t gram_distances(const float* G, int n, long long d, int S,
                                  int cps, int kg, float* ws, float* D,
                                  cudaStream_t stream) {
    const cudaError_t err = gram_partials(G, n, d, S, cps, kg, ws, stream);
    if (err != cudaSuccess) return err;
    return gram_epilogue(ws, n, S, D, stream);
}

}  // namespace fl
