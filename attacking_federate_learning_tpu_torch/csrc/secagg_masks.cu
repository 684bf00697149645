// Secure aggregation's mask arithmetic (protocols/secagg.py): three entry
// points over uint32 words, the bit patterns of f32 client updates.
//
// Replaces no TPU kernel.  The JAX package draws these masks with XLA's
// threefry inside its jitted round (attacking_federate_learning_tpu/
// protocols/secagg.py:94 pairwise_deltas, :148 recovery_residue) and
// sums them there.  The draw is O(n^2 d): n (n - 1) / 2 pair streams of
// d words a round, 393 million words at n = 100, d = 79,510.  A plain
// PyTorch version holds a (pairs, d) int64 tensor per operation (6.4 GB
// at n = 100) or loops over pairs, so the card gets a kernel.
//
// Every word is the y0 ^ y1 of threefry2x32(pair_key, (0, col)), the bits
// of jax.random.bits(pair_key, (d,)) in its partitionable mode, as
// csrc/threefry_bits.cu draws them; the pair keys come from the host
// (utils/threefry.py:pair_keys), one (P, 2) table in row-major
// upper-triangle order of the row pairs a < b.  All arithmetic is on
// uint32_t, which wraps mod 2^32 by definition: results are integers, and
// the kernels agree with their plain versions (ops/secagg_masks.py) bit
// for bit.
//
// fl_secagg_deltas: the (n, d) net masks, row a's word the sum over b != a
//   of +m_ab where ids[a] < ids[b], -m_ab otherwise.  Bound by integer
//   operations: each word costs 20 rounds of add, rotate and xor, 5 key
//   injections of 3 adds, the third key word and the output xor, about 80
//   operations, on the 64 int32 lanes of an SM (a quarter of the fp32
//   rate).  The design draws each unordered pair's word once, not twice:
//   a block owns a tile of 256 columns (128 threads, 2 independent
//   columns each) and the accumulators of its rows in shared memory (100
//   KB at n = 100); row a's sum stays in registers while b runs, row b's
//   word is subtracted in shared memory (each thread its own column: no
//   bank conflict, no race).  The pair range is split over blockIdx.z so
//   that enough blocks fill the card (the accumulators of all d columns
//   would just exceed its shared memory at n = 100); the splits' partial
//   sums meet in the output through atomicAdd on uint32, which commutes,
//   so the result does not depend on their order.  More rows than a tile
//   holds split over blockIdx.y; a pair across two row tiles is then drawn
//   by each.
// fl_secagg_residue: the (d,) net mask the dropped rows leave in the alive
//   rows' sum, over the (alive i, dropped j) pairs, and their count.
//   Bound by operations as above, over alive x dropped pairs; one thread
//   per column pair, the pair loop uniform across the block.
// fl_secagg_unmask_sum: one pass over (n, d): the wire (the clear bits
//   plus the delta, through an empty asm, the network, that keeps the
//   compiler from cancelling the mask), the mod-2^32 column sums of the
//   alive wire and clear rows, the check s_wire - residue == s_clear, and
//   the recovered f32 rows (wire - delta; dropped rows zeroed).  Bound by
//   bytes: 2 n d 4 read, n d 4 written.  One thread a column, the row
//   loop unrolled for loads in flight; the check ANDs into one int32 flag
//   with atomicAnd, one per block that found a mismatch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 2;                     // columns per thread
constexpr int kTile = kThreads * kCols;      // columns per block
constexpr int kSmemMax = 232448;             // 227 KB a block

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

#define FL_MIX(r) x0 += x1; x1 = rotl32(x1, r) ^ x0;

// y0 ^ y1 of threefry2x32((k0, k1), (0, c)): word c of
// jax.random.bits((k0, k1), ...).
__device__ __forceinline__ uint32_t mask_word(uint32_t k0, uint32_t k1,
                                              uint32_t c) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    uint32_t x0 = k0, x1 = c + k1;
    FL_MIX(13) FL_MIX(15) FL_MIX(26) FL_MIX(6)
    x0 += k1; x1 += k2 + 1u;
    FL_MIX(17) FL_MIX(29) FL_MIX(16) FL_MIX(24)
    x0 += k2; x1 += k0 + 2u;
    FL_MIX(13) FL_MIX(15) FL_MIX(26) FL_MIX(6)
    x0 += k0; x1 += k1 + 3u;
    FL_MIX(17) FL_MIX(29) FL_MIX(16) FL_MIX(24)
    x0 += k1; x1 += k2 + 4u;
    FL_MIX(13) FL_MIX(15) FL_MIX(26) FL_MIX(6)
    x0 += k2; x1 += k0 + 5u;
    return x0 ^ x1;
}

#undef FL_MIX

// Flat index of the row pair (a, b), a < b, in row-major upper-triangle
// order.
__device__ __forceinline__ long long pair_index(int a, int b, int n) {
    return (long long)a * n - (long long)a * (a + 1) / 2 + (b - a - 1);
}

// Grid (column tiles, row tiles, pair splits).  out: (n, d), zeroed by
// the caller; each block adds its rows' partial sums over its pairs.
__global__ void __launch_bounds__(kThreads)
secagg_deltas_kernel(const uint2* __restrict__ keys,
                     const long long* __restrict__ ids, int n, long long d,
                     int row_tile, long long pairs_per_split,
                     uint32_t* __restrict__ out) {
    extern __shared__ uint32_t acc[];        // (rows of the tile, kTile)
    const long long c0 = (long long)blockIdx.x * kTile;
    const int r0 = blockIdx.y * row_tile;
    const int rows = min(n - r0, row_tile);
    const long long P = (long long)n * (n - 1) / 2;
    const long long p0 = (long long)blockIdx.z * pairs_per_split;
    const long long p1 = min(P, p0 + pairs_per_split);
    for (int i = threadIdx.x; i < rows * kTile; i += kThreads) acc[i] = 0u;
    __syncthreads();
    uint32_t col[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
        col[j] = (uint32_t)(c0 + threadIdx.x + j * kThreads);
    if (p0 < p1) {
        // The first pair of the split, (a, b).
        int a = 0;
        long long first = 0;                 // pair index of (a, a + 1)
        while (first + (n - 1 - a) <= p0) {
            first += n - 1 - a;
            ++a;
        }
        int b = a + 1 + (int)(p0 - first);
        bool a_in = a >= r0 && a < r0 + rows;
        long long id_a = ids[a];
        uint32_t own[kCols];                 // row a's sum over this b run
#pragma unroll
        for (int j = 0; j < kCols; ++j) own[j] = 0u;
        for (long long p = p0; p < p1; ++p) {
            const bool b_in = b >= r0 && b < r0 + rows;
            if (a_in || b_in) {              // uniform across the block
                const uint2 k = keys[p];
                const bool a_low = id_a < ids[b];
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    const uint32_t m = mask_word(k.x, k.y, col[j]);
                    const uint32_t ma = a_low ? m : 0u - m;
                    own[j] += ma;
                    if (b_in)
                        acc[(b - r0) * kTile + threadIdx.x + j * kThreads]
                            -= ma;
                }
            }
            if (++b == n) {                  // row a's pairs end here
                if (a_in) {
#pragma unroll
                    for (int j = 0; j < kCols; ++j)
                        acc[(a - r0) * kTile + threadIdx.x + j * kThreads]
                            += own[j];
                }
#pragma unroll
                for (int j = 0; j < kCols; ++j) own[j] = 0u;
                ++a;
                b = a + 1;
                a_in = a >= r0 && a < r0 + rows;
                if (a < n) id_a = ids[a];
            }
        }
        if (a_in && a < n) {                 // a row cut by the split
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                acc[(a - r0) * kTile + threadIdx.x + j * kThreads] += own[j];
        }
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            if ((long long)col[j] < d)
                atomicAdd(&out[(long long)(r0 + r) * d + col[j]],
                          acc[r * kTile + threadIdx.x + j * kThreads]);
        }
    }
}

// residue: (d,); count: the (alive, dropped) pairs, written by one thread.
__global__ void __launch_bounds__(kThreads)
secagg_residue_kernel(const uint2* __restrict__ keys,
                      const long long* __restrict__ ids,
                      const unsigned char* __restrict__ alive, int n,
                      long long d, uint32_t* __restrict__ residue,
                      int* __restrict__ count) {
    const long long c0 = (long long)blockIdx.x * kTile;
    uint32_t col[kCols], sum[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
        col[j] = (uint32_t)(c0 + threadIdx.x + j * kThreads);
        sum[j] = 0u;
    }
    int pairs = 0;
    for (int jr = 0; jr < n; ++jr) {         // each dropped row j
        if (alive[jr]) continue;
        const long long id_j = ids[jr];
        for (int i = 0; i < n; ++i) {        // against each alive row i
            if (!alive[i]) continue;
            const uint2 k = keys[pair_index(min(i, jr), max(i, jr), n)];
            const bool i_low = ids[i] < id_j;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const uint32_t m = mask_word(k.x, k.y, col[j]);
                sum[j] += i_low ? m : 0u - m;
            }
            ++pairs;
        }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
        if ((long long)col[j] < d) residue[col[j]] = sum[j];
    if (blockIdx.x == 0 && threadIdx.x == 0) *count = pairs;
}

// clear, recovered: (n, d) as uint32 bit patterns; deltas (n, d);
// residue (d,) or null (nothing dropped); alive (n,) or null (every row).
__global__ void __launch_bounds__(256)
secagg_unmask_sum_kernel(const uint32_t* __restrict__ clear,
                         const uint32_t* __restrict__ deltas,
                         const uint32_t* __restrict__ residue,
                         const unsigned char* __restrict__ alive, int n,
                         long long d, uint32_t* __restrict__ recovered,
                         int* __restrict__ ok) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int bad = 0;
    if (c < d) {
        uint32_t s_wire = 0u, s_clear = 0u;
#pragma unroll 4
        for (int r = 0; r < n; ++r) {
            const long long i = (long long)r * d + c;
            const uint32_t x = clear[i], dl = deltas[i];
            uint32_t w = x + dl;             // what client r sends
            asm volatile("" : "+r"(w));      // the network
            const bool live = alive == nullptr || alive[r];
            if (live) {
                s_wire += w;
                s_clear += x;
            }
            recovered[i] = live ? w - dl : 0u;
        }
        const uint32_t res = residue == nullptr ? 0u : residue[c];
        bad = (s_wire - res) != s_clear;
    }
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicAnd(ok, 0);
}

}  // namespace

// keys: (P, 2) int32 pair keys, P = n (n - 1) / 2; ids: (n,) int64; out:
// (n, d) int32, zeroed.  row_tile rows a block (row_tile * 256 * 4 bytes
// of shared memory, at most 227 KB), the pairs split over `splits` blocks
// a tile.  Launches on `stream`; returns the CUDA error code (0 on
// success).
extern "C" int fl_secagg_deltas(const int* keys, const long long* ids,
                                int n, long long d, int row_tile,
                                int splits, int* out, void* stream) {
    if (n < 2 || d <= 0) return 0;
    const int smem = row_tile * kTile * (int)sizeof(uint32_t);
    if (row_tile < 1 || smem > kSmemMax || splits < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        secagg_deltas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (err != cudaSuccess) return (int)err;
    const long long P = (long long)n * (n - 1) / 2;
    const long long per = (P + splits - 1) / splits;
    const dim3 grid((unsigned)((d + kTile - 1) / kTile),
                    (unsigned)((n + row_tile - 1) / row_tile),
                    (unsigned)splits);
    secagg_deltas_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint2*>(keys), ids, n, d, row_tile, per,
        reinterpret_cast<uint32_t*>(out));
    return (int)cudaGetLastError();
}

// keys, ids as above; alive: (n,) bool; residue: (d,) int32; count: one
// int32.
extern "C" int fl_secagg_residue(const int* keys, const long long* ids,
                                 const unsigned char* alive, int n,
                                 long long d, int* residue, int* count,
                                 void* stream) {
    if (d <= 0) return 0;
    const unsigned blocks = (unsigned)((d + kTile - 1) / kTile);
    secagg_residue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint2*>(keys), ids, alive, n, d,
        reinterpret_cast<uint32_t*>(residue), count);
    return (int)cudaGetLastError();
}

// clear: (n, d) float32; deltas: (n, d) int32; residue: (d,) int32 or
// null; alive: (n,) bool or null; recovered: (n, d) float32; ok: one
// int32, set to 0 when the check fails in any column (else left as it
// is).
extern "C" int fl_secagg_unmask_sum(const float* clear, const int* deltas,
                                    const int* residue,
                                    const unsigned char* alive, int n,
                                    long long d, float* recovered, int* ok,
                                    void* stream) {
    if (d <= 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((d + threads - 1) / threads);
    secagg_unmask_sum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint32_t*>(clear),
        reinterpret_cast<const uint32_t*>(deltas),
        reinterpret_cast<const uint32_t*>(residue), alive, n, d,
        reinterpret_cast<uint32_t*>(recovered), ok);
    return (int)cudaGetLastError();
}
