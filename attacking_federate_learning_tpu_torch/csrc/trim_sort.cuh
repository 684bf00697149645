// The median-anchored trimmed mean by a sort in registers, one thread per
// column, for cohorts of at most 128 rows.  It is the n <= 128 route of
// trimmed_mean.cu (fl_trimmed_mean), which replaces the TPU kernel
// attacking_federate_learning_tpu/ops/pallas_defense.py:_trim_kernel, and
// of masked_trimmed_mean.cu (fl_masked_trimmed_mean, weighted variant
// included), which replaces _masked_trim_kernel.  Past 128 rows both take
// coord_select.cuh's radix selection (kTrim).  The Python wrapper picks
// the route and the padded row count NP = 32, 36, ..., 128
// (ops/defense_kernels.py:trim_plan); the entry points refuse a plan that
// does not fit (n, d).
//
// What bounds it on an H100: instruction issue, before bytes.  The bytes
// are one read of the (n, d) matrix (31.8 MB at n = 100, d = 79,510:
// 9.5 us at 3.35 TB/s) and a second read of it from L2, which holds it.
// The instructions are the sort's: a compare-exchange is an integer min
// and max, which issue at half rate (one warp's min or max a clock for
// each pair of an SM's schedulers), and NP = 100 takes 1,104 of them plus
// the |dev| merge's 316.  coord_select.cuh's radix selection spends about
// 66 counting passes of one warp on a column, each warp instruction
// handling 32 rows of that one column; here a warp instruction handles
// 32 columns:
//
// 1. load.  A block stages the rows' alive bits (a ballot over the mask,
//    one word per 32 rows) in shared memory, so no row's load waits for
//    its mask byte.  A warp reads 32 neighbouring columns one row at a
//    time (one coalesced line a row).  Each alive row's float becomes its
//    order-preserving key (coord_select.cuh:ordered_key, -0 folded into
//    +0); dead rows and the padding up to NP take the sentinel
//    0xffffffff, which plays the part of the JAX kernels' +inf key.
// 2. sort.  Batcher's odd-even merge sort, unrolled over a comparator
//    table built at compile time, so every index is a constant and the NP
//    keys stay in registers.  The e alive keys come first: the sentinel
//    is the largest key.
// 3. median.  jnp.median's midpoint of the keys at (e - 1) / 2 and e / 2.
//    Those indices depend on the mask at run time, so each read is a
//    tree of selects over the registers, never keys[i] (which would put
//    the array in local memory).
// 4. |dev|.  Over the sorted values dev = v - med does not decrease
//    (rounded subtraction is monotonic), so |dev| first falls, then rises;
//    the keys become |dev|'s bits (bits & 0x7fffffff, as coord_select.cuh
//    selects them) in place, the dead rows stay above every alive |dev|,
//    and the sequence is bitonic.  One bitonic merge sorts it.  The k-th
//    smallest |dev| is T, and need = k - #{|dev| < T}.
// 5. keep.  The rows once more in row order (from L2): every alive row
//    with |dev| < T, and the first `need` with |dev| == T, which is
//    exactly a stable argsort's kept set.  Their deviations are summed in
//    row order (times w when weighted).
//
// Semantics are coord_select.cuh's, bit for bit in every selection: the
// median, the kept set, NaNs where its keys put them, e = 0 -> NaN,
// k = max(e - k_delta, 1).  Only the order of the kept sum differs (row
// order here, per lane and then across the warp there), which moves a
// trimmed mean by at most k rounding steps of the largest kept |dev|.
// The unmasked entry runs the kernel without reading a mask; with an
// all-true mask the masked one does the same arithmetic in the same
// order, so the two agree bit for bit.
//
// The median kernels can take the same sort: steps 1 to 3 are the median.

#pragma once

#include <type_traits>
#include <utility>

#include "coord_select.cuh"

namespace fl {

constexpr unsigned kSentinel = 0xffffffffu;
constexpr int kSortThreads = 128;       // threads (columns) a block
// The padded row counts NP: 32, 36, ..., 128.  The sort's registers and
// comparators grow with NP, so it pads n by at most 3 rows.
constexpr int kSortMinRows = 32, kSortStep = 4, kSortMaxRows = 128;

// -- the two comparator networks, as tables --------------------------------
// Batcher's odd-even merge sort, and the bitonic merge (the half-cleaners
// h = P/2, P/4, ..., 1), each of the next power of two P >= N with every
// comparator that touches an index >= N dropped: keys past N would be
// sentinels, the largest, and a min/max comparator leaves them in place.
// The tables are built at compile time and unrolled as template arguments,
// so every index is a constant and the keys stay in registers.

__host__ __device__ constexpr int next_pow2(int n) {
    int p = 1;
    while (p < n) p *= 2;
    return p;
}

// Writes the network's comparators (lo < hi) to lo/hi when they are not
// null; returns how many there are.
template <int N, bool MERGE>
__host__ __device__ constexpr int network(short* lo, short* hi) {
    int c = 0;
    if (MERGE) {
        for (int h = next_pow2(N) / 2; h >= 1; h /= 2)
            for (int i = 0; i + h < N; ++i)
                if ((i & h) == 0) {
                    if (lo) {
                        lo[c] = (short)i;
                        hi[c] = (short)(i + h);
                    }
                    ++c;
                }
        return c;
    }
    for (int p = 1; p < N; p *= 2)
        for (int k = p; k >= 1; k /= 2)
            for (int j = k % p; j + k < N; j += 2 * k)
                for (int i = 0; i < k && i + j + k < N; ++i)
                    if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
                        if (lo) {
                            lo[c] = (short)(i + j);
                            hi[c] = (short)(i + j + k);
                        }
                        ++c;
                    }
    return c;
}

template <int N, bool MERGE>
struct Table {
    static constexpr int kCount = network<N, MERGE>(nullptr, nullptr);
    short lo[kCount];
    short hi[kCount];
};

template <int N, bool MERGE>
__host__ __device__ constexpr Table<N, MERGE> make_table() {
    Table<N, MERGE> t{};
    network<N, MERGE>(t.lo, t.hi);
    return t;
}

template <int N, bool MERGE>
struct Net {
    static constexpr Table<N, MERGE> kTable = make_table<N, MERGE>();
};

// The c-th comparator's indices, read where the call is a constant
// expression (a template argument), so device code only sees constants.
template <int N, bool MERGE>
__host__ __device__ constexpr int net_lo(int c) {
    return Net<N, MERGE>::kTable.lo[c];
}
template <int N, bool MERGE>
__host__ __device__ constexpr int net_hi(int c) {
    return Net<N, MERGE>::kTable.hi[c];
}

__device__ __forceinline__ void compare_exchange(unsigned& a, unsigned& b) {
    const unsigned lo = min(a, b);
    b = max(a, b);
    a = lo;
}

template <int V>
using Const = std::integral_constant<int, V>;

template <bool MERGE, int N, std::size_t... C>
__device__ __forceinline__ void run_network(unsigned (&x)[N],
                                            std::index_sequence<C...>) {
    (compare_exchange(x[Const<net_lo<N, MERGE>((int)C)>::value],
                      x[Const<net_hi<N, MERGE>((int)C)>::value]),
     ...);
}

// Sorts N keys ascending.
template <int N>
__device__ __forceinline__ void sort_keys(unsigned (&x)[N]) {
    run_network<false>(
        x, std::make_index_sequence<Table<N, false>::kCount>{});
}

// Sorts ascending N keys that fall, then rise (the largest at the end
// included): a bitonic sequence.
template <int N>
__device__ __forceinline__ void bitonic_merge(unsigned (&x)[N]) {
    run_network<true>(
        x, std::make_index_sequence<Table<N, true>::kCount>{});
}

// x[idx] for a run-time idx (the same in every lane), without indexing the
// registers: in each chunk of 8 the candidate by idx's low three bits (7
// selects), then the chunk by the rest.
template <int N>
__device__ __forceinline__ unsigned pick(const unsigned (&x)[N], int idx) {
    const bool b0 = idx & 1, b1 = idx & 2, b2 = idx & 4;
    const int chunk = idx >> 3;
    unsigned v = 0u;
#pragma unroll
    for (int q = 0; q < (N + 7) / 8; ++q) {
        unsigned a[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) a[t] = x[8 * q + t < N ? 8 * q + t : N - 1];
        const unsigned m0 = b0 ? a[1] : a[0], m1 = b0 ? a[3] : a[2];
        const unsigned m2 = b0 ? a[5] : a[4], m3 = b0 ? a[7] : a[6];
        const unsigned c = b2 ? (b1 ? m3 : m2) : (b1 ? m1 : m0);
        v = q == chunk ? c : v;
    }
    return v;
}

// Row i of this thread's column: one multiply-add on the FMA pipe (the
// row stride in bytes is below 2^32).
__device__ __forceinline__ const float* row_of(const float* col0,
                                               unsigned stride, int i) {
    return reinterpret_cast<const float*>(
        reinterpret_cast<const char*>(col0)
        + (unsigned long long)stride * (unsigned)i);
}

// One thread a column.  NP >= n keys in registers; k = max(e - k_delta, 1)
// of the e alive rows are kept.  Without MASKED every row is alive (the
// mask is not read); with an all-true mask the MASKED kernel does the same
// arithmetic in the same order, so the two agree bit for bit.
template <int NP, bool MASKED, bool WEIGHTED>
__global__ void __launch_bounds__(kSortThreads)
trim_sort_kernel(const float* __restrict__ G,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ w, int n, long long d,
                 int k_delta, float* __restrict__ out) {
    // The rows' alive bits, one word per 32 rows (NP <= kSortThreads):
    // every thread then reads them from shared memory, and no row's load
    // waits for its mask byte.
    constexpr int kWords = (NP + 31) / 32;
    __shared__ unsigned alive_bits[kSortThreads / 32];
    {
        const int r = threadIdx.x;
        const bool ok = r < n && (!MASKED || __ldg(mask + r) != 0);
        const unsigned word = __ballot_sync(kFull, ok);
        if ((r & 31) == 0) alive_bits[r >> 5] = word;
    }
    __syncthreads();
    const long long col = (long long)blockIdx.x * kSortThreads + threadIdx.x;
    if (col >= d) return;
    const float* g = G + col;
    const unsigned stride = (unsigned)d * (unsigned)sizeof(float);
    unsigned live[kWords];
    int e = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
        live[j] = alive_bits[j];
        e += __popc(live[j]);
    }
    if (e == 0) {
        out[col] = __int_as_float(0x7fc00000);      // NaN, as in JAX
        return;
    }
    const int k = e - k_delta > 1 ? e - k_delta : 1;

    // 1. load: the alive rows' keys, all loads in flight at once.
    unsigned x[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
        const bool ok = (live[i / 32] >> (i % 32)) & 1u;
        const float v = ok ? __ldg(row_of(g, stride, i)) : 0.0f;
        x[i] = ok ? ordered_key(v) : kSentinel;
    }

    // 2. sort, 3. median
    sort_keys(x);
    const float med = (from_ordered_key(pick(x, (e - 1) / 2))
                       + from_ordered_key(pick(x, e / 2))) * 0.5f;

    // 4. |dev| bits, merged; T and the ties to keep.  A sentinel becomes
    // 0x7fffffff (NaN - med is NaN), which no alive |dev| exceeds, so the
    // dead rows stay last; they can tie only with an alive NaN, and the
    // walk below never keeps a dead row.
#pragma unroll
    for (int p = 0; p < NP; ++p)
        x[p] = __float_as_uint(from_ordered_key(x[p]) - med) & 0x7fffffffu;
    bitonic_merge(x);
    const unsigned T = pick(x, k - 1);
    int need = k;
#pragma unroll
    for (int p = 0; p < NP; ++p) need -= x[p] < T ? 1 : 0;

    // 5. keep, in row order (the reads hit L2).
    float sum = 0.0f, mass = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
        // (x + 0) - med: the bits of from_ordered_key(ordered_key(x)).
        const float dev = (__ldg(row_of(g, stride, i)) + 0.0f) - med;
        const float wi = WEIGHTED ? __ldg(w + i) : 1.0f;
        const bool alive = (alive_bits[i >> 5] >> (i & 31)) & 1u;
        const unsigned a = __float_as_uint(dev) & 0x7fffffffu;
        const bool tie = alive && a == T;
        const bool keep = (alive && a < T) || (tie && need > 0);
        need -= tie ? 1 : 0;
        if (keep) {
            if (WEIGHTED) {
                sum += wi * dev;
                mass += wi;
            } else {
                sum += dev;
            }
        }
    }
    out[col] = WEIGHTED ? sum / fmaxf(mass, 1e-12f) + med
                        : sum / (float)k + med;
}

template <int NP, bool MASKED, bool WEIGHTED>
cudaError_t launch_trim_sort(const float* G, const unsigned char* mask,
                             const float* w, int n, long long d, int k_delta,
                             float* out, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((d + kSortThreads - 1) / kSortThreads);
    const auto kernel = trim_sort_kernel<NP, MASKED, WEIGHTED>;
    kernel<<<blocks, kSortThreads, 0, stream>>>(G, mask, w, n, d, k_delta, out);
    return cudaGetLastError();
}

// The sort kernel for `padded` rows: the first NP = kSortMinRows,
// kSortMinRows + kSortStep, ... that equals it; any other count is
// refused.
template <int NP, bool MASKED, bool WEIGHTED>
cudaError_t launch_padded(int padded, const float* G,
                          const unsigned char* mask, const float* w, int n,
                          long long d, int k_delta, float* out,
                          cudaStream_t stream) {
    if constexpr (NP > kSortMaxRows) {
        return cudaErrorInvalidValue;
    } else {
        if (padded == NP)
            return launch_trim_sort<NP, MASKED, WEIGHTED>(G, mask, w, n, d,
                                                          k_delta, out,
                                                          stream);
        return launch_padded<NP + kSortStep, MASKED, WEIGHTED>(
            padded, G, mask, w, n, d, k_delta, out, stream);
    }
}

// The trimmed mean on the route the caller planned: padded = 0 is
// coord_select.cuh's radix selection (any n); padded = 32, 36, ..., 128 is
// the sort, for n <= padded.  Any other plan is refused.  Without MASKED
// every row is alive and `mask` is not read.
template <bool MASKED, bool WEIGHTED>
cudaError_t trimmed_mean_route(const float* G, const unsigned char* mask,
                               const float* w, int n, long long d,
                               int k_delta, int padded, float* out,
                               void* stream) {
    if (n <= 0 || d <= 0) return cudaErrorInvalidValue;
    if (padded == 0)
        return coord_select<kTrim, WEIGHTED>(G, MASKED ? mask : nullptr, w,
                                             n, d, k_delta, out, stream);
    // The sort keeps the row stride in 32 bits (d < 2^30).
    if (n > padded || d >= (1LL << 30)) return cudaErrorInvalidValue;
    return launch_padded<kSortMinRows, MASKED, WEIGHTED>(
        padded, G, mask, w, n, d, k_delta, out,
        static_cast<cudaStream_t>(stream));
}

}  // namespace fl
