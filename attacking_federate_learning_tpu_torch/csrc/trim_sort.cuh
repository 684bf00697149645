// Sorts in registers, one thread per column, for cohorts of at most 128
// rows: the median-anchored trimmed mean (trim_sort_kernel) and the
// median (median_sort_kernel).  They are the n <= 128 route of
//
//   trimmed_mean.cu         fl_trimmed_mean         replaces pallas_defense.py:_trim_kernel
//   masked_trimmed_mean.cu  fl_masked_trimmed_mean  replaces _masked_trim_kernel
//   median.cu               fl_median               replaces _median_kernel
//   masked_median.cu        fl_masked_median        replaces _masked_median_kernel
//
// (JAX kernels under attacking_federate_learning_tpu/ops/).  Past 128
// rows all four take coord_select.cuh's radix selection.  The Python
// wrappers pick the route and the padded row count NP = 32, 36, ..., 128
// (ops/defense_kernels.py:trim_plan); the entry points refuse a plan that
// does not fit (n, d).
//
// What bounds them on an H100: instruction issue, before bytes.  The
// bytes are one read of the (n, d) matrix (31.8 MB at n = 100, d =
// 79,510: 9.5 us at 3.35 TB/s), and for the trimmed mean and the weighted
// median more reads of it from L2, which holds it.  The instructions are
// the sort's: a compare-exchange is an integer min and max, which issue at
// half rate (one warp's min or max a clock for each pair of an SM's
// schedulers), and NP = 100 takes 1,104 of them (the trimmed mean's |dev|
// merge 316 more).  coord_select.cuh's radix selection spends 33 (the
// median) to 66 (the trimmed mean) counting passes of one warp on a
// column, each warp instruction handling 32 rows of that one column; here
// a warp instruction handles 32 columns.
//
// Steps 1 to 3 are shared by both kernels:
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
// 3. median.  jnp.median's midpoint of the keys at (e - 1) / 2 and e / 2,
//    the same two keys coord_select.cuh's radix selection finds, so the
//    two routes' medians agree bit for bit.  Those indices depend on the
//    mask at run time, so each read is a tree of selects over the
//    registers, never keys[i] (which would put the array in local
//    memory).
//
// The median kernel stops there, or for the lower weighted median (the
// smallest alive value v with W(<= v) >= W / 2, coord_select.cuh's
// weighted_median) bisects over the sorted keys: "W(key <= x[p]) >= W / 2"
// holds from some p on, and each of the at most 7 steps (NP <= 128) is one
// row-order pass over the column (from L2) summing the alive weights
// staged in shared memory.  W itself is the same row-order sum, so the
// predicate holds at p = e - 1 exactly.  e = 0 gives +inf, as the radix
// route does.
//
// The trimmed mean goes on:
//
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
// median, the kept set, NaNs where its keys put them, e = 0 -> NaN (the
// trimmed mean) or +inf (the median), k = max(e - k_delta, 1).  Only the
// order of a sum differs: the trimmed mean's kept sum (row order here,
// per lane and then across the warp there), which moves it by at most k
// rounding steps of the largest kept |dev|, and the weighted median's
// weight sums, which are exact on dyadic weights.  The unmasked entries
// run the kernels without reading a mask; with an all-true mask the
// masked ones do the same arithmetic in the same order, so the two agree
// bit for bit.

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

// x[idx] for a run-time idx, without indexing the registers: in each
// chunk of 8 the candidate by idx's low three bits (7 selects), then the
// chunk by the rest.  Only selects, so lanes may ask for different idx.
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

// -- steps 1 to 3, shared by the two kernels ---------------------------------

// 1a. The rows' alive bits, one word per 32 rows (thread r takes row r:
// NP <= kSortThreads), into `bits` (shared memory): every thread then
// reads them there, and no row's load waits for its mask byte.  Without
// MASKED every row below n is alive and the mask is not read.  Every
// thread of the block calls it (it synchronises).
static_assert(kSortMaxRows <= kSortThreads, "one row a thread");
template <bool MASKED>
__device__ __forceinline__ void stage_alive_bits(
        const unsigned char* __restrict__ mask, int n,
        unsigned (&bits)[kSortThreads / 32]) {
    const int r = threadIdx.x;
    const bool ok = r < n && (!MASKED || __ldg(mask + r) != 0);
    const unsigned word = __ballot_sync(kFull, ok);
    if ((r & 31) == 0) bits[r >> 5] = word;
    __syncthreads();
}

// 1b. e, the alive count, with the alive words copied to registers.
template <int NP>
__device__ __forceinline__ int alive_count(const unsigned* bits,
                                           unsigned (&live)[(NP + 31) / 32]) {
    int e = 0;
#pragma unroll
    for (int j = 0; j < (NP + 31) / 32; ++j) {
        live[j] = bits[j];
        e += __popc(live[j]);
    }
    return e;
}

// 1c. The alive rows' keys, the sentinel elsewhere; all loads in flight
// at once.
template <int NP>
__device__ __forceinline__ void load_keys(const unsigned (&live)[(NP + 31) / 32],
                                          const float* g, unsigned stride,
                                          unsigned (&x)[NP]) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
        const bool ok = (live[i / 32] >> (i % 32)) & 1u;
        const float v = ok ? __ldg(row_of(g, stride, i)) : 0.0f;
        x[i] = ok ? ordered_key(v) : kSentinel;
    }
}

// 3. jnp.median of the e >= 1 sorted alive keys.
template <int NP>
__device__ __forceinline__ float middle(const unsigned (&x)[NP], int e) {
    return (from_ordered_key(pick(x, (e - 1) / 2))
            + from_ordered_key(pick(x, e / 2))) * 0.5f;
}

// -- the trimmed mean ----------------------------------------------------------

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
    __shared__ unsigned alive_bits[kSortThreads / 32];
    stage_alive_bits<MASKED>(mask, n, alive_bits);
    const long long col = (long long)blockIdx.x * kSortThreads + threadIdx.x;
    if (col >= d) return;
    const float* g = G + col;
    const unsigned stride = (unsigned)d * (unsigned)sizeof(float);
    unsigned live[(NP + 31) / 32];
    const int e = alive_count<NP>(alive_bits, live);
    if (e == 0) {
        out[col] = __int_as_float(0x7fc00000);      // NaN, as in JAX
        return;
    }
    const int k = e - k_delta > 1 ? e - k_delta : 1;

    // 1. load, 2. sort, 3. median
    unsigned x[NP];
    load_keys<NP>(live, g, stride, x);
    sort_keys(x);
    const float med = middle(x, e);

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

// -- the median ----------------------------------------------------------------

// The alive weight of the rows whose key is at most t (every alive row
// when `all`), summed in row order: a row-order pass over the column,
// from L2.  Every row is read and the others add +0, so the loads need no
// branch, and an unroll of 16 keeps 16 of them in flight (smaller unrolls
// issued them in smaller groups and were slower).  The sum over every
// alive row and the sum at t = the largest alive key add the same terms
// in the same order.
__device__ __forceinline__ float weight_at_most(const float* g,
                                                unsigned stride,
                                                const unsigned* alive_bits,
                                                const float* ws, int n,
                                                unsigned t, bool all) {
    float s = 0.0f;
#pragma unroll 16
    for (int i = 0; i < n; ++i) {
        const bool alive = (alive_bits[i >> 5] >> (i & 31)) & 1u;
        const bool below =
            all || ordered_key(__ldg(row_of(g, stride, i))) <= t;
        s += alive && below ? ws[i] : 0.0f;
    }
    return s;
}

// One thread a column: the median of the alive rows, or with WEIGHTED
// (MASKED only) their lower weighted median.  Without MASKED every row is
// alive; an all-true mask gives the same bits.
template <int NP, bool MASKED, bool WEIGHTED>
__global__ void __launch_bounds__(kSortThreads)
median_sort_kernel(const float* __restrict__ G,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ w, int n, long long d,
                   float* __restrict__ out) {
    static_assert(MASKED || !WEIGHTED, "weights ride the mask");
    __shared__ unsigned alive_bits[kSortThreads / 32];
    __shared__ float ws[WEIGHTED ? NP : 1];          // the rows' weights
    if (WEIGHTED && threadIdx.x < n) ws[threadIdx.x] = __ldg(w + threadIdx.x);
    stage_alive_bits<MASKED>(mask, n, alive_bits);
    const long long col = (long long)blockIdx.x * kSortThreads + threadIdx.x;
    if (col >= d) return;
    const float* g = G + col;
    const unsigned stride = (unsigned)d * (unsigned)sizeof(float);
    unsigned live[(NP + 31) / 32];
    const int e = alive_count<NP>(alive_bits, live);
    if (e == 0) {
        out[col] = __int_as_float(0x7f800000);      // +inf, as in JAX
        return;
    }

    // 1. load, 2. sort
    unsigned x[NP];
    load_keys<NP>(live, g, stride, x);
    sort_keys(x);
    if (!WEIGHTED) {
        out[col] = middle(x, e);                      // 3. median
        return;
    }

    // The lower weighted median: the first p with W(key <= x[p]) >= half.
    // With no weight at all (half = 0) the first alive value, as JAX's
    // argmax(cum >= 0) makes it.
    const float half =
        weight_at_most(g, stride, alive_bits, ws, n, 0u, true) / 2.0f;
    int pos = 0;                 // every p < pos fails the predicate
    if (half > 0.0f) {
        // Steps of 2^j down to 1 from the largest power of two <= e - 1:
        // they reach any pos <= e - 1, and p = e - 1 holds.
        for (int step = e > 1 ? 1 << (31 - __clz(e - 1)) : 0; step >= 1;
             step >>= 1) {
            const int q = min(pos + step - 1, e - 1);
            if (weight_at_most(g, stride, alive_bits, ws, n, pick(x, q),
                               false) < half)
                pos += step;
        }
    }
    out[col] = from_ordered_key(pick(x, pos));
}

// -- launches --------------------------------------------------------------------

// The sort kernel of OP for `padded` rows: the first NP = kSortMinRows,
// kSortMinRows + kSortStep, ... that equals it; any other count is
// refused.
template <int NP, int OP, bool MASKED, bool WEIGHTED>
cudaError_t launch_padded(int padded, const float* G,
                          const unsigned char* mask, const float* w, int n,
                          long long d, int k_delta, float* out,
                          cudaStream_t stream) {
    if constexpr (NP > kSortMaxRows) {
        return cudaErrorInvalidValue;
    } else {
        if (padded != NP)
            return launch_padded<NP + kSortStep, OP, MASKED, WEIGHTED>(
                padded, G, mask, w, n, d, k_delta, out, stream);
        const unsigned blocks =
            (unsigned)((d + kSortThreads - 1) / kSortThreads);
        if constexpr (OP == kTrim)
            trim_sort_kernel<NP, MASKED, WEIGHTED>
                <<<blocks, kSortThreads, 0, stream>>>(G, mask, w, n, d,
                                                      k_delta, out);
        else
            median_sort_kernel<NP, MASKED, WEIGHTED>
                <<<blocks, kSortThreads, 0, stream>>>(G, mask, w, n, d, out);
        return cudaGetLastError();
    }
}

// OP (kTrim or kMedian) on the route the caller planned: padded = 0 is
// coord_select.cuh's radix selection (any n); padded = 32, 36, ..., 128
// is the sort, for n <= padded.  Any other plan is refused.  Without
// MASKED every row is alive and `mask` is not read.
template <int OP, bool MASKED, bool WEIGHTED>
cudaError_t select_route(const float* G, const unsigned char* mask,
                         const float* w, int n, long long d, int k_delta,
                         int padded, float* out, void* stream) {
    if (n <= 0 || d <= 0) return cudaErrorInvalidValue;
    if (padded == 0)
        return coord_select<OP, WEIGHTED>(G, MASKED ? mask : nullptr, w, n,
                                          d, k_delta, out, stream);
    // The sort keeps the row stride in 32 bits (d < 2^30).
    if (n > padded || d >= (1LL << 30)) return cudaErrorInvalidValue;
    return launch_padded<kSortMinRows, OP, MASKED, WEIGHTED>(
        padded, G, mask, w, n, d, k_delta, out,
        static_cast<cudaStream_t>(stream));
}

}  // namespace fl
