// Coordinate-wise selection over the client axis of an (n, d) f32 matrix:
// the median and the median-anchored trimmed mean, over every row or over
// the rows a per-row mask keeps alive, unweighted or with per-row weights.
// One kernel template serves four entry points:
//
//   median.cu               fl_median                all rows
//   masked_median.cu        fl_masked_median         alive rows
//   trimmed_mean.cu         fl_trimmed_mean          all rows, k static
//   masked_trimmed_mean.cu  fl_masked_trimmed_mean   alive rows, k = max(e - k_delta, 1)
//
// All four take this template only for n > 128 (or when the caller plans
// the radix route); up to 128 rows they sort each column in one thread's
// registers (trim_sort.cuh), which issues far fewer instructions a column
// and picks the same keys.
//
// With every row alive, the masked kernels run exactly the instructions of
// the unmasked ones (e = n), so their outputs are bit for bit the same.
//
// What bounds them on an H100: in bytes, one read of the (n, d) matrix and
// one (d,) write (31.8 MB at n = 100, d = 79,510: 9.5 us at 3.35 TB/s); in
// practice the issue of the counting passes below.  A block stages an
// (n x C) column block in shared memory once (coalesced along the
// columns; row stride C + 1, odd, so a warp reading one column down its
// rows hits 32 banks), and one warp takes a column at a time, its lanes
// striding over the rows:
//
// - an order statistic by radix selection on the float's order-preserving
//   32-bit key, one bit per counting pass over n (32 passes, each count a
//   ballot per 32 rows); the median's upper middle value by one more pass
//   (jnp.median's midpoint (lo + hi) * 0.5, not torch.median's lower one);
// - the trimmed mean overwrites the keys with the deviations' bits and
//   selects the k-th smallest |dev| = T the same way (31 passes); one
//   ballot pass keeps every row with |dev| < T and the first
//   k - #{|dev| < T} rows with |dev| == T in row order, which is exactly a
//   stable argsort's kept set;
// - the weighted median (the lower weighted median: the smallest alive
//   value v with W(<= v) >= W / 2) is one more radix selection, whose
//   counting pass sums the alive weights below the candidate instead of
//   counting rows.
//
// Dead rows never enter a count or a sum.  That is what the JAX kernels'
// +inf sentinels do: dead rows sort last, and the kept set k <= e never
// reaches them.  The alive count e, and k, come from the mask inside the
// kernel (the same ballot count in every warp), so the caller reads
// nothing back to the host.  e = 0 reproduces the JAX functions: the
// median of no rows is +inf (both middle picks land on the +inf
// sentinels), the trimmed mean of no rows is NaN (-inf + inf).
//
// Order-preserving keys fold -0 into +0, where jnp.sort orders -0 below
// +0: a median may come out +0 where JAX gives -0, equal in value.
//
// The kept deviations are summed per lane and then across the warp,
// another order than the reference's sorted one, which moves a trimmed
// mean by at most k rounding steps of the largest kept |dev|.

#pragma once

#include <cuda_runtime.h>

namespace fl {

constexpr unsigned kFull = 0xffffffffu;

enum Op { kTrim = 0, kMedian = 1 };

// Order-preserving key of a float (-0 taken as +0), and back.
__device__ __forceinline__ unsigned ordered_key(float x) {
    const unsigned u = __float_as_uint(x + 0.0f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_key(unsigned o) {
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);   // the same sum in every lane
    return v;
}

// One lane's share of a column: rows i = lane + 32 j.  With RPL > 0 the
// lane holds its RPL rows' keys, alive bits and weights in registers
// (n <= 32 RPL); with RPL == 0 the keys stay in shared memory
// (x[i * stride]) and the mask and weights are read from device memory.
// The alive bits and weights are per row, the same in every column.
template <int RPL>
struct Column {
    unsigned r[RPL > 0 ? RPL : 1];
    float wr[RPL > 0 ? RPL : 1];
    unsigned live;
    unsigned* x;
    const unsigned char* mask;       // nullptr: every row alive
    const float* w;                  // nullptr: unit weights
    int n, stride, lane;

    __device__ __forceinline__ int slots() const {
        return RPL > 0 ? RPL : (n + 31) / 32;
    }
    __device__ __forceinline__ bool valid(int j) const {
        return lane + 32 * j < n;
    }
    __device__ __forceinline__ bool alive(int j) const {
        if (RPL > 0) return (live >> j) & 1u;
        return valid(j) && (mask == nullptr || mask[lane + 32 * j] != 0);
    }
    __device__ __forceinline__ float weight(int j) const {
        if (RPL > 0) return wr[j];
        return w == nullptr ? 1.0f : __ldg(w + lane + 32 * j);
    }
    __device__ __forceinline__ unsigned get(int j) const {
        return RPL > 0 ? r[j] : x[(lane + 32 * j) * stride];
    }
    __device__ __forceinline__ void set(int j, unsigned v) {
        if (RPL > 0) r[j] = v;
        else x[(lane + 32 * j) * stride] = v;
    }
};

// #{alive i : (key_i & mask) < t}, the same count in every lane.
template <int RPL>
__device__ __forceinline__ int count_below(const Column<RPL>& c, unsigned t,
                                           unsigned mask) {
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < c.slots(); ++j)
        cnt += __popc(__ballot_sync(
            kFull, c.alive(j) && (c.get(j) & mask) < t));
    return cnt;
}

// e: how many rows are alive, the same count in every lane.
template <int RPL>
__device__ __forceinline__ int alive_count(const Column<RPL>& c) {
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < c.slots(); ++j)
        cnt += __popc(__ballot_sync(kFull, c.alive(j)));
    return cnt;
}

// The r-th smallest (0-based) of the alive masked keys, built one bit at
// a time from bit `top` down: a bit is set when at most r keys lie below
// the prefix with that bit set.
template <int RPL>
__device__ __forceinline__ unsigned select_key(const Column<RPL>& c, int r,
                                               int top, unsigned mask) {
    unsigned ans = 0u;
    for (int b = top; b >= 0; --b) {
        const unsigned t = ans | (1u << b);
        if (count_below(c, t, mask) <= r) ans = t;
    }
    return ans;
}

// The alive weight below key t (all alive rows when `all`), the same sum
// in every lane.
template <int RPL>
__device__ __forceinline__ float weight_below(const Column<RPL>& c,
                                              unsigned t, bool all) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < c.slots(); ++j)
        if (c.alive(j) && (all || c.get(j) < t)) s += c.weight(j);
    return warp_sum(s);
}

// jnp.median of the e >= 1 alive keys: the midpoint of the (e-1)/2-th and
// e/2-th smallest.
template <int RPL>
__device__ __forceinline__ float alive_median(const Column<RPL>& c, int e) {
    const int mlo = (e - 1) / 2, mhi = e / 2;
    const unsigned lo = select_key(c, mlo, 31, kFull);
    unsigned hi = lo;
    if (mhi != mlo) {
        int le = 0;
        unsigned above = kFull;
#pragma unroll
        for (int j = 0; j < c.slots(); ++j) {
            const bool ok = c.alive(j);
            const unsigned v = ok ? c.get(j) : 0u;
            le += __popc(__ballot_sync(kFull, ok && v <= lo));
            if (ok && v > lo && v < above) above = v;
        }
        hi = le > mhi ? lo : __reduce_min_sync(kFull, above);
    }
    return (from_ordered_key(lo) + from_ordered_key(hi)) * 0.5f;
}

// The lower weighted median of the e >= 1 alive keys: the largest key t
// whose alive weight below stays under half, which is the smallest alive
// value v with W(<= v) >= half.  With no weight at all (half = 0) every
// candidate fails, and the first alive value is the pick, as the JAX
// function's argmax(cum >= 0) makes it.
template <int RPL>
__device__ __forceinline__ float weighted_median(const Column<RPL>& c,
                                                 float half) {
    if (!(half > 0.0f)) return from_ordered_key(select_key(c, 0, 31, kFull));
    unsigned ans = 0u;
    for (int b = 31; b >= 0; --b) {
        const unsigned t = ans | (1u << b);
        if (weight_below(c, t, false) < half) ans = t;
    }
    return from_ordered_key(ans);
}

// Block: `cols` columns of G, which its warps take in turn.  OP picks the
// median or the trimmed mean; k = max(e - k_delta, 1) values are kept.
template <int RPL, int OP, bool WEIGHTED>
__global__ void coord_kernel(const float* __restrict__ G,
                             const unsigned char* __restrict__ mask,
                             const float* __restrict__ w, int n, long long d,
                             int k_delta, int cols, float* __restrict__ out) {
    extern __shared__ unsigned tile[];            // [n][cols + 1]
    const int stride = cols + 1;
    const long long c0 = (long long)blockIdx.x * cols;
    for (int e = threadIdx.x; e < n * cols; e += blockDim.x) {
        const int r = e / cols, c = e % cols;
        const long long col = c0 + c;
        tile[r * stride + c] =
            col < d ? ordered_key(G[(long long)r * d + col]) : 0u;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    // (Each lane only ever touches its own rows, i = lane mod 32.)
    Column<RPL> c;
    c.x = tile;
    c.mask = mask;
    c.w = w;
    c.n = n;
    c.stride = stride;
    c.lane = lane;
    c.live = 0u;
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
        const int i = lane + 32 * j;
        const bool ok = i < n && (mask == nullptr || mask[i] != 0);
        c.live |= (ok ? 1u : 0u) << j;
        c.wr[j] = ok && w != nullptr ? w[i] : 1.0f;
    }
    const int e = alive_count(c);
    const int k = e - k_delta > 1 ? e - k_delta : 1;
    const float half =
        OP == kMedian && WEIGHTED ? weight_below(c, 0u, true) / 2.0f : 0.0f;

    for (int cc = threadIdx.x >> 5; cc < cols && c0 + cc < d; cc += nwarps) {
        c.x = tile + cc;
#pragma unroll
        for (int j = 0; j < RPL; ++j)
            c.r[j] = c.valid(j) ? c.x[(lane + 32 * j) * stride] : 0u;

        if (e == 0) {
            if (lane == 0)
                out[c0 + cc] = OP == kMedian ? __int_as_float(0x7f800000)
                                             : __int_as_float(0x7fc00000);
            continue;
        }
        if (OP == kMedian) {
            const float m = WEIGHTED ? weighted_median(c, half)
                                     : alive_median(c, e);
            if (lane == 0) out[c0 + cc] = m;
            continue;
        }
        const float med = alive_median(c, e);

        // Keys -> deviation bits; |dev| is the bits without the sign.
#pragma unroll
        for (int j = 0; j < c.slots(); ++j)
            if (c.alive(j))
                c.set(j, __float_as_uint(from_ordered_key(c.get(j)) - med));

        const unsigned T = select_key(c, k - 1, 30, 0x7fffffffu);
        int need = k - count_below(c, T, 0x7fffffffu);
        float sum = 0.0f, mass = 0.0f;
#pragma unroll
        for (int j = 0; j < c.slots(); ++j) {
            const bool ok = c.alive(j);
            const unsigned v = ok ? c.get(j) : 0u;
            const unsigned key = v & 0x7fffffffu;
            const bool tie = ok && key == T;
            const unsigned ties = __ballot_sync(kFull, tie);
            const int before = __popc(ties & ((1u << lane) - 1u));
            if ((ok && key < T) || (tie && before < need)) {
                if (WEIGHTED) {
                    const float wj = c.weight(j);
                    sum += wj * __uint_as_float(v);
                    mass += wj;
                } else {
                    sum += __uint_as_float(v);
                }
            }
            need -= __popc(ties);
        }
        sum = warp_sum(sum);
        if (WEIGHTED) {
            mass = warp_sum(mass);
            if (lane == 0)
                out[c0 + cc] = sum / fmaxf(mass, 1e-12f) + med;
        } else if (lane == 0) {
            out[c0 + cc] = sum / (float)k + med;
        }
    }
}

template <int RPL, int OP, bool WEIGHTED>
cudaError_t launch_coord(const float* G, const unsigned char* mask,
                         const float* w, int n, long long d, int k_delta,
                         int cols, size_t bytes, float* out,
                         cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        coord_kernel<RPL, OP, WEIGHTED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    const int threads = 32 * (cols < 8 ? cols : 8);
    const unsigned blocks = (unsigned)((d + cols - 1) / cols);
    coord_kernel<RPL, OP, WEIGHTED><<<blocks, threads, bytes, stream>>>(
        G, mask, w, n, d, k_delta, cols, out);
    return cudaGetLastError();
}

// The launch plan every entry point shares.  n <= 25,600: one column's
// staging must fit a block's shared memory; larger n is refused.
template <int OP, bool WEIGHTED>
cudaError_t coord_select(const float* G, const unsigned char* mask,
                         const float* w, int n, long long d, int k_delta,
                         float* out, void* stream) {
    if (n <= 0 || d <= 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // The widest column block (up to 32) whose staging takes at most 64 KB,
    // so several blocks share an SM; one column up to 200 KB for large n.
    int cols = 32;
    while (cols > 1 && (size_t)n * (cols + 1) * sizeof(unsigned) > 64 * 1024)
        cols /= 2;
    const size_t bytes = (size_t)n * (cols + 1) * sizeof(unsigned);
    if (bytes > 200 * 1024) return cudaErrorInvalidValue;
    // Rows in registers up to 256 (8 a lane), in shared memory past that.
    const int rpl = (n + 31) / 32;
    return rpl <= 1
        ? launch_coord<1, OP, WEIGHTED>(G, mask, w, n, d, k_delta, cols, bytes, out, st)
        : rpl <= 2
        ? launch_coord<2, OP, WEIGHTED>(G, mask, w, n, d, k_delta, cols, bytes, out, st)
        : rpl <= 4
        ? launch_coord<4, OP, WEIGHTED>(G, mask, w, n, d, k_delta, cols, bytes, out, st)
        : rpl <= 8
        ? launch_coord<8, OP, WEIGHTED>(G, mask, w, n, d, k_delta, cols, bytes, out, st)
        : launch_coord<0, OP, WEIGHTED>(G, mask, w, n, d, k_delta, cols, bytes, out, st);
}

}  // namespace fl
