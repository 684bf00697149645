// Fused distance -> Krum score: (n, d) f32 or bf16 -> (n,) scores, (n,)
// rowsums, f32.
//
// Replaces the TPU kernel attacking_federate_learning_tpu/ops/
// pallas_defense.py:pallas_krum_scores (_krum_score_kernel), and with
// fl_krum_scores_bf16 its bf16 operand route (the Gram's stage 1 on the
// tensor cores, gram_mma.cuh).  Row i's
// score is the sum of its k smallest distances to the other rows,
// evaluated by the complement identity: rowsum_i minus the sum of the
// c = f - 1 (+2 under paper scoring) largest off-diagonal distances.  The
// caller applies the cancellation guard on (scores, rowsums) and falls
// back to the exact sort over the distance matrix when it fails.
//
// What bounds it on an H100: the distance kernel's Gram.  On the f32
// route, its fp32 FMA work, n(n-1)*d + 2*n*d flops (0.80 GFLOP at n =
// 100, d = 79,510, 12 us at 67 TFLOP/s); on the bf16 route, bytes up to
// about n = 150 (2 n d, 4.7 us at n = 100) and the same flops at the
// dense bf16 tensor rate above (81 us at n = 1,000).  The selection reads
// n^2 floats.  The design: the distance kernel's two stages (gram_tile.cuh
// or gram_mma.cuh: the upper-triangle Gram split over d across every SM,
// then the fixed-order epilogue) write the (n, n)
// distances to scratch, and a third launch, one block per row, folds row
// i into its rowsum and the sum of its c largest.  The Pallas kernel
// keeps the matrix out of HBM because VMEM is where the TPU holds it;
// here the matrix is 40 KB at n = 100 and 4 MB at n = 1,000, small next
// to the 31.8 MB input, and it stays in the 50 MB L2.  Workspace: the
// Gram partials (S * tiles * 64 KB and their diagonals) plus the n^2
// floats.
//
// The c largest are found by radix selection of the c-th largest on the
// floats' order-preserving keys, 8 bits a pass, four passes, counts in
// shared memory; the sum is the values above that threshold T plus
// T times the ties still to take (ties at T are taken in index order;
// equal values, so which ones does not change the sum).  The rowsum and
// the sum above T are per-thread sums in index order added across the
// block in a fixed order, so two launches give the same bits.  c = 0 is
// the rowsum alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_mma.cuh"
#include "gram_tile.cuh"

namespace fl {

// Block-wide sum in a fixed order: the warps' butterfly sums, then the
// eight warp sums in warp order.  Every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w];
    __syncthreads();
    return t;
}

// Order-preserving key of a float: larger float, larger key (NaN above
// +inf, as torch.topk ranks it).
__device__ __forceinline__ uint32_t float_key(float f) {
    const uint32_t u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One block per row i of D (n, n): rowsum and rowsum minus the sum of the
// comp largest off-diagonal entries.
__global__ void __launch_bounds__(kThreads)
krum_rows_kernel(const float* __restrict__ D, int n, int comp,
                 float* __restrict__ scores, float* __restrict__ rowsums) {
    __shared__ float red[kWarps];
    __shared__ unsigned hist[256];
    __shared__ uint32_t sel[2];            // prefix, ties still to take
    const int i = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const float* row = D + (long long)i * n;

    float part = 0.f;
    for (int j = tid; j < n; j += kThreads)
        if (j != i) part += row[j];
    const float rowsum = block_sum(part, red);
    if (comp == 0) {
        if (tid == 0) {
            scores[i] = rowsum;
            rowsums[i] = rowsum;
        }
        return;
    }

    // The comp-th largest key, 8 bits at a time from the top.
    uint32_t prefix = 0, known = 0, want = (uint32_t)comp;
    for (int shift = 24; shift >= 0; shift -= 8) {
        hist[tid] = 0;                     // kThreads == 256 bins
        __syncthreads();
        for (int j = tid; j < n; j += kThreads) {
            if (j == i) continue;
            const uint32_t k = float_key(row[j]);
            if ((k & known) == prefix)
                atomicAdd(&hist[(k >> shift) & 255], 1u);
        }
        __syncthreads();
        if (tid < 32) {
            // Lane l holds bins 255 - 8l down to 248 - 8l.
            unsigned cnt[8], mine = 0;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                cnt[q] = hist[255 - 8 * lane - q];
                mine += cnt[q];
            }
            unsigned incl = mine;          // inclusive scan over lanes
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const unsigned o = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += o;
            }
            const unsigned hit =
                __ballot_sync(0xffffffffu, incl >= want);
            const int first = __ffs(hit) - 1;       // want <= total
            if (lane == first) {
                unsigned before = incl - mine;
                int q = 0;
                while (before + cnt[q] < want) before += cnt[q++];
                sel[0] = prefix | ((uint32_t)(255 - 8 * lane - q) << shift);
                sel[1] = want - before;
            }
        }
        __syncthreads();
        prefix = sel[0];
        want = sel[1];
        known |= 255u << shift;
        __syncthreads();
    }

    // Values above the threshold, then `want` copies of it.
    float above = 0.f;
    for (int j = tid; j < n; j += kThreads)
        if (j != i && float_key(row[j]) > prefix) above += row[j];
    above = block_sum(above, red);
    if (tid == 0) {
        const float top = above + (float)want * key_float(prefix);
        scores[i] = rowsum - top;
        rowsums[i] = rowsum;
    }
}

// The per-row selection on D, after the Gram's launches returned err.
inline int krum_rows(cudaError_t err, const float* D, int n, int comp,
                     float* scores, float* rowsums, cudaStream_t st) {
    if (err != cudaSuccess) return (int)err;
    krum_rows_kernel<<<n, kThreads, 0, st>>>(D, n, comp, scores, rowsums);
    return (int)cudaGetLastError();
}

}  // namespace fl

// G: (n, d) f32 row-major on the device; ws: f32 scratch of the Gram
// partials (as fl_pairwise_distances); D: (n, n) f32 scratch; scores and
// rowsums: (n,) out.  comp = c, the count of largest distances each row
// drops (0 <= c <= n-1).  The plan (S, cps, kg) comes from the caller
// (ops/distances.py:gram_plan).  Launches on `stream`; returns the CUDA
// error code (0 on success).
extern "C" int fl_krum_scores(const float* G, int n, long long d, int comp,
                              int S, int cps, int kg, float* ws,
                              float* D, float* scores, float* rowsums,
                              void* stream) {
    if (!fl::plan_ok(n, d, S, cps, kg) || comp < 0 || comp > n - 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return fl::krum_rows(fl::gram_distances(G, n, d, S, cps, kg, ws, D, st),
                         D, n, comp, scores, rowsums, st);
}

// As fl_krum_scores, with G (n, d) bf16 (its 16-bit words) and the
// tensor cores' plan (ops/distances.py:mma_plan): S slices of cps chains,
// stage_k k a pipeline stage.
extern "C" int fl_krum_scores_bf16(const uint16_t* G, int n, long long d,
                                   int comp, int S, int cps, int stage_k,
                                   float* ws, float* D, float* scores,
                                   float* rowsums, void* stream) {
    if (!fl::mma::mma_plan_ok(n, d, S, cps, stage_k) || comp < 0
        || comp > n - 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return fl::krum_rows(
        fl::gram_distances_bf16(G, n, d, S, cps, stage_k, ws, D, st), D, n,
        comp, scores, rowsums, st);
}

// The per-row selection alone, on a distance matrix D (n, n) f32 computed
// elsewhere (fl_gram_epilogue over the model axis' positions): scores and
// rowsums (n,) out, comp as for fl_krum_scores.
extern "C" int fl_krum_rows(const float* D, int n, int comp, float* scores,
                            float* rowsums, void* stream) {
    if (n <= 0 || comp < 0 || comp > n - 1)
        return (int)cudaErrorInvalidValue;
    return fl::krum_rows(cudaSuccess, D, n, comp, scores, rowsums,
                         static_cast<cudaStream_t>(stream));
}
