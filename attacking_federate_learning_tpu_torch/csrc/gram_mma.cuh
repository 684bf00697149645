// Stage 1 of the bf16 operand route of the distance kernels
// (pairwise_distances.cu, krum_scores.cu): the Gram of an (n, d) bf16
// matrix on the tensor cores, with f32 accumulation, split over d across
// every SM.  Stage 2 is gram_tile.cuh's gram_epilogue_kernel, which reads
// the partial tiles this stage writes in the layout the f32 route uses.
//
// What bounds it on an H100: bytes up to about n = 150, operations above.
// The input is 2 n d bytes (15.9 MB at n = 100, d = 79,510: 4.7 us at
// 3.35 TB/s); the Gram needs n(n-1) d + 2 n d operations (0.80 GFLOP at
// n = 100, 0.8 us at the dense bf16 tensor rate of 989 TFLOP/s, and 79.7
// GFLOP, 81 us, at n = 1,000).  The two cross at 2 n d / 3.35e12 = n^2 d
// / 989e12, n of about 150.
//
// The design.  The padded Gram is cut into 128 x 128 tiles and only the
// nt(nt+1)/2 tiles on or above the diagonal are computed (nt = ceil(n /
// 128)); d is cut into S slices of `cps` whole chains of 256 k.  The grid
// is tiles x S blocks, block = s * tiles + tile, and block (tile, s)
// writes its partial tile to ws[s][tile][128][128] and, on a diagonal
// tile, its diagonal to dg[s][nt * 128], as gram_partials_kernel does.
// The plan (cps, S, stage_k) comes from ops/distances.py:mma_plan.
//
// A block is one or two warpgroups.  Each runs wgmma.m64nNk16 (bf16 in,
// f32 accumulators in registers) on 64 rows of the tile and N columns:
// N = 64 with one warpgroup where n <= 64, else N = 128 with two (rows
// 0-63 and 64-127 of the tile, all 128 columns; on a diagonal tile that
// computes the mirror entries below the diagonal too, which no one
// reads).  Where n <= 16 (32), the 64 rows hold four (two) chains
// stacked, one group of 16 (32) rows each, and the product's diagonal
// blocks are the chains' Grams (gram_mma_kernel's note).  Both operands are rows of G, k contiguous, so both are
// K-major in shared memory, in the 128-byte swizzled layout wgmma's
// descriptor names: 64 k of a row are one 128-byte line, 8 lines an atom
// of 1 KB, the 16-byte chunk c of line r stored at chunk c ^ (r % 8).
// wgmma (not mma.sync) because above n = 150 the route is bound by
// operations, and only wgmma reaches the dense bf16 rate.
//
// The loader.  A row of G starts at 2 d bytes past the last (159,020 at
// d = 79,510, 4 mod 16), so a TMA tensor map cannot describe G and a
// 16-byte copy into the swizzled layout does not fit every row; G is
// never repacked (a padded copy would cost more than the whole route),
// and narrower copies proved slow (4-byte cp.async held the loads alone
// to 0.93 ms at n = 1,000).  So a stage of a chunk of stage_k k moves in
// two steps.  (1) Copies: for each live row, the stage_k / 8 + 1 aligned
// 16-byte words that cover its values go by cp.async.cg into a raw stage
// (a ring of kRaw = 4, kAhead = 3 chunks in flight); a word wholly past
// the slice's end is zero-filled, not read; the row addresses come from a
// table in shared memory, the word index by a multiplication.  (2)
// Realign: each thread reads two raw words, shifts them by the row's
// offset (its address mod 16: a word shift by selects, a half-word shift
// by a funnel shift), zeroes the values past the slice's end, and stores
// the 16 bytes into one of two swizzled stages.  A warp's accesses cover
// whole 128-byte lines, so neither step meets a bank conflict.
// Only the block's live rows are copied (rows past n are neither read
// nor zeroed): a swizzled stage is [stage_k / 64 lines][P rows][128 B], P
// the live rows of the tile's two operands, each padded to 8 (on a
// diagonal tile the operands are the same rows, loaded once).  A
// descriptor of 64 rows, or of N columns, may so reach past the live rows
// into the next line, the raw ring or a tail of 16 KB past it: those rows
// feed only outputs past n, which no one reads.  The plan takes the
// largest stage_k that fits 227 KB (n = 100: 128 k a stage; n = 1,000:
// 64; with stacked chains one chain a group, 1,024 k at n = 10), so three
// raw stages of 60 to 110 KB are in flight.
//
// Summation order.  Each chain of 256 k is 16 wgmma k16 steps, the first
// with scale-d 0 (from zero); the tensor core rounds each step's sum to
// f32.  Every output element gets the same fixed arithmetic on its
// operand pairs, whatever its position in the tile or the instruction's
// N.  The chain's sum is added in order to the slice's partial in
// registers (the first chain stored), and the epilogue sums the S
// partials in its fixed order (ops/distances.py:MmaPlan.rounding_chain
// counts the roundings).  Values past the slice's end are zeros and add
// nothing.  The row norms are the summed Gram diagonal, made by the same
// instructions as the off-diagonal outputs, so two bit-identical rows i,
// j give acc[i][j] == acc[i][i] == acc[j][j] and their distance is
// exactly 0 (ALIE's crafted rows).  No float atomics: two launches give
// the same bits.
//
// The pipeline, per chunk c: wait for raw chunk c (cp.async.wait_group)
// and __syncthreads; issue chunk c + 3's copies into the raw stage chunk
// c - 1 used; realign chunk c into the swizzled stage chunk c - 2 used;
// fence.proxy.async (the tensor cores read through the async proxy) and
// __syncthreads; wait for the warpgroup's group of chunk c - 1 (it ran on
// under these copies and this realign) and add the chains it finished;
// issue chunk c's group.  Where a stage holds whole chains (n <= 64), its
// chains are stacked (n <= 32) or two run interleaved step by step in
// independent accumulators (a single chain leaves the tensor cores
// waiting on each step's latency); where a chain spans stages (n > 64),
// the open chain accumulates across groups.  Every branch around the wgmmas is
// block-uniform and their loops are unrolled, nothing predicated, and the
// accumulators are fenced only after a full wait: ptxas otherwise
// serializes the wgmmas or inserts waits of its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_tile.cuh"

namespace fl {
namespace mma {

constexpr int kChainK = 256;          // k per chain: 16 k16 steps
constexpr int kStepK = 16;            // k per wgmma
constexpr int kLineK = 64;            // k per 128-byte swizzled line
constexpr int kLineBytes = 128;
constexpr int kRaw = 4;               // raw stages of the copies' ring
constexpr int kAhead = 3;             // chunks of copies in flight
constexpr int kTableBytes = 2 * kT * 8;       // row addresses, in the tail
constexpr int kXchBytes = 4096;               // stacked chains' exchange
constexpr int kMinStageK = 64;
constexpr int kMaxStageK = 4 * kChainK;  // four stacked chains
constexpr int kTailBytes = kT * kLineBytes;   // a descriptor's reach
constexpr int kAlign = 1024;                  // a swizzle atom
constexpr int kMaxSmem = 232448;              // a block's limit (227 KB)
static_assert(kTableBytes + kXchBytes <= kTailBytes, "the tail holds both");

__host__ __device__ constexpr int pad8(int r) { return (r + 7) & ~7; }

// Chains stacked in one instruction's 64 rows where n is small: 4 groups
// of 16 rows (n <= 16), 2 of 32 (n <= 32), else 1.
__host__ __device__ constexpr int mma_groups(int n) {
    return n <= 16 ? 4 : n <= 32 ? 2 : 1;
}

// The instruction's columns: 64 with one warpgroup (n <= 64), else 128.
inline int mma_cols(int n) { return n <= 64 ? 64 : 128; }

// The busiest block's live rows (both operands) and swizzled stage rows
// (each operand's padded to 8, or the 64 rows of stacked chains);
// ops/distances.py:mma_plan mirrors them.
inline int ring_live(int n) {
    const int nt = (n + kT - 1) / kT;
    return nt <= 2 ? n : 2 * kT;
}

inline int ring_rows(int n) {
    const int nt = (n + kT - 1) / kT;
    if (mma_groups(n) > 1) return 64;
    if (nt == 1) return pad8(n);
    if (nt == 2) return kT + pad8(n - kT);
    return 2 * kT;
}

// A block's shared memory: two swizzled stages the tensor cores read,
// the ring of kRaw raw stages the copies fill, then the tail (which
// holds the row-address table and the stacked chains' exchange).
inline size_t ring_smem(int n, int stage_k) {
    return 2 * (size_t)ring_rows(n) * (stage_k / mma_groups(n)) * 2
           + (size_t)kRaw * ring_live(n) * (stage_k / 8 + 1) * 16
           + kTailBytes + kAlign;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A K-major operand of 8-row groups 1 KB apart, 128-byte swizzle,
// starting at shared address `addr` (its atom 1 KB aligned; a k16 step
// inside a line adds 32 bytes).  Bits: start >> 4 [0, 14), leading
// offset [16, 30) (unused by a swizzled K-major operand), stride offset
// >> 4 [32, 46), layout [62, 64) = 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3ffff) >> 4) | (uint64_t)1 << 16
           | (uint64_t)(kAlign >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulators are written by the async wgmmas: keep the compiler
// from moving their reads across the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = A B^T (+ d where scale_d), A and B named by their descriptors:
// wgmma.m64nNk16, bf16 operands, f32 accumulators, both K-major.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int scale_d) {
    if constexpr (N == 64) wgmma_m64n64(d, a, b, scale_d);
    else wgmma_m64n128(d, a, b, scale_d);
}

// 16 bytes from global src (16-byte aligned) to shared address dst, or
// zeros where !valid.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(addr));
    return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t e) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(a), "r"(b), "r"(c), "r"(e));
}

// The 16 bytes at byte offset o (even, 0..14) of the 32 bytes w0:w1,
// little-endian: the word shift by selects (no indexed registers), the
// half-word shift by a funnel shift.
__device__ __forceinline__ void realign(uint4 w0, uint4 w1, int o,
                                        uint32_t (&out)[4]) {
    const uint32_t x[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    uint32_t t[7], y[5];
#pragma unroll
    for (int i = 0; i < 7; ++i) t[i] = (o & 4) ? x[i + 1] : x[i];
#pragma unroll
    for (int i = 0; i < 5; ++i) y[i] = (o & 8) ? t[i + 2] : t[i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        out[i] = __funnelshift_r(y[i], y[i + 1], (o & 3) * 8);
}

// The shared address of step j (16 k) of a swizzled stage.
__device__ __forceinline__ uint32_t step_line(uint32_t st, int j,
                                              uint32_t line_bytes) {
    return st + (j / (kLineK / kStepK)) * line_bytes
           + (j % (kLineK / kStepK)) * 32;
}

// The S steps of a stage into the open chain (from zero where `fresh`).
// Issues and commits one group; nothing is predicated, so ptxas keeps
// the wgmmas asynchronous.
template <int N, int S>
__device__ __forceinline__ void mma_steps(float (&acc)[N / 2], uint32_t st,
                                          uint32_t line_bytes,
                                          uint32_t a_off, uint32_t b_off,
                                          bool fresh) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < S; ++j) {
        const uint32_t line = step_line(st, j, line_bytes);
        wgmma<N>(acc, desc(line + a_off), desc(line + b_off),
                 j != 0 || !fresh);
    }
    wgmma_commit();
}

// A raw row: the stage_k / 8 + 1 aligned 16-byte words that cover a
// row's stage_k values.
__host__ __device__ constexpr uint32_t raw_row_bytes(int stage_k) {
    return (uint32_t)(stage_k / 8 + 1) * 16;
}

// Stage 1 for one block of WGS * 128 threads.  stage_k: KS * 256 where
// KS > 1, else a power of two in [64, 256].
//
// KS > 1 (n <= 32, one tile): the stage's KS chains are stacked as KS
// groups of 64 / KS rows of one m64n64 instruction, each group's rows the
// block's rows over its chain's k; the diagonal blocks of the 64 x 64
// product are the chains' Grams (the rest mixes chains and is not read).
// Group g's block sits in the registers [32 g / KS, 32 (g + 1) / KS) of
// the warps 4 g / KS to 4 (g + 1) / KS - 1, at the same place in each, so
// the chains are added in chain order through shared memory by group 0's
// warps.  One instruction reads a 64-row operand pair of four chains
// where an m64n16 would read 64 rows, 54 of them dead, for one.
//
// The body is shared with the split route's kernel (gram_split.cuh,
// SPLIT true): there block = tile * S + s, slice s is split_slice's run
// of chains of chain_steps k16 steps (a whole number of stages; 256 k
// where chains are stacked; cps unused), and the partial goes to a
// [128][128] f32 tile at the start of the block's shared memory, which
// the ring no longer needs, instead of ws.  Returns that tile (nullptr
// on the fused route).
template <int WGS, int N, int KS, bool SPLIT>
__device__ __forceinline__ float* mma_tile_partial(
        const uint16_t* __restrict__ G, int n, long long d, int nt, int cps,
        int stage_k, float* __restrict__ ws, int S, int chain_steps) {
    constexpr int kThreadsM = WGS * 128;
    constexpr int kRegs = N / 2;
    constexpr int kR = 64 / KS;                  // rows of a chain group
    constexpr int kGroupWarps = kR / 16;
    constexpr int kBlockRegs = KS > 1 ? kR / 2 : kRegs;  // a warp's outputs
    constexpr int kChainSteps = kChainK / kStepK;
    static_assert(WGS == 1 || N == kT, "two warpgroups take 128 columns");
    static_assert(KS == 1 || (WGS == 1 && N == 64), "stacked chains: m64n64");
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_addr(smem_raw) + kAlign - 1) & ~(kAlign - 1);

    const int tiles = nt * (nt + 1) / 2;
    const int tile = SPLIT ? blockIdx.x / S : blockIdx.x % tiles;
    const int s = SPLIT ? blockIdx.x % S : blockIdx.x / tiles;
    int ti, tj;
    tile_coords(tile, nt, ti, tj);
    const bool diag = ti == tj;
    const int row0 = ti * kT, col0 = tj * kT;
    const int ra = min(kT, n - row0);              // live rows of A
    const int rb = diag ? 0 : min(kT, n - col0);   // of B (A's on diag)
    const int live = ra + rb;
    const int pa = pad8(ra);
    const uint32_t line_bytes =                      // 64 k of every row
        (KS > 1 ? 64 : pa + pad8(rb)) * kLineBytes;
    const uint32_t swz = line_bytes * (stage_k / KS / kLineK);
    const uint32_t raw_row = raw_row_bytes(stage_k);
    const uint32_t raw0 = base + 2 * swz;
    const uint32_t raw_stage = live * raw_row;
    const int qrow = stage_k / 8;                  // 16-byte chunks a row
    const int lgq = __ffs(qrow) - 1;
    const int lgg = lgq - (KS == 4 ? 2 : KS == 2 ? 1 : 0);  // a group's
    long long k0, k1;
    if constexpr (SPLIT) {
        split_slice(d, chain_steps * kStepK, S, s, k0, k1);
    } else {
        k0 = (long long)s * cps * kChainK;
        const long long kend = k0 + (long long)cps * kChainK;
        k1 = kend < d ? kend : d;
    }
    const int nchunks = (int)((k1 - k0 + stage_k - 1) / stage_k);
    const unsigned long long gbase = reinterpret_cast<unsigned long long>(G);

    const int tid = threadIdx.x;
    const int wg = tid / 128;

    // The address of each live row of the stage (A's rows, then B's) in
    // G, in a table in the tail (which only reads past the stages).
    unsigned long long* rows_at = reinterpret_cast<unsigned long long*>(
        smem_raw + (raw0 + kRaw * raw_stage - smem_addr(smem_raw)));
    float* xch = reinterpret_cast<float*>(rows_at) + kTableBytes / 4;
    for (int r = tid; r < live; r += kThreadsM)
        rows_at[r] = gbase
                     + 2ull * (r < ra ? row0 + r : col0 + (r - ra)) * d;
    __syncthreads();
    // Copies of chunk c into raw stage st: for each live row, the qrow + 1
    // aligned 16-byte words that cover its stage_k values (a word wholly
    // past the slice's end is zero-filled, never read).  Copy e is word
    // e % (qrow + 1) of row e / (qrow + 1), the quotient by a
    // multiplication (exact for e < 2^32 / (qrow + 1)).
    const uint32_t wpr = qrow + 1;
    const uint32_t magic = 0xffffffffu / wpr + 1;
    auto load_chunk = [&](int c, int st) {
        const unsigned long long kc2 = 2ull * (k0 + (long long)c * stage_k);
        const unsigned long long k12 = 2ull * k1;
        const uint32_t dst0 = raw0 + st * raw_stage;
        for (uint32_t e = tid; e < live * wpr; e += kThreadsM) {
            const uint32_t r = __umulhi(e, magic);
            const uint32_t w = e - r * wpr;
            const unsigned long long row = rows_at[r];
            const unsigned long long src = ((row + kc2) & ~15ull) + 16 * w;
            copy16(dst0 + r * raw_row + 16 * w,
                   reinterpret_cast<const void*>(src), src < row + k12);
        }
    };
    // Raw stage st of chunk c into swizzled stage dst: each 16-byte chunk
    // q of a live row, realigned by the row's offset; in the slice's last
    // chunk the values past its end are zeroed.  A warp's lanes take
    // consecutive q, so its reads and writes cover whole 128-byte lines.
    auto realign_chunk = [&](int c, int st, uint32_t dst) {
        const long long kc = k0 + (long long)c * stage_k;
        const bool tail = kc + stage_k > k1;             // block-uniform
        const uint32_t src0 = raw0 + st * raw_stage;
        for (int e = tid; e < (live << lgq); e += kThreadsM) {
            const int r = e >> lgq;
            const int q = e & (qrow - 1);
            const int grp = q >> lgg;              // its chain group
            const int ql = q - (grp << lgg);       // chunk in the group
            const int srow = KS > 1 ? kR * grp + r
                                    : r < ra ? r : pa + (r - ra);
            const int o = (int)(rows_at[r] & 15);
            const uint32_t src = src0 + r * raw_row + 16 * q;
            uint32_t v[4];
            realign(lds128(src), lds128(src + 16), o, v);
            if (tail) {
                const long long kq = kc + 8 * q;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (kq + 2 * i >= k1) v[i] &= 0xffff0000u;
                    if (kq + 2 * i + 1 >= k1) v[i] &= 0x0000ffffu;
                }
            }
            sts128(dst + (ql >> 3) * line_bytes + srow * kLineBytes
                       + (((ql & 7) ^ (srow & 7)) << 4),
                   v[0], v[1], v[2], v[3]);
        }
    };

    float acc[kRegs], part[kRegs];
#pragma unroll
    for (int i = 0; i < kRegs; ++i) acc[i] = part[i] = 0.f;
    bool first = true;
    auto add_chain = [&](float (&a)[kRegs]) {
#pragma unroll
        for (int i = 0; i < kRegs; ++i)
            part[i] = first ? a[i] : part[i] + a[i];
        first = false;
    };
    const uint32_t a_off = wg * 64 * kLineBytes;
    const uint32_t b_off = diag ? 0 : pa * kLineBytes;

#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
        if (c < nchunks) load_chunk(c, c);
        cp_async_commit();
    }
    int t = 0;       // steps of the open chain (KS == 1)
    int pend = 0;    // chains of the group in flight still to be added
    // The group in flight is waited for just before the next one is
    // issued, so that it runs on under the next chunk's copies and
    // realign; then its finished chains are added, in chain order.
    const int warp = tid >> 5, lane = tid & 31;
    auto settle = [&]() {
        wgmma_wait<0>();
        fence_regs(acc);
        if constexpr (KS > 1) {
            if (pend > 0) {                      // block-uniform
                // Groups 1 .. KS - 1 hand their blocks to group 0's warps.
                const int g = warp / kGroupWarps;
                float* x = xch + ((warp - kGroupWarps) * 32 + lane)
                                     * kBlockRegs;
                if (g > 0) {
#pragma unroll
                    for (int j = 0; j < kBlockRegs; ++j) {
                        float v = acc[j];
#pragma unroll
                        for (int gg = 1; gg < KS; ++gg)
                            if (g == gg) v = acc[gg * kBlockRegs + j];
                        x[j] = v;
                    }
                }
                __syncthreads();
                if (g == 0) {
                    add_chain(acc);
                    for (int gg = 1; gg < pend; ++gg) {
                        const float* y =
                            xch + (((gg - 1) * kGroupWarps + warp) * 32
                                   + lane) * kBlockRegs;
#pragma unroll
                        for (int j = 0; j < kBlockRegs; ++j)
                            part[j] += y[j];
                    }
                }
            }
        } else if (pend > 0) {
            add_chain(acc);
        }
        pend = 0;
    };
    // Every branch around the wgmmas is block-uniform, so that they are
    // never on a divergent path (ptxas would serialize them).
    for (int c = 0; c < nchunks; ++c) {
        cp_async_wait<kAhead - 1>();
        __syncthreads();    // raw chunk c landed; raw chunk c - 1 read;
                            // each warpgroup has at most chunk c - 1's
                            // group in flight
        if (c + kAhead < nchunks) load_chunk(c + kAhead, (c + kAhead) % kRaw);
        cp_async_commit();
        const uint32_t st = base + (c & 1) * swz;   // chunk c - 2's is done
        realign_chunk(c, c % kRaw, st);
        fence_proxy_async();
        __syncthreads();    // swizzled chunk c complete
        settle();
        // Every stage runs all its steps: the values past the slice's
        // end are zeros, which add nothing.
        if constexpr (KS > 1) {
            // The stage's KS chains stacked in one instruction; those past
            // the slice's end are zeros, not added.
            const long long kc = k0 + (long long)c * stage_k;
            const long long kc1 = kc + stage_k < k1 ? kc + stage_k : k1;
            mma_steps<N, kChainSteps>(acc, st, line_bytes, 0, 0, true);
            pend = (int)((kc1 - kc + kChainK - 1) / kChainK);
        } else {
            // A stage of 64, 128 or 256 k: its steps into the open chain.
            if (stage_k == kChainK)
                mma_steps<N, 16>(acc, st, line_bytes, a_off, b_off, t == 0);
            else if (stage_k == 2 * kLineK)
                mma_steps<N, 8>(acc, st, line_bytes, a_off, b_off, t == 0);
            else
                mma_steps<N, 4>(acc, st, line_bytes, a_off, b_off, t == 0);
            t += stage_k / kStepK;
            if (t == (SPLIT ? chain_steps : kChainSteps) || c + 1 == nchunks) {
                pend = 1;
                t = 0;
            }
        }
    }
    settle();
    cp_async_wait<0>();
    float* staged_tile = nullptr;
    if constexpr (SPLIT) {
        // Every warpgroup has waited for its last group and every copy has
        // landed: the ring is free for the partial tile.
        __syncthreads();
        fence_proxy_async();
        staged_tile = reinterpret_cast<float*>(
            smem_raw + (base - smem_addr(smem_raw)));
    }

    // Register i of thread (warp w, lane l) of the warpgroup holds row
    // 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2
    // of its 64 x N outputs; with stacked chains, group 0's warps hold the
    // partial in their first kBlockRegs registers.
    if (KS > 1 && warp >= kGroupWarps) return staged_tile;
    float* out = SPLIT ? staged_tile
                       : ws + ((long long)s * tiles + tile) * (kT * kT);
    float* dg = ws + (long long)gridDim.x * (kT * kT)
                + (long long)s * nt * kT + row0;
    const int rbase = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int cbase = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < kBlockRegs; i += 2) {
        const int row = rbase + 8 * ((i >> 1) & 1);
        const int col = cbase + 8 * (i >> 2);
        if (row < ra) {
            *reinterpret_cast<float2*>(out + row * kT + col) =
                make_float2(part[i], part[i + 1]);
            if (!SPLIT && diag && row == col) dg[row] = part[i];
            if (!SPLIT && diag && row == col + 1) dg[row] = part[i + 1];
        }
    }
    return staged_tile;
}

// Stage 1 of the fused bf16 route (mma_tile_partial's note): grid tiles *
// S blocks, block = s * tiles + tile; ws: (S, tiles, 128, 128) f32, then
// dg: (S, nt * 128); only the rows inside n of each warpgroup's outputs
// are written.  Dynamic shared memory: ring_smem(n, stage_k).
template <int WGS, int N, int KS>
__global__ void __launch_bounds__(WGS * 128, 1)
gram_mma_kernel(const uint16_t* __restrict__ G, int n, long long d, int nt,
                int cps, int stage_k, float* __restrict__ ws) {
    mma_tile_partial<WGS, N, KS, false>(G, n, d, nt, cps, stage_k, ws, 0,
                                        0);
}

// stage_k one chain a group where chains are stacked, else a power of two
// in [64, 256], its stages fitting a block's shared memory.
inline bool stage_ok(int n, int stage_k) {
    if (stage_k < kMinStageK || stage_k > kMaxStageK
        || (stage_k & (stage_k - 1)))
        return false;
    if (mma_groups(n) > 1 ? stage_k != mma_groups(n) * kChainK
                           : stage_k > kChainK)
        return false;
    return ring_smem(n, stage_k) <= (size_t)kMaxSmem;
}

// Checks a plan from the wrapper: S slices of cps chains cover [0, d),
// the last one not empty; stage_k as stage_ok allows.
inline bool mma_plan_ok(int n, long long d, int S, int cps, int stage_k) {
    if (n <= 0 || d <= 0 || S <= 0 || cps <= 0) return false;
    if (!stage_ok(n, stage_k)) return false;
    const long long per = (long long)cps * kChainK;
    return (long long)S * per >= d && (long long)(S - 1) * per < d;
}

template <int WGS, int N, int KS>
cudaError_t launch_mma(const uint16_t* G, int n, long long d, int nt, int S,
                       int cps, int stage_k, float* ws,
                       cudaStream_t stream) {
    const int smem = (int)ring_smem(n, stage_k);
    const cudaError_t err = cudaFuncSetAttribute(
        gram_mma_kernel<WGS, N, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int tiles = nt * (nt + 1) / 2;
    gram_mma_kernel<WGS, N, KS><<<tiles * S, WGS * 128, smem, stream>>>(
        G, n, d, nt, cps, stage_k, ws);
    return cudaGetLastError();
}

}  // namespace mma

// Stage 1 of the bf16 route on `stream`: the Gram partials on the tensor
// cores into ws, in gram_tile.cuh's layout.  Returns the launch error.
inline cudaError_t gram_partials_bf16(const uint16_t* G, int n, long long d,
                                      int S, int cps, int stage_k,
                                      float* ws, cudaStream_t stream) {
    const int nt = (n + kT - 1) / kT;
    const int groups = mma::mma_groups(n);
    return groups == 4   ? mma::launch_mma<1, 64, 4>(G, n, d, nt, S, cps,
                                                     stage_k, ws, stream)
           : groups == 2 ? mma::launch_mma<1, 64, 2>(G, n, d, nt, S, cps,
                                                     stage_k, ws, stream)
           : mma::mma_cols(n) == 64
               ? mma::launch_mma<1, 64, 1>(G, n, d, nt, S, cps, stage_k,
                                           ws, stream)
               : mma::launch_mma<2, 128, 1>(G, n, d, nt, S, cps, stage_k,
                                            ws, stream);
}

// Both stages of the bf16 route on `stream`: the Gram partials on the
// tensor cores into ws, then gram_tile.cuh's epilogue into D.  Returns
// the first launch error.
inline cudaError_t gram_distances_bf16(const uint16_t* G, int n, long long d,
                                       int S, int cps, int stage_k,
                                       float* ws, float* D,
                                       cudaStream_t stream) {
    const cudaError_t err =
        gram_partials_bf16(G, n, d, S, cps, stage_k, ws, stream);
    if (err != cudaSuccess) return err;
    return gram_epilogue(ws, n, S, D, stream);
}

}  // namespace fl
