// Incremental exact Bulyan selection (native host runtime kernel), the
// port's copy of the JAX package's native/bulyan_select.cpp: the code is
// the same, the comments name the port's files.
//
// The reference's Bulyan (reference defences.py:55-70) runs set_size
// strictly sequential Krum selections over a shrinking pool.  Evaluated
// naively that is O(n^2) scoring per selection -> O(n^3) total; the
// presort-once NumPy path (defenses/host.py:_prefix_scores) keeps the
// per-selection cost at O(n^2), still ~multi-hour at the n=10,240 north
// star.  This kernel maintains every row's score *incrementally*:
//
//   score_i = sum of the finite values among the first min(k, a) alive
//             columns of row i's presorted distance row
//             (k = users_count - selected - f [- 2 under paper scoring],
//              a = number of alive columns)
//
// which is exactly defenses/host.py:_prefix_scores.  Per row we keep
//   - a doubly-linked list over the row's rank positions holding the
//     alive columns (unlink = O(1) via the inverse permutation),
//   - the inclusive rank `bnd` of the prefix's last alive element,
//   - the alive count `cnt` and the f64 prefix sum.
// A selection step then costs O(1) amortized per row (membership test +
// at most a few link hops), so the whole exact q=1 selection is
// O(n * set_size) after the O(n^2) init — seconds, not hours, at 10k.
//
// Semantics notes (all matching defenses/host.py; both are held against
// the JAX package's in tests/test_torch_port_host_engines.py):
//   - non-finite values (the +inf self-distance diagonal, adversarial
//     overflow rows) occupy prefix slots but contribute 0 to the sum;
//   - ties in the per-trip selection resolve to the lowest client index
//     (comparator on (score, index) == stable argsort);
//   - batch_select q > 1 selects q lowest against the SAME scores and
//     rescores between trips; q=1 is the reference semantics;
//   - scores accumulate in f64 (f32 values are exact in f64, so there
//     is no incremental drift) but COMPARE at f32 resolution: the NumPy
//     path's scores are f32 pairwise sums, so rows whose true sums
//     differ below f32 eps usually land on the same f32 value there and
//     tie-break by index — quantizing the comparator reproduces that
//     tie-break instead of resolving gaps the f32 computation cannot
//     see.  The precise contract: the two paths agree whenever score
//     gaps exceed the f32 summation's rounding error (a few ulps,
//     ~log2(n) worst case); within that noise band either pick is
//     inside the reference's own numerical indeterminacy (its torch
//     f32 sums have the same-order error with yet another ordering).
//     The JAX package measured 3/1000 adversarial 1e6-magnitude trials
//     diverging at set level, every one a <=1-ulp f32 tie at its first
//     diverging trip (its tests/test_native.py sweep).
//
// Built with g++ at first use by ops/_build.py:build_host_library and
// loaded by native/__init__.py.
//
// Error contract: every kernel returns nonzero on ANY failure — including
// std::bad_alloc from the O(n^2) scratch (~16 bytes/entry, ~1.7 GB at
// n=10,240).  An exception escaping the extern "C" boundary into the
// ctypes frame would std::terminate the whole process; catching it lets
// the loader raise the failure as a Python error.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

// Shared column-blocked machinery for the coordinate-wise kernels: the
// (n, d) matrix is row-major, so per-coordinate work would stride the
// whole matrix; instead gather BLOCK columns at a time into an
// L2-resident column-major buffer and run O(n) selection per column.
static const int32_t kColBlock = 128;

static void gather_block(const float* sel, int32_t n, int32_t d,
                         int32_t c0, int32_t bw, float* buf) {
    for (int64_t i = 0; i < n; ++i) {
        const float* row = sel + i * static_cast<int64_t>(d) + c0;
        for (int32_t c = 0; c < bw; ++c)
            buf[static_cast<size_t>(c) * n + i] = row[c];
    }
}

// NumPy median semantics: mid element (odd n) / f32 mean of the two
// middles (even n).  Clobbers tmp.
static float column_median(const float* col, int32_t n,
                           std::vector<float>& tmp) {
    std::copy(col, col + n, tmp.begin());
    const int32_t h = n / 2;
    std::nth_element(tmp.begin(), tmp.begin() + h, tmp.end());
    float med = tmp[h];
    if ((n & 1) == 0) {
        const float lo = *std::max_element(tmp.begin(), tmp.begin() + h);
        med = (lo + med) / 2.0f;
    }
    return med;
}

// Median-anchored trimmed mean (reference defences.py:48-51), evaluated
// column-blocked so the per-coordinate work runs on L2-resident data —
// the NumPy axis-0 formulation pays strided access over the whole
// (n, d) matrix for median, partition, and masks (~105 s at the
// (5326, 79510) exact-Bulyan tail; this kernel is ~2 passes + O(n) per
// coordinate).  Semantics match defenses/host.py:host_trimmed_mean_of:
//   - median = NumPy semantics (mean of the two middles for even n);
//   - keep the k smallest |dev| with boundary ties resolved to the
//     LOWEST row index (Python's stable sorted());
//   - mean of kept deviations + median, accumulated in f64.
static int trimmed_mean_impl(
    const float* sel,  // (n, d) row-major
    int32_t n, int32_t d, int32_t k,
    float* out         // (d,)
) {
    if (n <= 0 || d <= 0 || k <= 0 || k > n) return 1;
    std::vector<float> buf(static_cast<size_t>(n) * kColBlock);
    std::vector<float> tmp(n), adev(n);
    for (int32_t c0 = 0; c0 < d; c0 += kColBlock) {
        const int32_t bw = std::min(kColBlock, d - c0);
        gather_block(sel, n, d, c0, bw, buf.data());
        for (int32_t c = 0; c < bw; ++c) {
            const float* col = buf.data() + static_cast<size_t>(c) * n;
            const float med = column_median(col, n, tmp);
            for (int32_t i = 0; i < n; ++i)
                adev[i] = std::fabs(col[i] - med);
            std::copy(adev.begin(), adev.end(), tmp.begin());
            std::nth_element(tmp.begin(), tmp.begin() + (k - 1),
                             tmp.end());
            const float kth = tmp[k - 1];
            int32_t strict = 0;
            double sum = 0.0;
            for (int32_t i = 0; i < n; ++i)
                if (adev[i] < kth) {
                    ++strict;
                    sum += static_cast<double>(col[i] - med);
                }
            int32_t need = k - strict;  // boundary ties, lowest rows
            for (int32_t i = 0; i < n && need > 0; ++i)
                if (adev[i] == kth) {
                    sum += static_cast<double>(col[i] - med);
                    --need;
                }
            out[c0 + c] = static_cast<float>(
                sum / static_cast<double>(k) +
                static_cast<double>(med));
        }
    }
    return 0;
}

// Coordinate-wise median (defenses/median.py host path).
static int median_impl(
    const float* sel,  // (n, d) row-major
    int32_t n, int32_t d,
    float* out         // (d,)
) {
    if (n <= 0 || d <= 0) return 1;
    std::vector<float> buf(static_cast<size_t>(n) * kColBlock);
    std::vector<float> tmp(n);
    for (int32_t c0 = 0; c0 < d; c0 += kColBlock) {
        const int32_t bw = std::min(kColBlock, d - c0);
        gather_block(sel, n, d, c0, bw, buf.data());
        for (int32_t c = 0; c < bw; ++c)
            out[c0 + c] = column_median(
                buf.data() + static_cast<size_t>(c) * n, n, tmp);
    }
    return 0;
}

static int bulyan_select_impl(
    const float* D,        // (n, n) row-major distances, +inf diagonal
    const int32_t* order,  // (n, n) per-row argsort (ascending) of D
    int32_t n,
    int32_t users_count,
    int32_t f,
    int32_t set_size,
    int32_t q,
    int32_t paper_scoring,
    int32_t* out_selected  // (set_size,)
) {
    if (n <= 0 || set_size <= 0 || set_size > n || q < 1 || f < 0)
        return 1;
    const int64_t nn = static_cast<int64_t>(n) * n;

    // Row-major scratch.  sd = presorted values (gathered once so the
    // hot loops read contiguously); pos = inverse permutation; nxt/prv =
    // alive linked list over rank positions; head = first alive rank.
    std::vector<float> sd(nn);
    std::vector<int32_t> pos(nn), nxt(nn), prv(nn), head(n, 0);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t base = i * n;
        const float* drow = D + base;
        const int32_t* ord = order + base;
        for (int32_t r = 0; r < n; ++r) {
            const int32_t c = ord[r];
            if (c < 0 || c >= n) return 1;
            sd[base + r] = drow[c];
            pos[base + c] = r;
            nxt[base + r] = r + 1;
            prv[base + r] = r - 1;
        }
    }

    std::vector<double> sum(n, 0.0);
    std::vector<int32_t> bnd(n, -1), cnt(n, 0);
    std::vector<uint8_t> alive_row(n, 1);

    int32_t s = 0;  // selected so far
    int32_t a = n;  // alive columns (columns == clients, same per row)
    const int32_t extra = paper_scoring ? 2 : 0;
    auto desired = [&]() -> int32_t {
        int64_t k = static_cast<int64_t>(users_count) - s - f - extra;
        if (k < 0) k = 0;
        if (k > a) k = a;
        return static_cast<int32_t>(k);
    };

    // Initial prefixes: all columns alive, ranks 0..d0-1.
    const int32_t d0 = desired();
    for (int64_t i = 0; i < n; ++i) {
        const int64_t base = i * n;
        double sm = 0.0;
        for (int32_t r = 0; r < d0; ++r) {
            const float v = sd[base + r];
            if (std::isfinite(v)) sm += static_cast<double>(v);
        }
        sum[i] = sm;
        cnt[i] = d0;
        bnd[i] = d0 - 1;
    }

    std::vector<int32_t> cand(n);
    std::vector<int32_t> pick;
    pick.reserve(q);

    while (s < set_size) {
        const int32_t r = std::min(q, set_size - s);
        int32_t m = 0;
        for (int32_t i = 0; i < n; ++i)
            if (alive_row[i]) cand[m++] = i;
        if (m < r) return 2;
        const auto cmp = [&](int32_t x, int32_t y) {
            const float sx = static_cast<float>(sum[x]);
            const float sy = static_cast<float>(sum[y]);
            if (sx != sy) return sx < sy;
            return x < y;
        };
        if (r < m)
            std::nth_element(cand.begin(), cand.begin() + (r - 1),
                             cand.begin() + m, cmp);
        std::sort(cand.begin(), cand.begin() + r, cmp);
        pick.assign(cand.begin(), cand.begin() + r);
        for (const int32_t j : pick) {
            out_selected[s++] = j;
            alive_row[j] = 0;
        }
        a -= r;
        const int32_t d = desired();  // next trip's k, post-trip pool

        // Row-major update: unlink this trip's deaths from each row's
        // list, then re-balance the prefix to the new desired size.
        for (int64_t i = 0; i < n; ++i) {
            const int64_t base = i * n;
            int32_t b = bnd[i], c = cnt[i];
            double sm = sum[i];
            for (const int32_t j : pick) {
                const int32_t p = pos[base + j];
                if (p <= b) {  // inside the prefix (p was alive)
                    const float v = sd[base + p];
                    if (std::isfinite(v)) sm -= static_cast<double>(v);
                    --c;
                    if (p == b) b = prv[base + p];
                }
                const int32_t pn = nxt[base + p];
                const int32_t pp = prv[base + p];
                if (pp >= 0) nxt[base + pp] = pn; else head[i] = pn;
                if (pn < n) prv[base + pn] = pp;
            }
            while (c > d) {  // k shrank: drop the prefix's last alive
                const float v = sd[base + b];
                if (std::isfinite(v)) sm -= static_cast<double>(v);
                --c;
                b = prv[base + b];
            }
            while (c < d) {  // deaths inside the prefix: extend it
                const int32_t nb = (b < 0) ? head[i] : nxt[base + b];
                if (nb >= n) break;  // fewer than d alive columns left
                const float v = sd[base + nb];
                if (std::isfinite(v)) sm += static_cast<double>(v);
                ++c;
                b = nb;
            }
            bnd[i] = b;
            cnt[i] = c;
            sum[i] = sm;
        }
    }
    return 0;
}

// extern "C" surface (see error contract at the top of the file).
extern "C" int fl_trimmed_mean(const float* sel, int32_t n, int32_t d,
                               int32_t k, float* out) {
    try {
        return trimmed_mean_impl(sel, n, d, k, out);
    } catch (...) {
        return 1;
    }
}

extern "C" int fl_median(const float* sel, int32_t n, int32_t d,
                         float* out) {
    try {
        return median_impl(sel, n, d, out);
    } catch (...) {
        return 1;
    }
}

extern "C" int fl_bulyan_select(const float* D, const int32_t* order,
                                int32_t n, int32_t users_count, int32_t f,
                                int32_t set_size, int32_t q,
                                int32_t paper_scoring,
                                int32_t* out_selected) {
    try {
        return bulyan_select_impl(D, order, n, users_count, f, set_size,
                                  q, paper_scoring, out_selected);
    } catch (...) {
        return 1;
    }
}
