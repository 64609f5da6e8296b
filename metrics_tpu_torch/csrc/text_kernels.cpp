// Host text kernels: Levenshtein edit distance (one pair, a batch, the full
// table), LCS length and the Extended Edit Distance sentence score.
//
// A copy of `metrics_tpu/native/text_kernels.cpp`, built by the port's own
// loader (`metrics_tpu_torch/ops/text_native.py`) with the host g++ into
// build/metrics_tpu_torch/. The text metrics intern their tokens to int32 ids
// in Python and run these O(m*n) dynamic programs here; this is host code, not
// a device kernel. Plain C interface for ctypes. The plain Python versions of
// the same programs stay in `metrics_tpu_torch/functional/text/` and the tests
// hold this library to them.
#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// Levenshtein distance between a[0:m] and b[0:n] (unit costs).
int32_t mt_levenshtein(const int32_t* a, int32_t m, const int32_t* b, int32_t n) {
    if (m == 0) return n;
    if (n == 0) return m;
    std::vector<int32_t> prev(n + 1), curr(n + 1);
    for (int32_t j = 0; j <= n; ++j) prev[j] = j;
    for (int32_t i = 1; i <= m; ++i) {
        curr[0] = i;
        const int32_t ai = a[i - 1];
        for (int32_t j = 1; j <= n; ++j) {
            const int32_t sub = prev[j - 1] + (ai != b[j - 1]);
            curr[j] = std::min(sub, std::min(prev[j] + 1, curr[j - 1] + 1));
        }
        std::swap(prev, curr);
    }
    return prev[n];
}

// Batched distances over k CSR-packed sequence pairs; offsets have k+1 entries.
void mt_levenshtein_batch(const int32_t* a_flat, const int64_t* a_off, const int32_t* b_flat,
                          const int64_t* b_off, int64_t k, int32_t* out) {
    for (int64_t i = 0; i < k; ++i) {
        out[i] = mt_levenshtein(a_flat + a_off[i], (int32_t)(a_off[i + 1] - a_off[i]),
                                b_flat + b_off[i], (int32_t)(b_off[i + 1] - b_off[i]));
    }
}

// Full (m+1) x (n+1) row-major DP table (TER's shift search needs the table).
void mt_levenshtein_matrix(const int32_t* a, int32_t m, const int32_t* b, int32_t n, int32_t* d) {
    const int64_t w = n + 1;
    for (int32_t j = 0; j <= n; ++j) d[j] = j;
    for (int32_t i = 1; i <= m; ++i) {
        int32_t* row = d + i * w;
        const int32_t* up = row - w;
        row[0] = i;
        const int32_t ai = a[i - 1];
        for (int32_t j = 1; j <= n; ++j) {
            const int32_t sub = up[j - 1] + (ai != b[j - 1]);
            row[j] = std::min(sub, std::min(up[j] + 1, row[j - 1] + 1));
        }
    }
}

// Longest-common-subsequence length (ROUGE-L).
int32_t mt_lcs(const int32_t* a, int32_t m, const int32_t* b, int32_t n) {
    if (m == 0 || n == 0) return 0;
    std::vector<int32_t> prev(n + 1, 0), curr(n + 1, 0);
    for (int32_t i = 1; i <= m; ++i) {
        const int32_t ai = a[i - 1];
        for (int32_t j = 1; j <= n; ++j) {
            curr[j] = (ai == b[j - 1]) ? prev[j - 1] + 1 : std::max(prev[j], curr[j - 1]);
        }
        std::swap(prev, curr);
    }
    return prev[n];
}

// Batched LCS over k CSR-packed pairs.
void mt_lcs_batch(const int32_t* a_flat, const int64_t* a_off, const int32_t* b_flat,
                  const int64_t* b_off, int64_t k, int32_t* out) {
    for (int64_t i = 0; i < k; ++i) {
        out[i] = mt_lcs(a_flat + a_off[i], (int32_t)(a_off[i + 1] - a_off[i]),
                        b_flat + b_off[i], (int32_t)(b_off[i + 1] - b_off[i]));
    }
}

// Extended Edit Distance (Stanchev et al. 2019) sentence score over character
// codepoints: the CDER alignment grid with a long-jump at blank positions
// (penalty `alpha`) and the `rho` coverage penalty. Double precision matches
// the python fallback's float semantics exactly (tie-breaks included: the
// first minimum's index takes the visit). `space_id` marks the jump anchor
// (codepoint 32 for the published en/ja preprocessing).
double mt_eed_score(const int32_t* hyp, int32_t m, const int32_t* ref, int32_t n,
                    int32_t space_id, double alpha, double rho, double deletion,
                    double insertion) {
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<int32_t> visits(m + 1, -1);
    std::vector<double> row(m + 1, 1.0), next(m + 1);
    row[0] = 0.0;
    for (int32_t w = 1; w <= n; ++w) {
        std::fill(next.begin(), next.end(), INF);
        next[0] = row[0] + 1.0;
        const int32_t ref_char = ref[w - 1];
        for (int32_t i = 1; i <= m; ++i) {
            const double sub = row[i - 1] + (hyp[i - 1] == ref_char ? 0.0 : 1.0);
            next[i] = std::min({next[i - 1] + deletion, sub, row[i] + insertion});
        }
        int32_t min_index = 0;
        for (int32_t i = 1; i <= m; ++i)
            if (next[i] < next[min_index]) min_index = i;
        visits[min_index] += 1;
        if (ref_char == space_id) {
            const double jump = alpha + next[min_index];
            for (int32_t i = 0; i <= m; ++i) next[i] = std::min(next[i], jump);
        }
        std::swap(row, next);
    }
    double coverage = 0.0;
    for (int32_t i = 0; i <= m; ++i) coverage += visits[i] >= 0 ? visits[i] : 1;
    coverage *= rho;
    const double score = (row[m] + coverage) / ((double)n + coverage);
    return score < 1.0 ? score : 1.0;
}

// Batched EED over k CSR-packed (hypothesis, reference) codepoint pairs.
void mt_eed_batch(const int32_t* h_flat, const int64_t* h_off, const int32_t* r_flat,
                  const int64_t* r_off, int64_t k, int32_t space_id, double alpha,
                  double rho, double deletion, double insertion, double* out) {
    for (int64_t i = 0; i < k; ++i) {
        out[i] = mt_eed_score(h_flat + h_off[i], (int32_t)(h_off[i + 1] - h_off[i]),
                              r_flat + r_off[i], (int32_t)(r_off[i + 1] - r_off[i]),
                              space_id, alpha, rho, deletion, insertion);
    }
}

}  // extern "C"
