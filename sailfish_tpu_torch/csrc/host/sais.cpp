// SA-IS suffix array construction (Nong, Zhang & Chan induced sorting).
//
// Native replacement for the role libdivsufsort plays in the reference
// build (reference CMakeLists.txt:279-288): offline suffix-array
// construction for the index.  O(n) time, small alphabet.
//
// Exposed C ABI:
//   int32_t sf_build_sa(const uint8_t* text, int64_t n, int32_t* sa_out)
// Builds the suffix array of text[0..n) (arbitrary byte values; an
// internal sentinel smaller than every symbol is appended).  Returns 0
// on success.  A copy of native/sais.cpp, built by _ext.py with g++;
// held to the numpy construction and to the JAX package's suffix array
// in tests/test_torch_host.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using idx_t = int64_t;

template <typename T>
void get_counts(const T* s, idx_t* cnt, idx_t n, idx_t K) {
    std::memset(cnt, 0, K * sizeof(idx_t));
    for (idx_t i = 0; i < n; ++i) cnt[s[i]]++;
}

void get_buckets(const idx_t* cnt, idx_t* bkt, idx_t K, bool end) {
    idx_t sum = 0;
    for (idx_t i = 0; i < K; ++i) {
        sum += cnt[i];
        bkt[i] = end ? sum : sum - cnt[i];
    }
}

template <typename T>
void induce(const T* s, idx_t* SA, const std::vector<bool>& t, idx_t n,
            idx_t K, std::vector<idx_t>& cnt, std::vector<idx_t>& bkt) {
    // L-type, left to right
    get_buckets(cnt.data(), bkt.data(), K, false);
    for (idx_t i = 0; i < n; ++i) {
        idx_t j = SA[i] - 1;
        if (SA[i] > 0 && !t[j]) SA[bkt[s[j]]++] = j;
    }
    // S-type, right to left
    get_buckets(cnt.data(), bkt.data(), K, true);
    for (idx_t i = n - 1; i >= 0; --i) {
        idx_t j = SA[i] - 1;
        if (SA[i] > 0 && t[j]) SA[--bkt[s[j]]] = j;
    }
}

// s[n-1] must be a unique sentinel strictly smaller than all other
// symbols.  SA must have room for n entries.
template <typename T>
void sais(const T* s, idx_t* SA, idx_t n, idx_t K) {
    std::vector<bool> t(n);
    t[n - 1] = true;
    for (idx_t i = n - 2; i >= 0; --i)
        t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);

    auto is_lms = [&](idx_t i) { return i > 0 && t[i] && !t[i - 1]; };

    std::vector<idx_t> cnt(K), bkt(K);
    get_counts(s, cnt.data(), n, K);

    // stage 1: sort LMS substrings by induced sorting
    std::fill(SA, SA + n, idx_t(-1));
    get_buckets(cnt.data(), bkt.data(), K, true);
    for (idx_t i = 1; i < n; ++i)
        if (is_lms(i)) SA[--bkt[s[i]]] = i;
    induce(s, SA, t, n, K, cnt, bkt);

    // compact sorted LMS positions into SA[0..m)
    idx_t m = 0;
    for (idx_t i = 0; i < n; ++i)
        if (SA[i] > 0 && is_lms(SA[i])) SA[m++] = SA[i];

    // name LMS substrings into SA[m..n)
    std::fill(SA + m, SA + n, idx_t(-1));
    idx_t name = 0, prev = -1;
    for (idx_t i = 0; i < m; ++i) {
        idx_t pos = SA[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (idx_t d = 0;; ++d) {
                if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    // both hit the next LMS boundary simultaneously
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
            }
        }
        if (diff) {
            ++name;
            prev = pos;
        }
        SA[m + pos / 2] = name - 1;
    }
    // compact the names to the tail of SA
    for (idx_t i = n - 1, j = n - 1; i >= m; --i)
        if (SA[i] >= 0) SA[j--] = SA[i];

    // stage 2: order the LMS suffixes
    idx_t* s1 = SA + n - m;
    if (name < m) {
        sais(s1, SA, m, name);
    } else {
        for (idx_t i = 0; i < m; ++i) SA[s1[i]] = i;
    }
    // map reduced-string order back to LMS positions (reuse s1 as P)
    for (idx_t i = 1, q = 0; i < n; ++i)
        if (is_lms(i)) s1[q++] = i;
    for (idx_t i = 0; i < m; ++i) SA[i] = s1[SA[i]];

    // stage 3: induce the full order from sorted LMS suffixes
    std::fill(SA + m, SA + n, idx_t(-1));
    get_buckets(cnt.data(), bkt.data(), K, true);
    for (idx_t i = m - 1; i >= 0; --i) {
        idx_t j = SA[i];
        SA[i] = -1;
        SA[--bkt[s[j]]] = j;
    }
    induce(s, SA, t, n, K, cnt, bkt);
}

}  // namespace

extern "C" int32_t sf_build_sa(const uint8_t* text, int64_t n,
                               int32_t* sa_out) {
    if (n <= 0) return 0;
    if (n >= (int64_t(1) << 31) - 2) return 1;  // int32 output only
    // append sentinel 0; shift symbols by +1
    std::vector<uint16_t> s(n + 1);
    for (idx_t i = 0; i < n; ++i) s[i] = uint16_t(text[i]) + 1;
    s[n] = 0;
    std::vector<idx_t> SA(n + 1);
    sais(s.data(), SA.data(), n + 1, 257);
    // SA[0] is the sentinel suffix; drop it
    for (idx_t i = 0; i < n; ++i) sa_out[i] = int32_t(SA[i + 1]);
    return 0;
}
