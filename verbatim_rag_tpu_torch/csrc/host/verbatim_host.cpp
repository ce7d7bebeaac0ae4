// Native host runtime for verbatim-rag-tpu.
//
// The TPU owns all scoring math; these are the host-side hot loops that feed
// it (SURVEY.md §2.8 — the reference outsources this work to Milvus's C++):
//
//   project_rows   SpMM sketching of forward-index rows against the random
//                  projection matrix (the ingest-time hot loop of the
//                  projected sparse path; ~nnz·d_p·4B of memory traffic).
//   exact_rescore  exact sparse scores for (query, candidate) pairs — the
//                  query-time host hot loop of the projected path.
//   analyze_text   BM25 analyzer: lowercase word tokenization + FNV-1a
//                  hashing into a fixed vocab (ingest-time, replaces a
//                  Python regex + blake2 loop).
//
// Plain C ABI for ctypes; no Python headers needed.

#include <cstdint>
#include <cstring>
#include <cctype>
#include <cstdlib>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Worker count for the row-parallel loops. VERBATIM_NATIVE_THREADS pins it;
// default = hardware concurrency (1 on a 1-vCPU host -> zero overhead).
int native_threads() {
    static const int n = [] {
        if (const char* env = std::getenv("VERBATIM_NATIVE_THREADS")) {
            const long v = std::strtol(env, nullptr, 10);
            if (v >= 1 && v <= 1024) return (int)v;
        }
        const unsigned hw = std::thread::hardware_concurrency();
        return hw ? (int)hw : 1;
    }();
    return n;
}

// Run fn(start, end) over T contiguous chunks of [0, n). Inline when a
// single worker (or fewer than min_rows) makes threads pure overhead;
// min_rows is caller-tuned to the per-row work size.
template <typename Fn>
void parallel_rows(int64_t n, int64_t min_rows, Fn fn) {
    const int threads = (int)std::min<int64_t>(native_threads(), n);
    if (threads <= 1 || n < min_rows) {
        fn((int64_t)0, n);
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(threads);
    const int64_t chunk = (n + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
        const int64_t start = (int64_t)t * chunk;
        const int64_t end = std::min(n, start + chunk);
        if (start >= end) break;
        pool.emplace_back([=] { fn(start, end); });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// out[n, d] = sum_j w[n, j] * P[ids[n, j], d]
// Row-parallel over `n` (disjoint output rows; read-only inputs).
void project_rows(const int32_t* ids, const float* w, int64_t n, int64_t m,
                  const float* P, int64_t V, int64_t d, float* out) {
    parallel_rows(n, /*min_rows=*/64, [=](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            float* acc = out + i * d;
            std::memset(acc, 0, sizeof(float) * d);
            const int32_t* row_ids = ids + i * m;
            const float* row_w = w + i * m;
            for (int64_t j = 0; j < m; ++j) {
                const float weight = row_w[j];
                if (weight == 0.0f) continue;
                const int32_t t = row_ids[j];
                if (t < 0 || t >= V) continue;
                const float* p_row = P + (int64_t)t * d;
                // Compilers vectorize this loop (contiguous fma).
                for (int64_t k = 0; k < d; ++k) acc[k] += weight * p_row[k];
            }
        }
    });
}

// scores[b, c] = sum_j w[rows[b,c], j] * q[b, ids[rows[b,c], j]]
// rows may contain -1 (missing candidate) -> score = -inf.
// Query-parallel over `B` (disjoint score rows; read-only inputs).
void exact_rescore(const int64_t* rows, int64_t B, int64_t C,
                   const int32_t* ids, const float* w, int64_t n, int64_t m,
                   const float* q, int64_t V, float* scores) {
    const float neg_inf = -3.0e38f;
    parallel_rows(B, /*min_rows=*/8, [=](int64_t lo, int64_t hi) {
        for (int64_t b = lo; b < hi; ++b) {
            const float* qb = q + b * V;
            for (int64_t c = 0; c < C; ++c) {
                const int64_t row = rows[b * C + c];
                if (row < 0 || row >= n) { scores[b * C + c] = neg_inf; continue; }
                const int32_t* row_ids = ids + row * m;
                const float* row_w = w + row * m;
                float acc = 0.0f;
                for (int64_t j = 0; j < m; ++j) {
                    const float weight = row_w[j];
                    if (weight != 0.0f) acc += weight * qb[row_ids[j]];
                }
                scores[b * C + c] = acc;
            }
        }
    });
}

static inline uint32_t fnv1a(const char* s, int len) {
    uint32_t h = 2166136261u;
    for (int i = 0; i < len; ++i) { h ^= (uint8_t)s[i]; h *= 16777619u; }
    return h;
}

// Tokenize [a-z0-9]+ runs of `text` (ASCII lowercased), hash each token into
// [1, vocab), and accumulate term frequencies into the caller's buffers.
// Returns document length (token count). term_ids/term_tfs must have
// capacity max_terms; the number of unique terms is written to *n_terms.
// Hashing matches HashTokenizer-style slot layout: slot 0 reserved for pad.
int64_t analyze_text(const char* text, int64_t text_len, int64_t vocab,
                     int32_t* term_ids, int32_t* term_tfs, int64_t max_terms,
                     int64_t* n_terms) {
    int64_t dl = 0;
    int64_t unique = 0;
    int64_t i = 0;
    char buf[256];
    while (i < text_len) {
        char c = (char)std::tolower((unsigned char)text[i]);
        if (!std::isalnum((unsigned char)c)) { ++i; continue; }
        int len = 0;
        while (i < text_len) {
            c = (char)std::tolower((unsigned char)text[i]);
            if (!std::isalnum((unsigned char)c)) break;
            if (len < (int)sizeof(buf)) buf[len++] = c;
            ++i;
        }
        ++dl;
        const int32_t slot = (int32_t)(fnv1a(buf, len) % (uint32_t)(vocab - 1)) + 1;
        // Linear probe over the collected terms (docs have few uniques).
        bool found = false;
        for (int64_t t = 0; t < unique; ++t) {
            if (term_ids[t] == slot) { ++term_tfs[t]; found = true; break; }
        }
        if (!found && unique < max_terms) {
            term_ids[unique] = slot;
            term_tfs[unique] = 1;
            ++unique;
        }
    }
    *n_terms = unique;
    return dl;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// hash_tokenize: the HashTokenizer hot loop in C++ (models/tokenizer.py).
//
// Reproduces BIT-EXACTLY, for ASCII text, the Python pipeline
//   re.findall(r"[a-z0-9]+|[^\w\s]", text.lower())
//   id = reserved + int.from_bytes(blake2b(repr(tok), digest_size=8), 'little',
//                                  signed=True) % (vocab - reserved)
// so native and Python tokenization are interchangeable per text (the caller
// falls back to Python for any non-ASCII input). Parity is enforced by
// tests/test_native_tokenizer.py over the repository's own corpus.
// ---------------------------------------------------------------------------

#include <string>
#include <unordered_map>

namespace {

// RFC 7693 BLAKE2b, unkeyed, 8-byte digest — matches hashlib.blake2b(...,
// digest_size=8).
struct Blake2b8 {
    static inline uint64_t rotr64(uint64_t x, int n) {
        return (x >> n) | (x << (64 - n));
    }

    static void compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
                         bool last) {
        static const uint64_t IV[8] = {
            0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
            0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
            0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
        static const uint8_t SIGMA[12][16] = {
            {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
            {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
            {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
            {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
            {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
            {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
            {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
            {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
            {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
            {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
            {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
            {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};
        uint64_t m[16], v[16];
        for (int i = 0; i < 16; ++i) {
            uint64_t w = 0;
            for (int j = 7; j >= 0; --j) w = (w << 8) | block[i * 8 + j];
            m[i] = w;
        }
        for (int i = 0; i < 8; ++i) v[i] = h[i];
        for (int i = 0; i < 8; ++i) v[8 + i] = IV[i];
        v[12] ^= t;  // low counter word (inputs here are far below 2^64)
        if (last) v[14] = ~v[14];
        for (int r = 0; r < 12; ++r) {
            const uint8_t* s = SIGMA[r];
            auto G = [&](int a, int b, int c, int d, uint64_t x, uint64_t y) {
                v[a] = v[a] + v[b] + x;
                v[d] = rotr64(v[d] ^ v[a], 32);
                v[c] = v[c] + v[d];
                v[b] = rotr64(v[b] ^ v[c], 24);
                v[a] = v[a] + v[b] + y;
                v[d] = rotr64(v[d] ^ v[a], 16);
                v[c] = v[c] + v[d];
                v[b] = rotr64(v[b] ^ v[c], 63);
            };
            G(0, 4, 8, 12, m[s[0]], m[s[1]]);
            G(1, 5, 9, 13, m[s[2]], m[s[3]]);
            G(2, 6, 10, 14, m[s[4]], m[s[5]]);
            G(3, 7, 11, 15, m[s[6]], m[s[7]]);
            G(0, 5, 10, 15, m[s[8]], m[s[9]]);
            G(1, 6, 11, 12, m[s[10]], m[s[11]]);
            G(2, 7, 8, 13, m[s[12]], m[s[13]]);
            G(3, 4, 9, 14, m[s[14]], m[s[15]]);
        }
        for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[8 + i];
    }

    // 64-bit little-endian digest of `data` as a signed int64.
    static int64_t hash8(const uint8_t* data, size_t len) {
        uint64_t h[8] = {
            0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
            0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
            0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
        h[0] ^= 0x01010000ULL ^ 8ULL;  // depth/fanout 1, key 0, digest_len 8
        uint8_t block[128];
        size_t off = 0;
        // All full blocks except the last go through non-final compression.
        while (len - off > 128) {
            std::memcpy(block, data + off, 128);
            off += 128;
            compress(h, block, (uint64_t)off, false);
        }
        const size_t rem = len - off;
        std::memset(block, 0, sizeof(block));
        std::memcpy(block, data + off, rem);
        compress(h, block, (uint64_t)len, true);
        return (int64_t)h[0];  // first 8 LE bytes == low word
    }
};

// Python repr() of a single ASCII punctuation/control character, appended to
// `out` — the exact bytes hashlib sees for one-char tokens.
inline void repr_single(uint8_t c, std::string& out) {
    if (c == '\'') {
        out += "\"'\"";
    } else if (c == '\\') {
        out += "'\\\\'";
    } else if (c >= 0x20 && c < 0x7f) {
        out += '\'';
        out += (char)c;
        out += '\'';
    } else {
        static const char* hexd = "0123456789abcdef";
        out += "'\\x";
        out += hexd[c >> 4];
        out += hexd[c & 0xf];
        out += '\'';
    }
}

// Character classes on the LOWERED ASCII text, matching Python's
// re (unicode mode) for [a-z0-9] / \s / \w — derived from CPython, pinned by
// the parity test. 'a' = token-run char, 's' = whitespace, 'w' = \w
// non-run (only '_' after lowering), 'p' = single-char punctuation token.
inline char char_class(uint8_t c) {
    if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
        (c >= '0' && c <= '9'))
        return 'a';
    if (c == ' ' || (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x1f))
        return 's';
    if (c == '_') return 'w';
    return 'p';
}

int64_t word_hash(const std::string& repr_bytes) {
    // Per-word digest memo: corpora repeat words heavily and BLAKE2b is the
    // expensive part. Thread-local: no locks on the (threaded) serving path.
    static thread_local std::unordered_map<std::string, int64_t> cache;
    auto it = cache.find(repr_bytes);
    if (it != cache.end()) return it->second;
    const int64_t h =
        Blake2b8::hash8((const uint8_t*)repr_bytes.data(), repr_bytes.size());
    if (cache.size() < (1u << 20)) cache.emplace(repr_bytes, h);
    return h;
}

}  // namespace

extern "C" {

// Tokenize ASCII `text` exactly like HashTokenizer.tokenize_with_offsets:
// ids_out[i] = token id, offsets_out[2i, 2i+1] = (char_start, char_end).
// Returns the token count (<= max_tokens), or -1 if any byte >= 0x80 was
// seen before max_tokens tokens were produced (caller must use Python).
int64_t hash_tokenize(const uint8_t* text, int64_t text_len,
                      int64_t vocab_size, int64_t reserved,
                      int64_t max_tokens, int32_t* ids_out,
                      int32_t* offsets_out) {
    const int64_t span = vocab_size - reserved;
    std::string repr_buf;
    int64_t n = 0;
    int64_t i = 0;
    while (i < text_len && n < max_tokens) {
        uint8_t c = text[i];
        if (c >= 0x80) return -1;
        const char cls = char_class(c);
        if (cls == 's' || cls == 'w') {
            ++i;
            continue;
        }
        repr_buf.clear();
        int64_t start = i, end;
        if (cls == 'a') {
            repr_buf += '\'';
            while (i < text_len) {
                c = text[i];
                if (c >= 0x80) return -1;  // a run is ended by non-[a-z0-9]
                if (char_class(c) != 'a') break;
                repr_buf += (char)(c >= 'A' && c <= 'Z' ? c + 32 : c);
                ++i;
            }
            repr_buf += '\'';
            end = i;
        } else {  // 'p': single-char token
            repr_single(c, repr_buf);
            end = ++i;
        }
        const int64_t h = word_hash(repr_buf);
        int64_t mod = h % span;  // Python %: result takes the divisor's sign
        if (mod < 0) mod += span;
        ids_out[n] = (int32_t)(reserved + mod);
        offsets_out[2 * n] = (int32_t)start;
        offsets_out[2 * n + 1] = (int32_t)end;
        ++n;
    }
    return n;
}

}  // extern "C"
