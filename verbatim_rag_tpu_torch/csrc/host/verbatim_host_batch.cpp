// Batch entry of the port's host runtime: the BM25 analyzer over many texts
// in one call.
//
// `verbatim_host.cpp` is kept byte-equal to the JAX package's
// `native/verbatim_host.cpp` (hash_tokenize, analyze_text, project_rows,
// exact_rescore); this file compiles it into the same library and adds
// `analyze_texts`, which runs its `analyze_text` on every text, in
// parallel over texts, so each text's slots are exactly what one
// `analyze_text` call gives: unique slots in first-occurrence order, their
// counts, and the document length.

#include "verbatim_host.cpp"

extern "C" {

// data[offsets[i] : offsets[i+1]] is text i's UTF-8 bytes. Text i may write
// min(max_terms, (bytes + 1) / 2) slots (a token is at least one byte and is
// followed by a separator, so no text has more unique tokens than that) at
// slots[cap_offsets[i]:], with cap_offsets the prefix sums of those caps.
// After the parallel pass the regions are packed to the front in text
// order: text i's slots end up at slots[out_offsets[i] : out_offsets[i+1]].
// lengths[i] is text i's document length. A text whose unique count reaches
// max_terms is past the scanner's buffer (the caller replaces it).
// Returns the total number of slots written.
int64_t analyze_texts(const char* data, const int64_t* offsets, int64_t n,
                      int64_t vocab, int64_t max_terms,
                      const int64_t* cap_offsets, int32_t* slots,
                      int32_t* counts, int64_t* out_offsets,
                      int64_t* lengths) {
    std::vector<int64_t> unique(n > 0 ? n : 1, 0);
    int64_t* uniq = unique.data();
    parallel_rows(n, /*min_rows=*/256, [=](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const int64_t cap = cap_offsets[i + 1] - cap_offsets[i];
            lengths[i] = analyze_text(data + offsets[i], offsets[i + 1] - offsets[i],
                                      vocab, slots + cap_offsets[i],
                                      counts + cap_offsets[i],
                                      std::min(cap, max_terms), &uniq[i]);
        }
    });
    int64_t total = 0;
    out_offsets[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        // Regions move only toward the front: memmove is safe in order.
        if (total != cap_offsets[i] && uniq[i] > 0) {
            std::memmove(slots + total, slots + cap_offsets[i], sizeof(int32_t) * uniq[i]);
            std::memmove(counts + total, counts + cap_offsets[i], sizeof(int32_t) * uniq[i]);
        }
        total += uniq[i];
        out_offsets[i + 1] = total;
    }
    return total;
}

}  // extern "C"
