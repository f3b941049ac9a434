// Copied from serenedb_tpu/native/indexer.cpp.
//
// Native inverted-index builder: tokenize + postings, sort-based.
//
// Reference analog: IResearch's segment_writer/field_data pipeline
// (libs/iresearch/index/segment_writer.cpp) — the analysis/indexing hot
// path is native C++ in the reference, and stays native here: Python hands
// a concatenated UTF-8 buffer of documents, C++ returns the full
// FieldIndex arrays (sorted terms, postings, positions, norms) ready to
// wrap as numpy arrays.
//
// Design: per-token work is ONE hash lookup into a term dictionary and
// ONE int32 append to a flat term-id stream — no per-posting containers.
// Postings are then produced by a counting-sort scatter of the stream by
// term rank (stable, so per-term entries stay in (doc, position) order),
// and a final linear grouping pass. Multithreading (the ParallelSink
// analog, reference: server/connector/duckdb_physical_search_insert.h)
// shards documents into contiguous byte-balanced ranges — shard s+1's
// doc ids all exceed shard s's, so a k-way merge of shard dictionaries
// concatenates per-term runs in shard order with no posting re-sort.
//
// Tokenization matches the engine's "simple" analyzer for ASCII: word
// characters are [A-Za-z0-9_] (lowercased) plus any non-ASCII byte
// (UTF-8 continuation-safe). Stemming/stopwords stay in Python analyzers.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

inline bool is_word_byte(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_' || c >= 0x80;
}

inline char lower_ascii(char c) {
    return (c >= 'A' && c <= 'Z') ? char(c - 'A' + 'a') : c;
}

// Open-addressing term dictionary over a byte arena: one FNV-1a hash per
// token (computed while lowercasing), linear probing, no per-term string
// allocation. ~3x faster than std::unordered_map on short zipf terms.
struct TermDict {
    struct Entry {
        uint64_t hash;
        int64_t arena_off;
        int32_t len;
    };
    std::vector<int64_t> slots;   // entry index, -1 = empty; pow2 size
    std::vector<Entry> entries;   // term id = index
    std::string arena;

    TermDict() : slots(1 << 12, -1) {}

    size_t size() const { return entries.size(); }

    std::string_view term(size_t id) const {
        const Entry& e = entries[id];
        return {arena.data() + e.arena_off, static_cast<size_t>(e.len)};
    }

    void grow() {
        std::vector<int64_t> ns(slots.size() * 2, -1);
        const uint64_t mask = ns.size() - 1;
        for (size_t i = 0; i < entries.size(); ++i) {
            uint64_t s = entries[i].hash & mask;
            while (ns[s] != -1) s = (s + 1) & mask;
            ns[s] = static_cast<int64_t>(i);
        }
        slots.swap(ns);
    }

    int32_t lookup_or_insert(const char* p, int32_t len, uint64_t h) {
        const uint64_t mask = slots.size() - 1;
        uint64_t s = h & mask;
        while (true) {
            const int64_t id = slots[s];
            if (id == -1) break;
            const Entry& e = entries[static_cast<size_t>(id)];
            if (e.hash == h && e.len == len &&
                std::memcmp(arena.data() + e.arena_off, p,
                            static_cast<size_t>(len)) == 0)
                return static_cast<int32_t>(id);
            s = (s + 1) & mask;
        }
        const int32_t id = static_cast<int32_t>(entries.size());
        entries.push_back({h, static_cast<int64_t>(arena.size()), len});
        arena.append(p, static_cast<size_t>(len));
        slots[s] = id;
        if (entries.size() * 10 > slots.size() * 7) grow();
        return id;
    }
};

// Output of one shard's tokenize + scatter passes: local term dictionary
// in sorted order, and (doc, pos) occurrence runs grouped by term rank.
struct ShardOut {
    std::vector<std::string> sorted_terms;
    std::vector<int64_t> run_offsets;   // (T_local+1) into out_docs/out_pos
    std::vector<int32_t> out_docs;      // global doc ids, stream-stable
    std::vector<int32_t> out_pos;       // token position within doc
};

void build_shard(const char* buf, const int64_t* doc_offsets,
                 int64_t doc_lo, int64_t doc_hi, int32_t* norms_out,
                 int64_t* total_tokens_out, ShardOut& out) {
    // pass 1: tokenize to a flat term-id stream
    TermDict dict;
    std::vector<int32_t> stream;
    const int64_t shard_bytes = doc_offsets[doc_hi] - doc_offsets[doc_lo];
    stream.reserve(static_cast<size_t>(shard_bytes / 6) + 16);
    std::vector<int32_t> doc_len(static_cast<size_t>(doc_hi - doc_lo), 0);
    std::string token;
    for (int64_t d = doc_lo; d < doc_hi; ++d) {
        const char* p = buf + doc_offsets[d];
        const char* end = buf + doc_offsets[d + 1];
        int32_t pos = 0;
        // doc_offsets[d] == doc_offsets[d+1] encodes NULL/empty: norm 0
        while (p < end) {
            while (p < end && !is_word_byte(static_cast<unsigned char>(*p)))
                ++p;
            if (p >= end) break;
            token.clear();
            uint64_t h = 1469598103934665603ull;   // FNV-1a 64
            while (p < end && is_word_byte(static_cast<unsigned char>(*p))) {
                const char c = lower_ascii(*p);
                token.push_back(c);
                h = (h ^ static_cast<unsigned char>(c)) * 1099511628211ull;
                ++p;
            }
            stream.push_back(dict.lookup_or_insert(
                token.data(), static_cast<int32_t>(token.size()), h));
            ++pos;
        }
        doc_len[static_cast<size_t>(d - doc_lo)] = pos;
        norms_out[d] = pos;
        *total_tokens_out += pos;
    }

    // rank terms by string order
    const size_t T = dict.size();
    {
        std::vector<int32_t> ids(T);
        for (size_t i = 0; i < T; ++i) ids[i] = static_cast<int32_t>(i);
        std::sort(ids.begin(), ids.end(),
                  [&dict](int32_t a, int32_t b) {
                      return dict.term(static_cast<size_t>(a)) <
                             dict.term(static_cast<size_t>(b));
                  });
        std::vector<int32_t> rank_of_id(T);
        for (size_t r = 0; r < T; ++r)
            rank_of_id[static_cast<size_t>(ids[r])] =
                static_cast<int32_t>(r);
        // rewrite the stream in-place to term ranks
        for (auto& tid : stream) tid = rank_of_id[static_cast<size_t>(tid)];
        out.sorted_terms.resize(T);
        for (size_t r = 0; r < T; ++r)
            out.sorted_terms[r] = std::string(
                dict.term(static_cast<size_t>(ids[r])));
    }

    // pass 2: counting-sort scatter by rank (stable in stream order)
    const size_t N = stream.size();
    out.run_offsets.assign(T + 1, 0);
    for (int32_t r : stream)
        ++out.run_offsets[static_cast<size_t>(r) + 1];
    for (size_t t = 0; t < T; ++t)
        out.run_offsets[t + 1] += out.run_offsets[t];
    out.out_docs.resize(N);
    out.out_pos.resize(N);
    std::vector<int64_t> cursor(out.run_offsets.begin(),
                                out.run_offsets.end() - 1);
    size_t i = 0;
    for (int64_t d = doc_lo; d < doc_hi; ++d) {
        const int32_t len = doc_len[static_cast<size_t>(d - doc_lo)];
        for (int32_t pos = 0; pos < len; ++pos, ++i) {
            const int64_t slot = cursor[static_cast<size_t>(stream[i])]++;
            out.out_docs[static_cast<size_t>(slot)] =
                static_cast<int32_t>(d);
            out.out_pos[static_cast<size_t>(slot)] = pos;
        }
    }
}

}  // namespace

struct BuildResult {
    std::vector<std::string> sorted_terms;
    std::vector<int32_t> doc_freq;
    std::vector<int64_t> offsets;       // (T+1)
    std::vector<int32_t> post_docs;
    std::vector<int32_t> post_tfs;
    std::vector<int64_t> pos_offsets;   // (P+1)
    std::vector<int32_t> positions;
    std::vector<int32_t> norms;
    int64_t total_tokens = 0;
};

namespace {

// K-way merge of shard outputs into the final postings arrays. Shard doc
// ranges ascend with shard index, so per-term runs concatenate in shard
// order; consecutive equal docs within a run group into one posting.
BuildResult* assemble(std::vector<ShardOut>& shards,
                      std::vector<int32_t>&& norms, int64_t total_tokens) {
    auto* r = new BuildResult();
    r->norms = std::move(norms);
    r->total_tokens = total_tokens;

    const size_t S = shards.size();
    std::vector<size_t> cur(S, 0);          // per-shard term cursor
    int64_t total_occ = 0;
    for (auto& sh : shards) total_occ += static_cast<int64_t>(
        sh.out_docs.size());
    r->positions.reserve(static_cast<size_t>(total_occ));
    r->pos_offsets.reserve(static_cast<size_t>(total_occ / 2) + 16);
    r->offsets.push_back(0);
    r->pos_offsets.push_back(0);

    std::vector<size_t> contrib;            // shards holding current term
    contrib.reserve(S);
    while (true) {
        // smallest term among shard cursors
        const std::string* best = nullptr;
        for (size_t s = 0; s < S; ++s) {
            if (cur[s] >= shards[s].sorted_terms.size()) continue;
            const std::string& t = shards[s].sorted_terms[cur[s]];
            if (best == nullptr || t < *best) best = &t;
        }
        if (best == nullptr) break;
        contrib.clear();
        for (size_t s = 0; s < S; ++s) {
            if (cur[s] < shards[s].sorted_terms.size() &&
                shards[s].sorted_terms[cur[s]] == *best)
                contrib.push_back(s);
        }
        int32_t df = 0;
        for (size_t s : contrib) {
            ShardOut& sh = shards[s];
            const int64_t lo = sh.run_offsets[cur[s]];
            const int64_t hi = sh.run_offsets[cur[s] + 1];
            int64_t i = lo;
            while (i < hi) {
                const int32_t doc = sh.out_docs[static_cast<size_t>(i)];
                int64_t j = i;
                while (j < hi &&
                       sh.out_docs[static_cast<size_t>(j)] == doc) {
                    r->positions.push_back(
                        sh.out_pos[static_cast<size_t>(j)]);
                    ++j;
                }
                r->post_docs.push_back(doc);
                r->post_tfs.push_back(static_cast<int32_t>(j - i));
                r->pos_offsets.push_back(
                    static_cast<int64_t>(r->positions.size()));
                ++df;
                i = j;
            }
            ++cur[s];
        }
        r->sorted_terms.push_back(std::move(
            shards[contrib.front()].sorted_terms
                [cur[contrib.front()] - 1]));
        r->doc_freq.push_back(df);
        r->offsets.push_back(static_cast<int64_t>(r->post_docs.size()));
    }
    return r;
}

}  // namespace

extern "C" {

BuildResult* sdb_build_index_mt(const char* buf, const int64_t* doc_offsets,
                                int64_t n_docs, int32_t n_threads) {
    int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    if (n_threads > n_docs) n_threads = n_docs > 0 ?
        static_cast<int32_t>(n_docs) : 1;

    std::vector<int32_t> norms(static_cast<size_t>(n_docs), 0);
    std::vector<int64_t> totals(static_cast<size_t>(n_threads), 0);
    std::vector<ShardOut> shards(static_cast<size_t>(n_threads));

    if (n_threads <= 1) {
        build_shard(buf, doc_offsets, 0, n_docs, norms.data(),
                    &totals[0], shards[0]);
        return assemble(shards, std::move(norms), totals[0]);
    }

    // byte-balanced contiguous shard bounds
    const int64_t total_bytes = doc_offsets[n_docs];
    std::vector<int64_t> bounds(static_cast<size_t>(n_threads) + 1, 0);
    bounds[static_cast<size_t>(n_threads)] = n_docs;
    for (int32_t t = 1; t < n_threads; ++t) {
        const int64_t target = total_bytes * t / n_threads;
        const int64_t* lo = std::lower_bound(
            doc_offsets, doc_offsets + n_docs + 1, target);
        int64_t d = lo - doc_offsets;
        if (d > n_docs) d = n_docs;
        if (d < bounds[static_cast<size_t>(t) - 1])
            d = bounds[static_cast<size_t>(t) - 1];
        bounds[static_cast<size_t>(t)] = d;
    }

    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(n_threads));
    for (int32_t t = 0; t < n_threads; ++t) {
        pool.emplace_back(build_shard, buf, doc_offsets,
                          bounds[static_cast<size_t>(t)],
                          bounds[static_cast<size_t>(t) + 1],
                          norms.data(), &totals[static_cast<size_t>(t)],
                          std::ref(shards[static_cast<size_t>(t)]));
    }
    for (auto& th : pool) th.join();

    int64_t total_tokens = 0;
    for (int64_t v : totals) total_tokens += v;
    return assemble(shards, std::move(norms), total_tokens);
}

BuildResult* sdb_build_index(const char* buf, const int64_t* doc_offsets,
                             int64_t n_docs) {
    return sdb_build_index_mt(buf, doc_offsets, n_docs, 1);
}

int64_t sdb_num_terms(BuildResult* r) {
    return static_cast<int64_t>(r->sorted_terms.size());
}
int64_t sdb_postings_len(BuildResult* r) {
    return static_cast<int64_t>(r->post_docs.size());
}
int64_t sdb_positions_len(BuildResult* r) {
    return static_cast<int64_t>(r->positions.size());
}
int64_t sdb_terms_bytes(BuildResult* r) {
    int64_t total = 0;
    for (const auto& t : r->sorted_terms) total += static_cast<int64_t>(t.size());
    return total;
}
int64_t sdb_total_tokens(BuildResult* r) { return r->total_tokens; }

// Fill pre-allocated numpy buffers (sizes from the getters above).
void sdb_fill(BuildResult* r, char* terms_buf, int64_t* term_offsets,
              int32_t* doc_freq, int64_t* offsets, int32_t* post_docs,
              int32_t* post_tfs, int64_t* pos_offsets, int32_t* positions,
              int32_t* norms) {
    int64_t off = 0;
    int64_t ti = 0;
    term_offsets[0] = 0;
    for (const auto& t : r->sorted_terms) {
        std::memcpy(terms_buf + off, t.data(), t.size());
        off += static_cast<int64_t>(t.size());
        term_offsets[++ti] = off;
    }
    std::memcpy(doc_freq, r->doc_freq.data(),
                r->doc_freq.size() * sizeof(int32_t));
    std::memcpy(offsets, r->offsets.data(),
                r->offsets.size() * sizeof(int64_t));
    std::memcpy(post_docs, r->post_docs.data(),
                r->post_docs.size() * sizeof(int32_t));
    std::memcpy(post_tfs, r->post_tfs.data(),
                r->post_tfs.size() * sizeof(int32_t));
    std::memcpy(pos_offsets, r->pos_offsets.data(),
                r->pos_offsets.size() * sizeof(int64_t));
    std::memcpy(positions, r->positions.data(),
                r->positions.size() * sizeof(int32_t));
    std::memcpy(norms, r->norms.data(), r->norms.size() * sizeof(int32_t));
}

void sdb_free(BuildResult* r) { delete r; }

}  // extern "C"
