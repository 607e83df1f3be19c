// BPE tokenizer: whitespace pre-tokenization + byte-pair-merge training and
// encoding, exposed through a C ABI for ctypes.
//
// Native equivalent of the HF `tokenizers` (Rust) usage in the reference BM25
// baseline (`reference/retrieval/bm25/train_tokenizer.py:21-27`,
// `bm25/main.py:46,88`): BPE model with unk token, Whitespace pre-tokenizer
// (the HF regex \w+|[^\w\s]+), trained on premise+state corpora.
//
// Training uses the standard pair-count + lazy max-heap algorithm so the
// ~130k-document corpus trains in seconds, not hours:
//   - count pre-tokenized "words" once;
//   - maintain pair -> frequency and pair -> {word ids} indexes;
//   - pop the best pair from a lazy heap, merge it inside every word that
//     contains it, incrementally updating neighbour pair counts.
//
// A copy of the JAX package's native/bpe.cpp for the PyTorch port.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 bpe.cpp -o libbpe.so
// (reprover_tpu_torch/native/bpe.py builds it under build/native/ at first use.)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <queue>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<int, int>& p) const {
        return std::hash<uint64_t>()((uint64_t(uint32_t(p.first)) << 32) |
                                     uint32_t(p.second));
    }
};

using Pair = std::pair<int, int>;

bool is_word_char(uint32_t cp) {
    // Approximation of regex \w for the UTF-8 code points we see in Lean
    // sources: ASCII alnum + underscore + all non-ASCII letters/symbols are
    // split by the HF Whitespace pre-tokenizer as \w only for
    // letters/digits. We treat every code point >= 128 as a word char except
    // common mathematical punctuation is still a word char in \w? HF's
    // `Whitespace` uses Unicode-aware \w+|[^\w\s]+. For parity that matters
    // here (token *sets* feeding BM25), ASCII behaviour is exact and
    // non-ASCII code points are classified via a small table of Unicode
    // ranges for letters/digits.
    if (cp < 128) {
        return (cp >= '0' && cp <= '9') || (cp >= 'a' && cp <= 'z') ||
               (cp >= 'A' && cp <= 'Z') || cp == '_';
    }
    // Greek, Coptic, letterlike (ℕ ℤ ...), subscripts, CJK, etc. count as \w;
    // mathematical operators/arrows do not.
    if ((cp >= 0x0370 && cp <= 0x03FF) ||  // Greek
        (cp >= 0x1F00 && cp <= 0x1FFF) ||  // Greek extended
        (cp >= 0x2070 && cp <= 0x209F) ||  // super/subscripts
        (cp >= 0x2100 && cp <= 0x214F) ||  // letterlike (ℕ, ℝ, ℤ)
        (cp >= 0x0400 && cp <= 0x04FF) ||  // Cyrillic
        (cp >= 0x00C0 && cp <= 0x024F) ||  // Latin extended
        (cp >= 0x3040 && cp <= 0x30FF) ||  // kana
        (cp >= 0x4E00 && cp <= 0x9FFF))    // CJK
        return true;
    return false;
}

bool is_space(uint32_t cp) {
    return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == 0x0B ||
           cp == 0x0C || cp == 0x00A0 || cp == 0x2028 || cp == 0x2029;
}

// Decode one UTF-8 code point starting at s[i]; advances i.
uint32_t next_cp(const std::string& s, size_t& i) {
    unsigned char c = s[i];
    uint32_t cp;
    int extra;
    if (c < 0x80) { cp = c; extra = 0; }
    else if ((c >> 5) == 0x6) { cp = c & 0x1F; extra = 1; }
    else if ((c >> 4) == 0xE) { cp = c & 0x0F; extra = 2; }
    else { cp = c & 0x07; extra = 3; }
    size_t start = i++;
    for (int k = 0; k < extra && i < s.size(); ++k, ++i)
        cp = (cp << 6) | (s[i] & 0x3F);
    (void)start;
    return cp;
}

// Whitespace pre-tokenizer: \w+ | [^\w\s]+ (runs of word chars, or runs of
// non-word non-space chars).
std::vector<std::string> pre_tokenize(const std::string& text) {
    std::vector<std::string> words;
    size_t i = 0;
    std::string cur;
    int cur_kind = -1;  // 0 word, 1 punct
    while (i < text.size()) {
        size_t start = i;
        uint32_t cp = next_cp(text, i);
        int kind = is_space(cp) ? -1 : (is_word_char(cp) ? 0 : 1);
        if (kind == -1) {
            if (!cur.empty()) { words.push_back(cur); cur.clear(); }
            cur_kind = -1;
            continue;
        }
        if (kind != cur_kind && !cur.empty()) {
            words.push_back(cur);
            cur.clear();
        }
        cur.append(text, start, i - start);
        cur_kind = kind;
    }
    if (!cur.empty()) words.push_back(cur);
    return words;
}

// Split a word into single-code-point symbol strings.
std::vector<std::string> to_symbols(const std::string& word) {
    std::vector<std::string> out;
    size_t i = 0;
    while (i < word.size()) {
        size_t start = i;
        next_cp(word, i);
        out.push_back(word.substr(start, i - start));
    }
    return out;
}

struct BPE {
    std::vector<std::string> vocab;                       // id -> token string
    std::unordered_map<std::string, int> token_to_id;     // token -> id
    std::unordered_map<Pair, int, PairHash> merge_rank;   // pair ids -> rank
    std::vector<Pair> merges;                             // rank order
    int unk_id = -1;
    // encode cache: word -> token ids
    std::unordered_map<std::string, std::vector<int>> cache;

    int add_token(const std::string& t) {
        auto it = token_to_id.find(t);
        if (it != token_to_id.end()) return it->second;
        int id = (int)vocab.size();
        vocab.push_back(t);
        token_to_id.emplace(t, id);
        return id;
    }

    std::vector<int> encode_word(const std::string& word) {
        auto hit = cache.find(word);
        if (hit != cache.end()) return hit->second;
        std::vector<std::string> syms = to_symbols(word);
        std::vector<int> ids;
        ids.reserve(syms.size());
        bool any_unknown = false;
        for (auto& s : syms) {
            auto it = token_to_id.find(s);
            if (it == token_to_id.end()) { ids.push_back(-1); any_unknown = true; }
            else ids.push_back(it->second);
        }
        // Iteratively apply the lowest-rank merge present.
        while (ids.size() >= 2) {
            int best_rank = INT32_MAX;
            size_t best_i = 0;
            for (size_t i = 0; i + 1 < ids.size(); ++i) {
                if (ids[i] < 0 || ids[i + 1] < 0) continue;
                auto it = merge_rank.find({ids[i], ids[i + 1]});
                if (it != merge_rank.end() && it->second < best_rank) {
                    best_rank = it->second;
                    best_i = i;
                }
            }
            if (best_rank == INT32_MAX) break;
            std::string merged = vocab[ids[best_i]] + vocab[ids[best_i + 1]];
            ids[best_i] = token_to_id.at(merged);
            ids.erase(ids.begin() + best_i + 1);
        }
        if (any_unknown)
            for (auto& id : ids)
                if (id < 0) id = unk_id;
        cache.emplace(word, ids);
        return ids;
    }

    std::vector<int> encode(const std::string& text) {
        std::vector<int> out;
        for (auto& w : pre_tokenize(text)) {
            auto ids = encode_word(w);
            out.insert(out.end(), ids.begin(), ids.end());
        }
        return out;
    }
};

struct TrainWord {
    std::vector<int> syms;
    int64_t freq;
};

void train_bpe(BPE& bpe, const std::vector<std::string>& texts, int vocab_size,
               const std::vector<std::string>& specials) {
    for (auto& s : specials) bpe.add_token(s);
    auto unk_it = bpe.token_to_id.find("[UNK]");
    bpe.unk_id = unk_it == bpe.token_to_id.end() ? 0 : unk_it->second;

    // 1. word frequency
    std::unordered_map<std::string, int64_t> word_freq;
    for (auto& t : texts)
        for (auto& w : pre_tokenize(t)) ++word_freq[w];

    // 2. alphabet + initial symbol sequences
    std::vector<TrainWord> words;
    words.reserve(word_freq.size());
    for (auto& [w, f] : word_freq) {
        TrainWord tw;
        tw.freq = f;
        for (auto& s : to_symbols(w)) tw.syms.push_back(bpe.add_token(s));
        words.push_back(std::move(tw));
    }

    // 3. pair counts + index
    std::unordered_map<Pair, int64_t, PairHash> pair_count;
    std::unordered_map<Pair, std::unordered_set<int>, PairHash> pair_words;
    for (int wi = 0; wi < (int)words.size(); ++wi) {
        auto& syms = words[wi].syms;
        for (size_t i = 0; i + 1 < syms.size(); ++i) {
            Pair p{syms[i], syms[i + 1]};
            pair_count[p] += words[wi].freq;
            pair_words[p].insert(wi);
        }
    }

    // 4. lazy max-heap of (count, pair); entries are revalidated on pop.
    // Tie-break on token strings for deterministic output (HF breaks ties by
    // construction order; string order is deterministic across runs here).
    auto cmp_key = [&](const Pair& p) {
        return std::make_pair(bpe.vocab[p.first], bpe.vocab[p.second]);
    };
    struct HeapItem {
        int64_t count;
        Pair pair;
    };
    auto heap_less = [&](const HeapItem& a, const HeapItem& b) {
        if (a.count != b.count) return a.count < b.count;
        return cmp_key(a.pair) > cmp_key(b.pair);  // smaller key wins ties
    };
    std::priority_queue<HeapItem, std::vector<HeapItem>, decltype(heap_less)>
        heap(heap_less);
    for (auto& [p, c] : pair_count) heap.push({c, p});

    auto bump = [&](const Pair& p, int64_t delta, int wi) {
        auto& c = pair_count[p];
        c += delta;
        if (delta > 0) {
            pair_words[p].insert(wi);
            heap.push({c, p});
        }
        // On decrease we leave stale heap entries; they are revalidated.
    };

    while ((int)bpe.vocab.size() < vocab_size && !heap.empty()) {
        HeapItem top = heap.top();
        heap.pop();
        auto it = pair_count.find(top.pair);
        if (it == pair_count.end() || it->second != top.count || it->second <= 0)
            continue;  // stale
        Pair best = top.pair;
        int64_t freq = it->second;
        if (freq < 1) break;  // exhausted (HF min_frequency default 0)
        std::string merged_str = bpe.vocab[best.first] + bpe.vocab[best.second];
        int merged_id = bpe.add_token(merged_str);
        bpe.merge_rank[best] = (int)bpe.merges.size();
        bpe.merges.push_back(best);

        auto touched = pair_words[best];  // copy: we mutate the index
        for (int wi : touched) {
            auto& syms = words[wi].syms;
            int64_t f = words[wi].freq;
            for (size_t i = 0; i + 1 < syms.size();) {
                if (syms[i] == best.first && syms[i + 1] == best.second) {
                    if (i > 0) {
                        bump({syms[i - 1], syms[i]}, -f, wi);
                        bump({syms[i - 1], merged_id}, f, wi);
                    }
                    if (i + 2 < syms.size()) {
                        bump({syms[i + 1], syms[i + 2]}, -f, wi);
                        bump({merged_id, syms[i + 2]}, f, wi);
                    }
                    syms[i] = merged_id;
                    syms.erase(syms.begin() + i + 1);
                } else {
                    ++i;
                }
            }
        }
        pair_count.erase(best);
        pair_words.erase(best);
    }
}

}  // namespace

// ------------------------------------------------------------------ //
// C ABI
// ------------------------------------------------------------------ //

extern "C" {

void* bpe_new() { return new BPE(); }

void bpe_free(void* h) { delete (BPE*)h; }

void bpe_train(void* h, const char** texts, int64_t n, int vocab_size,
               const char** specials, int n_specials) {
    std::vector<std::string> ts(texts, texts + n);
    std::vector<std::string> sp(specials, specials + n_specials);
    train_bpe(*(BPE*)h, ts, vocab_size, sp);
}

int bpe_vocab_size(void* h) { return (int)((BPE*)h)->vocab.size(); }

const char* bpe_get_token(void* h, int id) {
    return ((BPE*)h)->vocab[id].c_str();
}

// Encode into caller-provided buffer; returns the token count.
int64_t bpe_encode(void* h, const char* text, int32_t* out, int64_t capacity) {
    auto ids = ((BPE*)h)->encode(text);
    int64_t n = std::min<int64_t>((int64_t)ids.size(), capacity);
    std::memcpy(out, ids.data(), n * sizeof(int32_t));
    return (int64_t)ids.size();
}

int bpe_save(void* h, const char* path) {
    BPE& b = *(BPE*)h;
    std::ofstream f(path, std::ios::binary);
    if (!f) return -1;
    uint64_t nv = b.vocab.size(), nm = b.merges.size();
    f.write((char*)&nv, 8);
    f.write((char*)&nm, 8);
    int32_t unk = b.unk_id;
    f.write((char*)&unk, 4);
    for (auto& t : b.vocab) {
        uint32_t len = (uint32_t)t.size();
        f.write((char*)&len, 4);
        f.write(t.data(), len);
    }
    for (auto& m : b.merges) {
        int32_t a = m.first, c = m.second;
        f.write((char*)&a, 4);
        f.write((char*)&c, 4);
    }
    return 0;
}

int bpe_load_file(void* h, const char* path) {
    BPE& b = *(BPE*)h;
    std::ifstream f(path, std::ios::binary);
    if (!f) return -1;
    uint64_t nv, nm;
    f.read((char*)&nv, 8);
    f.read((char*)&nm, 8);
    int32_t unk;
    f.read((char*)&unk, 4);
    b.unk_id = unk;
    b.vocab.clear();
    b.token_to_id.clear();
    for (uint64_t i = 0; i < nv; ++i) {
        uint32_t len;
        f.read((char*)&len, 4);
        std::string t(len, 0);
        f.read(&t[0], len);
        b.token_to_id.emplace(t, (int)b.vocab.size());
        b.vocab.push_back(std::move(t));
    }
    b.merges.clear();
    b.merge_rank.clear();
    for (uint64_t i = 0; i < nm; ++i) {
        int32_t a, c;
        f.read((char*)&a, 4);
        f.read((char*)&c, 4);
        b.merge_rank[{a, c}] = (int)i;
        b.merges.push_back({a, c});
    }
    return 0;
}

}  // extern "C"
