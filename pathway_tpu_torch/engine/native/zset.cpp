// Native z-set kernel: consolidation, keyed state, multiset arrangements.
//
// Reference parity: the hot inner loops the reference gets from
// differential-dataflow's arrange/consolidate machinery
// (reference/external/differential-dataflow/, used via
// src/engine/dataflow.rs ArrangeWithTypes) — here as a small C ABI library
// driven from the Python engine through ctypes.
//
// Data model: rows are interned Python-side; this library only sees
//   key   = 128-bit row key (lo, hi)
//   token = u64 intern id of the row payload
//   diff  = i64 multiplicity delta
// so every loop is flat integer hashing — no Python object traffic.
//
// Build: g++ -O3 -shared -fPIC (engine/native/__init__.py drives it).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key128 {
    uint64_t lo, hi;
    bool operator==(const Key128& o) const { return lo == o.lo && hi == o.hi; }
};

struct Key128Hash {
    size_t operator()(const Key128& k) const {
        // splitmix-style fold of the two halves
        uint64_t x = k.lo ^ (k.hi * 0x9E3779B97F4A7C15ull);
        x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
        x ^= x >> 27; x *= 0x94D049BB133111EBull;
        x ^= x >> 31;
        return static_cast<size_t>(x);
    }
};

struct PairHash {
    size_t operator()(const std::pair<Key128, uint64_t>& p) const {
        return Key128Hash{}(p.first) * 1099511628211ull ^ p.second;
    }
};
struct PairEq {
    bool operator()(const std::pair<Key128, uint64_t>& a,
                    const std::pair<Key128, uint64_t>& b) const {
        return a.first == b.first && a.second == b.second;
    }
};

// keyed state: key -> payload token (healthy table, one row per key)
struct KeyedState {
    std::unordered_map<Key128, uint64_t, Key128Hash> rows;
};

// arrangement: dkey token -> { payload token -> count }
struct Arrangement {
    std::unordered_map<uint64_t, std::unordered_map<uint64_t, int64_t>> groups;
};

}  // namespace

extern "C" {

// ------------------------------------------------------------- consolidate

// Sums diffs of identical (key, token) pairs in place; returns new length.
// Arrays are rewritten with the consolidated entries (order unspecified).
int64_t zs_consolidate(int64_t n, uint64_t* key_lo, uint64_t* key_hi,
                       uint64_t* token, int64_t* diff) {
    std::unordered_map<std::pair<Key128, uint64_t>, int64_t, PairHash, PairEq>
        acc;
    acc.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        acc[{Key128{key_lo[i], key_hi[i]}, token[i]}] += diff[i];
    }
    int64_t m = 0;
    for (const auto& kv : acc) {
        if (kv.second == 0) continue;
        key_lo[m] = kv.first.first.lo;
        key_hi[m] = kv.first.first.hi;
        token[m] = kv.first.second;
        diff[m] = kv.second;
        ++m;
    }
    return m;
}

// Z-set difference A ⊖ B in one pass: sums A's diffs, subtracts B's,
// compacts non-zero entries into the OUT arrays (order unspecified).
// The iterate scope's per-round feedback identity (capture wave delta
// minus this round's external push, engine/runtime.py IterateNode) is
// exactly this kernel; out arrays must hold n_a + n_b entries.
int64_t zs_difference(int64_t n_a, const uint64_t* a_lo, const uint64_t* a_hi,
                      const uint64_t* a_tok, const int64_t* a_diff,
                      int64_t n_b, const uint64_t* b_lo, const uint64_t* b_hi,
                      const uint64_t* b_tok, const int64_t* b_diff,
                      uint64_t* out_lo, uint64_t* out_hi, uint64_t* out_tok,
                      int64_t* out_diff) {
    std::unordered_map<std::pair<Key128, uint64_t>, int64_t, PairHash, PairEq>
        acc;
    acc.reserve(static_cast<size_t>(n_a + n_b));
    for (int64_t i = 0; i < n_a; ++i) {
        acc[{Key128{a_lo[i], a_hi[i]}, a_tok[i]}] += a_diff[i];
    }
    for (int64_t i = 0; i < n_b; ++i) {
        acc[{Key128{b_lo[i], b_hi[i]}, b_tok[i]}] -= b_diff[i];
    }
    int64_t m = 0;
    for (const auto& kv : acc) {
        if (kv.second == 0) continue;
        out_lo[m] = kv.first.first.lo;
        out_hi[m] = kv.first.first.hi;
        out_tok[m] = kv.first.second;
        out_diff[m] = kv.second;
        ++m;
    }
    return m;
}

// ------------------------------------------------------------ keyed state

void* zs_keyed_new() { return new KeyedState(); }
void zs_keyed_free(void* h) { delete static_cast<KeyedState*>(h); }

// Applies a batch. For diff>0 insert/overwrite; diff<0 deletes only when the
// stored token matches (same guard as the Python KeyedState).
void zs_keyed_update(void* h, int64_t n, const uint64_t* key_lo,
                     const uint64_t* key_hi, const uint64_t* token,
                     const int64_t* diff) {
    auto* st = static_cast<KeyedState*>(h);
    for (int64_t i = 0; i < n; ++i) {
        Key128 k{key_lo[i], key_hi[i]};
        if (diff[i] > 0) {
            st->rows[k] = token[i];
        } else if (diff[i] < 0) {
            auto it = st->rows.find(k);
            if (it != st->rows.end() && it->second == token[i]) {
                st->rows.erase(it);
            }
        }
    }
}

// Batch lookup: out_token[i] = token or UINT64_MAX when absent.
void zs_keyed_get(void* h, int64_t n, const uint64_t* key_lo,
                  const uint64_t* key_hi, uint64_t* out_token) {
    auto* st = static_cast<KeyedState*>(h);
    for (int64_t i = 0; i < n; ++i) {
        auto it = st->rows.find(Key128{key_lo[i], key_hi[i]});
        out_token[i] = (it == st->rows.end()) ? UINT64_MAX : it->second;
    }
}

int64_t zs_keyed_len(void* h) {
    return static_cast<int64_t>(static_cast<KeyedState*>(h)->rows.size());
}

// Dump all (key, token) pairs; returns count. Buffers must hold zs_keyed_len.
int64_t zs_keyed_items(void* h, uint64_t* key_lo, uint64_t* key_hi,
                       uint64_t* token) {
    auto* st = static_cast<KeyedState*>(h);
    int64_t i = 0;
    for (const auto& kv : st->rows) {
        key_lo[i] = kv.first.lo;
        key_hi[i] = kv.first.hi;
        token[i] = kv.second;
        ++i;
    }
    return i;
}

// ------------------------------------------------------------ arrangement

void* zs_arr_new() { return new Arrangement(); }
void zs_arr_free(void* h) { delete static_cast<Arrangement*>(h); }

void zs_arr_update(void* h, int64_t n, const uint64_t* dkey,
                   const uint64_t* token, const int64_t* diff) {
    auto* arr = static_cast<Arrangement*>(h);
    for (int64_t i = 0; i < n; ++i) {
        auto& group = arr->groups[dkey[i]];
        int64_t c = (group[token[i]] += diff[i]);
        if (c == 0) {
            group.erase(token[i]);
            if (group.empty()) arr->groups.erase(dkey[i]);
        }
    }
}

// Number of (token, count) entries under dkey.
int64_t zs_arr_group_size(void* h, uint64_t dkey) {
    auto* arr = static_cast<Arrangement*>(h);
    auto it = arr->groups.find(dkey);
    return it == arr->groups.end() ? 0
                                   : static_cast<int64_t>(it->second.size());
}

// Fills out_token/out_count for dkey; returns entry count.
int64_t zs_arr_get(void* h, uint64_t dkey, uint64_t* out_token,
                   int64_t* out_count) {
    auto* arr = static_cast<Arrangement*>(h);
    auto it = arr->groups.find(dkey);
    if (it == arr->groups.end()) return 0;
    int64_t i = 0;
    for (const auto& kv : it->second) {
        out_token[i] = kv.first;
        out_count[i] = kv.second;
        ++i;
    }
    return i;
}

// Total count (sum of multiplicities) under dkey.
int64_t zs_arr_group_count(void* h, uint64_t dkey) {
    auto* arr = static_cast<Arrangement*>(h);
    auto it = arr->groups.find(dkey);
    if (it == arr->groups.end()) return 0;
    int64_t total = 0;
    for (const auto& kv : it->second) total += kv.second;
    return total;
}

// Delta join: for each input (dkey, diff) pair, cross with the OTHER side's
// current group. Emits flattened (input_index, other_token, other_count)
// triples. Returns number of triples; if it exceeds cap, returns the
// required size negated (caller re-allocates and retries).
int64_t zs_arr_delta_join(void* other_handle, int64_t n, const uint64_t* dkey,
                          int64_t cap, int64_t* out_input_idx,
                          uint64_t* out_token, int64_t* out_count) {
    auto* other = static_cast<Arrangement*>(other_handle);
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        auto it = other->groups.find(dkey[i]);
        if (it == other->groups.end()) continue;
        for (const auto& kv : it->second) {
            if (m < cap) {
                out_input_idx[m] = i;
                out_token[m] = kv.first;
                out_count[m] = kv.second;
            }
            ++m;
        }
    }
    return (m <= cap) ? m : -m;
}

}  // extern "C"

// ---------------------------------------------------------- group reduce
//
// Semigroup aggregation: the engine's groupby hot path for invertible
// reducers (count / sum / avg). Mirrors differential's semigroup reducer
// dispatch (reference/src/engine/reduce.rs:40 `ReducerImpl` vs
// `SemigroupReducerImpl`, applied at dataflow.rs:2715) — per-group
// aggregates are delta-updated in O(batch), never recomputed from the
// group's full multiset.
//
// Value model per (group, reducer): exact int64 sum, double sum, row
// count, and an `err` count of rows whose argument was not numeric
// (ERROR poison, None, strings). Bad rows never enter the sums, so when
// they are retracted the aggregate recovers exactly — same observable
// behavior as the Python recompute path.

namespace {

struct GroupAgg {
    int64_t n_red;
    std::vector<int64_t> kinds;  // 0=count, 1=sum, 2=avg (kind semantics live in Python)
    struct Slot {
        int64_t isum = 0;
        double fsum = 0.0;
        int64_t cnt = 0;    // sum of diffs of rows contributing to this reducer
        int64_t fseen = 0;  // count of float-typed contributions (for int/float result typing)
        int64_t err = 0;    // rows with non-numeric argument
        // i64 aggregate overflow is unrecoverable (the pre-overflow value
        // is lost), so it poisons the slot permanently -> ERROR output
        // rather than a silently wrapped sum.
        uint8_t overflow = 0;
    };
    struct G {
        int64_t total = 0;  // sum of diffs over the group (row count)
        std::vector<Slot> slots;
    };
    std::unordered_map<uint64_t, G> groups;
};

}  // namespace

extern "C" {

void* zs_agg_new(int64_t n_red, const int64_t* kinds) {
    auto* h = new GroupAgg();
    h->n_red = n_red;
    h->kinds.assign(kinds, kinds + n_red);
    return h;
}

void zs_agg_free(void* h) { delete static_cast<GroupAgg*>(h); }

// Batch update. Value arrays are reducer-major: vals_*[r * n + i].
// vals_tag: 0 = int64 contribution (vals_i), 1 = double (vals_f),
// 2 = non-numeric (error bucket). Writes the affected unique groups'
// post-update state to the out arrays (out_* are [m * n_red] reducer-minor
// per group; out_g/out_total are [m]); returns m <= n.
int64_t zs_agg_update(void* h, int64_t n, const uint64_t* gtoken,
                      const int64_t* vals_i, const double* vals_f,
                      const uint8_t* vals_tag, const int64_t* diff,
                      uint64_t* out_g, int64_t* out_total, int64_t* out_i,
                      double* out_f, int64_t* out_cnt, uint8_t* out_flags) {
    auto* agg = static_cast<GroupAgg*>(h);
    const int64_t r_n = agg->n_red;
    std::vector<uint64_t> order;
    order.reserve(16);
    std::unordered_map<uint64_t, char> seen;
    seen.reserve(16);
    for (int64_t i = 0; i < n; ++i) {
        auto& g = agg->groups[gtoken[i]];
        if (g.slots.empty()) g.slots.resize(static_cast<size_t>(r_n));
        g.total += diff[i];
        for (int64_t r = 0; r < r_n; ++r) {
            auto& s = g.slots[static_cast<size_t>(r)];
            const int64_t j = r * n + i;
            switch (vals_tag[j]) {
                case 0: {
                    int64_t term, next;
                    if (__builtin_mul_overflow(vals_i[j], diff[i], &term) ||
                        __builtin_add_overflow(s.isum, term, &next)) {
                        s.overflow = 1;
                    } else {
                        s.isum = next;
                    }
                    s.cnt += diff[i];
                    break;
                }
                case 1:
                    s.fsum += vals_f[j] * diff[i];
                    s.cnt += diff[i];
                    s.fseen += diff[i];
                    break;
                default:
                    s.err += diff[i];
                    break;
            }
        }
        if (!seen.count(gtoken[i])) {
            seen.emplace(gtoken[i], 1);
            order.push_back(gtoken[i]);
        }
    }
    int64_t m = 0;
    for (uint64_t gt : order) {
        auto it = agg->groups.find(gt);
        out_g[m] = gt;
        if (it == agg->groups.end()) {
            out_total[m] = 0;
        } else {
            auto& g = it->second;
            out_total[m] = g.total;
            for (int64_t r = 0; r < r_n; ++r) {
                auto& s = g.slots[static_cast<size_t>(r)];
                out_i[m * r_n + r] = s.isum;
                out_f[m * r_n + r] = s.fsum;
                out_cnt[m * r_n + r] = s.cnt;
                out_flags[m * r_n + r] = static_cast<uint8_t>(
                    ((s.err != 0 || s.overflow) ? 2 : 0) | (s.fseen != 0 ? 1 : 0));
            }
            if (g.total == 0) agg->groups.erase(it);
        }
        ++m;
    }
    return m;
}

int64_t zs_agg_len(void* h) {
    return static_cast<int64_t>(static_cast<GroupAgg*>(h)->groups.size());
}

// Full-state export/import for operator checkpointing (the engine's
// equivalent of the reference's operator snapshots,
// reference/src/persistence/operator_snapshot.rs). Slot arrays are
// [m * n_red] reducer-minor per group; caller sizes them via zs_agg_len.
int64_t zs_agg_export(void* h, uint64_t* out_g, int64_t* out_total,
                      int64_t* out_isum, double* out_fsum, int64_t* out_cnt,
                      int64_t* out_fseen, int64_t* out_err, uint8_t* out_ovf) {
    auto* agg = static_cast<GroupAgg*>(h);
    const int64_t r_n = agg->n_red;
    int64_t m = 0;
    for (auto& [gt, g] : agg->groups) {
        out_g[m] = gt;
        out_total[m] = g.total;
        for (int64_t r = 0; r < r_n; ++r) {
            auto& s = g.slots[static_cast<size_t>(r)];
            out_isum[m * r_n + r] = s.isum;
            out_fsum[m * r_n + r] = s.fsum;
            out_cnt[m * r_n + r] = s.cnt;
            out_fseen[m * r_n + r] = s.fseen;
            out_err[m * r_n + r] = s.err;
            out_ovf[m * r_n + r] = s.overflow;
        }
        ++m;
    }
    return m;
}

void zs_agg_import(void* h, int64_t m, const uint64_t* g_in,
                   const int64_t* total, const int64_t* isum,
                   const double* fsum, const int64_t* cnt,
                   const int64_t* fseen, const int64_t* err,
                   const uint8_t* ovf) {
    auto* agg = static_cast<GroupAgg*>(h);
    const int64_t r_n = agg->n_red;
    agg->groups.clear();
    for (int64_t i = 0; i < m; ++i) {
        auto& g = agg->groups[g_in[i]];
        g.total = total[i];
        g.slots.resize(static_cast<size_t>(r_n));
        for (int64_t r = 0; r < r_n; ++r) {
            auto& s = g.slots[static_cast<size_t>(r)];
            s.isum = isum[i * r_n + r];
            s.fsum = fsum[i * r_n + r];
            s.cnt = cnt[i * r_n + r];
            s.fseen = fseen[i * r_n + r];
            s.err = err[i * r_n + r];
            s.overflow = ovf[i * r_n + r];
        }
    }
}

// --------------------------------------------------------- line tokenizer

// Splits a byte buffer into lines; writes (start, end) offsets per line,
// handling \n and \r\n. Returns line count; negative = required capacity.
int64_t zs_split_lines(const char* data, int64_t len, int64_t cap,
                       int64_t* out_start, int64_t* out_end) {
    int64_t count = 0;
    int64_t start = 0;
    for (int64_t i = 0; i < len; ++i) {
        if (data[i] == '\n') {
            int64_t end = (i > start && data[i - 1] == '\r') ? i - 1 : i;
            if (count < cap) {
                out_start[count] = start;
                out_end[count] = end;
            }
            ++count;
            start = i + 1;
        }
    }
    if (start < len) {
        if (count < cap) {
            out_start[count] = start;
            out_end[count] = (len > start && data[len - 1] == '\r') ? len - 1 : len;
        }
        ++count;
    }
    return count <= cap ? count : -count;
}

// CSV RECORD splitter: like zs_split_lines but newlines inside RFC-4180
// quoted fields do NOT terminate a record. Returns record count; negative =
// required capacity.
int64_t zs_split_csv_records(const char* data, int64_t len, int64_t cap,
                             int64_t* out_start, int64_t* out_end) {
    int64_t count = 0;
    int64_t start = 0;
    bool in_quote = false;
    for (int64_t i = 0; i < len; ++i) {
        char c = data[i];
        if (c == '"') {
            if (in_quote && i + 1 < len && data[i + 1] == '"') {
                ++i;  // escaped quote
            } else {
                in_quote = !in_quote;
            }
        } else if (c == '\n' && !in_quote) {
            int64_t end = (i > start && data[i - 1] == '\r') ? i - 1 : i;
            if (count < cap) {
                out_start[count] = start;
                out_end[count] = end;
            }
            ++count;
            start = i + 1;
        }
    }
    if (start < len) {
        if (count < cap) {
            out_start[count] = start;
            out_end[count] = (len > start && data[len - 1] == '\r') ? len - 1 : len;
        }
        ++count;
    }
    return count <= cap ? count : -count;
}

// CSV field splitter for ONE line (RFC-4180 quoting). Writes field
// boundaries (start, end, needs_unquote flag packed in a third array).
// Returns field count; negative = required capacity.
int64_t zs_split_csv_fields(const char* data, int64_t len, char delim,
                            int64_t cap, int64_t* out_start, int64_t* out_end,
                            int64_t* out_quoted) {
    int64_t count = 0;
    int64_t i = 0;
    while (true) {
        int64_t start = i;
        int64_t quoted = 0;
        if (i < len && data[i] == '"') {
            quoted = 1;
            ++i;
            while (i < len) {
                if (data[i] == '"') {
                    if (i + 1 < len && data[i + 1] == '"') {
                        i += 2;  // escaped quote
                        continue;
                    }
                    ++i;
                    break;
                }
                ++i;
            }
            // skip to delimiter
            while (i < len && data[i] != delim) ++i;
        } else {
            while (i < len && data[i] != delim) ++i;
        }
        if (count < cap) {
            out_start[count] = start;
            out_end[count] = i;
            out_quoted[count] = quoted;
        }
        ++count;
        if (i >= len) break;
        ++i;  // skip delimiter
        if (i == len) {  // trailing delimiter -> empty last field
            if (count < cap) {
                out_start[count] = i;
                out_end[count] = i;
                out_quoted[count] = 0;
            }
            ++count;
            break;
        }
    }
    return count <= cap ? count : -count;
}

}  // extern "C"
