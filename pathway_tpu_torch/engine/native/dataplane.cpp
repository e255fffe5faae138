// Native data plane: token-resident rows for the dataflow hot path.
//
// Reference parity: the reference keeps every production row inside the
// Rust engine as typed `Value`s flowing through differential arrangements
// (reference/src/engine/dataflow.rs:2270,2991,5506 and the vendored
// differential-dataflow); Python only appears at UDF boundaries. This
// library gives the Python engine the same property: rows are interned
// ONCE at ingest into canonical serialized bytes (the exact byte format of
// internals/keys._serialize_value, so 128-bit row keys computed here are
// bit-identical to the Python ones), and from then on a batch is four flat
// arrays (key_lo, key_hi, token, diff). Parsing, key hashing, group
// projection, shard routing, row building and output formatting all run
// here, one call per batch, with the GIL released (ctypes).
//
// Value piece format (must stay byte-identical to keys._serialize_value):
//   0x00                        None
//   0x01 u8                     bool
//   0x02 i64-le                 int
//   0x03 f64-le                 float
//   0x04 i64-le len, utf8       str
//   0x05 i64-le len, raw        bytes
// A row is the concatenation of its column pieces. key_for_values(row) =
// blake2b-128(row bytes), exactly like the Python side.
//
// Build: g++ -O3 -shared -fPIC (engine/native/dataplane.py drives it).

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// ------------------------------------------------------------- blake2b-128
// RFC 7693, sequential mode, no key. Digest size 16 bytes — must match
// hashlib.blake2b(data, digest_size=16).

constexpr uint64_t B2B_IV[8] = {
    0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
    0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
    0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};

constexpr uint8_t B2B_SIGMA[12][16] = {
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

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;  // little-endian hosts only (x86/arm)
}

struct Blake2b {
    uint64_t h[8];
    uint8_t buf[128];
    size_t buflen = 0;
    uint64_t t = 0;  // total bytes compressed (fits u64 for our sizes)

    explicit Blake2b(size_t digest_len) {
        for (int i = 0; i < 8; ++i) h[i] = B2B_IV[i];
        h[0] ^= 0x01010000ull ^ static_cast<uint64_t>(digest_len);
    }

    void compress(const uint8_t* block, bool last) {
        uint64_t v[16], m[16];
        for (int i = 0; i < 8; ++i) v[i] = h[i];
        for (int i = 0; i < 8; ++i) v[i + 8] = B2B_IV[i];
        v[12] ^= t;  // t_lo (t_hi stays 0 for < 2^64 bytes)
        if (last) v[14] = ~v[14];
        for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);
        for (int r = 0; r < 12; ++r) {
            const uint8_t* s = B2B_SIGMA[r];
#define B2B_G(a, b, c, d, x, y)                                   \
    v[a] = v[a] + v[b] + (x); v[d] = rotr64(v[d] ^ v[a], 32);     \
    v[c] = v[c] + v[d];       v[b] = rotr64(v[b] ^ v[c], 24);     \
    v[a] = v[a] + v[b] + (y); v[d] = rotr64(v[d] ^ v[a], 16);     \
    v[c] = v[c] + v[d];       v[b] = rotr64(v[b] ^ v[c], 63);
            B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]])
            B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]])
            B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]])
            B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]])
            B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]])
            B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]])
            B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]])
            B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]])
#undef B2B_G
        }
        for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
    }

    void update(const uint8_t* data, size_t len) {
        while (len > 0) {
            if (buflen == 128) {  // buffer full AND more coming -> compress
                t += 128;
                compress(buf, false);
                buflen = 0;
            }
            size_t take = 128 - buflen;
            if (take > len) take = len;
            std::memcpy(buf + buflen, data, take);
            buflen += take;
            data += take;
            len -= take;
        }
    }

    // 128-bit digest as (lo, hi) halves of the little-endian digest bytes:
    // Python does int.from_bytes(digest, "little"), so digest[0:8] is the
    // LOW u64 and digest[8:16] the HIGH u64 of the 128-bit key.
    void final128(uint64_t* lo, uint64_t* hi) {
        t += buflen;
        std::memset(buf + buflen, 0, 128 - buflen);
        compress(buf, true);
        *lo = h[0];
        *hi = h[1];
    }
};

inline void blake2b_128(const uint8_t* data, size_t len, uint64_t* lo,
                        uint64_t* hi) {
    Blake2b b(16);
    b.update(data, len);
    b.final128(lo, hi);
}

// ------------------------------------------------------------- intern table
//
// Canonical row/value bytes -> stable u64 token (dense, from 1; 0 invalid).
// Arena-chunked storage keeps pointers stable for the table's lifetime.
// One coarse mutex: callers batch thousands of rows per call, so the lock
// is taken once per batch, not per row.

// Fast non-cryptographic row-bytes hash (8 bytes/step + fmix64 finish).
// Only feeds the intern table's bucket choice — key identity still uses
// blake2b_128 everywhere keys are derived.
static inline uint64_t row_hash(const char* p, size_t len) {
    uint64_t h = 0x9E3779B97F4A7C15ull ^ (static_cast<uint64_t>(len) *
                                          0xA24BAED4963EE407ull);
    while (len >= 8) {
        uint64_t k;
        std::memcpy(&k, p, 8);
        k *= 0xC2B2AE3D27D4EB4Full;
        k = (k << 31) | (k >> 33);
        k *= 0x9E3779B185EBCA87ull;
        h = ((h ^ k) << 27 | (h ^ k) >> 37) * 5 + 0x52DCE729;
        p += 8;
        len -= 8;
    }
    uint64_t tail = 0;
    if (len) std::memcpy(&tail, p, len);
    h ^= tail;
    h ^= h >> 33;
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
    h *= 0xC4CEB9FE1A85EC53ull;
    h ^= h >> 33;
    return h ? h : 1;  // 0 marks an empty slot
}

struct InternTable {
    std::shared_mutex mu;
    std::vector<char*> chunks;
    size_t chunk_used = 0;
    static constexpr size_t CHUNK = 1 << 22;  // 4 MiB
    // Flat open-addressing hash map (linear probing, stored hashes):
    // node-based unordered_map was the build_rows/ingest bottleneck at
    // 10M+ rows (pointer-chasing cache misses made interning superlinear
    // in practice — ~12x slower per row at 5M inputs than at 1M).
    std::vector<uint64_t> slot_hash;  // 0 = empty
    std::vector<uint64_t> slot_id;
    size_t slot_mask;
    std::vector<std::pair<const char*, int64_t>> items;  // token-1 -> (ptr,len)
    std::vector<uint64_t> item_hash;                     // token-1 -> row_hash

    InternTable() : slot_hash(1 << 16, 0), slot_id(1 << 16), slot_mask((1 << 16) - 1) {
        items.reserve(1024);
        item_hash.reserve(1024);
    }

    ~InternTable() {
        for (char* c : chunks) std::free(c);
    }

    const char* arena_put(const char* data, size_t len) {
        if (chunks.empty() || chunk_used + len > CHUNK) {
            size_t sz = len > CHUNK ? len : CHUNK;
            chunks.push_back(static_cast<char*>(std::malloc(sz)));
            chunk_used = 0;
        }
        char* dst = chunks.back() + chunk_used;
        std::memcpy(dst, data, len);
        chunk_used += len;
        return dst;
    }

    void rehash_locked(size_t new_slots) {
        slot_hash.assign(new_slots, 0);
        slot_id.assign(new_slots, 0);
        slot_mask = new_slots - 1;
        for (size_t k = 0; k < items.size(); ++k) {
            size_t i = item_hash[k] & slot_mask;
            while (slot_hash[i]) i = (i + 1) & slot_mask;
            slot_hash[i] = item_hash[k];
            slot_id[i] = k + 1;
        }
    }


    // caller must hold mu
    uint64_t intern_locked(const char* data, int64_t len) {
        uint64_t hv = row_hash(data, static_cast<size_t>(len));
        size_t i = hv & slot_mask;
        while (slot_hash[i]) {
            if (slot_hash[i] == hv) {
                auto& it = items[slot_id[i] - 1];
                if (it.second == len &&
                    std::memcmp(it.first, data, static_cast<size_t>(len)) == 0)
                    return slot_id[i];
            }
            i = (i + 1) & slot_mask;
        }
        const char* stored = arena_put(data, static_cast<size_t>(len));
        uint64_t id = items.size() + 1;
        items.emplace_back(stored, len);
        item_hash.push_back(hv);
        if (items.size() * 10 >= (slot_mask + 1) * 7) {
            rehash_locked(2 * (slot_mask + 1));  // keep load factor < 0.7
        } else {
            slot_hash[i] = hv;
            slot_id[i] = id;
        }
        return id;
    }

    bool get(uint64_t id, const char** ptr, int64_t* len) {
        if (id == 0 || id > items.size()) return false;
        *ptr = items[id - 1].first;
        *len = items[id - 1].second;
        return true;
    }
};

// ----------------------------------------------------------- piece helpers

constexpr uint8_t TAG_NONE = 0x00, TAG_BOOL = 0x01, TAG_INT = 0x02,
                  TAG_FLOAT = 0x03, TAG_STR = 0x04, TAG_BYTES = 0x05,
                  TAG_KEY = 0x06;
// Plane-internal ERROR poison marker (self-describing, 1 byte). NOT part
// of keys._serialize_value: rows carrying it never feed key hashing —
// group keys for ERROR groups are computed Python-side canonically, and
// join keys containing it are dropped (forbid_tag below).
constexpr uint8_t TAG_ERROR = 0x0E;

inline void put_i64(std::string& out, int64_t v) {
    char b[8];
    std::memcpy(b, &v, 8);
    out.append(b, 8);
}

inline void put_f64(std::string& out, double v) {
    char b[8];
    std::memcpy(b, &v, 8);
    out.append(b, 8);
}

inline void piece_none(std::string& out) { out.push_back(static_cast<char>(TAG_NONE)); }
inline void piece_bool(std::string& out, bool v) {
    out.push_back(static_cast<char>(TAG_BOOL));
    out.push_back(v ? '\x01' : '\x00');
}
inline void piece_int(std::string& out, int64_t v) {
    out.push_back(static_cast<char>(TAG_INT));
    put_i64(out, v);
}
inline void piece_float(std::string& out, double v) {
    out.push_back(static_cast<char>(TAG_FLOAT));
    put_f64(out, v);
}
inline void piece_str(std::string& out, const char* s, int64_t len) {
    out.push_back(static_cast<char>(TAG_STR));
    put_i64(out, len);
    out.append(s, static_cast<size_t>(len));
}

inline void piece_key(std::string& out, uint64_t lo, uint64_t hi) {
    out.push_back(static_cast<char>(TAG_KEY));
    char b[16];
    std::memcpy(b, &lo, 8);
    std::memcpy(b + 8, &hi, 8);
    out.append(b, 16);  // 128-bit key, little-endian (keys.py Key piece)
}

// Walk one piece starting at p (within [p, end)); returns pointer past it,
// or nullptr on malformed/unsupported data.
inline const char* skip_piece(const char* p, const char* end) {
    if (p >= end) return nullptr;
    uint8_t tag = static_cast<uint8_t>(*p++);
    switch (tag) {
        case TAG_NONE: return p;
        case TAG_ERROR: return p;
        case TAG_BOOL: return p + 1 <= end ? p + 1 : nullptr;
        case TAG_INT:
        case TAG_FLOAT: return p + 8 <= end ? p + 8 : nullptr;
        case TAG_KEY: return p + 16 <= end ? p + 16 : nullptr;
        case TAG_STR:
        case TAG_BYTES: {
            if (p + 8 > end) return nullptr;
            int64_t len;
            std::memcpy(&len, p, 8);
            p += 8;
            if (len < 0 || p + len > end) return nullptr;
            return p + len;
        }
        default: return nullptr;  // tuples/ndarrays etc. never enter the plane
    }
}

// Locate the [start, end) byte range of each requested column piece in a
// row. col_idx may be in any order (and repeat). Returns false on
// malformed rows or out-of-range columns.
inline bool find_cols(const char* row, int64_t row_len, const int64_t* col_idx,
                      int64_t n_cols, const char** starts, const char** ends) {
    int64_t max_want = -1;
    for (int64_t j = 0; j < n_cols; ++j)
        if (col_idx[j] > max_want) max_want = col_idx[j];
    // one walk records every piece boundary up to the furthest column
    const char* bounds[2 * 64];  // start/end interleaved; 64 cols is plenty
    std::vector<const char*> big;
    const char** bp = bounds;
    if (max_want >= 64) {
        big.resize(static_cast<size_t>(2 * (max_want + 1)));
        bp = big.data();
    }
    const char* p = row;
    const char* end = row + row_len;
    for (int64_t c = 0; c <= max_want; ++c) {
        const char* nxt = skip_piece(p, end);
        if (nxt == nullptr) return false;
        bp[2 * c] = p;
        bp[2 * c + 1] = nxt;
        p = nxt;
    }
    for (int64_t j = 0; j < n_cols; ++j) {
        if (col_idx[j] < 0) return false;
        starts[j] = bp[2 * col_idx[j]];
        ends[j] = bp[2 * col_idx[j] + 1];
    }
    return true;
}

// Canonicalize one piece for shard routing (matches workers._canon +
// _serialize_value): bool -> int, integral float -> int (folds -0.0 too).
inline void canon_piece(std::string& out, const char* p, const char* end) {
    uint8_t tag = static_cast<uint8_t>(*p);
    if (tag == TAG_BOOL) {
        piece_int(out, p[1] ? 1 : 0);
        return;
    }
    if (tag == TAG_FLOAT) {
        double v;
        std::memcpy(&v, p + 1, 8);
        // float.is_integer() && int(v) fits i64 -> canonical int form
        if (v == static_cast<int64_t>(v) && v >= -9.223372036854776e18 &&
            v < 9.223372036854776e18) {
            piece_int(out, static_cast<int64_t>(v));
            return;
        }
    }
    out.append(p, static_cast<size_t>(end - p));
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- table api

void* dp_tab_new() { return new InternTable(); }
void dp_tab_free(void* h) { delete static_cast<InternTable*>(h); }
int64_t dp_tab_len(void* h) {
    auto* tab = static_cast<InternTable*>(h);
    std::shared_lock<std::shared_mutex> g(tab->mu);
    return static_cast<int64_t>(tab->items.size());
}

uint64_t dp_tab_intern(void* h, const char* data, int64_t len) {
    auto* tab = static_cast<InternTable*>(h);
    std::unique_lock<std::shared_mutex> g(tab->mu);
    return tab->intern_locked(data, len);
}

// Bytes of a token; returns length, or -1 if unknown. *ptr stays valid for
// the table's lifetime.
int64_t dp_tab_get(void* h, uint64_t id, const char** ptr) {
    auto* tab = static_cast<InternTable*>(h);
    std::shared_lock<std::shared_mutex> g(tab->mu);
    const char* p;
    int64_t len;
    if (!tab->get(id, &p, &len)) return -1;
    *ptr = p;
    return len;
}

// blake2b-128 of raw bytes (the key/hash primitive, bit-identical to
// hashlib.blake2b(digest_size=16) + int.from_bytes(..., "little")).
void dp_hash128(const char* data, int64_t len, uint64_t* lo, uint64_t* hi) {
    blake2b_128(reinterpret_cast<const uint8_t*>(data), static_cast<size_t>(len),
                lo, hi);
}

// Capability bitmask the Python loader consults before enabling
// concurrency that leans on kernel-side guarantees.
//
// Bit 0 — reentrant ingest: dp_ingest_jsonl / dp_ingest_csv keep all
// per-call state on the stack (PendingRows, piece buffers, line memo)
// and touch the shared InternTable only through its shared_mutex: each
// call interns its morsel's rows as ONE batch under a single write-lock
// acquisition (PendingRows::flush), so concurrent morsel decodes into
// one table are safe and the "merge" of their intern batches is simply
// the lock's admission order — token NUMBERING may differ across
// schedules, token->bytes mappings never do. A library missing this
// symbol predates the contract; the loader then degrades morsel decode
// to serial (io/fs.py consults dataplane.ingest_reentrant()).
int64_t dp_abi_flags() { return 1; }

// ------------------------------------------------------------- json parsing

namespace {

struct JsonCursor {
    const char* p;
    const char* end;

    void ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
            ++p;
    }
    bool eat(char c) {
        ws();
        if (p < end && *p == c) {
            ++p;
            return true;
        }
        return false;
    }
};

// Parse a JSON string (cursor at opening quote) into UTF-8 `out`.
bool json_string(JsonCursor& c, std::string& out) {
    if (!c.eat('"')) return false;
    while (c.p < c.end) {
        char ch = *c.p++;
        if (ch == '"') return true;
        if (ch == '\\') {
            if (c.p >= c.end) return false;
            char e = *c.p++;
            switch (e) {
                case '"': out.push_back('"'); break;
                case '\\': out.push_back('\\'); break;
                case '/': out.push_back('/'); break;
                case 'b': out.push_back('\b'); break;
                case 'f': out.push_back('\f'); break;
                case 'n': out.push_back('\n'); break;
                case 'r': out.push_back('\r'); break;
                case 't': out.push_back('\t'); break;
                case 'u': {
                    auto hex4 = [&](uint32_t* v) -> bool {
                        if (c.p + 4 > c.end) return false;
                        uint32_t x = 0;
                        for (int i = 0; i < 4; ++i) {
                            char h = c.p[i];
                            x <<= 4;
                            if (h >= '0' && h <= '9') x |= h - '0';
                            else if (h >= 'a' && h <= 'f') x |= h - 'a' + 10;
                            else if (h >= 'A' && h <= 'F') x |= h - 'A' + 10;
                            else return false;
                        }
                        c.p += 4;
                        *v = x;
                        return true;
                    };
                    uint32_t cp;
                    if (!hex4(&cp)) return false;
                    if (cp >= 0xD800 && cp <= 0xDBFF) {  // surrogate pair
                        if (c.p + 2 <= c.end && c.p[0] == '\\' && c.p[1] == 'u') {
                            c.p += 2;
                            uint32_t lo2;
                            if (!hex4(&lo2) || lo2 < 0xDC00 || lo2 > 0xDFFF)
                                return false;
                            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo2 - 0xDC00);
                        }  // lone surrogate: keep as-is (Python would too)
                    }
                    // utf-8 encode
                    if (cp < 0x80) {
                        out.push_back(static_cast<char>(cp));
                    } else if (cp < 0x800) {
                        out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
                        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                    } else if (cp < 0x10000) {
                        if (cp >= 0xD800 && cp <= 0xDFFF) return false;  // lone
                        out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
                        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
                        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                    } else {
                        out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
                        out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
                        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
                        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                    }
                    break;
                }
                default: return false;
            }
        } else {
            out.push_back(ch);
        }
    }
    return false;  // unterminated
}

// Skip any JSON value (for fields not in the schema). Returns false on
// malformed input.
bool json_skip(JsonCursor& c) {
    c.ws();
    if (c.p >= c.end) return false;
    char ch = *c.p;
    if (ch == '"') {
        std::string sink;
        return json_string(c, sink);
    }
    if (ch == '{' || ch == '[') {
        char close = ch == '{' ? '}' : ']';
        ++c.p;
        c.ws();
        if (c.p < c.end && *c.p == close) {
            ++c.p;
            return true;
        }
        while (true) {
            if (ch == '{') {
                std::string sink;
                if (!json_string(c, sink)) return false;
                if (!c.eat(':')) return false;
            }
            if (!json_skip(c)) return false;
            c.ws();
            if (c.p >= c.end) return false;
            if (*c.p == ',') {
                ++c.p;
                c.ws();
                continue;
            }
            if (*c.p == close) {
                ++c.p;
                return true;
            }
            return false;
        }
    }
    // literal: true/false/null/number
    if (c.end - c.p >= 4 && std::memcmp(c.p, "true", 4) == 0) { c.p += 4; return true; }
    if (c.end - c.p >= 5 && std::memcmp(c.p, "false", 5) == 0) { c.p += 5; return true; }
    if (c.end - c.p >= 4 && std::memcmp(c.p, "null", 4) == 0) { c.p += 4; return true; }
    const char* start = c.p;
    while (c.p < c.end && (std::strchr("+-0123456789.eE", *c.p) != nullptr)) ++c.p;
    return c.p > start;
}

// Parse a scalar JSON value into a canonical piece. Containers / anomalies
// return false (the caller falls back to Python for the whole line).
//
// `declared` is the schema column's dtype tag (0 = any, TAG_INT/TAG_FLOAT
// for numeric columns): numeric literals coerce LOSSLESSLY to the declared
// type (1.0 in an int column -> int 1; 3 in a float column -> 3.0), so a
// column's token identity never splits on literal spelling — the Python
// parser applies the identical rule (io/fs.py _json_coerce). Lossy cases
// (1.5 in an int column, ints beyond 2^53 in a float column) stay
// literal-faithful / fall back.
bool json_value_piece(JsonCursor& c, std::string& piece, uint8_t declared) {
    c.ws();
    if (c.p >= c.end) return false;
    char ch = *c.p;
    if (ch == '"') {
        std::string s;
        if (!json_string(c, s)) return false;
        piece_str(piece, s.data(), static_cast<int64_t>(s.size()));
        return true;
    }
    if (ch == '{' || ch == '[') return false;  // Json dtype -> Python path
    if (c.end - c.p >= 4 && std::memcmp(c.p, "true", 4) == 0) {
        c.p += 4;
        piece_bool(piece, true);
        return true;
    }
    if (c.end - c.p >= 5 && std::memcmp(c.p, "false", 5) == 0) {
        c.p += 5;
        piece_bool(piece, false);
        return true;
    }
    if (c.end - c.p >= 4 && std::memcmp(c.p, "null", 4) == 0) {
        c.p += 4;
        piece_none(piece);
        return true;
    }
    // number — int unless '.', 'e', 'E' present (json.loads semantics)
    const char* start = c.p;
    bool is_float = false;
    while (c.p < c.end && std::strchr("+-0123456789.eE", *c.p) != nullptr) {
        if (*c.p == '.' || *c.p == 'e' || *c.p == 'E') is_float = true;
        ++c.p;
    }
    if (c.p == start) return false;
    std::string tok(start, static_cast<size_t>(c.p - start));
    if (is_float) {
        char* endp = nullptr;
        double v = std::strtod(tok.c_str(), &endp);
        if (endp != tok.c_str() + tok.size()) return false;
        if (declared == TAG_INT && v == static_cast<int64_t>(v) &&
            v >= -9.007199254740992e15 && v <= 9.007199254740992e15) {
            piece_int(piece, static_cast<int64_t>(v));
        } else {
            piece_float(piece, v);
        }
    } else {
        errno = 0;
        char* endp = nullptr;
        long long v = std::strtoll(tok.c_str(), &endp, 10);
        if (errno == ERANGE || endp != tok.c_str() + tok.size())
            return false;  // bigint -> Python path
        if (declared == TAG_FLOAT) {
            if (v > 9007199254740992ll || v < -9007199254740992ll)
                return false;  // not losslessly representable -> Python
            piece_float(piece, static_cast<double>(v));
        } else {
            piece_int(piece, static_cast<int64_t>(v));
        }
    }
    return true;
}

constexpr uint64_t SEQ_SALT_LO = 0xF39CC0605CEDC834ull;
constexpr uint64_t SEQ_SALT_HI = 0x9E3779B97F4A7C15ull;

// --------------------------------------------------------- cheap key mixes
//
// Plan-gated key elision (internals/planner.py): when the optimizer
// proves a source's row identities are unobservable in any output, scans
// may derive sequential keys with a SplitMix64-based 128-bit mix instead
// of blake2b (measured 175 ns/key — about half the whole jsonl parse).
// Same for join output ids (id_mode 3). The Python mirrors
// (internals/keys.py cheap_sequential_key_at / cheap_join_key) must stay
// bit-identical; tests pin the equality. Keys only need distinctness +
// run-to-run determinism — never derivable content.

inline uint64_t smix64(uint64_t z) {
    z += 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

inline void cheap_seq_key(uint64_t base, uint64_t n, uint64_t* lo,
                          uint64_t* hi) {
    uint64_t x = smix64(base ^ SEQ_SALT_LO);
    *lo = smix64(x ^ n);
    *hi = smix64(*lo + n + SEQ_SALT_HI);
    if (*lo == 0 && *hi == 0) *lo = 1;  // (0,0) is the ERROR sentinel
}

inline void cheap_join_key(uint64_t llo, uint64_t lhi, uint64_t rlo,
                           uint64_t rhi, uint64_t* lo, uint64_t* hi) {
    *lo = smix64(llo ^ smix64(rlo + SEQ_SALT_LO));
    *hi = smix64(lhi ^ smix64(rhi + SEQ_SALT_HI) + *lo);
    if (*lo == 0 && *hi == 0) *lo = 1;
}

// Pending rows of one ingest call: parsed row bytes are accumulated
// lock-free; the intern table's mutex is taken ONCE at the end for the
// whole batch (concurrent chunk parses then overlap almost fully — only
// the hash-map inserts serialize).
struct PendingRows {
    std::string blob;
    std::vector<std::pair<int64_t, int64_t>> spans;  // (offset, len)
    std::vector<int64_t> row_idx;                    // output slot

    void add(const std::string& row_bytes, int64_t i) {
        spans.emplace_back(static_cast<int64_t>(blob.size()),
                           static_cast<int64_t>(row_bytes.size()));
        blob += row_bytes;
        row_idx.push_back(i);
    }

    void intern_all(InternTable* tab, uint64_t* out_token) {
        std::unique_lock<std::shared_mutex> g(tab->mu);
        for (size_t k = 0; k < spans.size(); ++k) {
            out_token[row_idx[k]] = tab->intern_locked(
                blob.data() + spans[k].first, spans[k].second);
        }
    }
};

// Key computation shared by json/csv ingest (no lock needed).
// key_mode 1 = cheap sequential keys (plan-gated id elision; pk sources
// always blake — their keys are content-derived and user-visible).
inline void row_key(const std::string* pieces, const int64_t* pk_idx,
                    int64_t n_pk, uint64_t seq_base, uint64_t seq_no,
                    int64_t key_mode, uint64_t* out_lo, uint64_t* out_hi) {
    if (n_pk > 0) {
        std::string kb;
        for (int64_t j = 0; j < n_pk; ++j) kb += pieces[pk_idx[j]];
        blake2b_128(reinterpret_cast<const uint8_t*>(kb.data()), kb.size(),
                    out_lo, out_hi);
    } else if (key_mode == 1) {
        cheap_seq_key(seq_base, seq_no, out_lo, out_hi);
    } else {
        // sequential_key: blake2b(pack("<QQ", base, n) + SALT_16LE)
        uint8_t kb[32];
        std::memcpy(kb, &seq_base, 8);
        std::memcpy(kb + 8, &seq_no, 8);
        std::memcpy(kb + 16, &SEQ_SALT_LO, 8);
        std::memcpy(kb + 24, &SEQ_SALT_HI, 8);
        blake2b_128(kb, 32, out_lo, out_hi);
    }
}

}  // namespace

// Cheap-key mixes exported for the Python-mirror equality tests
// (internals/keys.cheap_sequential_key_at / cheap_join_key pin
// bit-identity against these).
void dp_cheap_seq_key(uint64_t base, uint64_t n, uint64_t* lo, uint64_t* hi) {
    cheap_seq_key(base, n, lo, hi);
}

void dp_cheap_join_key(uint64_t llo, uint64_t lhi, uint64_t rlo, uint64_t rhi,
                       uint64_t* lo, uint64_t* hi) {
    cheap_join_key(llo, lhi, rlo, rhi, lo, hi);
}

// Parse a chunk of JSON-lines into interned rows.
//
// col_names/col_name_lens: schema column names (utf8), n_cols of them.
// pk_idx/n_pk: primary-key column indices (empty -> sequential keys from
// (seq_base, seq_start + line_no)).
// Outputs per line i (cap = max lines): status[i] 0=ok 1=python-fallback
// 2=blank (skip); line_start/line_end for fallback reparses; token/key
// valid when status==0. Returns number of lines seen (<= cap assumed:
// caller sizes cap by newline count + 1).
int64_t dp_ingest_jsonl(void* h, const char* data, int64_t len, int64_t n_cols,
                        const char** col_names, const int64_t* col_name_lens,
                        const uint8_t* col_tags, const int64_t* pk_idx,
                        int64_t n_pk, uint64_t seq_base, uint64_t seq_start,
                        int64_t key_mode, uint64_t* out_token, uint64_t* out_lo,
                        uint64_t* out_hi, uint8_t* out_status,
                        int64_t* line_start, int64_t* line_end, int64_t cap) {
    auto* tab = static_cast<InternTable*>(h);
    PendingRows pend;
    std::vector<std::string> pieces(static_cast<size_t>(n_cols));
    std::vector<uint8_t> have(static_cast<size_t>(n_cols));
    std::string row_bytes, name;
    // Line-level dictionary: identical raw lines parse to identical row
    // bytes (and, for pk sources, identical content keys), so repeats
    // skip the whole JSON walk. Low-cardinality ingest — a grouped value
    // column, enum-ish event streams — collapses to one parse per
    // distinct line. Keys into the map are views of the input buffer
    // (stable for this call). High-cardinality data pays one hash probe
    // per line until the hit-rate check at MEMO_PROBE lines turns the
    // memo off; inserts stop at MEMO_CAP so adversarial input can't
    // balloon the map.
    struct LineMemo {
        std::string row;
        uint8_t status;
        uint64_t klo, khi;
    };
    constexpr int64_t MEMO_PROBE = 8192;
    constexpr size_t MEMO_CAP = 1 << 16;
    std::unordered_map<std::string_view, LineMemo> memo;
    bool memo_on = true;
    int64_t memo_seen = 0, memo_hits = 0;
    int64_t n_lines = 0;
    const char* p = data;
    const char* end = data + len;
    while (p < end && n_lines < cap) {
        const char* ls = p;
        const char* le = static_cast<const char*>(std::memchr(p, '\n', end - p));
        const char* nxt = le == nullptr ? end : le + 1;
        if (le == nullptr) le = end;
        if (le > ls && le[-1] == '\r') --le;
        int64_t i = n_lines++;
        line_start[i] = ls - data;
        line_end[i] = le - data;
        p = nxt;
        // blank line -> skip
        const char* q = ls;
        while (q < le && (*q == ' ' || *q == '\t')) ++q;
        if (q == le) {
            out_status[i] = 2;
            continue;
        }
        if (memo_on) {
            ++memo_seen;
            auto mit = memo.find(
                std::string_view(ls, static_cast<size_t>(le - ls)));
            if (mit != memo.end()) {
                ++memo_hits;
                const LineMemo& m = mit->second;
                out_status[i] = m.status;
                if (m.status == 0) {
                    pend.add(m.row, i);
                    if (n_pk > 0) {
                        out_lo[i] = m.klo;  // content key: line-determined
                        out_hi[i] = m.khi;
                    } else {
                        row_key(nullptr, nullptr, 0, seq_base,
                                seq_start + static_cast<uint64_t>(i),
                                key_mode, &out_lo[i], &out_hi[i]);
                    }
                }
                continue;
            }
            if (memo_seen == MEMO_PROBE && memo_hits * 8 < memo_seen) {
                memo_on = false;
                memo.clear();
            }
        }
        JsonCursor c{ls, le};
        std::fill(have.begin(), have.end(), 0);
        for (auto& s : pieces) s.clear();
        bool ok = c.eat('{');
        if (ok) {
            c.ws();
            if (c.p < c.end && *c.p == '}') {
                ++c.p;
            } else {
                while (ok) {
                    name.clear();
                    if (!json_string(c, name) || !c.eat(':')) {
                        ok = false;
                        break;
                    }
                    int64_t col = -1;
                    for (int64_t j = 0; j < n_cols; ++j) {
                        if (col_name_lens[j] ==
                                static_cast<int64_t>(name.size()) &&
                            std::memcmp(col_names[j], name.data(),
                                        name.size()) == 0) {
                            col = j;
                            break;
                        }
                    }
                    if (col >= 0) {
                        pieces[col].clear();
                        if (!json_value_piece(c, pieces[col], col_tags[col])) {
                            ok = false;
                            break;
                        }
                        have[col] = 1;
                    } else if (!json_skip(c)) {
                        ok = false;
                        break;
                    }
                    c.ws();
                    if (c.p < c.end && *c.p == ',') {
                        ++c.p;
                        continue;
                    }
                    if (c.p < c.end && *c.p == '}') {
                        ++c.p;
                        break;
                    }
                    ok = false;
                }
            }
        }
        if (ok) {
            c.ws();
            if (c.p != c.end) ok = false;  // trailing junk
        }
        if (!ok) {
            out_status[i] = 1;
            if (memo_on && memo.size() < MEMO_CAP)
                memo.emplace(
                    std::string_view(ls, static_cast<size_t>(le - ls)),
                    LineMemo{std::string(), 1, 0, 0});
            continue;
        }
        row_bytes.clear();
        for (int64_t j = 0; j < n_cols; ++j) {
            if (!have[j]) piece_none(pieces[j]);  // missing -> None
            row_bytes += pieces[j];
        }
        pend.add(row_bytes, i);
        row_key(pieces.data(), pk_idx, n_pk, seq_base,
                seq_start + static_cast<uint64_t>(i), key_mode, &out_lo[i],
                &out_hi[i]);
        out_status[i] = 0;
        if (memo_on && memo.size() < MEMO_CAP)
            memo.emplace(std::string_view(ls, static_cast<size_t>(le - ls)),
                         LineMemo{row_bytes, 0, out_lo[i], out_hi[i]});
    }
    pend.intern_all(tab, out_token);
    return n_lines;
}

// -------------------------------------------------------------- csv ingest

// Parse CSV records (no header; caller maps schema col -> field index via
// field_idx, -1 = missing). dtypes per schema col: 2=int 3=float 1=bool
// 4=str (json/any -> caller must not use native). opt[j]=1 allows None for
// empty fields. Quoting is RFC-4180. Same outputs as dp_ingest_jsonl.
int64_t dp_ingest_csv(void* h, const char* data, int64_t len, char delim,
                      int64_t n_cols, const int64_t* field_idx,
                      const uint8_t* dtypes, const uint8_t* opt,
                      const int64_t* pk_idx, int64_t n_pk, uint64_t seq_base,
                      uint64_t seq_start, int64_t key_mode, uint64_t* out_token,
                      uint64_t* out_lo, uint64_t* out_hi, uint8_t* out_status,
                      int64_t* line_start, int64_t* line_end, int64_t cap) {
    auto* tab = static_cast<InternTable*>(h);
    PendingRows pend;
    std::vector<std::string> fields;
    std::vector<std::string> pieces(static_cast<size_t>(n_cols));
    std::string row_bytes;
    int64_t n_rec = 0;
    const char* p = data;
    const char* end = data + len;
    while (p < end && n_rec < cap) {
        // find record end (newline outside quotes)
        const char* rs = p;
        bool in_q = false;
        const char* re = p;
        while (re < end) {
            char ch = *re;
            if (ch == '"') {
                if (in_q && re + 1 < end && re[1] == '"') ++re;
                else in_q = !in_q;
            } else if (ch == '\n' && !in_q) {
                break;
            }
            ++re;
        }
        const char* nxt = re < end ? re + 1 : end;
        if (re > rs && re[-1] == '\r') --re;
        int64_t i = n_rec++;
        line_start[i] = rs - data;
        line_end[i] = re - data;
        p = nxt;
        if (re == rs) {
            out_status[i] = 2;  // blank
            continue;
        }
        // split fields
        fields.clear();
        const char* f = rs;
        while (true) {
            std::string val;
            if (f < re && *f == '"') {
                ++f;
                while (f < re) {
                    if (*f == '"') {
                        if (f + 1 < re && f[1] == '"') {
                            val.push_back('"');
                            f += 2;
                        } else {
                            ++f;
                            break;
                        }
                    } else {
                        val.push_back(*f++);
                    }
                }
                // junk after closing quote concatenates (csv-module style)
                while (f < re && *f != delim) val.push_back(*f++);
            } else {
                while (f < re && *f != delim) val.push_back(*f++);
            }
            fields.push_back(std::move(val));
            if (f >= re) break;
            ++f;  // skip delim
            if (f == re) {
                fields.emplace_back();
                break;
            }
        }
        bool ok = true;
        for (int64_t j = 0; j < n_cols && ok; ++j) {
            pieces[j].clear();
            int64_t fi = field_idx[j];
            if (fi < 0 || fi >= static_cast<int64_t>(fields.size())) {
                piece_none(pieces[j]);
                continue;
            }
            const std::string& v = fields[static_cast<size_t>(fi)];
            uint8_t dt = dtypes[j];
            if (v.empty() && opt[j]) {
                piece_none(pieces[j]);
                continue;
            }
            switch (dt) {
                case 2: {  // int(value): sign + digits, tolerate spaces
                    size_t a = 0, b = v.size();
                    while (a < b && v[a] == ' ') ++a;
                    while (b > a && v[b - 1] == ' ') --b;
                    size_t d = a;
                    if (d < b && (v[d] == '+' || v[d] == '-')) ++d;
                    bool digits = d < b;
                    for (size_t k = d; k < b; ++k)
                        if (v[k] < '0' || v[k] > '9') { digits = false; break; }
                    if (!digits) {
                        // Python _coerce falls back to the raw string (or
                        // None when Optional)
                        if (opt[j]) piece_none(pieces[j]);
                        else piece_str(pieces[j], v.data(),
                                       static_cast<int64_t>(v.size()));
                        break;
                    }
                    errno = 0;
                    char* endp = nullptr;
                    std::string tok = v.substr(a, b - a);
                    long long x = std::strtoll(tok.c_str(), &endp, 10);
                    if (errno == ERANGE || endp != tok.c_str() + tok.size()) {
                        ok = false;  // bigint etc -> Python line
                        break;
                    }
                    piece_int(pieces[j], x);
                    break;
                }
                case 3: {  // float(value)
                    if (v.find('_') != std::string::npos) { ok = false; break; }
                    char* endp = nullptr;
                    std::string tok = v;
                    // trim spaces (Python float() allows them)
                    size_t a = tok.find_first_not_of(" \t");
                    size_t b = tok.find_last_not_of(" \t");
                    if (a == std::string::npos) {
                        if (opt[j]) { piece_none(pieces[j]); break; }
                        piece_str(pieces[j], v.data(),
                                  static_cast<int64_t>(v.size()));
                        break;
                    }
                    tok = tok.substr(a, b - a + 1);
                    double x = std::strtod(tok.c_str(), &endp);
                    if (endp != tok.c_str() + tok.size()) {
                        if (opt[j]) piece_none(pieces[j]);
                        else piece_str(pieces[j], v.data(),
                                       static_cast<int64_t>(v.size()));
                        break;
                    }
                    piece_float(pieces[j], x);
                    break;
                }
                case 1: {  // bool: strip().lower() in (true,1,yes,on)
                    std::string s;
                    for (char ch : v)
                        if (ch != ' ' && ch != '\t')
                            s.push_back(static_cast<char>(
                                ch >= 'A' && ch <= 'Z' ? ch + 32 : ch));
                    bool tv = s == "true" || s == "1" || s == "yes" || s == "on";
                    piece_bool(pieces[j], tv);
                    break;
                }
                default:  // str
                    piece_str(pieces[j], v.data(), static_cast<int64_t>(v.size()));
            }
        }
        if (!ok) {
            out_status[i] = 1;
            continue;
        }
        row_bytes.clear();
        for (int64_t j = 0; j < n_cols; ++j) row_bytes += pieces[j];
        pend.add(row_bytes, i);
        row_key(pieces.data(), pk_idx, n_pk, seq_base,
                seq_start + static_cast<uint64_t>(i), key_mode, &out_lo[i],
                &out_hi[i]);
        out_status[i] = 0;
    }
    pend.intern_all(tab, out_token);
    return n_rec;
}

// ------------------------------------------------------------ decode / agg

// Decode numeric columns: per (col j, row i) tags[j*n+i]: 0 = int64
// (vals_i), 1 = double (vals_f), 2 = other (None / str / malformed ->
// the aggregation error bucket), 3 = BOOL (vals_i 0/1 — int semantics
// for arithmetic, but the boolness is preserved so vectorized & | ^
// can emit bool-typed results like the Python plane). Callers feeding
// zs_agg must fold tag 3 -> 0 first. Returns 0, or -1-row_index of the
// first malformed row.
int64_t dp_decode_num_cols(void* h, int64_t n, const uint64_t* tokens,
                           const int64_t* col_idx, int64_t n_cols,
                           int64_t* vals_i, double* vals_f, uint8_t* tags) {
    auto* tab = static_cast<InternTable*>(h);
    std::shared_lock<std::shared_mutex> rg(tab->mu);
    std::vector<const char*> starts(static_cast<size_t>(n_cols));
    std::vector<const char*> ends(static_cast<size_t>(n_cols));
    for (int64_t i = 0; i < n; ++i) {
        const char* row;
        int64_t rlen;
        if (!tab->get(tokens[i], &row, &rlen) ||
            !find_cols(row, rlen, col_idx, n_cols, starts.data(), ends.data()))
            return -1 - i;
        for (int64_t j = 0; j < n_cols; ++j) {
            const char* p = starts[j];
            uint8_t tag = static_cast<uint8_t>(*p);
            int64_t o = j * n + i;
            if (tag == TAG_INT) {
                std::memcpy(&vals_i[o], p + 1, 8);
                tags[o] = 0;
            } else if (tag == TAG_FLOAT) {
                std::memcpy(&vals_f[o], p + 1, 8);
                tags[o] = 1;
            } else if (tag == TAG_BOOL) {
                vals_i[o] = p[1] ? 1 : 0;
                tags[o] = 3;
            } else {
                tags[o] = 2;
            }
        }
    }
    return 0;
}

// Decode string columns: offsets into a caller buffer. For col j, row i:
// kind[j*n+i] = 0 str (buf[off..off+len)), 1 None, 2 non-string.
// Returns bytes used, or -needed when cap is too small.
int64_t dp_decode_str_cols(void* h, int64_t n, const uint64_t* tokens,
                           const int64_t* col_idx, int64_t n_cols, char* buf,
                           int64_t cap, int64_t* off, int64_t* slen,
                           uint8_t* kind) {
    auto* tab = static_cast<InternTable*>(h);
    std::shared_lock<std::shared_mutex> rg(tab->mu);
    std::vector<const char*> starts(static_cast<size_t>(n_cols));
    std::vector<const char*> ends(static_cast<size_t>(n_cols));
    int64_t used = 0;
    for (int64_t i = 0; i < n; ++i) {
        const char* row;
        int64_t rlen;
        if (!tab->get(tokens[i], &row, &rlen) ||
            !find_cols(row, rlen, col_idx, n_cols, starts.data(), ends.data()))
            return INT64_MIN;  // malformed: caller falls back wholesale
        for (int64_t j = 0; j < n_cols; ++j) {
            const char* p = starts[j];
            uint8_t tag = static_cast<uint8_t>(*p);
            int64_t o = j * n + i;
            if (tag == TAG_STR) {
                int64_t L;
                std::memcpy(&L, p + 1, 8);
                if (used + L <= cap) {
                    std::memcpy(buf + used, p + 9, static_cast<size_t>(L));
                    off[o] = used;
                    slen[o] = L;
                    kind[o] = 0;
                }
                used += L;
            } else if (tag == TAG_NONE) {
                kind[o] = 1;
                off[o] = slen[o] = 0;
            } else {
                kind[o] = 2;
                off[o] = slen[o] = 0;
            }
        }
    }
    return used <= cap ? used : -used;
}

// --------------------------------------------------- group project + route

// For each row: project columns col_idx -> group bytes; gtoken = intern of
// the group bytes (group identity — matches Python freeze_value(tuple)
// because column dtypes are stable within a native pipeline); shard =
// blake2b(canonical tuple serialization)[0:8] % n_shards when n_shards>0
// (must stay byte-identical to workers._shard_of). Returns 0 or -1-i on
// malformed row i.
// forbid_tag != 0: rows whose projected pieces include that tag get
// gtoken 0 (invalid) instead of a group — join keys must drop ERROR rows
// like the object plane's _jk_of, while group-bys keep them as a group.
int64_t dp_project_group(void* h, int64_t n, const uint64_t* tokens,
                         const int64_t* col_idx, int64_t n_cols,
                         int64_t n_shards, uint64_t* out_gtoken,
                         int64_t* out_shard, uint8_t forbid_tag) {
    auto* tab = static_cast<InternTable*>(h);
    std::vector<const char*> starts(static_cast<size_t>(n_cols));
    std::vector<const char*> ends(static_cast<size_t>(n_cols));
    // dedupe group bytes within the batch LOCK-FREE (distinct groups are
    // typically a small fraction of rows); intern only the distinct set
    // under one short lock at the end.
    std::string blob, gbytes, canon;
    std::unordered_map<std::string_view, int64_t> local;  // gbytes -> gid
    // token -> gid short-circuit: a token names one immutable row, so its
    // projection is fixed; low-cardinality batches (e.g. a single grouped
    // value column) skip the decode+hash for every repeat.
    std::unordered_map<uint64_t, int64_t> tok2gid;
    std::vector<std::pair<int64_t, int64_t>> spans;       // gid -> span
    std::vector<int64_t> shard_of_gid;
    std::vector<int64_t> gid_of_row(static_cast<size_t>(n));
    blob.reserve(1024);
    std::shared_lock<std::shared_mutex> rg(tab->mu);
    for (int64_t i = 0; i < n; ++i) {
        auto memo = tok2gid.find(tokens[i]);
        if (memo != tok2gid.end()) {
            gid_of_row[static_cast<size_t>(i)] = memo->second;
            continue;
        }
        const char* row;
        int64_t rlen;
        if (!tab->get(tokens[i], &row, &rlen) ||
            !find_cols(row, rlen, col_idx, n_cols, starts.data(), ends.data()))
            return -1 - i;
        gbytes.clear();
        bool forbidden = false;
        for (int64_t j = 0; j < n_cols; ++j) {
            if (forbid_tag != 0 &&
                static_cast<uint8_t>(*starts[j]) == forbid_tag)
                forbidden = true;
            gbytes.append(starts[j], static_cast<size_t>(ends[j] - starts[j]));
        }
        if (forbidden) {
            gid_of_row[static_cast<size_t>(i)] = -1;
            tok2gid.emplace(tokens[i], -1);
            continue;
        }
        auto it = local.find(std::string_view(gbytes));
        int64_t gid;
        if (it != local.end()) {
            gid = it->second;
        } else {
            gid = static_cast<int64_t>(spans.size());
            // append to blob; string_view keys must point into the blob,
            // which may reallocate — rebuild the map when it does
            const char* before = blob.data();
            int64_t off = static_cast<int64_t>(blob.size());
            blob += gbytes;
            spans.emplace_back(off, static_cast<int64_t>(gbytes.size()));
            if (blob.data() != before) {
                local.clear();
                for (int64_t g2 = 0; g2 < gid; ++g2)
                    local.emplace(
                        std::string_view(blob.data() + spans[g2].first,
                                         static_cast<size_t>(spans[g2].second)),
                        g2);
            }
            local.emplace(
                std::string_view(blob.data() + spans.back().first,
                                 static_cast<size_t>(spans.back().second)),
                gid);
            if (n_shards > 0) {
                // serialize the canonicalized VALUE TUPLE: \x07+len+pieces
                canon.clear();
                canon.push_back('\x07');
                put_i64(canon, n_cols);
                for (int64_t j = 0; j < n_cols; ++j)
                    canon_piece(canon, starts[j], ends[j]);
                uint64_t lo, hi;
                blake2b_128(reinterpret_cast<const uint8_t*>(canon.data()),
                            canon.size(), &lo, &hi);
                shard_of_gid.push_back(static_cast<int64_t>(
                    lo % static_cast<uint64_t>(n_shards)));
            }
        }
        gid_of_row[static_cast<size_t>(i)] = gid;
        tok2gid.emplace(tokens[i], gid);
    }
    rg.unlock();
    std::vector<uint64_t> gtok(spans.size());
    {
        std::unique_lock<std::shared_mutex> g(tab->mu);
        for (size_t k = 0; k < spans.size(); ++k)
            gtok[k] = tab->intern_locked(blob.data() + spans[k].first,
                                         spans[k].second);
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t gid = gid_of_row[static_cast<size_t>(i)];
        if (gid < 0) {  // forbidden (ERROR join key)
            out_gtoken[i] = 0;
            if (n_shards > 0) out_shard[i] = 0;
            continue;
        }
        out_gtoken[i] = gtok[static_cast<size_t>(gid)];
        if (n_shards > 0) out_shard[i] = shard_of_gid[static_cast<size_t>(gid)];
    }
    return 0;
}

// ---------------------------------------------------------------- rekey

// New record keys from column content: key128 = blake2b-128 of the
// concatenated projected pieces — byte-identical to Python
// key_for_values(*cols) / ref_scalar (with_id_from semantics). Rows whose
// key columns contain forbid_tag (ERROR) get out_lo = out_hi = 0 and the
// caller falls back / drops them like the object plane's key_fn failure.
// Returns 0, or -1-i on malformed row i.
int64_t dp_rekey(void* h, int64_t n, const uint64_t* tokens,
                 const int64_t* col_idx, int64_t n_cols, uint8_t forbid_tag,
                 uint64_t* out_lo, uint64_t* out_hi) {
    auto* tab = static_cast<InternTable*>(h);
    std::vector<const char*> starts(static_cast<size_t>(n_cols));
    std::vector<const char*> ends(static_cast<size_t>(n_cols));
    std::string kb;
    kb.reserve(64);
    std::shared_lock<std::shared_mutex> g(tab->mu);
    for (int64_t i = 0; i < n; ++i) {
        const char* row;
        int64_t rlen;
        if (!tab->get(tokens[i], &row, &rlen) ||
            !find_cols(row, rlen, col_idx, n_cols, starts.data(), ends.data()))
            return -1 - i;
        kb.clear();
        bool forbidden = false;
        for (int64_t j = 0; j < n_cols; ++j) {
            if (forbid_tag != 0 &&
                static_cast<uint8_t>(*starts[j]) == forbid_tag)
                forbidden = true;
            kb.append(starts[j], static_cast<size_t>(ends[j] - starts[j]));
        }
        if (forbidden) {
            out_lo[i] = 0;
            out_hi[i] = 0;
            continue;
        }
        blake2b_128(reinterpret_cast<const uint8_t*>(kb.data()), kb.size(),
                    &out_lo[i], &out_hi[i]);
    }
    return 0;
}

// Salted re-key: new key128 = blake2b-128 of (TAG_KEY piece of the row's
// current key || TAG_INT piece of salt) — byte-identical to Python
// hash_values(key, salt), the concat_reindex per-input disambiguation.
void dp_rekey_salt(int64_t n, const uint64_t* key_lo, const uint64_t* key_hi,
                   int64_t salt, uint64_t* out_lo, uint64_t* out_hi) {
    std::string kb;
    kb.reserve(32);
    for (int64_t i = 0; i < n; ++i) {
        kb.clear();
        piece_key(kb, key_lo[i], key_hi[i]);
        piece_int(kb, salt);
        blake2b_128(reinterpret_cast<const uint8_t*>(kb.data()), kb.size(),
                    &out_lo[i], &out_hi[i]);
    }
}

// Shard by record key: key128 % n (identical to Python `key.value % n`).
void dp_route_key(int64_t n, const uint64_t* key_lo, const uint64_t* key_hi,
                  int64_t n_shards, int64_t* out_shard) {
    uint64_t m = static_cast<uint64_t>(n_shards);
    // 2^64 mod m without 128-bit literals: (2^64 - 1) % m + 1 (mod m)
    uint64_t r64 = (UINT64_MAX % m + 1) % m;
    for (int64_t i = 0; i < n; ++i) {
        out_shard[i] = static_cast<int64_t>(
            ((key_hi[i] % m) * r64 + key_lo[i] % m) % m);
    }
}

// ---------------------------------------------------------------- build rows

// Assemble new rows (select/map output). Output column j comes from:
//   src_kind[j] == 0 -> passthrough of input column src_col[j]
//   src_kind[j] == 1 -> computed from value slot s = src_col[j]:
//                       vtag[s*n+i] 0=int(vals_i) 1=float(vals_f)
//                       2=None 3=bool(vals_i)
//                       4=key128 (lo = vals_i bits, hi = vals_f bits)
//                       255=python-fallback row
// status[i]: 0 ok, 1 fallback (any col with vtag 255 or malformed input).
// Returns 0, or -1 on bad args.
int64_t dp_build_rows(void* h, int64_t n, const uint64_t* in_tokens,
                      int64_t n_out, const int64_t* src_kind,
                      const int64_t* src_col, const int64_t* vals_i,
                      const double* vals_f, const uint8_t* vtag,
                      uint64_t* out_token, uint8_t* out_status) {
    auto* tab = static_cast<InternTable*>(h);
    // passthrough columns, ascending for find_cols
    std::vector<int64_t> pass_cols;
    for (int64_t j = 0; j < n_out; ++j)
        if (src_kind[j] == 0) pass_cols.push_back(src_col[j]);
    std::vector<int64_t> sorted_cols(pass_cols);
    std::sort(sorted_cols.begin(), sorted_cols.end());
    sorted_cols.erase(std::unique(sorted_cols.begin(), sorted_cols.end()),
                      sorted_cols.end());
    std::unordered_map<int64_t, int64_t> col_slot;
    for (size_t k = 0; k < sorted_cols.size(); ++k)
        col_slot[sorted_cols[k]] = static_cast<int64_t>(k);
    std::vector<const char*> starts(sorted_cols.size());
    std::vector<const char*> ends(sorted_cols.size());
    std::string row_bytes;
    PendingRows pend;
    std::shared_lock<std::shared_mutex> rg(tab->mu);
    for (int64_t i = 0; i < n; ++i) {
        bool ok = true;
        if (!sorted_cols.empty()) {
            const char* row;
            int64_t rlen;
            if (!tab->get(in_tokens[i], &row, &rlen) ||
                !find_cols(row, rlen, sorted_cols.data(),
                           static_cast<int64_t>(sorted_cols.size()),
                           starts.data(), ends.data()))
                ok = false;
        }
        row_bytes.clear();
        for (int64_t j = 0; j < n_out && ok; ++j) {
            if (src_kind[j] == 0) {
                int64_t slot = col_slot[src_col[j]];
                row_bytes.append(starts[static_cast<size_t>(slot)],
                                 static_cast<size_t>(
                                     ends[static_cast<size_t>(slot)] -
                                     starts[static_cast<size_t>(slot)]));
            } else {
                int64_t o = src_col[j] * n + i;
                switch (vtag[o]) {
                    case 0: piece_int(row_bytes, vals_i[o]); break;
                    case 1: piece_float(row_bytes, vals_f[o]); break;
                    case 2: piece_none(row_bytes); break;
                    case 3: piece_bool(row_bytes, vals_i[o] != 0); break;
                    case 4: {
                        uint64_t lo, hi;
                        std::memcpy(&lo, &vals_i[o], 8);
                        std::memcpy(&hi, &vals_f[o], 8);
                        piece_key(row_bytes, lo, hi);
                        break;
                    }
                    default: ok = false;
                }
            }
        }
        if (!ok) {
            out_status[i] = 1;
            out_token[i] = 0;
            continue;
        }
        pend.add(row_bytes, i);
        out_status[i] = 0;
    }
    rg.unlock();
    pend.intern_all(tab, out_token);
    return 0;
}

// ---------------------------------------------------------------- formatting

namespace {

// Python-repr-compatible float formatting: shortest round-trip, then
// ".0" appended for integral values (repr(5.0) == "5.0"). libstdc++
// only grew floating-point to_chars in GCC 11 (__cpp_lib_to_chars); on
// older toolchains probe %.{1..17}g for the shortest representation
// that parses back exactly — same output, keeps the plane buildable.
inline void format_double(std::string& out, double v) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    char buf[40];
    auto r = std::to_chars(buf, buf + sizeof(buf), v);
    char* end = r.ptr;
#else
    char buf[40];
    int n = snprintf(buf, sizeof buf, "%.17g", v);
    for (int prec = 1; prec <= 16; ++prec) {
        char probe[40];
        int pn = snprintf(probe, sizeof probe, "%.*g", prec, v);
        if (strtod(probe, nullptr) == v) {
            std::memcpy(buf, probe, (size_t)pn + 1);
            n = pn;
            break;
        }
    }
    // snprintf/%g honors LC_NUMERIC (to_chars never does): normalize a
    // comma decimal point so embedding processes that setlocale() still
    // produce well-formed CSV/repr output
    for (int k = 0; k < n; ++k)
        if (buf[k] == ',') buf[k] = '.';
    char* end = buf + n;
#endif
    bool plain = true;
    for (char* q = buf; q < end; ++q)
        if (*q == '.' || *q == 'e' || *q == 'n' || *q == 'i') {
            plain = false;  // has '.', exponent, nan or inf
            break;
        }
    out.append(buf, end);
    if (plain) out.append(".0");
}

// csv.writer QUOTE_MINIMAL: quote when the field contains the delimiter,
// the quote char, \r or \n.
inline void csv_field(std::string& out, const char* s, int64_t len,
                      char delim) {
    bool need = false;
    for (int64_t k = 0; k < len; ++k) {
        char c = s[k];
        if (c == delim || c == '"' || c == '\r' || c == '\n') {
            need = true;
            break;
        }
    }
    if (!need) {
        out.append(s, static_cast<size_t>(len));
        return;
    }
    out.push_back('"');
    for (int64_t k = 0; k < len; ++k) {
        if (s[k] == '"') out.push_back('"');
        out.push_back(s[k]);
    }
    out.push_back('"');
}

}  // namespace

// Format rows as CSV lines `col,...,time,diff\r\n` (the engine csv writer's
// shape, matching Python csv.writer QUOTE_MINIMAL + str() value forms).
// Rows with unsupported tags (bytes etc.) are skipped and their indices
// written to fallback_idx (caller formats those via Python). Output is
// appended into `out` up to cap; returns bytes written, or -needed if cap
// too small (caller retries with a bigger buffer; the fallback list is
// only valid on success). n_fallback is in/out.
int64_t dp_format_csv(void* h, int64_t n, const uint64_t* tokens,
                      const int64_t* diffs, int64_t time, char delim,
                      char* out, int64_t cap, int64_t* fallback_idx,
                      int64_t* n_fallback) {
    auto* tab = static_cast<InternTable*>(h);
    std::shared_lock<std::shared_mutex> rg(tab->mu);
    std::string line;
    int64_t used = 0;
    int64_t nfb = 0;
    char numbuf[32];
    for (int64_t i = 0; i < n; ++i) {
        const char* row;
        int64_t rlen;
        if (!tab->get(tokens[i], &row, &rlen)) {
            fallback_idx[nfb++] = i;
            continue;
        }
        line.clear();
        const char* p = row;
        const char* end = row + rlen;
        bool ok = true;
        bool first = true;
        while (p < end) {
            if (!first) line.push_back(delim);
            first = false;
            uint8_t tag = static_cast<uint8_t>(*p);
            const char* nx = skip_piece(p, end);
            if (nx == nullptr) {
                ok = false;
                break;
            }
            switch (tag) {
                case TAG_NONE: break;  // empty field
                case TAG_BOOL: line.append(p[1] ? "True" : "False"); break;
                case TAG_INT: {
                    int64_t v;
                    std::memcpy(&v, p + 1, 8);
                    auto r = std::to_chars(numbuf, numbuf + sizeof(numbuf), v);
                    line.append(numbuf, r.ptr);
                    break;
                }
                case TAG_FLOAT: {
                    double v;
                    std::memcpy(&v, p + 1, 8);
                    std::string fv;
                    format_double(fv, v);
                    csv_field(line, fv.data(), static_cast<int64_t>(fv.size()),
                              delim);
                    break;
                }
                case TAG_STR: {
                    int64_t L;
                    std::memcpy(&L, p + 1, 8);
                    csv_field(line, p + 9, L, delim);
                    break;
                }
                default: ok = false;  // bytes -> Python str(b'..') form
            }
            if (!ok) break;
            p = nx;
        }
        if (!ok) {
            fallback_idx[nfb++] = i;
            continue;
        }
        line.push_back(delim);
        auto r = std::to_chars(numbuf, numbuf + sizeof(numbuf), time);
        line.append(numbuf, r.ptr);
        line.push_back(delim);
        r = std::to_chars(numbuf, numbuf + sizeof(numbuf), diffs[i]);
        line.append(numbuf, r.ptr);
        line.append("\r\n");
        if (used + static_cast<int64_t>(line.size()) <= cap)
            std::memcpy(out + used, line.data(), line.size());
        used += static_cast<int64_t>(line.size());
    }
    *n_fallback = nfb;
    return used <= cap ? used : -used;
}

// ------------------------------------------------------------- consolidation

// Fast ingest-shape check: 1 when all diffs are +1 and keys are pairwise
// distinct (the batch is already consolidated), else 0.
int64_t dp_distinct_check(int64_t n, const uint64_t* key_lo,
                          const uint64_t* key_hi, const int64_t* diff) {
    struct K {
        uint64_t lo, hi;
        bool operator==(const K& o) const { return lo == o.lo && hi == o.hi; }
    };
    struct KH {
        size_t operator()(const K& k) const {
            uint64_t x = k.lo ^ (k.hi * 0x9E3779B97F4A7C15ull);
            x ^= x >> 33;
            x *= 0xFF51AFD7ED558CCDull;
            x ^= x >> 33;
            return static_cast<size_t>(x);
        }
    };
    std::unordered_map<K, char, KH> seen;
    seen.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        if (diff[i] != 1) return 0;
        if (!seen.emplace(K{key_lo[i], key_hi[i]}, 1).second) return 0;
    }
    return 1;
}

// Order-stable consolidation on (key, token): sums diffs, keeps first-
// appearance order, drops zeros. In-place; returns the new length.
int64_t dp_consolidate(int64_t n, uint64_t* key_lo, uint64_t* key_hi,
                       uint64_t* token, int64_t* diff) {
    struct K {
        uint64_t lo, hi, tok;
        bool operator==(const K& o) const {
            return lo == o.lo && hi == o.hi && tok == o.tok;
        }
    };
    struct KH {
        size_t operator()(const K& k) const {
            uint64_t x = k.lo ^ (k.hi * 0x9E3779B97F4A7C15ull) ^
                         (k.tok * 0xBF58476D1CE4E5B9ull);
            x ^= x >> 33;
            x *= 0xFF51AFD7ED558CCDull;
            x ^= x >> 33;
            return static_cast<size_t>(x);
        }
    };
    std::unordered_map<K, int64_t, KH> slot;  // -> first index in output
    slot.reserve(static_cast<size_t>(n));
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        K k{key_lo[i], key_hi[i], token[i]};
        auto it = slot.find(k);
        if (it == slot.end()) {
            key_lo[m] = key_lo[i];
            key_hi[m] = key_hi[i];
            token[m] = token[i];
            diff[m] = diff[i];
            slot.emplace(k, m);
            ++m;
        } else {
            diff[it->second] += diff[i];
        }
    }
    // drop zeros, preserving order (stable compaction; slots shift left)
    int64_t w = 0;
    for (int64_t i = 0; i < m; ++i) {
        if (diff[i] == 0) continue;
        if (w != i) {
            key_lo[w] = key_lo[i];
            key_hi[w] = key_hi[i];
            token[w] = token[i];
            diff[w] = diff[i];
        }
        ++w;
    }
    return w;
}

// ------------------------------------------------------------ wire transport

// Export the unique row bytes of a token array for cross-process shipping:
// writes, per unique token (in first-appearance order), its byte length to
// ulen, and the bytes to blob; remaps tokens[] in place to LOCAL dense ids
// 0..n_unique-1 (indices into the export list). Returns n_unique, or
// -needed when blob cap is too small.
int64_t dp_export_tokens(void* h, int64_t n, uint64_t* tokens, char* blob,
                         int64_t blob_cap, int64_t* ulen, int64_t ulen_cap) {
    auto* tab = static_cast<InternTable*>(h);
    std::shared_lock<std::shared_mutex> rg(tab->mu);
    std::unordered_map<uint64_t, int64_t> local;
    local.reserve(static_cast<size_t>(n));
    int64_t used = 0;
    int64_t n_u = 0;
    for (int64_t i = 0; i < n; ++i) {
        auto it = local.find(tokens[i]);
        if (it == local.end()) {
            const char* p;
            int64_t len;
            if (!tab->get(tokens[i], &p, &len)) return INT64_MIN;
            if (used + len <= blob_cap) std::memcpy(blob + used, p, len);
            used += len;
            if (n_u < ulen_cap) ulen[n_u] = len;
            it = local.emplace(tokens[i], n_u++).first;
        }
        tokens[i] = static_cast<uint64_t>(it->second);
    }
    return (used <= blob_cap && n_u <= ulen_cap) ? n_u : -used;
}

// ----------------------------------------------------------- join kernel
//
// Token-resident incremental equi-join (reference: join_tables,
// src/engine/dataflow.rs:2270, over differential's arrange/join). Each
// side keeps jk_token -> multiset of (key_lo, key_hi, row_token); the
// delta rule dL ⋈ R_old + L_new ⋈ dR runs entirely on these flat ids,
// and output rows assemble as piece(lkey)+piece(rkey)+lrow+rrow bytes
// with blake2b output keys — byte-identical to the Python plane's
// hash_values(lkey, rkey) rows.

namespace {

struct JRow {
    uint64_t lo, hi, tok;
    bool operator==(const JRow& o) const {
        return lo == o.lo && hi == o.hi && tok == o.tok;
    }
};

struct JRowHash {
    size_t operator()(const JRow& r) const {
        uint64_t x = r.lo ^ (r.hi * 0x9E3779B97F4A7C15ull) ^
                     (r.tok * 0xBF58476D1CE4E5B9ull);
        x ^= x >> 33;
        x *= 0xFF51AFD7ED558CCDull;
        x ^= x >> 33;
        return static_cast<size_t>(x);
    }
};

// One join-key group: rows in INSERTION order (deterministic probe
// emission, unlike unordered_map bucket order) with tombstoning counts.
// Small groups linear-scan; past GROUP_INDEX_MIN entries a flat
// open-addressing index (vector-backed, no per-insert allocation — the
// measured cost of the old nested unordered_map was its per-node
// mallocs on the 1M-row static build) keeps find O(1). Tombstones
// (cnt==0) stay until their whole group empties; heavy per-group churn
// would scan them — acceptable for arrangement workloads, revisit with
// compaction if a bench says otherwise.
struct JGroup {
    std::vector<JRow> rows;
    std::vector<int64_t> cnt;
    std::vector<uint32_t> slots;  // row idx + 1; 0 = empty
    size_t mask = 0;              // 0 = unindexed (linear scan)
    int64_t live = 0;

    static constexpr size_t GROUP_INDEX_MIN = 16;

    int64_t find(const JRow& r) const {
        if (mask) {
            size_t i = JRowHash{}(r) & mask;
            while (slots[i]) {
                uint32_t k = slots[i] - 1;
                if (rows[k] == r && cnt[k] != 0)
                    return static_cast<int64_t>(k);
                i = (i + 1) & mask;
            }
            return -1;
        }
        for (size_t k = 0; k < rows.size(); ++k)
            if (cnt[k] != 0 && rows[k] == r) return static_cast<int64_t>(k);
        return -1;
    }

    void index_insert(uint32_t k) {
        size_t i = JRowHash{}(rows[k]) & mask;
        while (slots[i]) i = (i + 1) & mask;
        slots[i] = k + 1;
    }

    void reindex(size_t want_slots) {
        mask = want_slots - 1;
        slots.assign(want_slots, 0);
        for (size_t k = 0; k < rows.size(); ++k)
            if (cnt[k] != 0) index_insert(static_cast<uint32_t>(k));
    }

    void add(const JRow& r, int64_t diff) {
        rows.push_back(r);
        cnt.push_back(diff);
        ++live;
        if (mask) {
            if ((rows.size() + 1) * 2 >= mask + 1)
                reindex(2 * (mask + 1));
            else
                index_insert(static_cast<uint32_t>(rows.size() - 1));
        } else if (rows.size() >= GROUP_INDEX_MIN) {
            size_t want = 2 * GROUP_INDEX_MIN;
            while (want < rows.size() * 2) want *= 2;
            reindex(want);
        }
    }
};

struct JoinArr {
    std::unordered_map<uint64_t, JGroup> groups;
};

}  // namespace

void* dj_new() { return new JoinArr(); }
void dj_free(void* h) { delete static_cast<JoinArr*>(h); }

void dj_update(void* h, int64_t n, const uint64_t* jk, const uint64_t* klo,
               const uint64_t* khi, const uint64_t* tok, const int64_t* diff) {
    auto* arr = static_cast<JoinArr*>(h);
    for (int64_t i = 0; i < n; ++i) {
        auto& g = arr->groups[jk[i]];
        JRow r{klo[i], khi[i], tok[i]};
        int64_t k = g.find(r);
        if (k >= 0) {
            g.cnt[k] += diff[i];
            if (g.cnt[k] == 0) {
                --g.live;
                if (g.live == 0) arr->groups.erase(jk[i]);
            }
        } else {
            g.add(r, diff[i]);
        }
    }
}

// Cross each input row with the OTHER side's current group. Emits flat
// (input_idx, other_klo, other_khi, other_tok, other_count) tuples.
// Returns count, or negated required capacity when cap is too small.
int64_t dj_probe(void* other_h, int64_t n, const uint64_t* jk, int64_t cap,
                 int64_t* out_idx, uint64_t* out_klo, uint64_t* out_khi,
                 uint64_t* out_tok, int64_t* out_cnt) {
    auto* other = static_cast<JoinArr*>(other_h);
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        auto it = other->groups.find(jk[i]);
        if (it == other->groups.end()) continue;
        const JGroup& g = it->second;
        for (size_t k = 0; k < g.rows.size(); ++k) {
            if (g.cnt[k] == 0) continue;  // tombstone
            if (m < cap) {
                out_idx[m] = i;
                out_klo[m] = g.rows[k].lo;
                out_khi[m] = g.rows[k].hi;
                out_tok[m] = g.rows[k].tok;
                out_cnt[m] = g.cnt[k];
            }
            ++m;
        }
    }
    return m <= cap ? m : -m;
}

int64_t dj_len(void* h) {
    auto* arr = static_cast<JoinArr*>(h);
    int64_t n = 0;
    for (const auto& g : arr->groups) n += g.second.live;
    return n;
}

// Full-state export for operator snapshots: one row per (jk, row) pair.
int64_t dj_export(void* h, uint64_t* jk, uint64_t* klo, uint64_t* khi,
                  uint64_t* tok, int64_t* cnt) {
    auto* arr = static_cast<JoinArr*>(h);
    int64_t m = 0;
    for (const auto& g : arr->groups) {
        const JGroup& gr = g.second;
        for (size_t k = 0; k < gr.rows.size(); ++k) {
            if (gr.cnt[k] == 0) continue;
            jk[m] = g.first;
            klo[m] = gr.rows[k].lo;
            khi[m] = gr.rows[k].hi;
            tok[m] = gr.rows[k].tok;
            cnt[m] = gr.cnt[k];
            ++m;
        }
    }
    return m;
}

// Per-group live-row census for the spill tier (engine/spill.py): writes
// up to cap (jk, live_rows) pairs in arrangement iteration order.
// Returns group count, or negated required capacity when cap is small.
int64_t dj_groups(void* h, int64_t cap, uint64_t* jk, int64_t* nrows) {
    auto* arr = static_cast<JoinArr*>(h);
    int64_t m = 0;
    for (const auto& g : arr->groups) {
        if (m < cap) {
            jk[m] = g.first;
            nrows[m] = g.second.live;
        }
        ++m;
    }
    return m <= cap ? m : -m;
}

// Evict one group into the spill tier: export its live rows in INSERTION
// order — exactly the order dj_probe/dj_export would emit them, so a
// later promote via dj_update round-trips byte-identically — then erase
// the group. Returns live-row count; negated required capacity when cap
// is too small (group untouched); 0 when the group is absent.
int64_t dj_evict(void* h, uint64_t jkey, int64_t cap, uint64_t* klo,
                 uint64_t* khi, uint64_t* tok, int64_t* cnt) {
    auto* arr = static_cast<JoinArr*>(h);
    auto it = arr->groups.find(jkey);
    if (it == arr->groups.end()) return 0;
    const JGroup& g = it->second;
    if (g.live > cap) return -g.live;
    int64_t m = 0;
    for (size_t k = 0; k < g.rows.size(); ++k) {
        if (g.cnt[k] == 0) continue;  // tombstone
        klo[m] = g.rows[k].lo;
        khi[m] = g.rows[k].hi;
        tok[m] = g.rows[k].tok;
        cnt[m] = g.cnt[k];
        ++m;
    }
    arr->groups.erase(it);
    return m;
}

// ------------------------------------------------------------ spill bloom
//
// Split bloom filter over pre-hashed u64 keys for the LSM run probe
// ladder (engine/spill.py): k probes derived from one 64-bit hash via
// Kirsch-Mitzenmacher double hashing. m_bits must be a power of two.

static inline uint64_t dp_bloom_mix(uint64_t x) {
    x ^= x >> 33;
    x *= 0xFF51AFD7ED558CCDull;
    x ^= x >> 33;
    x *= 0xC4CEB9FE1A85EC53ull;
    x ^= x >> 33;
    return x;
}

void dp_bloom_build(int64_t n, const uint64_t* hashes, int64_t m_bits,
                    int64_t k, uint8_t* bits) {
    std::memset(bits, 0, static_cast<size_t>(m_bits / 8));
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h1 = dp_bloom_mix(hashes[i]);
        uint64_t h2 = dp_bloom_mix(h1 ^ 0x9E3779B97F4A7C15ull) | 1;
        for (int64_t j = 0; j < k; ++j) {
            uint64_t b = (h1 + static_cast<uint64_t>(j) * h2) &
                         static_cast<uint64_t>(m_bits - 1);
            bits[b >> 3] |= static_cast<uint8_t>(1u << (b & 7));
        }
    }
}

int64_t dp_bloom_check(const uint8_t* bits, int64_t m_bits, int64_t k,
                       uint64_t hash) {
    uint64_t h1 = dp_bloom_mix(hash);
    uint64_t h2 = dp_bloom_mix(h1 ^ 0x9E3779B97F4A7C15ull) | 1;
    for (int64_t j = 0; j < k; ++j) {
        uint64_t b = (h1 + static_cast<uint64_t>(j) * h2) &
                     static_cast<uint64_t>(m_bits - 1);
        if (!(bits[b >> 3] & (1u << (b & 7)))) return 0;
    }
    return 1;
}

// Assemble joined output rows: for pair p, row bytes =
// piece_key(lkey) + piece_key(rkey) + lrow_bytes + rrow_bytes, interned;
// out key: id_mode 0 = blake2b(piece_key(l)+piece_key(r)) (hash),
// 1 = left key, 2 = right key. Returns 0 or -1-p on a bad row token.
// n_out < 0: emit the full joined row (lkey, rkey, *lrow, *rrow).
// n_out >= 0: PROJECTED emission — out_sel[j] indexes the virtual joined
// row (0 = lkey piece, 1 = rkey piece, 2+c = combined column c, where
// c < l_width selects left column c and c >= l_width selects right
// column c - l_width). The post-join select fuses into the join this
// way: one row build instead of two full passes over the match set.
int64_t dp_join_rows(void* h, int64_t n, const uint64_t* l_lo,
                     const uint64_t* l_hi, const uint64_t* l_tok,
                     const uint64_t* r_lo, const uint64_t* r_hi,
                     const uint64_t* r_tok, int64_t id_mode,
                     int64_t n_out, const int64_t* out_sel, int64_t l_width,
                     uint64_t* out_lo, uint64_t* out_hi, uint64_t* out_tok) {
    auto* tab = static_cast<InternTable*>(h);
    std::string row_bytes, keys_bytes;
    PendingRows pend;
    // projection: per-side sorted unique column lists for find_cols
    std::vector<int64_t> l_cols, r_cols;
    std::vector<int64_t> sel_side, sel_slot;  // per out col: 0/1/2 lkey/rkey/col
    if (n_out >= 0) {
        for (int64_t j = 0; j < n_out; ++j) {
            int64_t s = out_sel[j];
            if (s == 0 || s == 1) {
                sel_side.push_back(s);
                sel_slot.push_back(0);
            } else {
                int64_t c = s - 2;
                if (c < l_width) {
                    sel_side.push_back(2);
                    l_cols.push_back(c);
                    sel_slot.push_back(c);
                } else {
                    sel_side.push_back(3);
                    r_cols.push_back(c - l_width);
                    sel_slot.push_back(c - l_width);
                }
            }
        }
        auto uniq = [](std::vector<int64_t>& v) {
            std::sort(v.begin(), v.end());
            v.erase(std::unique(v.begin(), v.end()), v.end());
        };
        uniq(l_cols);
        uniq(r_cols);
        // slot -> position in the sorted unique list
        for (size_t j = 0; j < sel_side.size(); ++j) {
            if (sel_side[j] == 2)
                sel_slot[j] = std::lower_bound(l_cols.begin(), l_cols.end(),
                                               sel_slot[j]) - l_cols.begin();
            else if (sel_side[j] == 3)
                sel_slot[j] = std::lower_bound(r_cols.begin(), r_cols.end(),
                                               sel_slot[j]) - r_cols.begin();
        }
    }
    std::vector<const char*> lst(l_cols.size()), len_(l_cols.size());
    std::vector<const char*> rst(r_cols.size()), ren(r_cols.size());
    // probe-row memo: dj_probe emits matches contiguously per probe
    // row, so one side's token repeats across its whole match run —
    // re-splitting the same row bytes per match was measurable on the
    // 1M-match bench wave (tokens start at 1; 0 = no memo yet)
    uint64_t memo_l = 0, memo_r = 0;
    {
        std::shared_lock<std::shared_mutex> rg(tab->mu);
        for (int64_t i = 0; i < n; ++i) {
            const char* lrow;
            int64_t llen;
            const char* rrow;
            int64_t rlen;
            if (!tab->get(l_tok[i], &lrow, &llen) ||
                !tab->get(r_tok[i], &rrow, &rlen))
                return -1 - i;
            row_bytes.clear();
            if (n_out < 0) {
                piece_key(row_bytes, l_lo[i], l_hi[i]);
                piece_key(row_bytes, r_lo[i], r_hi[i]);
                row_bytes.append(lrow, static_cast<size_t>(llen));
                row_bytes.append(rrow, static_cast<size_t>(rlen));
            } else {
                if (!l_cols.empty() && l_tok[i] != memo_l) {
                    if (!find_cols(lrow, llen, l_cols.data(),
                                   static_cast<int64_t>(l_cols.size()),
                                   lst.data(), len_.data()))
                        return -1 - i;
                    memo_l = l_tok[i];
                }
                if (!r_cols.empty() && r_tok[i] != memo_r) {
                    if (!find_cols(rrow, rlen, r_cols.data(),
                                   static_cast<int64_t>(r_cols.size()),
                                   rst.data(), ren.data()))
                        return -1 - i;
                    memo_r = r_tok[i];
                }
                for (size_t j = 0; j < sel_side.size(); ++j) {
                    switch (sel_side[j]) {
                        case 0: piece_key(row_bytes, l_lo[i], l_hi[i]); break;
                        case 1: piece_key(row_bytes, r_lo[i], r_hi[i]); break;
                        case 2:
                            row_bytes.append(
                                lst[static_cast<size_t>(sel_slot[j])],
                                static_cast<size_t>(
                                    len_[static_cast<size_t>(sel_slot[j])] -
                                    lst[static_cast<size_t>(sel_slot[j])]));
                            break;
                        default:
                            row_bytes.append(
                                rst[static_cast<size_t>(sel_slot[j])],
                                static_cast<size_t>(
                                    ren[static_cast<size_t>(sel_slot[j])] -
                                    rst[static_cast<size_t>(sel_slot[j])]));
                    }
                }
            }
            pend.add(row_bytes, i);
            if (id_mode == 1) {
                out_lo[i] = l_lo[i];
                out_hi[i] = l_hi[i];
            } else if (id_mode == 2) {
                out_lo[i] = r_lo[i];
                out_hi[i] = r_hi[i];
            } else if (id_mode == 3) {
                // plan-gated cheap ids: join output identities proven
                // unobservable, so skip the per-match blake2b
                cheap_join_key(l_lo[i], l_hi[i], r_lo[i], r_hi[i],
                               &out_lo[i], &out_hi[i]);
            } else {
                keys_bytes.clear();
                piece_key(keys_bytes, l_lo[i], l_hi[i]);
                piece_key(keys_bytes, r_lo[i], r_hi[i]);
                blake2b_128(
                    reinterpret_cast<const uint8_t*>(keys_bytes.data()),
                    keys_bytes.size(), &out_lo[i], &out_hi[i]);
            }
        }
    }
    pend.intern_all(tab, out_tok);
    return 0;
}

// ------------------------------------------------- stateful-tail kernels
//
// Token-resident support for the stateful operator tail (update_cells,
// ix, flatten) — reference: src/engine/dataflow.rs:1555-2224 runs these
// on typed records; here the row bytes splice/decode directly.

// Output col j = column idx[j] of source side[j] (0..k-1). toks is
// [k][n] row-major: source s's token for pair i is toks[s*n + i].
// Returns 0, or -1-i on a malformed/unknown row at pair i.
int64_t dp_splice_cols(void* h, int64_t n, int64_t k, const uint64_t* toks,
                       int64_t n_out, const int64_t* side, const int64_t* idx,
                       uint64_t* out_tok) {
    auto* tab = static_cast<InternTable*>(h);
    // per-source sorted unique column lists for find_cols
    std::vector<std::vector<int64_t>> cols(static_cast<size_t>(k));
    std::vector<std::unordered_map<int64_t, int64_t>> slot(
        static_cast<size_t>(k));
    for (int64_t j = 0; j < n_out; ++j) {
        if (side[j] < 0 || side[j] >= k) return -1;
        cols[static_cast<size_t>(side[j])].push_back(idx[j]);
    }
    std::vector<std::vector<const char*>> starts(static_cast<size_t>(k));
    std::vector<std::vector<const char*>> ends(static_cast<size_t>(k));
    for (int64_t s = 0; s < k; ++s) {
        auto& c = cols[static_cast<size_t>(s)];
        std::sort(c.begin(), c.end());
        c.erase(std::unique(c.begin(), c.end()), c.end());
        for (size_t q = 0; q < c.size(); ++q)
            slot[static_cast<size_t>(s)][c[q]] = static_cast<int64_t>(q);
        starts[static_cast<size_t>(s)].resize(c.size());
        ends[static_cast<size_t>(s)].resize(c.size());
    }
    std::string row_bytes;
    PendingRows pend;
    {
        std::shared_lock<std::shared_mutex> rg(tab->mu);
        for (int64_t i = 0; i < n; ++i) {
            bool ok = true;
            for (int64_t s = 0; s < k && ok; ++s) {
                auto& c = cols[static_cast<size_t>(s)];
                if (c.empty()) continue;
                const char* row;
                int64_t rlen;
                if (!tab->get(toks[s * n + i], &row, &rlen) ||
                    !find_cols(row, rlen, c.data(),
                               static_cast<int64_t>(c.size()),
                               starts[static_cast<size_t>(s)].data(),
                               ends[static_cast<size_t>(s)].data()))
                    ok = false;
            }
            if (!ok) return -1 - i;
            row_bytes.clear();
            for (int64_t j = 0; j < n_out; ++j) {
                size_t s = static_cast<size_t>(side[j]);
                size_t q = static_cast<size_t>(slot[s][idx[j]]);
                row_bytes.append(starts[s][q],
                                 static_cast<size_t>(ends[s][q] - starts[s][q]));
            }
            pend.add(row_bytes, i);
        }
    }
    pend.intern_all(tab, out_tok);
    return 0;
}

// Extract a pointer (Key) column: status[i] 0 = Key (lo/hi valid),
// 1 = None, 2 = other scalar. Returns 0, or -1-i on malformed row i.
int64_t dp_decode_key_col(void* h, int64_t n, const uint64_t* tokens,
                          int64_t col, uint64_t* out_lo, uint64_t* out_hi,
                          uint8_t* out_status) {
    auto* tab = static_cast<InternTable*>(h);
    const char* start;
    const char* end;
    std::shared_lock<std::shared_mutex> g(tab->mu);
    for (int64_t i = 0; i < n; ++i) {
        const char* row;
        int64_t rlen;
        if (!tab->get(tokens[i], &row, &rlen) ||
            !find_cols(row, rlen, &col, 1, &start, &end))
            return -1 - i;
        uint8_t tag = static_cast<uint8_t>(*start);
        out_lo[i] = 0;
        out_hi[i] = 0;
        if (tag == TAG_KEY) {
            std::memcpy(&out_lo[i], start + 1, 8);
            std::memcpy(&out_hi[i], start + 9, 8);
            out_status[i] = 0;
        } else if (tag == TAG_NONE) {
            out_status[i] = 1;
        } else {
            out_status[i] = 2;
        }
    }
    return 0;
}

// Flatten a str/bytes column: each input row i expands to one child row
// per unicode character (str) / per single byte (bytes), with child key
// = blake2b(piece_key(parent) + piece_int(j)) — byte-identical to Python
// hash_values(key, j). Rows whose column is None expand to nothing;
// any other tag gets fb_status[i]=1 (python fallback). Output arrays are
// caller-sized; returns the child count, or the negated required
// capacity when cap is too small.
int64_t dp_flatten(void* h, int64_t n, const uint64_t* tokens,
                   const uint64_t* key_lo, const uint64_t* key_hi,
                   const int64_t* diffs, int64_t col, uint8_t* fb_status,
                   int64_t cap, uint64_t* o_lo, uint64_t* o_hi,
                   uint64_t* o_tok, int64_t* o_diff) {
    auto* tab = static_cast<InternTable*>(h);
    const char* start;
    const char* end;
    std::string row_bytes, kb;
    PendingRows pend;
    int64_t m = 0;
    {
        std::shared_lock<std::shared_mutex> rg(tab->mu);
        for (int64_t i = 0; i < n; ++i) {
            const char* row;
            int64_t rlen;
            fb_status[i] = 0;
            if (!tab->get(tokens[i], &row, &rlen) ||
                !find_cols(row, rlen, &col, 1, &start, &end)) {
                fb_status[i] = 1;
                continue;
            }
            uint8_t tag = static_cast<uint8_t>(*start);
            if (tag == TAG_NONE) continue;
            if (tag != TAG_STR && tag != TAG_BYTES) {
                fb_status[i] = 1;
                continue;
            }
            int64_t slen;
            std::memcpy(&slen, start + 1, 8);
            const char* s = start + 9;
            const char* prefix = row;
            size_t prefix_len = static_cast<size_t>(start - row);
            const char* suffix = end;
            size_t suffix_len = static_cast<size_t>(row + rlen - end);
            int64_t j = 0;
            for (int64_t b = 0; b < slen;) {
                int64_t clen = 1;
                if (tag == TAG_STR) {  // utf-8 char boundaries
                    uint8_t c0 = static_cast<uint8_t>(s[b]);
                    clen = c0 < 0x80 ? 1 : (c0 < 0xE0 ? 2 : (c0 < 0xF0 ? 3 : 4));
                    if (b + clen > slen) clen = slen - b;  // defensive
                }
                if (m < cap) {
                    row_bytes.clear();
                    row_bytes.append(prefix, prefix_len);
                    if (tag == TAG_STR)
                        piece_str(row_bytes, s + b, clen);
                    else {
                        row_bytes.push_back(static_cast<char>(TAG_BYTES));
                        put_i64(row_bytes, 1);
                        row_bytes.push_back(s[b]);
                    }
                    row_bytes.append(suffix, suffix_len);
                    pend.add(row_bytes, m);
                    kb.clear();
                    piece_key(kb, key_lo[i], key_hi[i]);
                    piece_int(kb, j);
                    blake2b_128(reinterpret_cast<const uint8_t*>(kb.data()),
                                kb.size(), &o_lo[m], &o_hi[m]);
                    o_diff[m] = diffs[i];
                }
                ++m;
                ++j;
                b += clen;
            }
        }
    }
    if (m > cap) return -m;
    pend.intern_all(tab, o_tok);
    return m;
}

// Import: intern each blob row (offsets implied by ulen), then map local
// ids in tokens[] back to this process's intern ids.
int64_t dp_import_tokens(void* h, int64_t n, uint64_t* tokens,
                         const char* blob, const int64_t* ulen, int64_t n_u) {
    auto* tab = static_cast<InternTable*>(h);
    std::unique_lock<std::shared_mutex> g(tab->mu);
    std::vector<uint64_t> ids(static_cast<size_t>(n_u));
    int64_t off = 0;
    for (int64_t u = 0; u < n_u; ++u) {
        ids[static_cast<size_t>(u)] = tab->intern_locked(blob + off, ulen[u]);
        off += ulen[u];
    }
    for (int64_t i = 0; i < n; ++i) {
        if (tokens[i] >= static_cast<uint64_t>(n_u)) return -1;
        tokens[i] = ids[static_cast<size_t>(tokens[i])];
    }
    return 0;
}

}  // extern "C"
