// The host ingest core of victorialogs_tpu_torch (C ABI, loaded through
// ctypes by native/ingest.py):
//
//   vl_jsonline_scan       - strict-subset JSON-lines scanner: a
//                            newline-aligned body chunk -> unescaped
//                            key/value spans, per-line schema signatures
//                            and a flag on every line it leaves to the
//                            Python parser
//   vl_tokenize_arena      - word tokenizer over a packed column (ASCII
//                            alnum + '_' + any >=0x80 byte)
//   vl_unique_token_hashes - tokenize + xxh64 + dedupe in one pass, the
//                            token hashes a block's bloom filters take
//
// Copied from the JAX package's native core (vlnative.cpp), trimmed to
// what the insert path and the block build use.  Build: g++ -O3
// -std=c++17 -shared -fPIC (native/__init__.py compile_library).

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

inline uint64_t rd64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

inline uint32_t rd32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

// Canonical XXH64 (public spec); bit-identical to the python `xxhash`
// package used by utils/hashing.py.
uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
                 v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = rotl64(v1 + rd64(p) * P2, 31) * P1; p += 8;
            v2 = rotl64(v2 + rd64(p) * P2, 31) * P1; p += 8;
            v3 = rotl64(v3 + rd64(p) * P2, 31) * P1; p += 8;
            v4 = rotl64(v4 + rd64(p) * P2, 31) * P1; p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) +
            rotl64(v4, 18);
        v1 *= P2; v1 = rotl64(v1, 31); v1 *= P1; h ^= v1; h = h * P1 + P4;
        v2 *= P2; v2 = rotl64(v2, 31); v2 *= P1; h ^= v2; h = h * P1 + P4;
        v3 *= P2; v3 = rotl64(v3, 31); v3 *= P1; h ^= v3; h = h * P1 + P4;
        v4 *= P2; v4 = rotl64(v4, 31); v4 *= P1; h ^= v4; h = h * P1 + P4;
    } else {
        h = seed + P5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        uint64_t k = rd64(p);
        k *= P2; k = rotl64(k, 31); k *= P1;
        h ^= k;
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)rd32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }
    h ^= h >> 33; h *= P2;
    h ^= h >> 29; h *= P3;
    h ^= h >> 32;
    return h;
}

inline bool word_char(uint8_t b) {
    return (b >= 'a' && b <= 'z') || (b >= 'A' && b <= 'Z') ||
           (b >= '0' && b <= '9') || b == '_' || b >= 0x80;
}

}  // namespace

extern "C" {

int64_t vl_tokenize_arena(const uint8_t* arena, const int64_t* offsets,
                          const int64_t* lengths, int64_t nrows,
                          int64_t* tok_start, int64_t* tok_end,
                          int64_t* tok_row, int64_t cap) {
    int64_t nt = 0;
    for (int64_t r = 0; r < nrows; r++) {
        const int64_t off = offsets[r], len = lengths[r];
        int64_t i = 0;
        while (i < len) {
            while (i < len && !word_char(arena[off + i])) i++;
            if (i >= len) break;
            int64_t s = i;
            while (i < len && word_char(arena[off + i])) i++;
            if (nt >= cap) return -1;
            tok_start[nt] = off + s;
            tok_end[nt] = off + i;
            tok_row[nt] = r;
            nt++;
        }
    }
    return nt;
}

// Tokenize + hash + dedupe in one pass.  Dedup keys on the xxh64 hash:
// for bloom construction this is exactly equivalent to deduping on token
// bytes (identical hashes set identical bloom bits).  Returns the number
// of unique hashes written to out (first-seen order), or -1 if out_cap
// would overflow.
int64_t vl_unique_token_hashes(const uint8_t* arena, const int64_t* offsets,
                               const int64_t* lengths, int64_t nrows,
                               uint64_t* out, int64_t out_cap) {
    // open-addressing set sized to the next power of two >= 2*out_cap
    size_t table_size = 64;
    while ((int64_t)table_size < out_cap * 2) table_size <<= 1;
    uint64_t* table = (uint64_t*)std::calloc(table_size, sizeof(uint64_t));
    if (table == nullptr) return -1;
    const size_t mask = table_size - 1;
    int64_t n_out = 0;
    for (int64_t r = 0; r < nrows; r++) {
        const int64_t off = offsets[r], len = lengths[r];
        int64_t i = 0;
        while (i < len) {
            while (i < len && !word_char(arena[off + i])) i++;
            if (i >= len) break;
            int64_t s = i;
            while (i < len && word_char(arena[off + i])) i++;
            uint64_t h = xxh64(arena + off + s, (size_t)(i - s), 0);
            // 0 is the empty slot marker; remap the (essentially
            // impossible) zero hash onto a fixed sentinel
            if (h == 0) h = 0x9E3779B97F4A7C15ULL;
            size_t slot = (size_t)h & mask;
            bool found = false;
            while (table[slot] != 0) {
                if (table[slot] == h) { found = true; break; }
                slot = (slot + 1) & mask;
            }
            if (!found) {
                if (n_out >= out_cap) { std::free(table); return -1; }
                table[slot] = h;
                out[n_out++] = h;
            }
        }
    }
    std::free(table);
    return n_out;
}

}  // extern "C"


// ---------------- jsonline scanner (native data loader) ----------------
//
// Strict-subset JSON-lines parser for the columnar ingest fast path
// (server/vlinsert.py).  Handles flat objects whose values are strings,
// numbers, true or false; everything else (nested objects, arrays,
// nulls, lone surrogates, duplicate keys, malformed lines) flags the
// line for the Python fallback, which re-parses it with json.loads so
// semantics (including error behavior) stay identical to the per-row
// path.  The reference's equivalent is the fastjson-backed parser in
// lib/logstorage/json_parser.go.
//
// Output layout:
//   arena      : unescaped key/value bytes (escapes only shrink text,
//                so cap = body_len is always enough)
//   fields i32 : per field [key_off, key_len, val_off, val_len, kind]
//                kind 0 = string, 1 = exact-int raw text,
//                2 = float raw text (Python re-formats via json.dumps),
//                3 = true, 4 = false
//   lines  i32 : per line  [field_start, nfields, flags, raw_off, raw_len]
//                flags bit0 = Python fallback required
//   sigs   i64 : per line xxh64 over (key_len, key bytes)* — the schema
//                signature the Python side keys its plan cache on
//   counts i64 : [nlines, nfields_total, arena_used, arena_is_ascii]
// Returns 0 on success, -1 when a capacity limit would be exceeded
// (caller falls back to the per-line path).

static inline bool js_ws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\r';
}

// Unescape one JSON string: body[*pi] is the first char AFTER the
// opening quote; on success *pi points at the closing quote, the
// unescaped bytes are appended at *app, and *ascii drops to 0 when any
// non-ASCII byte lands in the arena.  Returns false on any invalid
// escape, control char, lone surrogate, or missing close quote —
// the caller falls back to the Python parser for the line.
static bool js_unescape(const uint8_t* body, int64_t* pi, int64_t e,
                        uint8_t* arena, int64_t* app, int64_t* ascii) {
    int64_t i = *pi, ap = *app;
    while (i < e) {
        uint8_t c = body[i];
        if (c == '"') {
            *pi = i;
            *app = ap;
            return true;
        }
        if (c != '\\') {
            if (c < 0x20) return false;
            if (c >= 0x80) *ascii = 0;
            arena[ap++] = c;
            i++;
            continue;
        }
        if (i + 1 >= e) return false;
        uint8_t n = body[i + 1];
        i += 2;
        switch (n) {
            case '"': arena[ap++] = '"'; break;
            case '\\': arena[ap++] = '\\'; break;
            case '/': arena[ap++] = '/'; break;
            case 'b': arena[ap++] = '\b'; break;
            case 'f': arena[ap++] = '\f'; break;
            case 'n': arena[ap++] = '\n'; break;
            case 'r': arena[ap++] = '\r'; break;
            case 't': arena[ap++] = '\t'; break;
            case 'u': {
                if (i + 4 > e) return false;
                uint32_t cp = 0;
                for (int k = 0; k < 4; k++) {
                    uint8_t h = body[i + k];
                    cp <<= 4;
                    if (h >= '0' && h <= '9') cp |= h - '0';
                    else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
                    else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
                    else return false;
                }
                i += 4;
                if (cp >= 0xD800 && cp <= 0xDBFF) {
                    // high surrogate: require the low half
                    if (i + 6 > e || body[i] != '\\' || body[i + 1] != 'u')
                        return false;
                    uint32_t lo = 0;
                    for (int k = 0; k < 4; k++) {
                        uint8_t h = body[i + 2 + k];
                        lo <<= 4;
                        if (h >= '0' && h <= '9') lo |= h - '0';
                        else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
                        else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
                        else return false;
                    }
                    if (lo < 0xDC00 || lo > 0xDFFF) return false;
                    i += 6;
                    cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
                    return false;  // lone low surrogate
                }
                if (cp < 0x80) {
                    arena[ap++] = (uint8_t)cp;
                } else if (cp < 0x800) {
                    arena[ap++] = 0xC0 | (cp >> 6);
                    arena[ap++] = 0x80 | (cp & 0x3F);
                    *ascii = 0;
                } else if (cp < 0x10000) {
                    arena[ap++] = 0xE0 | (cp >> 12);
                    arena[ap++] = 0x80 | ((cp >> 6) & 0x3F);
                    arena[ap++] = 0x80 | (cp & 0x3F);
                    *ascii = 0;
                } else {
                    arena[ap++] = 0xF0 | (cp >> 18);
                    arena[ap++] = 0x80 | ((cp >> 12) & 0x3F);
                    arena[ap++] = 0x80 | ((cp >> 6) & 0x3F);
                    arena[ap++] = 0x80 | (cp & 0x3F);
                    *ascii = 0;
                }
                break;
            }
            default: return false;
        }
    }
    return false;  // no closing quote before end of line
}

extern "C" int64_t vl_jsonline_scan(
        const uint8_t* body, int64_t body_len,
        uint8_t* arena, int64_t arena_cap,
        int32_t* fields, int64_t fields_cap,
        int32_t* lines, int64_t lines_cap,
        int64_t* sigs, int64_t* counts) {
    int64_t nl = 0, nf = 0, ap = 0;
    int64_t ascii = 1;
    int64_t pos = 0;
    while (pos < body_len) {
        int64_t eol = pos;
        while (eol < body_len && body[eol] != '\n') eol++;
        int64_t s = pos, e = eol;
        pos = eol + 1;
        while (s < e && (js_ws(body[s]) || body[s] == '\n')) s++;
        while (e > s && js_ws(body[e - 1])) e--;
        if (s >= e) continue;          // blank line
        if (nl >= lines_cap) return -1;
        int32_t* L = lines + nl * 5;
        L[0] = (int32_t)nf;
        L[1] = 0;
        L[2] = 0;
        L[3] = (int32_t)s;
        L[4] = (int32_t)(e - s);
        sigs[nl] = 0;
        nl++;
        int64_t i = s;
        bool fall = false;
        int64_t line_fields = nf;
        uint64_t sig = 1469598103934665603ULL;  // seed only
        if (body[i] != '{') { L[2] = 1; continue; }
        i++;
        while (i < e && js_ws(body[i])) i++;
        if (i < e && body[i] == '}') {
            i++;
            while (i < e && js_ws(body[i])) i++;
            if (i != e) L[2] = 1;
            continue;                  // empty object: zero fields
        }
        for (;;) {
            while (i < e && js_ws(body[i])) i++;
            if (i >= e || body[i] != '"') { fall = true; break; }
            int64_t ko = ap;
            i++;
            if (!js_unescape(body, &i, e, arena, &ap, &ascii)) {
                fall = true; break;
            }
            i++;                       // past the closing quote
            int64_t klen = ap - ko;
            while (i < e && js_ws(body[i])) i++;
            if (i >= e || body[i] != ':') { fall = true; break; }
            i++;
            while (i < e && js_ws(body[i])) i++;
            if (i >= e) { fall = true; break; }
            int64_t vo = ap, vlen = 0;
            int32_t kind;
            uint8_t c = body[i];
            if (c == '"') {
                i++;
                if (!js_unescape(body, &i, e, arena, &ap, &ascii)) {
                    fall = true; break;
                }
                i++;
                vlen = ap - vo;
                kind = 0;
            } else if (c == 't') {
                if (e - i < 4 || memcmp(body + i, "true", 4) != 0) {
                    fall = true; break;
                }
                i += 4; kind = 3;
            } else if (c == 'f') {
                if (e - i < 5 || memcmp(body + i, "false", 5) != 0) {
                    fall = true; break;
                }
                i += 5; kind = 4;
            } else if (c == '-' || (c >= '0' && c <= '9')) {
                // strict JSON number grammar
                int64_t ns = i;
                bool neg = false, isflt = false, ok = true;
                if (c == '-') { neg = true; i++; }
                if (i >= e || body[i] < '0' || body[i] > '9') ok = false;
                else if (body[i] == '0') { i++; }
                else { while (i < e && body[i] >= '0' && body[i] <= '9') i++; }
                if (ok && i < e && body[i] == '.') {
                    isflt = true; i++;
                    if (i >= e || body[i] < '0' || body[i] > '9')
                        ok = false;
                    while (i < e && body[i] >= '0' && body[i] <= '9') i++;
                }
                if (ok && i < e && (body[i] == 'e' || body[i] == 'E')) {
                    isflt = true; i++;
                    if (i < e && (body[i] == '+' || body[i] == '-')) i++;
                    if (i >= e || body[i] < '0' || body[i] > '9')
                        ok = false;
                    while (i < e && body[i] >= '0' && body[i] <= '9') i++;
                }
                if (!ok) { fall = true; break; }
                vlen = i - ns;
                if (!isflt && neg && i - ns == 2 && body[ns + 1] == '0') {
                    // JSON "-0": json.loads -> int 0 -> dumps -> "0"
                    arena[ap++] = '0';
                    vlen = 1;
                } else {
                    std::memcpy(arena + ap, body + ns, (size_t)vlen);
                    ap += vlen;
                }
                kind = isflt ? 2 : 1;
            } else {
                fall = true; break;    // null / object / array / other
            }
            if (nf >= fields_cap) return -1;
            int32_t* F = fields + nf * 5;
            F[0] = (int32_t)ko; F[1] = (int32_t)klen;
            F[2] = (int32_t)vo; F[3] = (int32_t)vlen; F[4] = kind;
            nf++;
            // schema signature: xxh64 chained over (klen, key bytes)
            sig = xxh64(arena + ko, (size_t)klen, sig ^ (uint64_t)klen);
            while (i < e && js_ws(body[i])) i++;
            if (i < e && body[i] == ',') { i++; continue; }
            if (i < e && body[i] == '}') {
                i++;
                while (i < e && js_ws(body[i])) i++;
                if (i != e) fall = true;
                break;
            }
            fall = true; break;
        }
        int64_t cnt = nf - line_fields;
        if (!fall) {
            // duplicate keys: Python dict keeps the LAST value; fall back
            for (int64_t a = line_fields; a < nf && !fall; a++) {
                for (int64_t b = a + 1; b < nf; b++) {
                    if (fields[a * 5 + 1] == fields[b * 5 + 1] &&
                        memcmp(arena + fields[a * 5],
                               arena + fields[b * 5],
                               (size_t)fields[a * 5 + 1]) == 0) {
                        fall = true; break;
                    }
                }
            }
        }
        if (fall) {
            nf = line_fields;          // discard partial fields
            L[2] = 1;
            continue;
        }
        L[1] = (int32_t)cnt;
        sigs[nl - 1] = (int64_t)sig;
        (void)arena_cap;
    }
    counts[0] = nl; counts[1] = nf; counts[2] = ap; counts[3] = ascii;
    return 0;
}
