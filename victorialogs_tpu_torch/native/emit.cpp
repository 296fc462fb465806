// Columnar NDJSON serializer of the port's query answers (C ABI, loaded
// through ctypes by native/__init__.py, built there with g++).
//
// vl_emit_ndjson takes the columns of one result block (kind-tagged:
// byte arenas with per-row offsets and lengths, or typed int64/uint64
// arrays, see engine/block_result.py) and writes the response bytes.
// Output contract: byte-identical to
//   json.dumps({k: v for k, v in row if v != ""}, ensure_ascii=False,
//              separators=(",", ":")) + "\n"
// per row, keys in column order.  That means:
//   - zero-length values are omitted (empty string == absent field);
//   - rows with no non-empty values still emit "{}";
//   - escapes match CPython's ensure_ascii=False encoder exactly:
//     '"' and '\\', \b \t \n \f \r for their control chars, \u00XX for
//     the remaining bytes < 0x20, everything else verbatim;
//   - key tokens arrive pre-quoted (json.dumps of the name + ':'), so
//     key escaping is Python's own by construction.
//
// Column kinds (kinds[c]):
//   kind 0  byte arena + per-row offsets/lengths
//   kind 1  int64 epoch-ns timestamps -> RFC3339Nano (_time: trailing
//           fraction zeros trimmed, whole seconds carry no fraction)
//   kind 2  int64 epoch-ns timestamps -> ISO8601 with params[c]
//           fixed fractional digits (VT_TIMESTAMP_ISO8601 columns)
//   kind 3  int64  -> decimal (VT_INT64)
//   kind 4  uint64 -> decimal (VT_UINT8..64)
// For kinds != 0 the arenas[c] pointer is the numeric array and
// offsets/lengths are not read.
//
// Python decodes arenas with errors="replace"; to stay byte-identical
// the scan validates UTF-8 strictly and returns -1 on any invalid
// sequence (incl. surrogate halves and overlongs): the caller then
// writes that block by the per-row path.  Returns the bytes written,
// -1 on invalid UTF-8, -2 if out_cap would overflow, -3 on an unknown
// column kind.

#include <cstdint>
#include <cstring>

namespace {

const char HEXD[] = "0123456789abcdef";

// Escape one value into out at p; returns the new p, or -1 on invalid
// UTF-8 (the caller writes the whole block by the per-row path).
inline int64_t emit_escaped(const uint8_t* v, int64_t len,
                            uint8_t* out, int64_t p) {
    for (int64_t i = 0; i < len; i++) {
        const uint8_t c = v[i];
        if (c == '"') {
            out[p++] = '\\'; out[p++] = '"';
        } else if (c == '\\') {
            out[p++] = '\\'; out[p++] = '\\';
        } else if (c < 0x20) {
            out[p++] = '\\';
            switch (c) {
                case '\b': out[p++] = 'b'; break;
                case '\t': out[p++] = 't'; break;
                case '\n': out[p++] = 'n'; break;
                case '\f': out[p++] = 'f'; break;
                case '\r': out[p++] = 'r'; break;
                default:
                    out[p++] = 'u'; out[p++] = '0'; out[p++] = '0';
                    out[p++] = HEXD[c >> 4]; out[p++] = HEXD[c & 15];
            }
        } else if (c < 0x80) {
            out[p++] = c;
        } else {
            // strict UTF-8 validation (RFC 3629 table): continuation
            // ranges depend on the lead byte to reject overlongs,
            // surrogates and > U+10FFFF
            int need;
            uint8_t lo = 0x80, hi = 0xBF;
            if (c >= 0xC2 && c <= 0xDF) { need = 1; }
            else if (c == 0xE0) { need = 2; lo = 0xA0; }
            else if (c == 0xED) { need = 2; hi = 0x9F; }
            else if (c >= 0xE1 && c <= 0xEF) { need = 2; }
            else if (c == 0xF0) { need = 3; lo = 0x90; }
            else if (c >= 0xF1 && c <= 0xF3) { need = 3; }
            else if (c == 0xF4) { need = 3; hi = 0x8F; }
            else { return -1; }
            if (i + need >= len) return -1;
            const uint8_t b1 = v[i + 1];
            if (b1 < lo || b1 > hi) return -1;
            out[p++] = c;
            out[p++] = b1;
            for (int k = 2; k <= need; k++) {
                const uint8_t b = v[i + k];
                if (b < 0x80 || b > 0xBF) return -1;
                out[p++] = b;
            }
            i += need;
        }
    }
    return p;
}

inline int64_t fmt_u64(uint64_t v, uint8_t* out) {
    uint8_t tmp[20];
    int n = 0;
    do {
        tmp[n++] = (uint8_t)('0' + v % 10);
        v /= 10;
    } while (v);
    for (int i = 0; i < n; i++) out[i] = tmp[n - 1 - i];
    return n;
}

inline int64_t fmt_i64(int64_t v, uint8_t* out) {
    if (v < 0) {
        out[0] = '-';
        // -(v+1)+1 avoids INT64_MIN overflow
        return 1 + fmt_u64((uint64_t)(-(v + 1)) + 1, out + 1);
    }
    return fmt_u64((uint64_t)v, out);
}

// Epoch-ns -> 'YYYY-MM-DDTHH:MM:SS[.f...]Z'.  trim=true is RFC3339Nano
// (_time: trailing zeros trimmed, no fraction on whole seconds);
// trim=false renders exactly frac_w digits (stored ISO8601 columns are
// multiples of 10^(9-frac_w) by the round-trip property).  Digit-exact
// with storage/values_encoder.format_iso8601 (same civil-from-days
// algorithm, Howard Hinnant's).
inline int64_t fmt_ts(int64_t ns, int frac_w, bool trim, uint8_t* out) {
    const int64_t DAY = 86400LL * 1000000000LL;
    int64_t days = ns / DAY, rem = ns % DAY;
    if (rem < 0) { days -= 1; rem += DAY; }      // floor division
    const int64_t z = days + 719468;
    const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
    const int64_t doe = z - era * 146097;
    const int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096)
        / 365;
    int64_t y = yoe + era * 400;
    const int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
    const int64_t mp = (5 * doy + 2) / 153;
    const int64_t d = doy - (153 * mp + 2) / 5 + 1;
    const int64_t m = mp + (mp < 10 ? 3 : -9);
    if (m <= 2) y += 1;
    const int64_t secs = rem / 1000000000LL;
    int64_t frac = rem % 1000000000LL;
    const int64_t h = secs / 3600, mi = (secs % 3600) / 60,
                  s = secs % 60;
    out[0] = (uint8_t)('0' + (y / 1000) % 10);
    out[1] = (uint8_t)('0' + (y / 100) % 10);
    out[2] = (uint8_t)('0' + (y / 10) % 10);
    out[3] = (uint8_t)('0' + y % 10);
    out[4] = '-';
    out[5] = (uint8_t)('0' + m / 10);
    out[6] = (uint8_t)('0' + m % 10);
    out[7] = '-';
    out[8] = (uint8_t)('0' + d / 10);
    out[9] = (uint8_t)('0' + d % 10);
    out[10] = 'T';
    out[11] = (uint8_t)('0' + h / 10);
    out[12] = (uint8_t)('0' + h % 10);
    out[13] = ':';
    out[14] = (uint8_t)('0' + mi / 10);
    out[15] = (uint8_t)('0' + mi % 10);
    out[16] = ':';
    out[17] = (uint8_t)('0' + s / 10);
    out[18] = (uint8_t)('0' + s % 10);
    int64_t p = 19;
    int digits = 0;
    if (trim) {
        if (frac != 0) {
            digits = 9;
            while (frac % 10 == 0) { frac /= 10; digits--; }
        }
    } else if (frac_w > 0) {
        digits = frac_w;
        for (int k = 0; k < 9 - frac_w; k++) frac /= 10;
    }
    if (digits > 0) {
        out[p++] = '.';
        for (int i = digits - 1; i >= 0; i--) {
            out[p + i] = (uint8_t)('0' + frac % 10);
            frac /= 10;
        }
        p += digits;
    }
    out[p++] = 'Z';
    return p;
}

}  // namespace

extern "C" int64_t vl_emit_ndjson(
        int64_t ncols, int64_t nrows,
        const uint8_t* const* keys, const int64_t* key_lens,
        const uint8_t* const* arenas,
        const int64_t* const* offsets, const int64_t* const* lengths,
        const int64_t* kinds, const int64_t* params,
        uint8_t* out, int64_t out_cap) {
    for (int64_t c = 0; c < ncols; c++) {
        if (kinds[c] < 0 || kinds[c] > 4) return -3;
    }
    int64_t p = 0;
    for (int64_t r = 0; r < nrows; r++) {
        if (p + 3 > out_cap) return -2;
        out[p++] = '{';
        bool first = true;
        for (int64_t c = 0; c < ncols; c++) {
            const int64_t kind = kinds[c];
            if (kind == 0) {
                const int64_t len = lengths[c][r];
                if (len <= 0) continue;
                // worst case: ',' + key token + quotes + 6x value
                if (p + key_lens[c] + 6 * len + 6 > out_cap) return -2;
                if (!first) out[p++] = ',';
                first = false;
                std::memcpy(out + p, keys[c], (size_t)key_lens[c]);
                p += key_lens[c];
                out[p++] = '"';
                const int64_t np2 = emit_escaped(
                    arenas[c] + offsets[c][r], len, out, p);
                if (np2 < 0) return -1;
                p = np2;
                out[p++] = '"';
                continue;
            }
            // typed kinds: always present, pure ASCII, no escaping
            if (p + key_lens[c] + 40 > out_cap) return -2;
            if (!first) out[p++] = ',';
            first = false;
            std::memcpy(out + p, keys[c], (size_t)key_lens[c]);
            p += key_lens[c];
            out[p++] = '"';
            const int64_t* nums =
                reinterpret_cast<const int64_t*>(arenas[c]);
            switch (kind) {
                case 1:
                    p += fmt_ts(nums[r], 0, true, out + p);
                    break;
                case 2:
                    p += fmt_ts(nums[r], (int)params[c], false, out + p);
                    break;
                case 3:
                    p += fmt_i64(nums[r], out + p);
                    break;
                default:  // 4
                    p += fmt_u64(
                        reinterpret_cast<const uint64_t*>(arenas[c])[r],
                        out + p);
            }
            out[p++] = '"';
        }
        out[p++] = '}';
        out[p++] = '\n';
    }
    return p;
}

