"""Per-block column type inference and encoding.

Mirrors the reference's values encoder semantics (lib/logstorage/
values_encoder.go:109-154): for each column in a block, try encodings in order
dict -> uint{8,16,32,64} -> int64 -> float64 -> IPv4 -> ISO8601 timestamp ->
raw string, accepting an encoding only when decoding reproduces every original
string byte-for-byte (round-trip property).  Numeric columns additionally
record min/max for header-level range pruning.

Unlike the reference (per-value byte parsing in Go), attempts are vectorized
with numpy over the whole column; the accepted representation *is* the
in-memory query-time representation (typed numpy arrays / byte arenas), which
is also exactly what the device staging path uploads.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

# value types (stable on-disk ids)
VT_STRING = 0
VT_CONST = 1
VT_DICT = 2
VT_UINT8 = 3
VT_UINT16 = 4
VT_UINT32 = 5
VT_UINT64 = 6
VT_INT64 = 7
VT_FLOAT64 = 8
VT_IPV4 = 9
VT_TIMESTAMP_ISO8601 = 10

VT_NAMES = {
    VT_STRING: "string",
    VT_CONST: "const",
    VT_DICT: "dict",
    VT_UINT8: "uint8",
    VT_UINT16: "uint16",
    VT_UINT32: "uint32",
    VT_UINT64: "uint64",
    VT_INT64: "int64",
    VT_FLOAT64: "float64",
    VT_IPV4: "ipv4",
    VT_TIMESTAMP_ISO8601: "iso8601",
}

MAX_DICT_ENTRIES = 8  # reference: consts.go:61-70
MAX_DICT_BYTES = 256

_UINT_DTYPES = [(VT_UINT8, np.uint8), (VT_UINT16, np.uint16),
                (VT_UINT32, np.uint32), (VT_UINT64, np.uint64)]

_IPV4_RE = re.compile(r"^(\d{1,3})\.(\d{1,3})\.(\d{1,3})\.(\d{1,3})$")
_ISO8601_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})T(\d{2}):(\d{2}):(\d{2})(?:\.(\d{1,9}))?Z$")


@dataclass
class EncodedColumn:
    """A type-encoded column for one block."""

    name: str
    vtype: int
    # payloads by type:
    const_value: str | None = None                 # VT_CONST
    dict_values: list[str] | None = None           # VT_DICT
    ids: np.ndarray | None = None                  # VT_DICT: uint8[R]
    nums: np.ndarray | None = None                 # numeric types
    arena: np.ndarray | None = None                # VT_STRING: uint8[N]
    offsets: np.ndarray | None = None              # VT_STRING: int64[R]
    lengths: np.ndarray | None = None              # VT_STRING: int64[R]
    min_val: float = 0.0                           # numeric min (as float)
    max_val: float = 0.0
    iso_frac_w: int = 0                            # VT_TIMESTAMP fractional digits
    bloom: np.ndarray | None = None                # uint64 words (set later)
    # the distinct token hashes the bloom was built from (a fresh block;
    # None once read back from disk): the filter index's input at a seal
    token_hashes: np.ndarray | None = None
    _strings_cache: list[str] | None = field(default=None, repr=False)

    def to_strings(self, nrows: int) -> list[str]:
        """Decode back to the original string values (round-trip exact)."""
        if self._strings_cache is not None:
            return self._strings_cache
        out = decode_values(self, nrows)
        self._strings_cache = out
        return out


def _round_trip_uint(values: np.ndarray):
    try:
        u = values.astype(np.uint64)
    except (ValueError, OverflowError):
        return None
    back = u.astype(values.dtype)
    if back.shape != values.shape or not np.array_equal(back, values):
        return None
    return u


def _format_floats(f: np.ndarray) -> np.ndarray:
    # canonical float formatting = Python repr via numpy astype(U)
    return f.astype("U32")


def encode_values(name: str, values: list[str]) -> EncodedColumn:
    """Infer the tightest type for a column of strings and encode it."""
    nrows = len(values)
    assert nrows > 0
    first = values[0]

    # const
    all_same = True
    for v in values:
        if v != first:
            all_same = False
            break
    if all_same:
        return EncodedColumn(name=name, vtype=VT_CONST, const_value=first,
                             _strings_cache=values)

    # dict (<=8 distinct entries, <=256 total bytes)
    uniq: dict[str, int] = {}
    for v in values:
        if v not in uniq:
            if len(uniq) >= MAX_DICT_ENTRIES:
                uniq = None  # type: ignore
                break
            uniq[v] = len(uniq)
    if uniq is not None:
        dvals = list(uniq.keys())
        if sum(len(s.encode("utf-8")) for s in dvals) <= MAX_DICT_BYTES:
            ids = np.fromiter((uniq[v] for v in values), dtype=np.uint8,
                              count=nrows)
            return EncodedColumn(name=name, vtype=VT_DICT, dict_values=dvals,
                                 ids=ids, _strings_cache=values)

    arr = np.asarray(values, dtype="U")
    col = try_typed_encoding(name, arr, first, lambda: values)
    if col is not None:
        col._strings_cache = values
        return col

    # raw string arena
    bvals = [v.encode("utf-8") for v in values]
    lengths = np.fromiter((len(b) for b in bvals), dtype=np.int64, count=nrows)
    offsets = np.zeros(nrows, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    arena = np.frombuffer(b"".join(bvals), dtype=np.uint8)
    return EncodedColumn(name=name, vtype=VT_STRING, arena=arena,
                         offsets=offsets, lengths=lengths,
                         _strings_cache=values)


def try_typed_encoding(name: str, arr: np.ndarray, first: str,
                       get_values) -> EncodedColumn | None:
    """The uint{8..64} -> int64 -> float64 -> IPv4 -> ISO8601 trial
    cascade over the column (`arr`: its values as a U-dtype array,
    `first` the first value), or None when no typed encoding
    round-trips.  Shared by encode_values and the arena encode
    (storage/block_build.encode_arena_column), so both accept an
    encoding on the same evidence; `get_values()` gives the values as
    a list of str, which only the IPv4 and ISO8601 trials walk."""
    # uint8..uint64
    if first[:1].isdigit():
        u = _round_trip_uint(arr)
        if u is not None:
            mx = int(u.max())
            for vt, dt in _UINT_DTYPES:
                if mx <= int(np.iinfo(dt).max):
                    return EncodedColumn(
                        name=name, vtype=vt, nums=u.astype(dt),
                        min_val=float(u.min()), max_val=float(mx))

    # int64
    if first[:1] == "-" or first[:1].isdigit():
        try:
            i = arr.astype(np.int64)
        except (ValueError, OverflowError):
            i = None
        if i is not None and np.array_equal(i.astype(arr.dtype), arr):
            return EncodedColumn(name=name, vtype=VT_INT64, nums=i,
                                 min_val=float(i.min()),
                                 max_val=float(i.max()))

    # float64 (round-trip through canonical formatting)
    try:
        f = arr.astype(np.float64)
    except ValueError:
        f = None
    if f is not None and np.isfinite(f).all():
        if np.array_equal(_format_floats(f).astype(arr.dtype), arr):
            return EncodedColumn(name=name, vtype=VT_FLOAT64, nums=f,
                                 min_val=float(f.min()),
                                 max_val=float(f.max()))

    # IPv4
    if _IPV4_RE.match(first):
        ip = _try_ipv4(get_values())
        if ip is not None:
            return EncodedColumn(name=name, vtype=VT_IPV4, nums=ip,
                                 min_val=float(ip.min()),
                                 max_val=float(ip.max()))

    # ISO8601 timestamp (uniform fractional width)
    if len(first) >= 20 and first[4:5] == "-" and first.endswith("Z"):
        parsed = _try_iso8601(get_values())
        if parsed is not None:
            ts, frac_w = parsed
            return EncodedColumn(name=name, vtype=VT_TIMESTAMP_ISO8601,
                                 nums=ts, min_val=float(ts.min()),
                                 max_val=float(ts.max()),
                                 iso_frac_w=frac_w)
    return None


def _try_ipv4(values: list[str]) -> np.ndarray | None:
    out = np.empty(len(values), dtype=np.uint32)
    for i, v in enumerate(values):
        m = _IPV4_RE.match(v)
        if m is None:
            return None
        a, b, c, d = m.groups()
        # reject non-canonical octets like "01"
        if (len(a) > 1 and a[0] == "0") or (len(b) > 1 and b[0] == "0") or \
           (len(c) > 1 and c[0] == "0") or (len(d) > 1 and d[0] == "0"):
            return None
        ai, bi, ci, di = int(a), int(b), int(c), int(d)
        if ai > 255 or bi > 255 or ci > 255 or di > 255:
            return None
        out[i] = (ai << 24) | (bi << 16) | (ci << 8) | di
    return out


_EPOCH_DAYS_CACHE: dict[tuple[int, int, int], int] = {}


def _days_from_civil(y: int, m: int, d: int) -> int:
    key = (y, m, d)
    v = _EPOCH_DAYS_CACHE.get(key)
    if v is None:
        # Howard Hinnant's civil-days algorithm
        y2 = y - (m <= 2)
        era = (y2 if y2 >= 0 else y2 - 399) // 400
        yoe = y2 - era * 400
        doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
        doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
        v = era * 146097 + doe - 719468
        _EPOCH_DAYS_CACHE[key] = v
    return v


def _try_iso8601(values: list[str]) -> tuple[np.ndarray, int] | None:
    """Parse strictly-formatted UTC timestamps into int64 nanos.

    Requires every value to share the same fractional-digit width so that
    formatting round-trips (reference requires one exact layout per block).
    """
    m0 = _ISO8601_RE.match(values[0])
    if m0 is None:
        return None
    frac0 = m0.group(7)
    frac_w = len(frac0) if frac0 is not None else 0
    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values):
        m = _ISO8601_RE.match(v)
        if m is None:
            return None
        y, mo, d, h, mi, s, frac = m.groups()
        if (len(frac) if frac is not None else 0) != frac_w:
            return None
        mo_i, d_i, h_i, mi_i, s_i = int(mo), int(d), int(h), int(mi), int(s)
        if not (1 <= mo_i <= 12 and 1 <= d_i <= _days_in_month(int(y), mo_i)
                and h_i < 24 and mi_i < 60 and s_i < 60):
            return None
        days = _days_from_civil(int(y), mo_i, d_i)
        ns = ((days * 86400 + h_i * 3600 + mi_i * 60 + s_i) * 1_000_000_000)
        if frac_w:
            ns += int(frac) * 10 ** (9 - frac_w)
        out[i] = ns
    return out, frac_w


_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month(y: int, m: int) -> int:
    if m == 2 and (y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)):
        return 29
    return _MONTH_DAYS[m - 1]


def format_iso8601(ns: int, frac_w: int) -> str:
    days, rem = divmod(ns, 86400 * 1_000_000_000)
    # civil from days (inverse of _days_from_civil)
    z = days + 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    y += m <= 2
    secs, frac_ns = divmod(rem, 1_000_000_000)
    h, rem_s = divmod(secs, 3600)
    mi, s = divmod(rem_s, 60)
    base = f"{y:04d}-{m:02d}-{d:02d}T{h:02d}:{mi:02d}:{s:02d}"
    if frac_w:
        frac = frac_ns // 10 ** (9 - frac_w)
        base += f".{frac:0{frac_w}d}"
    return base + "Z"


def decode_values(col: EncodedColumn, nrows: int,
                  rows: np.ndarray | None = None) -> list[str]:
    """Decode a column back to its original strings: all `nrows` rows,
    or only the rows at the int indexes `rows`."""
    def pick(a):
        return a if rows is None else a[rows]

    vt = col.vtype
    if vt == VT_CONST:
        return [col.const_value] * (nrows if rows is None else len(rows))
    if vt == VT_DICT:
        dv = col.dict_values
        return [dv[i] for i in pick(col.ids).tolist()]  # type: ignore[index]
    if vt in (VT_UINT8, VT_UINT16, VT_UINT32, VT_UINT64, VT_INT64):
        return pick(col.nums).astype("U20").tolist()  # type: ignore[union-attr]
    if vt == VT_FLOAT64:
        return _format_floats(pick(col.nums)).tolist()  # type: ignore[arg-type]
    if vt == VT_IPV4:
        n = pick(col.nums)
        return [f"{(v >> 24) & 255}.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}"
                for v in n.tolist()]
    if vt == VT_TIMESTAMP_ISO8601:
        return [format_iso8601(v, col.iso_frac_w)
                for v in pick(col.nums).tolist()]
    # VT_STRING
    buf = col.arena.tobytes()
    offs = pick(col.offsets).tolist()
    lens = pick(col.lengths).tolist()
    return [buf[o:o + l].decode("utf-8", "replace")
            for o, l in zip(offs, lens)]
