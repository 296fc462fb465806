"""LogsQL stats functions of the port's stats pipe.

Each function keeps one mutable state per group: `new_state`, `update`
over a block's selected rows, `merge` of two states and `finalize` to
the result string.  Device runners hand the stats pipe partial states
built from per-cell kernel outputs (gpu/stats_device.py
`build_partial_states`), which merge exactly like states updated from
rows, so a device result equals the host executor's.

Functions: count, count_empty, sum, sum_len, min, max, avg, count_uniq,
quantile, median, rate and rate_sum, which have device partials, and
count_uniq_hash, uniq_values, values, histogram, row_min, row_max,
json_values and row_any, which run on the host only.  A function may
carry an `if (filter)` guard (`iff`): it then sees only the rows the
filter keeps.  Functions that collect values charge the stats pipe's
memory budget (`budget`) as their states grow.
"""

from __future__ import annotations

import json
import math

import numpy as np

from ..storage.values_encoder import _format_floats
from ..utils.hashing import xxh64
from .matchers import parse_number


def format_number(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "inf" if v > 0 else "-inf"
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 2**63:
        return str(int(v))
    return repr(float(v))


class StatsFunc:
    """Base: a parsed stats function with its input fields and result
    name."""

    name = "?"
    iff = None          # the `if (filter)` row guard, or None
    budget = None       # the stats pipe's MemoryBudget, set by its processor

    def __init__(self, fields: list[str], out_name: str = ""):
        self.fields = fields
        self.out_name = out_name or self.default_name()

    def default_name(self) -> str:
        return f"{self.name}({', '.join(self.fields)})"

    def to_string(self) -> str:
        s = f"{self.name}({', '.join(self.fields)})"
        if self.iff is not None:
            s += f" if ({self.iff.to_string()})"
        if self.out_name != self.default_name():
            s += f" as {self.out_name}"
        return s

    def needed_fields(self) -> set:
        out = set(self.fields)
        if self.iff is not None:
            out |= self.iff.needed_fields()
        return out

    def _charge(self, nbytes: int) -> None:
        if self.budget is not None and nbytes:
            self.budget.add(nbytes)

    def new_state(self):
        raise NotImplementedError

    def block_cols(self, br):
        """What `update` reads of a block: one column per field."""
        return [br.column(f) for f in self.fields]

    def update(self, state, cols, idxs):
        """The state after the rows `idxs` (a list) of `cols`."""
        raise NotImplementedError

    def merge(self, a, b):
        raise NotImplementedError

    def finalize(self, state) -> str:
        raise NotImplementedError


class StatsCount(StatsFunc):
    name = "count"

    def default_name(self):
        return "count(*)" if not self.fields else super().default_name()

    def new_state(self):
        return 0

    def update(self, state, cols, idxs):
        if not self.fields:
            return state + len(idxs)
        n = state
        for i in idxs:
            if any(c[i] != "" for c in cols):
                n += 1
        return n

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return str(state)


class StatsCountEmpty(StatsFunc):
    name = "count_empty"

    def new_state(self):
        return 0

    def update(self, state, cols, idxs):
        n = state
        for i in idxs:
            if all(c[i] == "" for c in cols):
                n += 1
        return n

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return str(state)


def _numeric_cols(fn, br) -> list:
    """Typed numeric columns as float64 arrays (no per-row parsing),
    others as string lists."""
    out = []
    for f in fn.fields:
        num = br.numeric_column(f)
        out.append(num if num is not None else br.column(f))
    return out


def _numbers(c, idxs) -> np.ndarray:
    """float64 values of rows `idxs` of one column, non-numbers skipped:
    the typed array's entries, or each non-empty string's
    parse_number."""
    if isinstance(c, np.ndarray):
        sub = c if len(idxs) == c.shape[0] else c[idxs]
        return sub[~np.isnan(sub)]
    return np.asarray([v for i in idxs
                       if c[i] and not math.isnan(v := parse_number(c[i]))],
                      dtype=np.float64)


class StatsSum(StatsFunc):
    name = "sum"

    def new_state(self):
        return math.nan

    block_cols = _numeric_cols

    def update(self, state, cols, idxs):
        # one np.sum (pairwise) per block and column on either path, so
        # typed and string columns give bit-identical float sums
        s = state
        for c in cols:
            buf = _numbers(c, idxs)
            if buf.size:
                add = float(np.sum(buf))
                s = add if math.isnan(s) else s + add
        return s

    def merge(self, a, b):
        if math.isnan(a):
            return b
        if math.isnan(b):
            return a
        return a + b

    def finalize(self, state):
        return format_number(state) if not math.isnan(state) else "NaN"


class StatsSumLen(StatsFunc):
    name = "sum_len"

    def new_state(self):
        return 0

    def update(self, state, cols, idxs):
        s = state
        for c in cols:
            for i in idxs:
                s += len(c[i])
        return s

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return str(state)


def _num_or_str_less(a: str, b: str) -> bool:
    """Numeric compare when both parse, numbers before strings, else
    string order."""
    fa, fb = parse_number(a), parse_number(b)
    if not math.isnan(fa) and not math.isnan(fb):
        if fa != fb:
            return fa < fb
        return a < b
    if not math.isnan(fa):
        return True
    if not math.isnan(fb):
        return False
    return a < b


def _min_max_reduce(vals, want_min: bool, best: str | None = None):
    """The min or max of string values in `_num_or_str_less` order,
    empty values skipped."""
    for v in vals:
        if v == "":
            continue
        if best is None or (_num_or_str_less(v, best) if want_min
                            else _num_or_str_less(best, v)):
            best = v
    return best


class _TypedMinMaxCol:
    """A block's typed numeric or dict column for min/max: the numeric
    extreme maps back to the stored string (numeric encodings round-trip
    exactly), a dict column reduces over its distinct codes, and a block
    whose header bounds cannot improve the state is never decoded."""
    __slots__ = ("br", "name", "is_dict")

    def __init__(self, br, name, is_dict: bool):
        self.br = br
        self.name = name
        self.is_dict = is_dict

    def skip(self, best, want_min: bool) -> bool:
        """True when the block header proves no row beats `best`
        (strictly, so numeric ties still take the string tiebreak)."""
        if self.is_dict or best is None:
            return False
        hdr = self.br.header_min_max(self.name)
        fb = parse_number(best)
        if hdr is None or math.isnan(fb):
            return False
        return fb < hdr[0] if want_min else fb > hdr[1]

    def candidate(self, idxs, want_min: bool) -> str | None:
        """The extreme among rows `idxs` as the stored string."""
        if self.is_dict:
            ids, dvals = self.br.dict_column(self.name)
            sub = ids if len(idxs) == ids.shape[0] else ids[idxs]
            if not sub.size:
                return None
            return _min_max_reduce((dvals[j] for j in np.unique(sub)),
                                   want_min)
        arr, is_int = self.br.typed_numeric(self.name)
        sub = arr if len(idxs) == arr.shape[0] else arr[idxs]
        if not sub.size:
            return None
        m = sub.min() if want_min else sub.max()
        if is_int:
            return str(int(m))
        return str(_format_floats(np.array([m]))[0])


class StatsMin(StatsFunc):
    name = "min"
    _want_min = True

    def new_state(self):
        return None

    def block_cols(self, br):
        out = []
        for f in self.fields:
            if br.header_min_max(f) is not None:
                out.append(_TypedMinMaxCol(br, f, is_dict=False))
            elif br.dict_column(f) is not None:
                out.append(_TypedMinMaxCol(br, f, is_dict=True))
            else:
                out.append(br.column(f))
        return out

    def _better(self, a: str, b: str) -> bool:
        return _num_or_str_less(a, b) if self._want_min else \
            _num_or_str_less(b, a)

    def update(self, state, cols, idxs):
        best = state
        for c in cols:
            if isinstance(c, _TypedMinMaxCol):
                if c.skip(best, self._want_min):
                    continue
                got = c.candidate(idxs, self._want_min)
                if got is not None and (best is None or
                                        self._better(got, best)):
                    best = got
                continue
            best = _min_max_reduce((c[i] for i in idxs), self._want_min,
                                   best)
        return best

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return b if self._better(b, a) else a

    def finalize(self, state):
        return state if state is not None else ""


class StatsMax(StatsMin):
    name = "max"
    _want_min = False


class StatsAvg(StatsFunc):
    name = "avg"

    def new_state(self):
        return (0.0, 0)  # (sum, count)

    block_cols = _numeric_cols

    def update(self, state, cols, idxs):
        s, n = state
        for c in cols:
            buf = _numbers(c, idxs)
            if buf.size:
                s += float(np.sum(buf))
                n += int(buf.size)
        return (s, n)

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def finalize(self, state):
        s, n = state
        return format_number(s / n) if n else "NaN"


class StatsCountUniq(StatsFunc):
    """The number of distinct non-empty values (tuples of the fields);
    the state is the exact set, so device cells merge by union."""

    name = "count_uniq"

    def __init__(self, fields, out_name="", limit: int = 0):
        super().__init__(fields, out_name)
        self.limit = limit

    def new_state(self):
        return set()

    def update(self, state, cols, idxs):
        if self.limit and len(state) >= self.limit:
            return state
        if len(cols) == 1:
            vals = cols[0]
            if len(idxs) == len(vals):
                state |= {(v,) for v in vals if v != ""}
            else:
                state |= {(vals[i],) for i in idxs if vals[i] != ""}
            return state
        for i in idxs:
            key = tuple(c[i] for c in cols)
            if any(k != "" for k in key):
                state.add(key)
        return state

    def merge(self, a, b):
        a |= b
        return a

    def finalize(self, state):
        n = len(state)
        if self.limit and n > self.limit:
            n = self.limit
        return str(n)


class StatsQuantile(StatsFunc):
    """The phi-quantile of the numeric values: the state is their list,
    so device cells contribute [value] * count."""

    name = "quantile"

    def __init__(self, phi: float, fields, out_name=""):
        self.phi = phi
        super().__init__(fields, out_name)

    def default_name(self):
        return f"quantile({format_number(self.phi)}, " \
            f"{', '.join(self.fields)})"

    def to_string(self):
        # quantile and median render no `if` guard, as in the JAX package
        s = self.default_name()
        if self.out_name != self.default_name():
            s += f" as {self.out_name}"
        return s

    def new_state(self):
        return []

    block_cols = _numeric_cols

    def update(self, state, cols, idxs):
        for c in cols:
            state.extend(_numbers(c, idxs).tolist())
        return state

    def merge(self, a, b):
        a.extend(b)
        return a

    def finalize(self, state):
        if not state:
            return "NaN"
        vs = sorted(state)
        idx = int(self.phi * len(vs))
        if idx >= len(vs):
            idx = len(vs) - 1
        return format_number(vs[idx])


class StatsMedian(StatsQuantile):
    name = "median"

    def __init__(self, fields, out_name=""):
        super().__init__(0.5, fields, out_name)

    def default_name(self):
        return f"median({', '.join(self.fields)})"


class StatsRate(StatsCount):
    """count() over the seconds of the query's time filter
    (`step_seconds`, set by the executor; 0 leaves the count)."""

    name = "rate"
    step_seconds: float = 0.0

    def finalize(self, state):
        v = float(state)
        if self.step_seconds > 0:
            v /= self.step_seconds
        return format_number(v)


class StatsRateSum(StatsSum):
    """sum() over the seconds of the query's time filter."""

    name = "rate_sum"
    step_seconds: float = 0.0

    def finalize(self, state):
        if math.isnan(state):
            return "NaN"
        v = state
        if self.step_seconds > 0:
            v /= self.step_seconds
        return format_number(v)


# ---------------- host-only functions ----------------

class StatsCountUniqHash(StatsCountUniq):
    """count_uniq over the xxhash64 of each value tuple: the state holds
    8-byte hashes instead of the values."""

    name = "count_uniq_hash"

    def update(self, state, cols, idxs):
        if self.limit and len(state) >= self.limit:
            return state
        for i in idxs:
            key = tuple(c[i] for c in cols)
            if any(k != "" for k in key):
                state.add(xxh64("\x00".join(key).encode("utf-8")))
        return state


def _uniq_sort_key(v: str):
    f = parse_number(v)
    return ((0, f) if not math.isnan(f) else (1, 0), v)


class StatsUniqValues(StatsFunc):
    """The distinct non-empty values as a JSON array, numbers first by
    value, then strings."""

    name = "uniq_values"

    def __init__(self, fields, out_name="", limit: int = 0):
        super().__init__(fields, out_name)
        self.limit = limit

    def new_state(self):
        return set()

    def update(self, state, cols, idxs):
        grown = 0
        for c in cols:
            for i in idxs:
                v = c[i]
                if v != "" and v not in state:
                    state.add(v)
                    grown += len(v) + 56
        self._charge(grown)
        return state

    def merge(self, a, b):
        a |= b
        return a

    def finalize(self, state):
        vals = sorted(state, key=_uniq_sort_key)
        if self.limit and len(vals) > self.limit:
            vals = vals[:self.limit]
        return json.dumps(vals, separators=(",", ":")) if vals else ""


class StatsValues(StatsFunc):
    """Every value, empty ones included, as a JSON array in row order."""

    name = "values"

    def __init__(self, fields, out_name="", limit: int = 0):
        super().__init__(fields, out_name)
        self.limit = limit

    def new_state(self):
        return []

    def update(self, state, cols, idxs):
        grown = 0
        for c in cols:
            for i in idxs:
                state.append(c[i])
                grown += len(c[i]) + 48
        self._charge(grown)
        return state

    def merge(self, a, b):
        a.extend(b)
        return a

    def finalize(self, state):
        vals = state
        if self.limit and len(vals) > self.limit:
            vals = vals[:self.limit]
        return json.dumps(vals, separators=(",", ":")) if vals else ""


# histogram: VictoriaMetrics vmrange buckets, 18 a decade
_HIST_BUCKETS_PER_DECIMAL = 18
_HIST_LOWER = 1e-9
_HIST_UPPER = 1e18


def _vmrange(v: float) -> str:
    """The log-scale bucket label of v >= 0."""
    if v < _HIST_LOWER:
        return f"0...{_HIST_LOWER:.3e}"
    if v > _HIST_UPPER:
        return f"{_HIST_UPPER:.3e}...+Inf"
    idx = math.floor(math.log10(v) * _HIST_BUCKETS_PER_DECIMAL + 1e-9)
    lo = 10 ** (idx / _HIST_BUCKETS_PER_DECIMAL)
    hi = 10 ** ((idx + 1) / _HIST_BUCKETS_PER_DECIMAL)
    if v > hi:  # float rounding at a bucket edge
        idx += 1
        lo, hi = hi, 10 ** ((idx + 1) / _HIST_BUCKETS_PER_DECIMAL)
    return f"{lo:.3e}...{hi:.3e}"


def _vmrange_sort_key(r: str):
    try:
        return float(r.split("...", 1)[0])
    except ValueError:
        return math.inf


class StatsHistogram(StatsFunc):
    """Hits per vmrange bucket of the non-negative numbers, as a JSON
    array in bucket order."""

    name = "histogram"

    def new_state(self):
        return {}

    def update(self, state, cols, idxs):
        for c in cols:
            for i in idxs:
                v = parse_number(c[i]) if c[i] else math.nan
                if math.isnan(v) or v < 0:
                    continue
                r = _vmrange(v)
                state[r] = state.get(r, 0) + 1
        return state

    def merge(self, a, b):
        for k, v in b.items():
            a[k] = a.get(k, 0) + v
        return a

    def finalize(self, state):
        out = [{"vmrange": r, "hits": state[r]}
               for r in sorted(state, key=_vmrange_sort_key)]
        return json.dumps(out, separators=(",", ":"))


class StatsRowMin(StatsFunc):
    """The row (all its fields, or the named ones) where the first field
    is least, as a JSON object."""

    name = "row_min"
    _want_max = False

    def __init__(self, fields, out_name=""):
        if not fields:
            raise ValueError(f"{self.name} needs a source field")
        self.src_field = fields[0]
        self.row_fields = fields[1:]
        super().__init__(fields, out_name)

    def needed_fields(self):
        if self.row_fields:
            return {self.src_field, *self.row_fields}
        return {"*"}

    def block_cols(self, br):
        names = self.row_fields or br.column_names()
        return [br.column(self.src_field),
                [(n, br.column(n)) for n in names]]

    def new_state(self):
        return None         # (source value, row dict)

    def _better(self, a: str, b: str) -> bool:
        return _num_or_str_less(b, a) if self._want_max \
            else _num_or_str_less(a, b)

    def update(self, state, cols, idxs):
        src, row_cols = cols
        best = state
        for i in idxs:
            v = src[i]
            if v == "":
                continue
            if best is None or self._better(v, best[0]):
                best = (v, {n: c[i] for n, c in row_cols if c[i] != ""})
        return best

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a if self._better(a[0], b[0]) else b

    def finalize(self, state):
        return json.dumps(state[1], separators=(",", ":")) \
            if state is not None else ""


class StatsRowMax(StatsRowMin):
    name = "row_max"
    _want_max = True


class StatsJSONValues(StatsFunc):
    """Each row (all its fields, or the named ones) as a JSON object,
    collected into one JSON array."""

    name = "json_values"

    def __init__(self, fields, out_name="", limit: int = 0):
        super().__init__(fields, out_name)
        self.limit = limit

    def needed_fields(self):
        return set(self.fields) if self.fields else {"*"}

    def block_cols(self, br):
        names = self.fields or br.column_names()
        return [[(n, br.column(n)) for n in names]]

    def new_state(self):
        return []

    def update(self, state, cols, idxs):
        if self.limit and len(state) >= self.limit:
            return state
        grown = 0
        for i in idxs:
            item = json.dumps({n: c[i] for n, c in cols[0]},
                              separators=(",", ":"), ensure_ascii=False)
            state.append(item)
            grown += len(item) + 48
            if self.limit and len(state) >= self.limit:
                break
        self._charge(grown)
        return state

    def merge(self, a, b):
        a.extend(b)
        return a

    def finalize(self, state):
        items = state
        if self.limit and len(items) > self.limit:
            items = items[:self.limit]
        return "[" + ",".join(items) + "]"


class StatsRowAny(StatsFunc):
    """The first row a group sees (all its fields, or the named ones), as
    a JSON object."""

    name = "row_any"

    def default_name(self):
        return "row_any(*)" if not self.fields else super().default_name()

    def needed_fields(self):
        out = super().needed_fields()
        return out if self.fields else out | {"*"}

    def new_state(self):
        return None

    def block_cols(self, br):
        names = self.fields or br.column_names()
        return [(n, br.column(n)) for n in names]

    def update(self, state, cols, idxs):
        if state is not None or not idxs:
            return state
        i = idxs[0]
        return {f: c[i] for f, c in cols if c[i] != ""}

    def merge(self, a, b):
        return a if a is not None else b

    def finalize(self, state):
        return json.dumps(state, separators=(",", ":")) \
            if state is not None else ""
