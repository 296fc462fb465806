"""Device stats partials: which stats queries run on the card, and how a
cell of the kernels' output becomes the stats pipe's partial states.

`device_stats_spec(q)` maps `<filter> | stats [by (...)] <funcs...>` to
a `StatsSpec`: group-by axes (`_time:<duration>` buckets, dict fields,
numeric buckets), per-function partial kinds, the value columns the
value kernel reduces, the `count_uniq` fields (one dict-code axis each)
and the quantile/median fields (one per-value histogram axis each).  It
is None where any function or axis has no device form; the filter then
runs on the card and the stats pipe aggregates the rows on the host.

Exactness (why a device result equals the host executor's):
- value columns are storage-typed uint/int, whose encodings round-trip:
  every stored string is the canonical decimal of its value, so a min or
  max chosen numerically maps back to the string the host would pick;
- sums are exact int64 sums of uint32 offsets from the part minimum;
  a part is staged only while max|value| * rows < 2**53, so the host's
  float64 sum is exact too;
- `sum_len` and `count_empty` reduce derived columns (code-point length,
  0/1 empty flag) whose sum is the answer;
- count_uniq and quantile states stay the host's own (the value set,
  the value list rebuilt as [v] * count per cell), so finalize is the
  host's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..logsql import stats_funcs as sf
from ..logsql.duration import parse_duration
from ..logsql.matchers import parse_number
from ..logsql.pipes import PipeStats

MAX_BUCKETS = 8192                # widest cell product a part runs
MAX_ABS_TIMES_ROWS = 1 << 53      # keeps the host's float64 sums exact
MAX_QUANTILE_RANGE = 2048         # widest per-value histogram axis
# The TPU's MAX_STAT_ROWS (16M rows a part) bounds its four uint8
# byte-plane sums (255 * R < 2**32); the port sums in int64 and needs
# no such bound.

# Value-column tokens of the derived columns: `sum_len(f)` reduces the
# code-point lengths of f (stats_stage.stage_len_column), `count_empty(f)`
# its 0/1 empty flags (stage_empty_column).
SYNTH_LEN = "#synth:len:"
SYNTH_EMPTY = "#synth:empty:"


@dataclass
class FuncSpec:
    kind: str           # count | count_field | sum | avg | min | max |
    #                     sum_len | count_empty | uniq | quantile
    field: str | None   # value field (a SYNTH_ token for derived ones)


@dataclass
class ByKey:
    kind: str           # 'time' | 'field' | 'numbucket' | 'seg' (the
    #                     member axis of a packed unit, with_segment_axis)
    name: str = ""      # field name ('field' / 'numbucket')
    step: int = 0       # ns ('time')
    offset: int = 0     # ns ('time')
    fstep: float = 0.0  # numeric bucket size ('numbucket')
    foff: float = 0.0   # numeric bucket offset ('numbucket')


@dataclass
class StatsSpec:
    by: list               # list[ByKey] in the pipe's by order
    funcs: list            # list[FuncSpec], parallel to the pipe's funcs
    value_fields: list     # distinct value columns, staging order
    uniq_fields: list      # distinct count_uniq fields
    quantile_fields: list  # distinct quantile/median fields


def with_segment_axis(spec: StatsSpec) -> StatsSpec:
    """The spec of a packed unit (gpu/pipeline.py): a LEADING member
    axis (ByKey "seg"), so one reduction over several concatenated small
    parts yields each member's partials.  gpu/batch.py stages the
    per-row member ids from the pack's block -> member map, and every
    partial's key parts lead with ("s", member); the pipeline strips it
    and absorbs each member's partials in member order, the serial
    walk's granularity."""
    return StatsSpec(by=[ByKey("seg")] + list(spec.by), funcs=spec.funcs,
                     value_fields=spec.value_fields,
                     uniq_fields=spec.uniq_fields,
                     quantile_fields=spec.quantile_fields)


def _one_field(fn, allow_time: bool = True) -> str | None:
    f = fn.fields
    if len(f) == 1 and "*" not in f[0] and (allow_time or f[0] != "_time"):
        return f[0]
    return None


def _func_spec(fn) -> FuncSpec | None:
    """The device partial kind of one stats function, or None.  Exact
    type checks: rate and rate_sum keep count's and sum's states and
    only change finalize, which stays on the host."""
    t = type(fn)
    if t in (sf.StatsCount, sf.StatsRate):
        if not fn.fields:
            return FuncSpec("count", None)
        # an int-typed block has a value in every row, so count(field)
        # over eligible blocks is the masked row count
        fld = _one_field(fn)
        return None if fld is None else FuncSpec("count_field", fld)
    kinds = {sf.StatsSum: "sum", sf.StatsRateSum: "sum", sf.StatsAvg: "avg",
             sf.StatsMin: "min", sf.StatsMax: "max"}
    if t in kinds:
        fld = _one_field(fn)
        return None if fld is None else FuncSpec(kinds[t], fld)
    # _time is a virtual column no stager can see
    fld = _one_field(fn, allow_time=False)
    if fld is None:
        return None
    if t is sf.StatsSumLen:
        return FuncSpec("sum_len", SYNTH_LEN + fld)
    if t is sf.StatsCountEmpty:
        return FuncSpec("count_empty", SYNTH_EMPTY + fld)
    if t in (sf.StatsQuantile, sf.StatsMedian):
        return FuncSpec("quantile", fld)
    if t is sf.StatsCountUniq:
        return FuncSpec("uniq", fld)
    return None


def device_stats_spec(q) -> StatsSpec | None:
    """The device shape of a query whose first pipe is `stats`, or None:
    at most one `_time:<duration>` bucket, plain fields (dict/const
    columns, decided per part when staged), numeric buckets, and every
    function with a device partial and no `if (...)` guard."""
    if not q.pipes or not isinstance(q.pipes[0], PipeStats):
        return None
    ps = q.pipes[0]
    by: list[ByKey] = []
    n_time = 0
    for b in ps.by:
        if b.name == "_time" and b.bucket:
            if b.bucket.lower() in ("week", "month", "year"):
                return None         # calendar buckets have no fixed step
            d = parse_duration(b.bucket)
            if not d or d <= 0:
                return None
            n_time += 1
            if n_time > 1:
                return None
            by.append(ByKey("time", step=int(d), offset=b.offset_ns()))
            continue
        if b.name in ("_time", "_stream", "_stream_id") or "*" in b.name:
            return None
        if b.bucket:
            fstep = parse_number(b.bucket)
            if math.isnan(fstep) or fstep <= 0:
                # the host keys on the raw value: a plain dict axis
                by.append(ByKey("field", name=b.name))
                continue
            foff = parse_number(b.bucket_offset) if b.bucket_offset else 0.0
            if math.isnan(foff):
                foff = 0.0
            by.append(ByKey("numbucket", name=b.name, fstep=fstep,
                            foff=foff))
            continue
        by.append(ByKey("field", name=b.name))
    funcs = []
    for fn in ps.funcs:
        if fn.iff is not None:
            return None             # the guard's rows are the host's
        spec = _func_spec(fn)
        if spec is None:
            return None
        funcs.append(spec)
    fields: list[str] = []
    uniq: list[str] = []
    quant: list[str] = []
    for f in funcs:
        dest = uniq if f.kind == "uniq" else \
            quant if f.kind == "quantile" else fields
        if f.field is not None and f.field not in dest:
            dest.append(f.field)
    return StatsSpec(by=by, funcs=funcs, value_fields=fields,
                     uniq_fields=uniq, quantile_fields=quant)


def build_partial_states(spec: StatsSpec, pipe_funcs, count: int,
                         field_stats: dict, uniq_vals: dict | None = None,
                         quant_vals: dict | None = None) -> list:
    """One cell's states, parallel to pipe_funcs.

    field_stats: value field -> (sum, min, max) as exact integers;
    uniq_vals: count_uniq field -> the cell's value on its uniq axis;
    quant_vals: quantile field -> the cell's number on its histogram
    axis, contributing [v] * count, the list the host's update builds
    for these rows."""
    states = []
    for fs, fn in zip(spec.funcs, pipe_funcs):
        if fs.kind in ("count", "count_field"):
            states.append(count)
        elif fs.kind == "sum":
            s = field_stats[fs.field][0]
            states.append(float(s) if count else math.nan)
        elif fs.kind == "avg":
            states.append((float(field_stats[fs.field][0]), count))
        elif fs.kind in ("sum_len", "count_empty"):
            states.append(int(field_stats[fs.field][0]))
        elif fs.kind == "min":
            states.append(str(field_stats[fs.field][1]) if count else None)
        elif fs.kind == "max":
            states.append(str(field_stats[fs.field][2]) if count else None)
        elif fs.kind == "uniq":
            v = (uniq_vals or {}).get(fs.field, "")
            states.append({(v,)} if count and v != "" else set())
        elif fs.kind == "quantile":
            v = (quant_vals or {}).get(fs.field)
            states.append([float(v)] * count if count and v is not None
                          else [])
        else:  # pragma: no cover - _func_spec gates the kinds
            raise AssertionError(fs.kind)
    return states
