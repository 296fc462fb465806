"""Shared ingestion plumbing: per-request params, row batching, timestamps.

CommonParams come from the request's query args or headers
(`_time_field`, `_msg_field`, `_stream_fields`, `ignore_fields`,
`decolorize_fields`, `extra_fields`, `default_msg_value`, `debug`), the
tenant from the AccountID/ProjectID headers or args.  A
LogMessageProcessor gathers a request's rows into LogRows batches and
hands each full batch, and the rest on flush(), to its sink; it starts
no thread, so the caller flushes at the end of a request.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field

from ..logsql.duration import parse_rfc3339
from ..storage.log_rows import LogRows, TenantID, match_any

MAX_BATCH_ROWS = 100_000
MAX_BATCH_BYTES = 50 << 20


def get_tenant_id(headers, args) -> TenantID:
    """Tenant from AccountID/ProjectID headers or query args."""
    acc = headers.get("AccountID") or args.get("AccountID") or "0"
    proj = headers.get("ProjectID") or args.get("ProjectID") or "0"
    try:
        return TenantID(int(acc), int(proj))
    except ValueError:
        return TenantID()


def _csv(s: str | None) -> list[str]:
    if not s:
        return []
    return [x.strip() for x in s.split(",") if x.strip()]


@dataclass
class CommonParams:
    tenant: TenantID = dc_field(default_factory=TenantID)
    time_field: str = "_time"
    msg_fields: list = dc_field(default_factory=lambda: ["_msg"])
    stream_fields: list = dc_field(default_factory=list)
    ignore_fields: list = dc_field(default_factory=list)
    decolorize_fields: list = dc_field(default_factory=list)
    extra_fields: list = dc_field(default_factory=list)
    default_msg_value: str = ""
    debug: bool = False

    @staticmethod
    def from_request(headers, args) -> "CommonParams":
        def hv(name, hdr):
            return args.get(name) or headers.get(hdr) or ""
        cp = CommonParams()
        cp.tenant = get_tenant_id(headers, args)
        cp.time_field = hv("_time_field", "VL-Time-Field") or "_time"
        msg = _csv(hv("_msg_field", "VL-Msg-Field"))
        if msg:
            cp.msg_fields = msg
        cp.stream_fields = _csv(hv("_stream_fields", "VL-Stream-Fields"))
        cp.ignore_fields = _csv(hv("ignore_fields", "VL-Ignore-Fields"))
        cp.decolorize_fields = _csv(hv("decolorize_fields",
                                       "VL-Decolorize-Fields"))
        cp.extra_fields = [tuple(ef.split("=", 1)) for ef in
                           _csv(hv("extra_fields", "VL-Extra-Fields"))
                           if "=" in ef]
        cp.default_msg_value = args.get("default_msg_value") or ""
        cp.debug = hv("debug", "VL-Debug").lower() in ("1", "true", "y")
        return cp


def parse_timestamp(v, default_ns: int | None = None) -> int | None:
    """Nanoseconds of a log timestamp: an RFC3339 string, or a unix time
    (a number or its decimal string) in seconds, milliseconds,
    microseconds or nanoseconds told apart by magnitude; a float is
    seconds with a fraction.  None, "" and 0 are `default_ns`, else now;
    an unparsable string is None."""
    if v is None or v == "" or v == 0:
        return default_ns if default_ns is not None else time.time_ns()
    if isinstance(v, str):
        if v.isascii() and v.isdigit():
            v = int(v)
        else:
            ts = parse_rfc3339(v)
            if ts is not None:
                return ts
            try:
                v = float(v) if ("." in v or "e" in v or "E" in v) \
                    else int(v)
            except ValueError:
                return None
    if isinstance(v, float):
        return int(v * 1e9)
    if isinstance(v, int):
        if v < (1 << 32):           # seconds until year 2106
            return v * 1_000_000_000
        if v < (1 << 32) * 1_000:   # milliseconds
            return v * 1_000_000
        if v < (1 << 32) * 1_000_000:
            return v * 1_000
        return v
    return None


def decolorize(s: str) -> str:
    """Strip ANSI CSI escape sequences (`ESC [ ... final byte`)."""
    if "\x1b[" not in s:
        return s
    out = []
    i, n = 0, len(s)
    while i < n:
        if s[i] == "\x1b" and i + 1 < n and s[i + 1] == "[":
            i += 2
            while i < n and not ("@" <= s[i] <= "~"):
                i += 1
            i += 1  # final byte
            continue
        out.append(s[i])
        i += 1
    return "".join(out)


class LogRowsStorage:
    """Where a LogMessageProcessor's batches go."""

    def must_add_rows(self, lr: LogRows) -> None:
        raise NotImplementedError


class LocalLogRowsStorage(LogRowsStorage):
    """Batches into a local Storage, rows or columns."""

    def __init__(self, storage):
        self.storage = storage

    def must_add_rows(self, lr: LogRows) -> None:
        self.storage.must_add_rows(lr)

    def must_add_columns(self, lc) -> None:
        self.storage.must_add_columns(lc)


class LogMessageProcessor:
    """Gathers rows into a LogRows batch and hands it to the sink when it
    reaches MAX_BATCH_ROWS rows or MAX_BATCH_BYTES bytes, or on
    flush()/stop()."""

    def __init__(self, cp: CommonParams, sink: LogRowsStorage):
        self.cp = cp
        self.sink = sink
        self.lr = self._new_batch(list(cp.stream_fields))
        self.bytes = 0
        self.rows_total = 0

    def _new_batch(self, stream_fields: list) -> LogRows:
        return LogRows(stream_fields=stream_fields,
                       ignore_fields=list(self.cp.ignore_fields),
                       extra_fields=list(self.cp.extra_fields),
                       default_msg_value=self.cp.default_msg_value)

    def stop(self) -> None:
        self.flush()

    def add_row(self, ts_ns: int | None, fields: list[tuple[str, str]],
                stream_fields: list[tuple[str, str]] | None = None) -> None:
        """Add one row (`ts_ns` None is now).  `stream_fields`: labels a
        protocol carries beside the row; they lead its fields and become
        the batch's stream fields."""
        if ts_ns is None:
            ts_ns = time.time_ns()
        if self.cp.decolorize_fields:
            fields = [(k, decolorize(v))
                      if match_any(k, self.cp.decolorize_fields) else (k, v)
                      for k, v in fields]
        if stream_fields is not None:
            names = [k for k, _ in stream_fields]
            self.lr.stream_fields = names
            fields = list(stream_fields) + \
                [f for f in fields if f[0] not in names]
        self.lr.add(self.cp.tenant, ts_ns, fields)
        self.rows_total += 1
        self.bytes += sum(len(k) + len(v) for k, v in fields)
        if len(self.lr) >= MAX_BATCH_ROWS or self.bytes >= MAX_BATCH_BYTES:
            self.flush()

    def flush(self) -> None:
        """Hand the pending rows to the sink."""
        if len(self.lr):
            self.sink.must_add_rows(self.lr)
            self.lr = self._new_batch(list(self.lr.stream_fields))
            self.bytes = 0

    def supports_columns(self) -> bool:
        """True when the sink takes LogColumns batches and no per-row
        transform (decolorize) is set: the jsonline bulk path's gate."""
        return not self.cp.decolorize_fields and \
            hasattr(self.sink, "must_add_columns")

    def ingest_columns(self, lc) -> None:
        """Hand a LogColumns batch to the sink, after the pending rows, so
        rows reach the sink in the order they arrived."""
        if lc.nrows == 0:
            return
        self.flush()
        self.sink.must_add_columns(lc)
        self.rows_total += lc.nrows
