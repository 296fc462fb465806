"""Syslog message parsing (RFC3164 and RFC5424) for `unpack_syslog`:
priority, facility, severity, timestamp, hostname, app name, process
and message ids, structured data and the message."""

from __future__ import annotations

import datetime
import re
import time

_RFC3164_RE = re.compile(
    r"^(?P<mon>[A-Z][a-z]{2}) +(?P<day>\d{1,2}) "
    r"(?P<time>\d{2}:\d{2}:\d{2}) (?P<host>\S+) (?P<rest>.*)$", re.DOTALL)
_TAG_RE = re.compile(r"^(?P<tag>[^\s:\[\]]+)(?:\[(?P<pid>\d+)\])?: ?")
_SD_PARAM_RE = re.compile(r'(\S+?)="((?:[^"\\]|\\.)*)"')

_MONTHS = {m: i + 1 for i, m in enumerate(
    ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep", "Oct",
     "Nov", "Dec"])}

_SEVERITIES = ["emerg", "alert", "crit", "err", "warning", "notice", "info",
               "debug"]


def parse_syslog_message(line: str, current_year: int | None = None,
                         tz_offset_ns: int = 0) -> list[tuple[str, str]]:
    """One syslog line as log fields; the format is detected.  An RFC3164
    timestamp takes `current_year` (this year by default), or the year
    before when that puts it over two days ahead of now."""
    fields: list[tuple[str, str]] = []
    pri = None
    if line.startswith("<"):
        end = line.find(">")
        if 0 < end <= 4 and line[1:end].isdigit():
            pri = int(line[1:end])
            line = line[end + 1:]
    if pri is not None:
        fields.append(("priority", str(pri)))
        fields.append(("facility", str(pri // 8)))
        sev = pri % 8
        fields.append(("severity", str(sev)))
        fields.append(("level", _SEVERITIES[sev]))

    if line.startswith("1 "):
        fields.extend(_parse_rfc5424(line[2:]))
        fields.append(("format", "rfc5424"))
        return fields

    m = _RFC3164_RE.match(line)
    if m is not None:
        mon = _MONTHS.get(m.group("mon"))
        if mon is not None:
            year = current_year or time.gmtime().tm_year
            hh, mm, ss = m.group("time").split(":")
            try:
                dt = datetime.datetime(year, mon, int(m.group("day")),
                                       int(hh), int(mm), int(ss),
                                       tzinfo=datetime.timezone.utc)
                ts = int(dt.timestamp()) * 1_000_000_000 - tz_offset_ns
                if ts > time.time_ns() + 2 * 86400 * 1_000_000_000:
                    dt = dt.replace(year=year - 1)
                fields.append(("timestamp",
                               dt.strftime("%Y-%m-%dT%H:%M:%SZ")))
            except ValueError:
                pass
            fields.append(("hostname", m.group("host")))
            rest = m.group("rest")
            tm = _TAG_RE.match(rest)
            if tm is not None:
                fields.append(("app_name", tm.group("tag")))
                if tm.group("pid"):
                    fields.append(("proc_id", tm.group("pid")))
                rest = rest[tm.end():]
            fields.append(("_msg", rest))
            fields.append(("format", "rfc3164"))
            return fields

    fields.append(("_msg", line))
    fields.append(("format", "unknown"))
    return fields


def _parse_rfc5424(rest: str) -> list[tuple[str, str]]:
    fields: list[tuple[str, str]] = []
    parts = rest.split(" ", 5)
    if len(parts) < 6:
        parts += ["-"] * (6 - len(parts))
    ts_s, host, app, procid, msgid, tail = parts
    for name, v in (("timestamp", ts_s), ("hostname", host),
                    ("app_name", app), ("proc_id", procid),
                    ("msg_id", msgid)):
        if v != "-":
            fields.append((name, v))
    tail = tail.lstrip()
    if tail.startswith("["):
        i = 0
        while i < len(tail) and tail[i] == "[":
            end = _sd_end(tail, i)
            if end < 0:
                break
            fields.extend(_parse_sd_element(tail[i + 1:end]))
            i = end + 1
            if i < len(tail) and tail[i] == " ":
                i += 1
        tail = tail[i:].lstrip()
    elif tail.startswith("- "):
        tail = tail[2:]
    elif tail == "-":
        tail = ""
    fields.append(("_msg", tail))
    return fields


def _sd_end(s: str, start: int) -> int:
    """The index of the `]` closing the structured-data element at
    `start`, or -1."""
    i = start + 1
    in_quote = False
    while i < len(s):
        c = s[i]
        if c == "\\" and in_quote:
            i += 2
            continue
        if c == '"':
            in_quote = not in_quote
        elif c == "]" and not in_quote:
            return i
        i += 1
    return -1


def _parse_sd_element(sd: str) -> list[tuple[str, str]]:
    sd_id, _, rest = sd.partition(" ")
    return [(f"{sd_id}.{m.group(1)}",
             m.group(2).replace('\\"', '"').replace("\\\\", "\\"))
            for m in _SD_PARAM_RE.finditer(rest)]
