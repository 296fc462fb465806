"""Synthetic log rows in the vlogsgenerator shape, made from a seed.

Streams are (app, host) pairs: `streams` hosts spread over `apps` apps.
Each row carries an 8-word `_msg` drawn from WORDS, a dict-sized `lvl`
field, a uint `dur`, a float `lat`, a high-cardinality `user` and an
HTTP-status-like uint `status` (200 for ~80% of rows, else drawn from
200-504: a small-range int column).  The
word RARE occurs only in the first two apps, so a query on it lets the
bloom filters rule out the blocks of the other apps.  Timestamps are
strictly increasing (no ties) and spread over [start_ns, start_ns +
span_ns).

    python -m victorialogs_tpu_torch.cli.vlogsgenerator -rows 10 -seed 1

prints the rows as JSON lines, the body `jsonline_body` makes for
`/insert/jsonline`; `bulk_body` makes an Elasticsearch `_bulk` body.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

WORDS = ["error", "warn", "info", "request", "response", "timeout",
         "connected", "closed", "retry", "flush", "compact", "merge",
         "alloc", "free", "login", "logout", "GET", "POST", "PUT"]
RARE = "quota"
LEVELS = ("debug", "info", "warn", "error")
NS_PER_DAY = 86400 * 1_000_000_000


def today_start_ns() -> int:
    """Start of the current UTC day (inside any retention window)."""
    return time.time_ns() // NS_PER_DAY * NS_PER_DAY


def generate(n: int, seed: int, start_ns: int, span_ns: int,
             streams: int = 64, apps: int = 8, words: int = 8) -> list:
    """n rows as [(timestamp_ns, [(field, value), ...]), ...]."""
    rng = np.random.default_rng(seed)
    stream = np.arange(n) % streams
    ts = (start_ns + np.arange(n, dtype=np.int64) * (span_ns // max(n, 1))
          ).tolist()
    w = np.array(WORDS, dtype=object)[rng.integers(0, len(WORDS),
                                                   size=(n, words))]
    rare = (stream % apps < 2) & (rng.random(n) < 0.25)
    rare_at = rng.integers(0, words, size=n)
    w[rare, rare_at[rare]] = RARE
    msg = [" ".join(r) for r in w.tolist()]
    lvl = np.array(LEVELS, dtype=object)[rng.integers(0, len(LEVELS),
                                                      size=n)].tolist()
    dur = rng.integers(0, 1 << 16, size=n).astype(str).tolist()
    lat = [repr(x) for x in np.round(rng.random(n) * 100, 3).tolist()]
    user = [f"user-{u}" for u in rng.integers(0, 1_000_000,
                                               size=n).tolist()]
    # drawn after every other column, so those stay as they were for a
    # given seed
    status = np.where(rng.random(n) < 0.8, 200,
                      rng.integers(200, 505, size=n)).astype(str).tolist()
    app = [f"app-{s % apps}" for s in range(streams)]
    host = [f"host-{s}" for s in range(streams)]
    return [(ts[i], [("_msg", msg[i]), ("app", app[s]), ("host", host[s]),
                     ("lvl", lvl[i]), ("dur", dur[i]), ("lat", lat[i]),
                     ("user", user[i]), ("status", status[i])])
            for i, s in enumerate(stream.tolist())]


def jsonline_body(rows: list) -> bytes:
    """generate()'s rows as an `/insert/jsonline` body: one object a row,
    `_time` (integer nanoseconds) first, then the fields in order."""
    return "".join(json.dumps({"_time": ts, **dict(fields)}) + "\n"
                   for ts, fields in rows).encode("utf-8")


def bulk_body(rows: list) -> bytes:
    """generate()'s rows as an Elasticsearch `_bulk` body: a `create`
    action line, then the document with `@timestamp` (integer
    nanoseconds) and the `_msg` field as `message`."""
    action = json.dumps({"create": {}})
    return "".join(
        action + "\n" + json.dumps(
            {"@timestamp": ts, **{("message" if k == "_msg" else k): v
                                  for k, v in fields}}) + "\n"
        for ts, fields in rows).encode("utf-8")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vlogsgenerator")
    p.add_argument("-rows", type=int, default=1000)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-streams", type=int, default=64)
    args = p.parse_args(argv)
    start = today_start_ns()
    rows = generate(args.rows, args.seed, start, NS_PER_DAY // 2,
                    streams=args.streams)
    sys.stdout.write(jsonline_body(rows).decode("utf-8"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
