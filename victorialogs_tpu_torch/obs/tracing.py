"""Per-query span trees: where a query's host time goes.

A trace is a tree of Spans with monotonic (perf_counter) timings and
attributes (counters via add(), values via set()).  Spans are opened
only as context managers, so every span closes on every exit path (a
satisfied limit, an exception):

    root = tracing.make_root("query", query=qs)
    with tracing.activate(root):            # sets the ambient span
        ...
        sp = tracing.current_span()
        with sp.span("harvest", unit=3) as h:   # child span
            h.add("rows_downloaded", n)
    tree = root.to_dict()

The ambient span rides a contextvars.ContextVar, so the deep layers (the
dispatch window in gpu/pipeline.py, the searcher's partition setup) read
`current_span()` without threading it through their signatures.  The
port starts no threads, so there is no lock and no re-entry helper.

When no trace is active, `current_span()` returns _NOOP: a shared
singleton whose span() returns a shared reusable context manager and
whose set()/add() do nothing.  An untraced query creates no span
(`spans_created()` does not move).
"""

from __future__ import annotations

import contextvars
import time

_current: contextvars.ContextVar = contextvars.ContextVar(
    "vl_torch_trace_span", default=None)

# real spans made in this process: an untraced query makes none
_created = 0

# children a span keeps; past it the parent counts `children_dropped`
# (the pipeline span gains ~3 children a dispatch unit)
MAX_CHILDREN = 4096


def spans_created() -> int:
    return _created


class Span:
    """One node of a trace tree.  Made only by make_root() and
    parent.span()."""

    __slots__ = ("name", "t0", "t1", "attrs", "children")

    enabled = True

    def __init__(self, name: str, attrs: dict):
        global _created
        self.name = name
        self.t0 = time.perf_counter()
        self.t1 = None
        self.attrs = attrs
        self.children: list = []
        _created += 1

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def add(self, key: str, n=1) -> None:
        """Accumulate a numeric attribute (a counter)."""
        self.attrs[key] = self.attrs.get(key, 0) + n

    def span(self, name: str, **attrs) -> "_SpanCtx":
        """Open a child span; use it as a context manager."""
        return _SpanCtx(self, name, attrs)

    def close(self) -> None:
        if self.t1 is None:
            self.t1 = time.perf_counter()

    def open_spans(self) -> int:
        """Descendants (self included) not yet closed: 0 after any exit
        path of a query."""
        return (self.t1 is None) + sum(c.open_spans()
                                       for c in self.children)

    def to_dict(self, base: float | None = None) -> dict:
        """JSON-ready tree; start_ms is relative to the root's t0."""
        if base is None:
            base = self.t0
        end = self.t1 if self.t1 is not None else time.perf_counter()
        out = {"name": self.name,
               "start_ms": round((self.t0 - base) * 1e3, 3),
               "duration_ms": round((end - self.t0) * 1e3, 3)}
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_dict(base) for c in self.children]
        return out

    def flatten(self) -> dict:
        """{span name: {count, total_ms}} over the tree."""
        agg: dict[str, dict] = {}

        def walk(node: Span) -> None:
            end = node.t1 if node.t1 is not None else time.perf_counter()
            a = agg.setdefault(node.name, {"count": 0, "total_ms": 0.0})
            a["count"] += 1
            a["total_ms"] += (end - node.t0) * 1e3
            for c in node.children:
                walk(c)

        walk(self)
        for a in agg.values():
            a["total_ms"] = round(a["total_ms"], 3)
        return agg


class _SpanCtx:
    """Makes the child at __enter__; closes it and restores the ambient
    span on every exit path."""

    __slots__ = ("_parent", "_name", "_attrs", "_span", "_token")

    def __init__(self, parent: Span, name: str, attrs: dict):
        self._parent = parent
        self._name = name
        self._attrs = attrs
        self._span = None
        self._token = None

    def __enter__(self) -> Span:
        sp = Span(self._name, self._attrs)
        parent = self._parent
        if len(parent.children) < MAX_CHILDREN:
            parent.children.append(sp)
        else:
            parent.add("children_dropped")
        self._span = sp
        self._token = _current.set(sp)
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._span
        if exc_type is not None:
            sp.attrs.setdefault("error", exc_type.__name__)
        sp.close()
        _current.reset(self._token)
        return False


class _NoopCtx:
    """The shared no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return _NOOP

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


class _NoopSpan:
    """The ambient span when tracing is off: every operation is a
    constant-time no-op returning shared singletons."""

    __slots__ = ()

    enabled = False
    name = "noop"

    def set(self, key, value) -> None:
        pass

    def add(self, key, n=1) -> None:
        pass

    def span(self, name, **attrs):
        return _NOOP_CTX

    def close(self) -> None:
        pass

    def open_spans(self) -> int:
        return 0

    def to_dict(self, base=None) -> dict:
        return {}

    def flatten(self) -> dict:
        return {}


_NOOP = _NoopSpan()
_NOOP_CTX = _NoopCtx()


def current_span():
    """The ambient span of the active trace, or the shared no-op
    singleton when tracing is off."""
    sp = _current.get()
    return sp if sp is not None else _NOOP


def make_root(name: str, **attrs) -> Span:
    """A detached root span; exiting activate(root) closes it."""
    return Span(name, attrs)


class _Activation:
    """The dynamic extent of a trace: sets the ambient span and closes
    the root on exit.  activate(None) is a no-op extent."""

    __slots__ = ("_root", "_token")

    def __init__(self, root):
        self._root = root
        self._token = None

    def __enter__(self):
        if self._root is not None:
            self._token = _current.set(self._root)
        return self._root

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._root is not None:
            if exc_type is not None:
                self._root.attrs.setdefault("error", exc_type.__name__)
            self._root.close()
            _current.reset(self._token)
        return False


def activate(root) -> _Activation:
    return _Activation(root)
