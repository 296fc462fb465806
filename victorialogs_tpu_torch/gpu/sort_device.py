"""Device top-k prefilter for `<filter> | sort by (field [desc]) limit N`.

The host's top-k sort processor keeps only offset + limit rows, but
every matching row still reaches it.  The device form: in the part's
filter program, the k-th best sort key among the filter's definite
matches is found on the card (`torch.topk` over the staged uint32 value
offsets, gpu/batch.py `run_part_topk`), and only rows at or above that
key come back to the host.  The sort processor then runs unchanged over
a few rows instead of millions: the same comparator and the same
arrival-order tie breaks, so the same output.

Why the threshold never drops a row of the true top k: let D be the
definite matches, M the maybe rows (truncated values, multibyte rows of
an any-case leaf) and T the true matches (D ⊆ T ⊆ D ∪ M).  The k-th
best key over D, kv_D, is at most the k-th best over T, kv_T (more
candidates only raise the k-th best), so every row of the true top k
has a key >= kv_T >= kv_D.  The runner returns the rows of D and of M
at or above kv_D; the host settles those of M with the filter's own
predicate before they reach the pipe.

Eligibility follows the host comparator: one sort field whose candidate
blocks are all int-typed, so its stored strings are canonical decimals,
numeric order is `_cmp_values` order, and keys tie only between equal
values, which the processor breaks by arrival order as on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..logsql.pipes import PipeSort

MAX_TOPK = 4096  # top-k cost grows with k; beyond this the host heap wins


@dataclass
class SortSpec:
    field: str
    desc: bool                    # effective order (field desc XOR global)
    k: int                        # limit + offset


def device_sort_spec(q) -> SortSpec | None:
    """The device prefilter of a query whose first pipe is a plain
    `sort by (one_field [desc]) [offset O] limit N`, or None:
    `partition by`, several sort fields, `_time`, `_stream`,
    `_stream_id`, wildcards and k > MAX_TOPK decline (the host sorts
    every matched row)."""
    if not q.pipes:
        return None
    ps = q.pipes[0]
    if type(ps) is not PipeSort:
        return None
    if ps.partition_by or ps.limit <= 0 or len(ps.by) != 1:
        return None
    fld, fdesc = ps.by[0]
    if fld in ("_time", "_stream", "_stream_id") or "*" in fld:
        return None
    k = ps.limit + ps.offset
    if k > MAX_TOPK:
        return None
    return SortSpec(field=fld, desc=bool(fdesc) != bool(ps.desc), k=k)
