"""Request helpers shared by the handlers: the tenant of a request and
the unix timestamp parser of numeric time arguments.

The tenant comes from the AccountID/ProjectID headers or query args;
unix times are seconds, milliseconds, microseconds or nanoseconds, told
apart by magnitude.
"""

from __future__ import annotations

import time

from ..storage.log_rows import TenantID


def get_tenant_id(headers, args) -> TenantID:
    """Tenant from AccountID/ProjectID headers or query args."""
    acc = headers.get("AccountID") or args.get("AccountID") or "0"
    proj = headers.get("ProjectID") or args.get("ProjectID") or "0"
    try:
        return TenantID(int(acc), int(proj))
    except ValueError:
        return TenantID()


def parse_timestamp(v: int | float) -> int:
    """Nanoseconds of a unix time: seconds with a fraction for a float;
    for an int seconds below 2**32, then milliseconds, microseconds,
    nanoseconds; 0 is now."""
    if v == 0:
        return time.time_ns()
    if isinstance(v, float):
        return int(v * 1e9)
    if v < (1 << 32):
        return v * 1_000_000_000
    if v < (1 << 32) * 1_000:
        return v * 1_000_000
    if v < (1 << 32) * 1_000_000:
        return v * 1_000
    return v
