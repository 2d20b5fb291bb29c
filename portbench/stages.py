"""What the per-layer readers of the program's own stages share: a stage
wall of the calls' LAST_STAGES, the program's stage spans (``mvs.*``) in
the trace's host spans, and the device's idle time inside the calls that no
stage span names. Each returns None where the program gives nothing to read
(a build without the key or the spans)."""

from __future__ import annotations

# the benchmark's own span around a call of the program, by call kind
CALL_SPAN = {"shard": "portbench.shard_", "search": "portbench.search_"}


def mean_stage(ctx, kind: str, key: str):
    """The mean of the calls' stage record ``key`` over the window's calls
    of ``kind``."""
    vals = [c["stages"][key] for c in ctx.calls
            if c["kind"] == kind and key in c["stages"]]
    return sum(vals) / len(vals) if vals else None


def span_ms_per_call(ctx, kind: str, name: str):
    """The trace's host spans named ``name``, summed in ms, over the
    window's calls of ``kind``."""
    calls = sum(c["kind"] == kind for c in ctx.calls)
    if ctx.trace is None or not calls:
        return None
    spans = [e - s for s, e, n in ctx.trace.host if n == name]
    return 1e3 * sum(spans) / calls if spans else None


def _union(ivs) -> list:
    out: list = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _meet(a: list, b: list) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(ivs: list) -> float:
    return sum(e - s for s, e in ivs)


def unnamed_idle_pct(ctx, kind: str):
    """Of the device's idle time inside the benchmark's spans around the
    calls of ``kind``, the share (%) that no stage span of the program
    covers (``mvs.`` spans; a call's own span, ``mvs.<kind>#<n>``, does not
    count)."""
    if ctx.trace is None or not ctx.trace.device \
            or not any(c["kind"] == kind for c in ctx.calls):
        return None
    host = ctx.trace.host
    stages = _union((s, e) for s, e, n in host
                    if n.startswith("mvs.") and "#" not in n)
    if not stages:
        return None
    calls = _union((s, e) for s, e, n in host
                   if n.startswith(CALL_SPAN[kind]))
    busy = _union((s, e) for s, e, _ in ctx.trace.device)
    called_busy = _meet(calls, busy)
    idle = _length(calls) - _length(called_busy)
    if idle <= 0:
        return None
    named = _length(_meet(calls, stages)) \
        - _length(_meet(called_busy, stages))
    return 100.0 * (idle - named) / idle
