"""The traced window: torch.profiler over the measured calls, read back from
its Chrome trace as device intervals (kernels, copies, sets) and host
spans.

- busy: the union of the device intervals inside the window;
- device_ops: device time summed by name, the largest first;
- idle_gaps: the longest stretches of the window with no device interval,
  each named by what the host was doing at its middle (the innermost
  profiler span there: an aten op, or the benchmark's own span around a
  call of the program).
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def span(name: str):
    """The benchmark's own profiler span, named in the trace's host
    intervals (a no-op outside a traced window)."""
    from torch.profiler import record_function
    return record_function(name)


class Trace:
    """Device intervals and host spans of one traced window, in seconds
    from the window's start."""

    def __init__(self, events: list, t0_us: float, t1_us: float):
        self.window_s = (t1_us - t0_us) * 1e-6
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = (float(e["ts"]) - t0_us) * 1e-6
            iv = (s, s + float(e["dur"]) * 1e-6, e.get("name", ""))
            if e.get("cat") in DEVICE_CATS:
                dev.append(iv)
            elif e.get("cat") in HOST_CATS:
                host.append(iv)
        self.device = [iv for iv in dev if iv[1] > 0 and iv[0] < self.window_s]
        self.host = host

    def kernels(self, pattern: str) -> list:
        """Device intervals whose name holds ``pattern``."""
        return [iv for iv in self.device if pattern in iv[2]]

    def device_s(self, pattern: str) -> float:
        return sum(e - s for s, e, _ in self.kernels(pattern))

    def _union(self) -> list:
        ivs = sorted((max(0.0, s), min(self.window_s, e))
                     for s, e, _ in self.device)
        out = []
        for s, e in ivs:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return float(sum(e - s for s, e in self._union()))

    def device_ops(self, top: int = 10) -> list:
        sums: dict = {}
        for s, e, name in self.device:
            sums[name] = sums.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in sums.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        busy = self._union()
        edges = [0.0] + [x for iv in busy for x in iv] + [self.window_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            inner = [h for h in self.host if h[0] <= mid <= h[1]]
            what = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
                else "outside any span"
            out.append([what, e - s])
        return out


@contextlib.contextmanager
def traced(folder: str, on: bool):
    """Profile the block when ``on``; yields a holder whose ``trace`` is
    the parsed Trace once the block has ended (None when off)."""
    holder = type("Held", (), {"trace": None})()
    if not on:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    try:
        with record_function("portbench.window"):
            yield holder
            if cuda:
                torch.cuda.synchronize()
    finally:
        prof.stop()
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "window_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    win = [e for e in events if e.get("name") == "portbench.window"
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if win:
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
    else:
        ts = np.array([float(e["ts"]) for e in events if "ts" in e])
        t0, t1 = float(ts.min()), float(ts.max())
    holder.trace = Trace(events, t0, t1)
