"""Profiling helpers (the reference has only wall-clock prints, SURVEY.md §5):
torch.profiler trace capture, and the stage timer of the program's entry
points, whose spans sit on the profiler's timeline beside the device's
kernels and copies."""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time

import torch
from torch.profiler import record_function

from .log import log


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block: host activity, plus the
    CUDA kernels when a card is present. The trace is written as a Chrome
    trace JSON file under log_dir (view with chrome://tracing or Perfetto);
    the counterpart of the JAX package's jax.profiler start/stop_trace. It
    holds the program's stage spans (``mvs.*``, see :func:`stage`) as
    ``user_annotation`` events. Yields the profiler, so a caller can also
    read key_averages()."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        log(f"device trace written to {path}")


@contextlib.contextmanager
def stage(span: str | None, record: dict | None = None,
          key: str | None = None):
    """Time the block as one stage: its perf_counter wall in ms is added to
    ``record[key]`` (when a key is given), and while a torch profiler runs
    on this thread the block is also the profiler span ``span``
    (torch.profiler.record_function). Without a profiler no
    record_function is entered: the cost is one _profiler_enabled() check
    and one perf_counter pair. Yields the block's start (perf_counter s)."""
    t0 = time.perf_counter()
    try:
        if span is not None and torch.autograd._profiler_enabled():
            with record_function(span):
                yield t0
        else:
            yield t0
    finally:
        if key is not None:
            record[key] = record.get(key, 0.0) \
                + (time.perf_counter() - t0) * 1e3


def entry_span(kind: str):
    """Decorator of an entry point: each call runs inside the span
    ``mvs.<kind>#<n>`` (:func:`stage`), n the call's number among this
    process's calls of the function (1, 2, ...), so that the stage spans
    of one call nest in a span that names it."""
    def wrap(fn):
        calls = itertools.count(1)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            with stage(f"mvs.{kind}#{next(calls)}"):
                return fn(*args, **kwargs)
        return call
    return wrap
