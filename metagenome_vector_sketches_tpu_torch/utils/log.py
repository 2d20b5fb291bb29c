"""Minimal leveled logging (the reference uses bare cout/cerr prints;
SURVEY.md §5). Quiet by default in library use, verbose in CLIs."""

from __future__ import annotations

import os
import sys
import time

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_level = _LEVELS.get(os.environ.get("MVS_LOG_LEVEL", "info"), 20)


def log(msg: str, level: str = "info") -> None:
    if _LEVELS.get(level, 20) >= _level:
        print(msg, file=sys.stderr if level in ("warn", "error") else sys.stdout,
              flush=True)


class Timer:
    """Wall-clock span timer mirroring the reference's chrono spans."""

    def __init__(self, label: str = "", verbose: bool = False):
        self.label = label
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        if self.verbose and self.label:
            log(f"{self.label}: {self.elapsed:.4f} s")
        return False


def human_time(seconds: float) -> tuple[float, str]:
    """Reference get_time_unit (query_pc_mat.cpp:20-36)."""
    if seconds < 60:
        return seconds, "seconds"
    if seconds < 3600:
        return seconds / 60.0, "minutes"
    return seconds / 3600.0, "hours"
