"""Per-stage wall-time registry (the jax-free part of
pero_ocr_tpu/utils/timing.py).

``stage_timer(name)`` accumulates host wall time and call counts per
stage into one process-wide registry; ``timing_report()`` formats it.
Device work is asynchronous, so a stage that does not end in a host
copy or a ``torch.cuda.synchronize()`` measures its enqueue time.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageStats:
    __slots__ = ("total_seconds", "calls")

    def __init__(self):
        self.total_seconds = 0.0
        self.calls = 0


class TimingRegistry:
    """Thread-safe accumulator of per-stage wall times."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                s = self._stats[name]
                s.total_seconds += elapsed
                s.calls += 1

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def add(self, stats: Dict[str, tuple]) -> None:
        """Add another registry's :meth:`stats` (a worker process's)."""
        with self._lock:
            for name, (seconds, calls) in stats.items():
                s = self._stats[name]
                s.total_seconds += seconds
                s.calls += calls

    def stats(self) -> Dict[str, tuple]:
        """{stage: (total seconds, calls)}."""
        with self._lock:
            return {k: (s.total_seconds, s.calls) for k, s in self._stats.items()}

    def report(self) -> str:
        with self._lock:
            items = sorted(self._stats.items(), key=lambda kv: -kv[1].total_seconds)
        if not items:
            return "no timed stages"
        width = max(len(k) for k, _ in items)
        lines = [f"{'stage':{width}}  total_s   calls   ms/call"]
        for name, s in items:
            per_call = 1000.0 * s.total_seconds / max(s.calls, 1)
            lines.append(
                f"{name:{width}}  {s.total_seconds:7.3f}  {s.calls:6d}  {per_call:8.2f}"
            )
        return "\n".join(lines)


GLOBAL_TIMING = TimingRegistry()


def stage_timer(name: str):
    """Time a stage into the global registry."""
    return GLOBAL_TIMING.timer(name)


def timing_report() -> str:
    return GLOBAL_TIMING.report()


def timing_stats() -> Dict[str, tuple]:
    return GLOBAL_TIMING.stats()


def reset_timing() -> None:
    GLOBAL_TIMING.reset()


def add_timing(stats: Dict[str, tuple]) -> None:
    GLOBAL_TIMING.add(stats)
