"""Throughput counters and optional JAX profiler tracing.

The reference's only observability is wall-clock timestamps at phase
boundaries (classify.cpp:17-21 logtime) — this module adds per-phase
reads/s and k-mers/s counters plus an opt-in XLA trace, the green-field
aux subsystem called out in SURVEY.md §5.
"""

from __future__ import annotations

import contextlib
import sys
import time


class PhaseTimer:
    """Accumulates named phase durations and item counts."""

    def __init__(self, log=sys.stderr):
        self.log = log
        self.phases: dict[str, float] = {}
        self.items: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if items:
                self.items[name] = self.items.get(name, 0) + items

    def add_items(self, name: str, n: int) -> None:
        self.items[name] = self.items.get(name, 0) + n

    def report(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, secs in self.phases.items():
            row = {"seconds": round(secs, 3)}
            n = self.items.get(name)
            if n:
                row["items"] = n
                row["items_per_s"] = round(n / secs) if secs > 0 else 0
            out[name] = row
            print(f"[hast_jax] {name}: {secs:.2f}s"
                  + (f" ({row['items_per_s']:,} items/s)" if n else ""),
                  file=self.log)
        return out


_FALLBACKS_SEEN: set = set()


def notice_fallback(name: str, exc: BaseException | str | None = None
                    ) -> None:
    """One-line stderr notice, once per process per site, when a native
    or snapshot fast path silently demotes to a slow path.

    The remaining except-Exception guards (probe-table snapshot load,
    native table-build helpers) keep the pipeline correct on the slow
    path, but a degradation with no signal is worse than a loud one."""
    if name in _FALLBACKS_SEEN:
        return
    _FALLBACKS_SEEN.add(name)
    why = f": {exc}" if exc else ""
    print(f"[hast_jax] NOTE: fast path '{name}' unavailable, using "
          f"fallback{why}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Wrap a block in jax.profiler.trace when a directory is given."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield
