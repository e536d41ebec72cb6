"""The count path's own spans and counters, kept in memory, one summary a
job.

A MerCounter owns one Trace (`counter.trace`), and its stores record into
it. `span(name, **counts)` times a block of host code by
time.perf_counter_ns and records its name, the span open around it, its
start and end, and integer counts that the code already holds on the
host (tensor shapes and byte sizes; `Span.add` adds to one inside the
block). A span itself never holds or reads a tensor, so it never waits
for the device. While a torch profiler records, a span also opens a
record_function range of its name, which puts it on the profiler's
timeline beside the device's kernels and copies; otherwise it opens none.

`end_job()` (MerCounter.reset) folds the job's spans into one summary,
{name: {"calls", "host_ns", <count>: sum}}, appends it to `jobs` and
drops the spans. The names and counts are listed in doc/API.md.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Span", "Trace", "OFF"]


class Span:
    """One timed block; a context manager that `Trace.span` returns."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "counts", "_trace",
                 "_range")

    def __init__(self, trace, name: str, counts: dict):
        self._trace = trace
        self.name = name
        self.counts = counts
        self.parent: Span | None = None
        self.start_ns = self.end_ns = 0
        self._range = None

    def add(self, key: str, n: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self):
        opened = self._trace._open
        self.parent = opened[-1] if opened else None
        opened.append(self)
        self._trace.spans.append(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._trace._open.pop()
        return False


class Trace:
    """The spans of the current job (`spans`, in the order they opened)
    and one summary of each finished job (`jobs`)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.jobs: list[dict] = []
        self._open: list[Span] = []

    def span(self, name: str, **counts) -> Span:
        return Span(self, name, counts)

    def end_job(self) -> None:
        summary: dict[str, dict[str, int]] = {}
        for s in self.spans:
            d = summary.setdefault(s.name, {"calls": 0, "host_ns": 0})
            d["calls"] += 1
            d["host_ns"] += s.end_ns - s.start_ns
            for key, n in s.counts.items():
                d[key] = d.get(key, 0) + n
        self.jobs.append(summary)
        self.spans = []


class _NoSpan:
    """The span of a store that no counter owns: records nothing."""

    def add(self, key: str, n: int) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Off:
    _span = _NoSpan()

    def span(self, name: str, **counts) -> _NoSpan:
        return self._span


OFF = _Off()
