"""The traced run: ranges around the program's entries, the profiler, and
the reduction of its trace to the record that the metric readers read.

The ranges are put in from here at run time (spans.py); the program is
not edited. Device operations meet the host range they were launched in
by their correlation id, as the repository's `chip_smoke.py`
`device_ms_by_range` does (copied here and extended to nested ranges).
"""

from __future__ import annotations

import functools
import importlib
import itertools
import json
import os
import tempfile

import torch

from jfbench import roofline

__all__ = ["Spans", "profile", "reduce_trace", "busy_union"]

PREFIX = "jfbench:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _resolve(target: str):
    """"module:a.b" -> (owner object, attribute name), or None."""
    mod, _, path = target.partition(":")
    try:
        owner = importlib.import_module(mod)
    except ImportError:
        return None
    *head, last = path.split(".")
    for part in head:
        owner = getattr(owner, part, None)
        if owner is None:
            return None
    if not hasattr(owner, last):
        return None
    return owner, last


class Spans:
    """Wraps the entries of the given spans ({name: spec}) in
    record_function ranges named "jfbench:<name>#<call>", and logs each
    call of a span with `bytes`: (name, call, bytes)."""

    def __init__(self, specs: dict):
        self.specs = specs
        self.calls: list[tuple[str, int, int]] = []
        self._ids = itertools.count()
        self._patched: list[tuple[object, str, object]] = []

    def _wrap(self, name, spec, fn):
        nbytes = spec.get("bytes")
        if isinstance(nbytes, str):
            nbytes = roofline.BYTES[nbytes]
        calls, ids = self.calls, self._ids

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            i = next(ids)
            with torch.profiler.record_function(f"{PREFIX}{name}#{i}"):
                out = fn(*args, **kwargs)
            if nbytes is not None:
                calls.append((name, i, nbytes(args, kwargs, out)))
            return out

        return wrapped

    def install(self) -> None:
        wrappers = {}
        for name, spec in self.specs.items():
            for target in spec["targets"]:
                at = _resolve(target)
                if at is None:
                    continue
                owner, attr = at
                fn = getattr(owner, attr)
                w = wrappers.get(id(fn))
                if w is None:
                    w = wrappers[id(fn)] = self._wrap(name, spec, fn)
                setattr(owner, attr, w)
                self._patched.append((owner, attr, fn))

    def uninstall(self) -> None:
        for owner, attr, fn in reversed(self._patched):
            w = getattr(owner, attr)
            # counters the program keeps on its functions (.launches)
            for key, val in vars(w).items():
                if key != "__wrapped__" and hasattr(fn, key):
                    setattr(fn, key, val)
            setattr(owner, attr, fn)
        self._patched.clear()


def profile():
    """The profiler for one traced window."""
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def trace_events(prof) -> list:
    """The profiler's events, through a chrome trace in TMPDIR that is
    deleted once read."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def _gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi] outside the intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _stacks(ranges, times):
    """For each time (sorted), the tuple of ranges (start, end, label)
    open at it, outermost first. Ranges nest properly."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            r = ranges[i]
            i += 1
            while stack and stack[-1][1] < r[0]:
                stack.pop()
            stack.append(r)
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(stack))
    return out


def _span_of(label: str):
    """"jfbench:name#7" -> ("name", 7)."""
    name, _, i = label[len(PREFIX):].rpartition("#")
    return name, int(i)


def reduce_trace(events, specs: dict, calls, job_label: str):
    """The trace of the traced window -> the record's device part:
    {"spans": {name: device ms under it}, "layers": {layer: device ms},
    "calls": [{"span", "bytes", "device_ms"}], "busy_s", "window_s",
    "device_ops": [[name, s]], "idle_gaps": [[host activity, s]]}.
    The window is the host range `job_label`."""
    ranges, host = [], []
    launch, ops = {}, []
    window = None
    main_tid = None
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation" and e.get("ph") == "X":
            if e["name"] == job_label:
                window = (e["ts"], e["ts"] + e["dur"])
                main_tid = e.get("tid")
            elif e["name"].startswith(PREFIX):
                ranges.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = e["ts"]
        elif cat in DEVICE_CATS:
            ops.append(e)
    if window is None:
        raise RuntimeError(f"the trace holds no range {job_label!r}")
    for e in events:
        if (e.get("cat") in ("cpu_op", "user_annotation")
                and e.get("ph") == "X" and e.get("tid") == main_tid):
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))

    # each device op -> the ranges open when it was launched
    corr = [(launch.get((e.get("args") or {}).get("correlation")), j)
            for j, e in enumerate(ops)]
    known = sorted((t, j) for t, j in corr if t is not None)
    stacks = _stacks(ranges, [t for t, _ in known])
    span_us, layer_us, call_us = {}, {}, {}
    for (t, j), stack in zip(known, stacks):
        dur = ops[j]["dur"]
        seen = set()
        layer = None
        for _, _, label in stack:
            name, i = _span_of(label)
            if name not in seen:
                seen.add(name)
                span_us[name] = span_us.get(name, 0.0) + dur
            spec = specs.get(name, {})
            if layer is None and spec.get("layer"):
                layer = spec["layer"]
            call_us[(name, i)] = call_us.get((name, i), 0.0) + dur
        layer = layer or "other"
        layer_us[layer] = layer_us.get(layer, 0.0) + dur
    unjoined = sum(ops[j]["dur"] for t, j in corr if t is None)
    if unjoined:
        layer_us["other"] = layer_us.get("other", 0.0) + unjoined

    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in ops]
    by_name = {}
    for e in ops:
        by_name[e["name"][:120]] = by_name.get(e["name"][:120], 0.0) + e["dur"]
    gaps = _gaps(intervals, *window)
    gaps.sort(key=lambda g: g[0] + g[1])
    idle = {}
    for (s, e), stack in zip(gaps, _stacks(host, [(s + e) / 2
                                                  for s, e in gaps])):
        what = stack[-1][2] if stack else "host outside any op"
        if what.startswith(PREFIX):
            what = PREFIX + _span_of(what)[0]
        idle[what] = idle.get(what, 0.0) + (e - s)

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "spans": {k: v / 1e3 for k, v in span_us.items()},
        "layers": {k: v / 1e3 for k, v in layer_us.items()},
        "calls": [{"span": name, "bytes": nb,
                   "device_ms": call_us.get((name, i), 0.0) / 1e3}
                  for name, i, nb in calls],
        "busy_s": busy_union(intervals) / 1e6,
        "window_s": (window[1] - window[0]) / 1e6,
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
    }

