"""The yardstick's arithmetic: bytes a call moves, the idle union, and the
reduction of a trace to the record."""

import pytest
import torch

from jfbench import harness, roofline, trace

PEAK = roofline.PEAK_BYTES_PER_S


def ms(nbytes):
    return 1e3 * nbytes / PEAK


def t(rows, cols=1):
    return torch.empty((rows, cols), dtype=torch.int64, device="meta")


def c(rows):
    return torch.empty(rows, dtype=torch.int64, device="meta")


def test_bounds_of_the_kernel_table():
    # PERF.md's kernel table: K1 at A 2^24 + B 2^24 rows of Wk 1
    b = roofline.merge_path_bytes((t(1 << 24), c(1 << 24), t(1 << 24),
                                   c(1 << 24)), {}, None)
    assert ms(b) == pytest.approx(0.3205, abs=1e-4)
    # K2 at 2^27 rows of Wk 1, 25% live
    b = roofline.compact_bytes((t(1 << 27), c(1 << 27)), {},
                               (None, None, 1 << 25))
    assert ms(b) == pytest.approx(0.8013, abs=1e-4)
    # merge_pass and block_sort at 2^26 rows of Wk 4, keys only
    assert ms(roofline.merge_pass_bytes((t(1 << 26, 4), 2048), {}, None)) \
        == pytest.approx(1.2821, abs=1e-4)
    assert ms(roofline.block_sort_bytes((t(1 << 26, 4),), {}, None)) \
        == pytest.approx(1.2821, abs=1e-4)
    # with a payload: 2^24 rows of Wk 1
    assert ms(roofline.merge_pass_bytes((t(1 << 24), 1 << 22),
                                        {"payload": c(1 << 24)}, None)) \
        == pytest.approx(0.1603, abs=1e-4)
    # the grain sort of a packed column: 2^27 int64 read and written
    assert ms(roofline.sort_rows_bytes((t(1 << 27),), {}, None)) \
        == pytest.approx(0.6410, abs=1e-4)


def test_busy_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 12), (12, 13), (20, 25), (21, 22), (30, 30)]
    assert trace.busy_union(iv) == 13 + 5
    assert trace.busy_union([]) == 0
    assert trace._gaps(iv, -5, 40) == [(-5, 0), (13, 20), (25, 40)]


def test_stacks_of_nested_ranges():
    r = [(0, 100, "a"), (10, 20, "b"), (12, 15, "c"), (30, 40, "d")]
    got = trace._stacks(r, [5, 13, 17, 25, 35, 200])
    assert [[x[2] for x in s] for s in got] == [
        ["a"], ["a", "b", "c"], ["a", "b"], ["a"], ["a", "d"], []]


def _event(cat, name, ts, dur=None, corr=None, tid=1):
    e = {"cat": cat, "name": name, "ts": ts, "ph": "X", "tid": tid}
    if dur is not None:
        e["dur"] = dur
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_trace_joins_device_time_to_layers_and_calls():
    P = trace.PREFIX
    ev = [
        _event("user_annotation", "job", 0, 1000),
        _event("user_annotation", P + "pipeline#0", 10, 100),
        _event("user_annotation", P + "store.insert_raw#1", 200, 300),
        _event("user_annotation", P + "store.flush#2", 210, 200),
        _event("user_annotation", P + "sort_rows#3", 220, 50),
        _event("user_annotation", P + "finalize#4", 600, 300),
        _event("user_annotation", P + "store.flush#5", 610, 100),
        _event("user_annotation", P + "compact#6", 620, 10),
        _event("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 230, 1, corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 450, 1, corr=3),
        _event("cuda_runtime", "cudaLaunchKernel", 625, 1, corr=4),
        _event("cuda_runtime", "cudaMemcpyAsync", 800, 1, corr=5),
        _event("kernel", "k1", 30, 40, corr=1),
        _event("kernel", "sortk", 240, 60, corr=2),
        _event("kernel", "k3", 460, 20, corr=3),
        _event("kernel", "compactk", 630, 30, corr=4),
        _event("gpu_memcpy", "Memcpy DtoH", 810, 90, corr=5),
        _event("kernel", "orphan", 950, 10, corr=99),
    ]
    from jfbench import spans

    calls = [("sort_rows", 3, 1000), ("compact", 6, 500)]
    rec = trace.reduce_trace(ev, spans.SPANS, calls, "job")
    assert rec["layers"] == pytest.approx(
        {"pipeline": 0.040, "store": 0.080, "finalize": 0.120,
         "other": 0.010})
    assert rec["spans"]["store.flush"] == pytest.approx(0.060 + 0.030)
    assert rec["calls"] == [
        {"span": "sort_rows", "bytes": 1000, "device_ms": pytest.approx(0.06)},
        {"span": "compact", "bytes": 500, "device_ms": pytest.approx(0.03)}]
    assert rec["busy_s"] == pytest.approx(250e-6)
    assert rec["window_s"] == pytest.approx(1000e-6)
    assert rec["device_ops"][0] == ["Memcpy DtoH", pytest.approx(90e-6)]
    assert sum(s for _, s in rec["idle_gaps"]) == pytest.approx(750e-6)


def _record(**kw):
    rec = {"jobs": 2, "layers": {}, "calls": [], "counters": {},
           "busy_s": 0.0, "window_s": 0.0, "counting_s": [],
           "mers_per_job": 1000}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("name,record,value", [
    ("pipeline.device_ms", _record(layers={"pipeline": 30.0}), 15.0),
    ("store.device_ms", _record(layers={"store": 8.0}), 4.0),
    ("finalize.device_ms", _record(layers={"finalize": 2.0}), 1.0),
    ("store.resting_gib", _record(counters={"store.resting_bytes": 2**31}),
     2.0),
    ("sort_rows_roofline", _record(calls=[
        {"span": "sort_rows", "bytes": PEAK * 1e-3, "device_ms": 4.0},
        {"span": "compact", "bytes": PEAK, "device_ms": 1.0}]), 25.0),
    ("kernels_roofline", _record(calls=[
        {"span": "sort_rows", "bytes": PEAK * 1e-3, "device_ms": 4.0},
        {"span": "compact", "bytes": PEAK * 1e-3, "device_ms": 2.0},
        {"span": "merge_path", "bytes": PEAK * 1e-3, "device_ms": 2.0}]),
     50.0),
    ("device.idle_pct", _record(busy_s=3.0, window_s=4.0), 25.0),
    ("counting_rate", _record(counting_s=[4.0, 6.0]), 200.0),
])
def test_metric_readers(name, record, value):
    mod = harness.load_module(harness.BENCH, "metrics", name)
    assert mod.read(record) == pytest.approx(value)


@pytest.mark.parametrize("name", ["pipeline.device_ms", "store.device_ms",
                                  "finalize.device_ms", "store.resting_gib",
                                  "sort_rows_roofline", "kernels_roofline",
                                  "device.idle_pct", "counting_rate"])
def test_readers_return_nothing_when_nothing_was_read(name):
    mod = harness.load_module(harness.BENCH, "metrics", name)
    assert mod.read(_record()) is None
