"""The trace reader on a hand-made Chrome trace."""

import json

import pytest

from portbench import trace


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_read_trace(tmp_path):
    events = [
        _ev(trace.WINDOW, "user_annotation", 1000, 1000),
        _ev("k1", "kernel", 900, 200, tid=7),        # clipped to [1000, 1100]
        _ev("k2", "kernel", 1050, 100, tid=7),       # overlaps k1: union [1000, 1150]
        _ev("Memcpy HtoD", "gpu_memcpy", 1400, 100, tid=8),
        _ev("k1", "kernel", 1900, 300, tid=7),       # clipped to [1900, 2000]
        _ev("aten::copy_", "cpu_op", 1150, 200),      # spans the gap [1150, 1400]
        _ev("parse", "user_annotation", 1500, 400),  # spans the gap [1500, 1900]
        _ev("aten::sort", "cpu_op", 1600, 50),        # inside parse, not at the gap's middle
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    r = trace.read_trace(str(p))
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((150 + 100 + 100) * 1e-6)
    assert r["kernel_s"] == pytest.approx((100 + 100 + 100) * 1e-6)
    assert dict(r["device_ops"]) == pytest.approx({"k1": 200e-6, "k2": 100e-6,
                                                   "Memcpy HtoD": 100e-6})
    assert dict(r["idle_gaps"]) == pytest.approx({"aten::copy_": 250e-6, "parse": 400e-6})


def test_no_device_activity_reads_nothing(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [_ev(trace.WINDOW, "user_annotation", 0, 10)]}))
    assert trace.read_trace(str(p)) is None


def test_spans_wrap_calls_and_iterators_and_restore():
    class Owner:
        @staticmethod
        def f(x):
            return x + 1

        @staticmethod
        def g(n):
            yield from range(n)

    f, g = Owner.f, Owner.g
    with trace.spans([(Owner, "f", "step"), (Owner, "g", "input wait")]):
        assert Owner.f is not f and Owner.f(1) == 2
        assert list(Owner.g(3)) == [0, 1, 2]
    assert Owner.f is f and Owner.g is g


@pytest.mark.parametrize("traffic", ["stream_depth", "lineage", "call"])
def test_traced_run_on_the_cpu(traffic, cache):
    """The traced path end to end: on the CPU the trace holds no device
    activity, so no device metric is read, and the run stays correct."""
    from portbench import run
    from portbench.tests.conftest import tiny

    cfg, tr = tiny(traffic)
    metrics = [{"name": n, "unit": "u"} for n in
               ("device_idle_pct.stream", "kernels_roofline.hpv16", "hpv16_table_build_s",
                "call_depth_map_s")]
    out = run.run_cell(cfg, tr, 8, 0.0, True, metrics, "cpu", 0.0)
    assert out["correct"]
    assert set(out["metrics"]) == {"lineage": {"hpv16_table_build_s"},
                                   "call": {"call_depth_map_s"}}.get(traffic, set())
    assert not (cache / "trace.json").exists()
