"""The port's tracing module (kubeflow_tpu_torch/utils/obs.py) against the
JAX package's: the same calls into both tracers give the same events and
Chrome documents (times taken relative to each module's epoch), and the
JAX cases of tests/test_obs.py hold on the port's copy: the bounded ring,
the disabled tracer's shared no-op span, trace-id sanitising,
merge_chrome_traces and FlightRecorder."""

from __future__ import annotations

import json
import re
import threading

import pytest

from kubeflow_tpu.utils import obs as jobs
from kubeflow_tpu_torch.utils import obs as tobs

MODULES = pytest.mark.parametrize("obs", [jobs, tobs], ids=["jax", "port"])


def _drive(obs, t0: float) -> "obs.Tracer":
    """One fixed sequence of calls, its recorded intervals at `t0` + k s
    on the module's own clock."""
    t = obs.Tracer(capacity=8, enabled=True)
    with t.span("serve.admit", trace_id="req-1", path="/v1/x") as sp:
        sp.set(admitted=True)
    t.record("serve.batch_gather", t0, t0 + 0.25, "req-1", slot=0)
    t.record("serve.decode_chunk", t0 + 1.0, t0 + 1.5, "req-2", slot=1,
             chunk=4, overlapped=False)
    t.record("serve.fetch", t0 + 1.5, t0 + 1.5, "req-2", slot=1)
    t.record("clamped", t0 + 2.0, t0 + 1.0, "req-3")  # negative -> 0
    return t


def _timeless(events):
    return [{k: v for k, v in e.items() if k != "ts_us"
             and not (k == "dur_us" and e["name"] == "serve.admit")}
            for e in events]


def test_events_and_chrome_trace_equal_jax():
    """Names, ids, attrs, threads and measured durations equal; start
    times equal once taken relative to each module's epoch."""
    jt, tt = _drive(jobs, jobs._EPOCH + 10.0), _drive(tobs,
                                                      tobs._EPOCH + 10.0)
    assert _timeless(tt.events()) == _timeless(jt.events())
    for e_j, e_t in zip(jt.events()[1:], tt.events()[1:]):
        assert e_t["ts_us"] == pytest.approx(e_j["ts_us"], abs=1e-3)
    for tid in (None, "req-2", "nope"):
        jd, td = jt.chrome_trace(tid), tt.chrome_trace(tid)
        assert set(td) == set(jd) == {"traceEvents", "displayTimeUnit",
                                      "now_us"}
        je, te = jd["traceEvents"], td["traceEvents"]
        assert len(je) == len(te)
        for a, b in zip(je, te):
            if a["name"] == "serve.admit":
                a, b = dict(a, dur=0, ts=0), dict(b, dur=0, ts=0)
            assert b == a
    assert tt.chrome_trace("req-2")["traceEvents"][0]["args"] == {
        "trace_id": "req-2", "slot": 1, "chunk": 4, "overlapped": False}
    assert tobs.perf_to_us(tobs._EPOCH + 1.0) == pytest.approx(1e6)


@MODULES
def test_tracer_ring_is_bounded(obs):
    t = obs.Tracer(capacity=16, enabled=True)
    for i in range(200):
        with t.span("x", trace_id="t", i=i):
            pass
    assert len(t) == 16
    assert [e["attrs"]["i"] for e in t.events()] == list(range(184, 200))
    with pytest.raises(ValueError):
        obs.Tracer(capacity=0)


@MODULES
def test_chrome_trace_valid_and_filterable(obs):
    t = obs.Tracer(capacity=32, enabled=True)
    with t.span("serve.admit", trace_id="req-1", admitted=True):
        pass
    t.record("serve.fetch", 1.0, 1.5, "req-2", slot=0)
    doc = json.loads(json.dumps(t.chrome_trace()))
    assert doc["now_us"] >= max(ev["ts"] + ev["dur"]
                                for ev in doc["traceEvents"])
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0
        assert "trace_id" in ev["args"]
    (only,) = t.chrome_trace("req-2")["traceEvents"]
    assert only["name"] == "serve.fetch"
    assert only["args"] == {"trace_id": "req-2", "slot": 0}
    assert only["dur"] == pytest.approx(0.5e6)
    assert only["tid"] == threading.current_thread().name


@MODULES
def test_disabled_tracer_allocates_nothing(obs):
    t = obs.Tracer(capacity=8, enabled=False)
    spans = {id(t.span("a", trace_id="x")) for _ in range(50)}
    assert spans == {id(obs.NOP_SPAN)}
    with t.span("a") as sp:
        sp.set(k=1)
    assert sp.dur_s == 0.0
    t.record("b", 0.0, 1.0, "x")
    assert len(t) == 0


@pytest.mark.parametrize("raw", [
    "ok-id_1.2:3", 'a"b\nc{d}', "x" * 1000, "é/ü <script>", "\x00\x01",
    "__", "a b\tc"])
def test_sanitize_trace_id_equals_jax_on_hostile_ids(raw):
    got = tobs.sanitize_trace_id(raw)
    assert got == jobs.sanitize_trace_id(raw)
    assert re.fullmatch(r"[A-Za-z0-9._:-]{1,128}", got), got


@MODULES
def test_fresh_ids_and_swapped_tracer(obs):
    fresh = obs.sanitize_trace_id(None)
    assert re.fullmatch(r"[0-9a-f]{32}", fresh)
    assert fresh != obs.sanitize_trace_id("")
    prev = obs.set_tracer(obs.Tracer(capacity=4, enabled=True))
    try:
        with obs.span("swapped", trace_id="z"):
            pass
        obs.record("rec", 1.0, 2.0, "z", k=1)
        assert [e["name"] for e in obs.get_tracer().events("z")] == [
            "swapped", "rec"]
    finally:
        obs.set_tracer(prev)


def test_env_switch_turns_tracing_off(monkeypatch):
    for value, on in (("0", False), ("1", True), (None, True)):
        if value is None:
            monkeypatch.delenv("TPK_TRACE", raising=False)
        else:
            monkeypatch.setenv("TPK_TRACE", value)
        assert tobs.Tracer().enabled is on is jobs.Tracer().enabled


def _parts(obs):
    t1 = obs.Tracer(capacity=8, enabled=True)
    t2 = obs.Tracer(capacity=8, enabled=True)
    t1.record("router.place", obs._EPOCH + 3.0, obs._EPOCH + 3.1, "rq")
    t2.record("serve.decode", obs._EPOCH + 5.0, obs._EPOCH + 5.5, "rq",
              slot=1)
    t2.record("early", obs._EPOCH + 1.0, obs._EPOCH + 2.0, "rq")
    return [
        {"process": "router", "doc": t1.chrome_trace("rq"),
         "offset_us": 0.0, "err_us": 0.0},
        {"process": "dec1", "doc": t2.chrome_trace("rq"),
         "offset_us": 1000.0, "err_us": 250.0},
        {"process": "dead", "doc": {"traceEvents": []},
         "offset_us": 0.0, "err_us": None},
        {"doc": None},
    ]


def test_merge_chrome_traces_equals_jax():
    jm = jobs.merge_chrome_traces(_parts(jobs))
    tm = tobs.merge_chrome_traces(_parts(tobs))
    assert tm == jm
    assert [m["args"]["name"] for m in tm["traceEvents"]
            if m["ph"] == "M"] == ["router", "dec1", "dead", "proc3"]
    names = [e["name"] for e in tm["traceEvents"] if e["ph"] != "M"]
    assert names == ["early", "router.place", "serve.decode"]
    assert tm["clock_alignment"]["dead"] == {
        "offset_us": 0.0, "skew_err_us": None, "aligned": False}
    json.loads(json.dumps(tm))


@MODULES
def test_flight_recorder_ring_tail_lookup_snapshot(obs):
    fr = obs.FlightRecorder(capacity=4, snapshot_capacity=2,
                            snapshot_tail=3)
    for i in range(6):
        fr.record(trace_id=f"t{i}", outcome="ok", i=i)
    assert len(fr) == 4
    assert [r["seq"] for r in fr.tail()] == [3, 4, 5, 6]
    assert [r["trace_id"] for r in fr.tail(2)] == ["t4", "t5"]
    assert fr.tail(0) == [] and fr.lookup("t0") is None
    fr.record(trace_id="t3", outcome="retry", i=99)
    assert fr.lookup("t3")["i"] == 99
    snap = fr.snapshot("resume:dec0", delivered=16)
    assert [r["trace_id"] for r in snap["records"]] == ["t4", "t5", "t3"]
    for i in range(10):
        fr.record(trace_id=f"u{i}")
    fr.snapshot("eject:a")
    fr.snapshot("eject:b")
    assert [s["reason"] for s in fr.snapshots()] == ["eject:a", "eject:b"]
    fr.clear()
    assert len(fr) == 0 and fr.snapshots() == []
    with pytest.raises(ValueError):
        obs.FlightRecorder(capacity=0)


def test_flight_recorder_records_equal_jax():
    def drive(obs):
        fr = obs.FlightRecorder(capacity=3, snapshot_tail=2)
        for i in range(5):
            fr.record(trace_id=f"t{i % 2}", outcome="ok", i=i)
        snap = fr.snapshot("x", k=1)
        return fr.tail(), fr.lookup("t1"), snap["records"], snap["context"]

    assert drive(tobs) == drive(jobs)
