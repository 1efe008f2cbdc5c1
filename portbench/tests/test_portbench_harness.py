"""The harness: it finds everything BENCHMARK.json names, prints the
contract's result, loads nothing of JAX, and refuses to run without a
card.  The test marked ``gpu`` runs a short traced run on the card."""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from conftest import calls_for
from portbench import spec, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_loaders_find_everything_named():
    bench = spec.benchmark()
    for c in bench["configs"]:
        assert spec.config(c["name"])["source"]
        assert os.path.exists(spec.ROOT / c["file"])
    for w in bench["workloads"]:
        spec.config(w["config"])
        assert spec.traffic(w["traffic"])["api"] in ("push", "push_many")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_benchmark_json_keeps_to_its_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m["name"] for m in spec.end_to_end(bench, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(bench, cell)
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in [x["name"] for x in
                                  spec.end_to_end(bench, cell)]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_the_last_line_has_the_contract_keys(small):
    from portbench import run
    r = run.run_cell("uhd8.push", 99, 0, False, time.perf_counter(),
                     device="cpu", overrides=small,
                     max_calls=calls_for("uhd8.push"))
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"pair_ms_p95", "setup_s"}
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    json.dumps(r)


def test_nothing_of_jax_is_loaded():
    code = ("import sys\n"
            "from portbench import run, check, control, content, driver, "
            "spec, trace, work\n"
            "from portbench.reference import cadence, models, pair\n"
            "bench = spec.benchmark()\n"
            "for m in bench['end_to_end'] + bench['per_layer']:\n"
            "    spec.reader(m['name'])\n"
            "import mpv_frame_interpolator_tpu_torch.pipeline.engine\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "from portbench.reference import cadence, models, pair\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mpv_frame_interpolator_tpu_torch', "
            "'mpv_frame_interpolator_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_command_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "uhd8.group8", "--seed", "3000000000", "--seconds",
                          "1", "--trace", "0"], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout


class _Ev:
    def __init__(self, name, dev, s, e, thread=1):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
        self.thread = thread

        class R:
            start, end = s, e
        self.time_range = R


def test_trace_reading_busy_idle_and_breakdown():
    ev = [_Ev(trace.MARK, True, 0.0, 99.0),
          _Ev(trace.MARK, False, 0.0, 100.0),
          _Ev("void pyramid_kernel<unsigned char, 16>", True, 10.0, 40.0),
          _Ev("Memcpy DtoD (Device -> Device)", True, 30.0, 50.0),
          _Ev("void pair_blend_kernel<unsigned char>", True, 70.0, 80.0),
          _Ev("cudaEventSynchronize", False, 50.0, 70.0),
          _Ev("cudaEventSynchronize", False, 80.0, 100.0, thread=2),
          _Ev("spin", True, -50.0, -10.0)]
    v = trace.read(ev, pairs=2)
    assert v.window_us == 100.0 and v.busy_us == 50.0
    assert v.ms_per_pair(("pyramid_kernel",)) == pytest.approx(0.015)
    assert v.ms_per_pair(("no such kernel",)) is None
    idle = dict(v.idle_by_host)
    assert idle == {"python (no op)": 30.0, "cudaEventSynchronize": 20.0}
    b = v.breakdown()
    assert b["device_ops"][0][0].startswith("void pyramid_kernel")
    assert len(b["device_ops"]) == 3


def _span_events():
    """A 100-us stretch of two push calls and a wait outside them, with
    the card busy over [10, 50] and [70, 80]."""
    host = [("mfi.push", 0, 45), ("mfi.engine.wait", 2, 12),
            ("mfi.pair", 15, 40), ("mfi.k1", 20, 30),
            ("mfi.push", 48, 95), ("mfi.engine.wait", 50, 60),
            ("cudaEventSynchronize", 50, 70), ("mfi.pair", 62, 90),
            ("mfi.k2", 75, 85), ("mfi.engine.wait", 96, 99),
            # not inside the stretch, or not on its thread
            ("mfi.push", -20, -10), ("mfi.push", 98, 105)]
    return ([_Ev(trace.MARK, True, 0.0, 99.0),
             _Ev(trace.MARK, False, 0.0, 100.0),
             _Ev("void pyramid_kernel<unsigned char, 16>", True, 10.0, 40.0),
             _Ev("Memcpy DtoD (Device -> Device)", True, 30.0, 50.0),
             _Ev("void pair_blend_kernel<unsigned char>", True, 70.0, 80.0),
             _Ev("mfi.pair", False, 20.0, 60.0, thread=2)]
            + [_Ev(n, False, float(s), float(e)) for n, s, e in host])


def test_trace_reading_spans():
    v = trace.read(_span_events(), pairs=2)
    # the old fields, as before
    assert v.window_us == 100.0 and v.busy_us == 50.0
    assert [r[1:] for r in v.rows] == [(10.0, 40.0), (30.0, 50.0),
                                       (70.0, 80.0)]
    assert dict(v.idle_by_host) == {"mfi.engine.wait": 10.0,
                                    "cudaEventSynchronize": 20.0,
                                    "mfi.pair": 20.0}
    assert v.breakdown()["idle_gaps"][0] == ["cudaEventSynchronize", 20e-6]
    # the marker thread's spans inside the stretch, by start
    assert [s[0] for s in v.spans] == [
        "mfi.push", "mfi.engine.wait", "mfi.pair", "mfi.k1", "mfi.push",
        "mfi.engine.wait", "mfi.pair", "mfi.k2", "mfi.engine.wait"]
    assert v.start_us == 0.0
    # inclusive host ms a pair
    assert v.span_ms_per_pair(("mfi.engine.wait",)) == pytest.approx(0.0115)
    assert v.span_ms_per_pair(("mfi.engine.wait",), ("mfi.push",)) == \
        pytest.approx(0.010)
    assert v.span_ms_per_pair(("mfi.pair",)) == pytest.approx(0.0265)
    assert v.span_ms_per_pair(("mfi.push",)) == pytest.approx(0.046)
    assert v.span_ms_per_pair(("mfi.group.fill",)) is None
    assert v.span_ms_per_pair(("mfi.engine.wait",),
                              ("mfi.push_many",)) is None
    # the card idle, by the innermost span open: 50 us of idle in all
    idle = {n: v.idle_within((n,)) for n in (
        "mfi.engine.wait", "mfi.push", "mfi.pair", "mfi.k1", "mfi.k2")}
    assert idle == pytest.approx({"mfi.engine.wait": 21.0, "mfi.push": 9.0,
                                  "mfi.pair": 13.0, "mfi.k1": 0.0,
                                  "mfi.k2": 5.0})
    assert v.idle_within(("mfi.pair", "mfi.k2")) == pytest.approx(18.0)
    assert v.idle_within(("mfi.group.fill",)) is None


def test_a_trace_without_spans_reads_none():
    v = trace.TraceView([("pair_blend_kernel", 0.0, 50.0)], 100.0, 50.0, 2,
                        [], [])
    assert v.spans == [] and v.span_ms_per_pair(("mfi.pair",)) is None
    assert v.idle_within(("mfi.pair",)) is None


@pytest.mark.parametrize("name,want", [
    ("engine.wait_ms_per_pair", 0.010), ("engine.body_ms_per_pair", 0.0265),
    ("group.wait_ms_per_pair", None), ("group.fill_ms_per_pair", None)])
def test_the_span_readers(name, want):
    view = type("View", (), {"trace": trace.read(_span_events(), pairs=2)})
    got = spec.reader(name).read(view)
    assert got == (pytest.approx(want) if want is not None else None)
    view.trace = None
    assert spec.reader(name).read(view) is None


def test_a_roofline_counts_the_pairs_work_once():
    """The share is the pair's least time times the stretch's pairs over
    the rows' device time: one launch a pair or five read alike."""
    one = trace.TraceView([("pair_blend_kernel", 0.0, 50.0),
                           ("pair_blend_kernel", 60.0, 110.0)],
                          200.0, 100.0, 2, [], [])
    five = trace.TraceView([("fused_blend_kernel", 10.0 * i, 10.0 * i + 10)
                            for i in range(10)], 200.0, 100.0, 2, [], [])
    least = 20e-6                       # 20 us of work a pair
    assert one.roofline(("pair_blend",), least) == pytest.approx(40.0)
    assert five.roofline(("fused_blend",), least) == pytest.approx(40.0)
    assert five.roofline(("no such kernel",), least) is None
    assert one.idle_percent() == pytest.approx(50.0)


def test_pair_ms_p95_is_the_tail_of_every_call():
    from portbench import driver
    import torch
    calls = [driver.Call(i, 1, 0.0, (i + 1) * 1e-3, ()) for i in range(100)]
    lat = driver.latencies_ms(calls, torch.device("cpu"))
    assert lat == pytest.approx([i + 1.0 for i in range(100)])
    # on a card, a call's host span is no latency: unstamped, no reading
    assert driver.latencies_ms(calls, torch.device("cuda")) == []
    view = type("View", (), {"latencies_ms": lat})
    assert spec.reader("pair_ms_p95").read(view) == pytest.approx(95.05)
    view.latencies_ms = []
    assert spec.reader("pair_ms_p95").read(view) is None


@pytest.mark.gpu
def test_a_traced_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "uhd8.push", "--seed", "2147483659", "--seconds",
                          "2", "--trace", "1"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert "engine.launches_per_pair" in r["metrics"]
    assert "engine.pair_period_ms_p95" in r["metrics"]
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "uhd8.push", "--seed", "2147483660", "--seconds",
                          "2", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    # a pair's device-clock latency: more than its ~0.33 device ms, far
    # under the 29.8 ms bar
    assert 0.3 < r["metrics"]["pair_ms_p95"]["value"] < 29.8
