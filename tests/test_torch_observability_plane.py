"""The observability plane of the port (ROADMAP A9) against paddle_tpu's:
the counterparts of the reference's ``tests/test_observability.py``,
``tests/test_slo_timeline.py`` and ``tests/test_telemetry_plane.py``.

- The registry: the same registrations give the reference's
  ``snapshot()`` dict and ``to_prometheus()`` text, character for
  character, and the exposition parses.
- `SLOTracker` on scripted request timelines: the same attained and
  violated totals, objectives, attainment and burn rate as the
  reference's tracker on the same timelines.
- Process self-telemetry and the profiler: the gauges and the
  ``/healthz`` block; `make_scheduler`'s windows state for state, and a
  `Profiler` on CPU targets exporting once a window; a GPU target
  without a card raises (no silent host-only trace).
- The flight recorder dumps exactly one postmortem on a step death and
  none on ``close()``; an engine-owned recorder leaves the tracing sinks.
- The endpoint on port 0: every path answers, ``/metrics`` parses, and a
  stopped server refuses.
- The Engine's spans and async events against a scripted reference run:
  the same names, phases and stage literals, in the same numbers.
- An engine with every A9 argument armed streams the same tokens as an
  unarmed one, and its ``stats()`` carries ``decode_exec_flops``,
  ``decode_flops_per_token`` and the SLO fields.
- ``tools/check_metric_names.py`` and ``tools/check_span_phases.py``
  pass over ``paddle_tpu_torch/`` (read-only use of the tools).
"""
import collections
import importlib.util
import json
import os
import re
import urllib.error
import urllib.request

import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.profiler import profiler as jprof
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler as pprof
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.observability.slo import SLO, SLOTracker
from paddle_tpu_torch.serving import Engine, FaultInjector

import _torch_serving as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODEL, MODEL = ts.both_models(seed=29)
ROWS = ts.rows(29, (5, 7, 3))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parse_prometheus(text):
    """``({series name: {label text: value}}, {family: type})`` of an
    exposition; raises on a malformed line."""
    series, types = collections.defaultdict(dict), {}
    pat = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
            continue
        if line.startswith("#") or not line:
            continue
        m = pat.match(line)
        assert m, f"malformed exposition line: {line!r}"
        series[m.group(1)][m.group(3) or ""] = float(m.group(4))
    return series, types


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _register(reg):
    reg.counter("tokens_total", "toks", labelnames=("engine",)).inc(
        7, engine='we"ird\nname\\x')
    reg.counter("tokens_total", "toks", labelnames=("engine",)).inc(
        2, engine="e1")
    g = reg.gauge("hbm_bytes", "bytes")
    g.set(1.5e9)
    reg.gauge("ratio").set(float("nan"))
    reg.gauge("level", labelnames=("k",)).set(float("inf"), k="a")
    h = reg.histogram("step_seconds", "steps", buckets=(0.1, 1.0))
    for v in (0.05, 10.0, 0.5):
        h.observe(v)
    reg.histogram("lat_seconds", labelnames=("engine",)).observe(
        0.003, engine="e1")


def test_registry_snapshot_and_exposition_are_the_references():
    mine, theirs = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _register(mine)
    _register(theirs)
    a, b = mine.snapshot(), theirs.snapshot()
    # NaN != NaN: compare the JSON texts, which spell it the same way
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert mine.to_prometheus() == theirs.to_prometheus()
    series, types = _parse_prometheus(mine.to_prometheus())
    assert types == {"tokens_total": "counter", "hbm_bytes": "gauge",
                     "ratio": "gauge", "level": "gauge",
                     "step_seconds": "histogram",
                     "lat_seconds": "histogram"}
    assert series["step_seconds_bucket"]['le="+Inf"'] == 3
    assert series["step_seconds_count"][""] == 3
    # the process-wide registry (whatever other tests put there) parses
    _parse_prometheus(obs.to_prometheus())
    assert obs.snapshot() == obs.get_registry().snapshot()
    # a reset counter child, a removed series
    mine.counter("tokens_total", labelnames=("engine",)).reset(1, engine="e1")
    mine.gauge("level", labelnames=("k",)).remove(k="a")
    snap = mine.snapshot()
    assert snap["level"]["values"] == []
    assert {v["labels"]["engine"]: v["value"]
            for v in snap["tokens_total"]["values"]}["e1"] == 1.0


class _Req:
    """A terminated request's timestamps, as the trackers read them."""

    def __init__(self, t0, ttft, gaps, e2e, state="finished"):
        self.submit_time = t0
        self.first_token_time = None if ttft is None else t0 + ttft
        times, t = [], self.first_token_time
        for gap in gaps:
            times.append(t)
            t += gap
        self.token_times = times
        self.finish_time = None if e2e is None else t0 + e2e
        self.state = state


#: (ttft, inter-token gaps, e2e, state, cause) of a scripted run
SCRIPT = [
    (0.01, [0.01] * 5, 0.08, "finished", "done"),
    (0.50, [0.01] * 5, 0.60, "finished", "done"),           # ttft
    (0.01, [0.01, 0.30, 0.01, 0.01], 0.40, "finished", "done"),   # itl
    (0.01, [0.01] * 5, 2.00, "finished", "done"),           # e2e
    (None, [], None, "cancelled", "deadline"),
    (None, [], None, "cancelled", "shed"),
    (0.02, [0.01] * 3, 0.06, "cancelled", "cancel"),        # neither
    (0.02, [0.02] * 3, 0.09, "finished", "done"),
]


@pytest.mark.parametrize("slo", [
    dict(ttft_p99_s=0.1, itl_p99_s=0.1, e2e_p99_s=1.0, availability=0.9),
    dict(e2e_p99_s=0.5, availability=0.99, windows=(60.0, 3600.0)),
    dict(ttft_p99_s=0.05)], ids=["all", "e2e", "ttft"])
def test_slo_tracker_matches_the_reference_on_scripted_timelines(slo):
    from paddle_tpu.observability.slo import SLO as JSLO
    from paddle_tpu.observability.slo import SLOTracker as JSLOTracker

    mine = SLOTracker(SLO(**slo), source_id="port-slo")
    theirs = JSLOTracker(JSLO(**slo), source_id="ref-slo")
    for ttft, gaps, e2e, state, cause in SCRIPT:
        req = _Req(100.0, ttft, gaps, e2e, state)
        assert mine.violations_of(req, cause) == \
            theirs.violations_of(req, cause)
        mine.observe(req, cause)
        theirs.observe(req, cause)
    a, b = mine.snapshot(), theirs.snapshot()
    for key in ("objectives", "attained_total", "violated_total",
                "attainment", "violated_by_objective", "availability"):
        assert a[key] == b[key], key
    assert a["burn_rate"] == pytest.approx(b["burn_rate"])
    assert mine.burn_rate() == pytest.approx(theirs.burn_rate())
    reg = obs.snapshot()
    vals = {v["labels"]["engine"]: v["value"]
            for v in reg["serving_slo_attained_total"]["values"]}
    assert vals["port-slo"] == b["attained_total"]
    mine.reset()
    assert mine.snapshot()["attained_total"] == 0


def test_process_stats_gauges_and_healthz_block():
    s = obs.publish_process_stats(instance="port-test")
    assert s["rss_bytes"] > 0 and s["uptime_s"] > 0
    assert s["thread_count"] >= 1
    assert set(s) == set(jobs.read_process_stats())
    vals = {v["labels"]["instance"]: v["value"] for v in
            obs.snapshot()["process_rss_bytes"]["values"]}
    assert vals["port-test"] == s["rss_bytes"]
    srv = obs.start_observability_server(port=0)
    try:
        code, body = _get(srv.url + "/healthz")
        assert code == 200
        assert set(json.loads(body)["process"]) == set(s)
        assert obs.ensure_process_sampler().running
    finally:
        srv.stop()


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, repeat=2),
    dict(closed=0, ready=0, record=2, repeat=3, skip_first=1),
    dict(closed=2, ready=0, record=1)])
def test_profiler_scheduler_windows_are_the_references(kw, tmp_path):
    mine, theirs = pprof.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert ([mine(i).name for i in range(14)]
            == [theirs(i).name for i in range(14)])
    fired = []
    prof = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU],
                          scheduler=mine,
                          on_trace_ready=lambda p: fired.append(
                              pprof.export_chrome_tracing(
                                  str(tmp_path))(p)))
    ref_fired = []
    ref = jprof.Profiler(targets=[jprof.ProfilerTarget.CPU],
                         scheduler=theirs,
                         on_trace_ready=lambda p: ref_fired.append(1))
    prof.start()
    ref.start()
    for i in range(12):
        with pprof.RecordEvent("work", args={"i": i}):
            pass
        prof.step()
        ref.step()
    prof.stop()
    ref.stop()
    assert len(fired) == len(ref_fired) > 0
    events = pprof.load_profiler_result(fired[0])["traceEvents"]
    assert events and {e["name"] for e in events} == {"work"}
    assert prof.device_profile is None      # CPU targets: no device trace


def test_profiler_gpu_target_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n0 = len(tracing._sinks)
    prof = pprof.Profiler()               # default targets: CPU and GPU
    with pytest.raises(RuntimeError, match="CUDA device"):
        prof.start()
    assert len(tracing._sinks) == n0
    with pytest.raises(ValueError, match="GPU"):
        pprof.Profiler(targets=[pprof.ProfilerTarget.TPU])


def _paged(**kw):
    return Engine(MODEL, device="cpu", slots=1, max_len=16,
                  prefill_buckets=(8,), kv_mode="paged", page_size=4, **kw)


def test_flight_recorder_dumps_once_on_a_death_and_not_on_close(tmp_path):
    inj = FaultInjector().add("step_error", at_step=1)
    rec = obs.FlightRecorder(dump_dir=str(tmp_path / "fr"))
    eng = _paged(fault_injector=inj, flight_recorder=rec)
    h = eng.submit(ROWS[0], max_new_tokens=4)
    with pytest.raises(RuntimeError):
        h.result(timeout=30.0)
    files = sorted((tmp_path / "fr").glob("*.json"))
    assert len(files) == 1 and rec.dumps == [str(files[0])]
    art = json.loads(files[0].read_text())
    assert art["schema"] == "paddle_tpu.flight_recorder/v1"
    assert art["reason"] == "InjectedFault"
    assert art["engine_id"] == eng.engine_id
    # dumped before the sweep released the request's pages
    assert art["pool"]["pages_in_use"] >= 1
    assert h._req.rid in art["in_flight_request_ids"]
    assert art["last_dispatch_done_age_s"] is not None
    assert art["in_flight_timelines"][0]["phases"][-1]["phase"] == "decode"
    assert eng.kv.pages_in_use == 0
    vals = obs.snapshot()["flight_recorder_dumps_total"]["values"]
    assert any(v["labels"]["engine"] == eng.engine_id and v["value"] == 1
               for v in vals)
    eng2 = _paged(flight_recorder=rec)
    assert len(eng2.submit(ROWS[1], max_new_tokens=2).result()) == 2
    eng2.close()
    assert len(sorted((tmp_path / "fr").glob("*.json"))) == 1
    rec.detach()
    # an engine-owned recorder unhooks its ring at shutdown
    n0 = len(tracing._sinks)
    eng3 = _paged(flight_recorder=True)
    assert len(tracing._sinks) == n0 + 1
    eng3.close()
    assert len(tracing._sinks) == n0


def test_endpoint_lifecycle_on_port_zero():
    eng = _paged(observability_port=0, slo=SLO(e2e_p99_s=60.0))
    srv = eng.obs_server
    assert srv is not None and srv.port != 0 and srv.host == "127.0.0.1"
    base = srv.url
    assert len(eng.submit(ROWS[0], max_new_tokens=3).result()) == 3
    eid = eng.engine_id
    code, text = _get(base + "/metrics")
    assert code == 200
    series, types = _parse_prometheus(text)
    assert types["serving_tokens_emitted_total"] == "counter"
    assert series["serving_tokens_emitted_total"][f'engine="{eid}"'] == 3
    code, body = _get(base + "/healthz")
    assert code == 200
    assert json.loads(body)["replicas"][eid]["state"] == "serving"
    code, body = _get(base + "/readyz")
    assert code == 200 and json.loads(body)["status"] == "ready"
    code, body = _get(base + "/stats")
    row = next(s for s in json.loads(body)["sources"]
               if s["engine_id"] == eid)
    assert row["type"] == "engine" and row["tokens_generated"] == 3
    assert "xla_traces" in json.loads(body)["bench"]
    code, body = _get(base + "/trace")
    assert code == 200
    assert "serving.decode" in {e["name"]
                                for e in json.loads(body)["traceEvents"]}
    code, body = _get(base + "/slo")
    slo = json.loads(body)["sources"][0]
    assert slo["id"] == eid and slo["attained_total"] == 1
    code, body = _get(base + "/requests")
    assert json.loads(body)["sources"][0]["id"] == eid
    code, body = _get(base + "/train")
    assert code == 200 and json.loads(body) == {"sources": []}
    code, body = _get(base + "/control")
    assert code == 404 and "/metrics" in json.loads(body)["paths"]
    eng.close()                     # stops the server
    srv.stop()                      # idempotent
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(base + "/metrics", timeout=1.0)
    srv2 = obs.start_observability_server(port=0, sources=(eng,))
    try:
        code, body = _get(srv2.url + "/healthz")
        assert code == 503
        assert json.loads(body)["replicas"][eid]["state"] == "dead"
    finally:
        srv2.stop()


def _events(mod, make, rows, spec_k=0):
    """``(name, ph, stage)`` of every event a scripted run emits."""
    with mod.collect() as window:
        eng = make(slots=2, max_len=20, prefill_buckets=(8,),
                   kv_mode="paged", page_size=4, spec_k=spec_k)
        handles = [eng.submit(r, max_new_tokens=5) for r in rows]
        outs = [h.result() for h in handles]
    return outs, [(e["name"], e["ph"], e.get("args", {}).get("stage"))
                  for e in window]


@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_spans_and_events_are_the_references(spec_k):
    rows = ROWS + ts.rows(31, (6,))
    ref_out, ref_ev = _events(jtracing, lambda **kw: JaxEngine(JAX_MODEL,
                                                               **kw),
                              rows, spec_k)
    out, ev = _events(tracing, lambda **kw: Engine(MODEL, device="cpu",
                                                   **kw), rows, spec_k)
    assert out == ref_out
    assert collections.Counter(ev) == collections.Counter(ref_ev)
    names = {n for n, _, _ in ev}
    assert {"request", "slot.admission", "serving.prefill",
            "serving.decode", "slot.decode_token",
            "slot.eviction"} <= names
    if spec_k:
        assert "spec.verify" in names


def test_no_sink_builds_no_token_events(monkeypatch):
    """With no sink attached and the buffer off, the decode loop asks
    `tracing.active()` once a step and builds no per-token event."""
    built = []
    real = tracing.async_instant_evt
    monkeypatch.setattr(
        tracing, "async_instant_evt",
        lambda name, *a, **k: built.append(name) or real(name, *a, **k))
    saved = tracing.buffer_enabled()
    tracing.set_buffer_enabled(False)
    try:
        assert not tracing.active()
        eng = _paged()
        assert len(eng.submit(ROWS[0], max_new_tokens=4).result()) == 4
        assert "slot.decode_token" not in built
    finally:
        tracing.set_buffer_enabled(saved)
    eng = _paged()
    assert len(eng.submit(ROWS[0], max_new_tokens=4).result()) == 4
    # the buffer on: the decode steps' three tokens
    assert built.count("slot.decode_token") == 3


def test_armed_engine_streams_the_unarmed_tokens(tmp_path):
    rows = ts.rows(33, (5, 8, 2, 7))
    base = dict(slots=2, max_len=20, prefill_buckets=(8,), kv_mode="paged",
                page_size=4)
    plain = Engine(MODEL, device="cpu", **base)
    want = [plain.submit(r, max_new_tokens=6).result() for r in rows]
    seen = []
    rec = obs.FlightRecorder(dump_dir=str(tmp_path / "fr"))
    with tracing.collect() as window:
        armed = Engine(MODEL, device="cpu", slo=SLO(ttft_p99_s=30.0),
                       flight_recorder=rec, observability_port=0,
                       profiler=lambda ev, info: seen.append(ev), **base)
        got = [armed.submit(r, max_new_tokens=6).result() for r in rows]
        s = armed.stats()
        armed.close()
    rec.detach()
    assert got == want
    assert window and rec.dumps == []
    assert collections.Counter(seen) == {"prefill": 4, "decode":
                                         s.decode_steps}
    assert s.slo_attained == 4 and s.slo_violated == 0
    assert s.slo_attainment == 1.0 and s.goodput_per_s > 0
    assert s.decode_exec_flops > 0
    # on the CPU every decode step is counted by the counter alone
    assert s.decode_flops_per_token == pytest.approx(
        s.decode_exec_flops * s.decode_steps / s.tokens_generated)
    name = armed._decode_name()
    assert obs.costs.executable_costs(name)["flops"] == s.decode_exec_flops


def test_decode_flops_add_the_paged_kernels_formula_on_a_card():
    """On a card the counter cannot see B3 (a ctypes launch), so the
    engine prices its decode step in closed form when ``stats()`` asks
    (`costs.gpt_decode_flops`): the products plus ``4 H W L D`` a row
    and a layer, L the cursor's columns (plus the window) of an active
    row and the whole table of a parked one (the kernel's uniform
    fallback). The closed form is held against `FlopCounterMode` over
    the step's body on the CPU, where the plain attention reads every
    row's whole table."""
    import numpy as np
    import torch

    eng = Engine(MODEL, device="cpu", slots=2, max_len=20,
                 prefill_buckets=(8,), kv_mode="paged", page_size=4)
    h = eng.submit(ROWS[0], max_new_tokens=8)
    eng.step()
    eng.step()
    w, cfg, lp = 1, MODEL.config, eng.kv.logical_len
    cols = np.where(eng.kv.active, np.minimum(eng.kv.steps + w, lp), lp)
    assert eng.kv.active.sum() == 1 and cols.min() < lp
    s = eng.stats()
    assert s.decode_exec_flops == pytest.approx(
        obs.costs.gpt_decode_flops(cfg, w, cols))
    # the pending tokens' step, as the next call runs it: its K/V land
    # where that call writes them
    with torch.inference_mode():
        _, counted = obs.costs.count_flops(
            eng._verify.run_eager,
            **eng._step_operands(eng._tokens[:, None]))
    assert counted == obs.costs.gpt_decode_flops(cfg, w, [lp] * eng.slots)
    assert h.result() == Engine(
        MODEL, device="cpu", slots=2, max_len=20, prefill_buckets=(8,),
        kv_mode="paged", page_size=4).submit(
            ROWS[0], max_new_tokens=8).result()


def test_step_flop_counting_takes_every_bmm_overload():
    """`costs.count_flops` gives ``aten.bmm`` a formula of its own: the
    ``bmm.dtype`` overload (16-bit operands, a float32 output, the dense
    decode attention on a card) passes its dtype third, which one
    torch's formula read as the output shape and raised on."""
    import torch

    from paddle_tpu_torch.observability.costs import bmm_flop, count_flops

    assert bmm_flop((2, 3, 4), (2, 4, 5), torch.float32,
                    out_shape=(2, 3, 5)) == 2 * 2 * 3 * 4 * 5
    a, b = torch.randn(2, 3, 4), torch.randn(2, 4, 5)
    out, flops = count_flops(torch.bmm, a, b)
    assert flops == 240 and out.shape == (2, 3, 5)


def test_costs_peak_table_and_mfu(monkeypatch):
    """The MFU denominator: an override, the reference's environment
    variable, the CPU's smoke value, the Hopper table by card name, and
    a card the table does not know raises."""
    import torch

    from paddle_tpu_torch.observability import costs

    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    costs.reset_for_test()
    assert costs.peak_flops_per_sec(device="cpu") == costs.CPU_PEAK_FLOPS
    assert costs.peak_flops_per_sec(override=5e14) == 5e14
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e15")
    assert costs.peak_flops_per_sec(device="cpu") == 1e15
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS")
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA A100-SXM4-80GB", None)):
        costs.reset_for_test()
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None, n=name: n)
        if peak is None:
            with pytest.raises(ValueError, match="PEAK_FLOPS_TABLE"):
                costs.peak_flops_per_sec(device="cuda:0")
        else:
            assert costs.peak_flops_per_sec(device="cuda:0") == peak
    costs.reset_for_test()
    assert costs.mfu(1e12, 0.5, peak=4e12) == 0.5
    assert costs.mfu(None, 0.5) is None
    entry = costs.record_executable_costs("step[x]", 2e9, nbytes=1e9)
    assert entry["arithmetic_intensity"] == 2.0
    assert costs.executable_costs("step[x]")["flops"] == 2e9
    vals = {v["labels"]["executable"]: v["value"] for v in
            obs.snapshot()["executable_flops"]["values"]}
    assert vals["step[x]"] == 2e9


def test_repo_lints_pass_over_the_port():
    names = _tool("check_metric_names")
    violations, allowed = names.scan_tree(os.path.join(ROOT,
                                                       "paddle_tpu_torch"))
    assert not violations, violations
    assert len(allowed) > 10
    phases = _tool("check_span_phases")
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    serving = phases.load_phases(os.path.join(pkg, "serving",
                                              "timeline.py"))
    v, audited = phases.scan_tree(os.path.join(pkg, "serving"), serving)
    assert not v, v
    assert {line.split("stage=")[1] for _, _, line in audited} >= {
        "'prefill'", "'decode'"}
    train = phases.load_phases(os.path.join(pkg, phases.TRAIN_VOCAB))
    for sub in phases.TRAIN_ROOTS:
        v, _ = phases.scan_tree(os.path.join(pkg, sub), train)
        assert not v, v
