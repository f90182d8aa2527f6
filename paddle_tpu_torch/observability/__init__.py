"""Observability: the recompile sentinel, the metrics registry and its
views, trace spans, the SLO tracker, the flight recorder, the scrape
endpoint, process self-telemetry and step costs.

Counterpart: ``paddle_tpu/observability/``. Ported: the sentinel
(`sentinel`); the registry (`registry`: labeled counters, gauges and
fixed-bucket histograms, `snapshot` and `to_prometheus`); trace spans
(`tracing`); the training introspection plane (`train_introspection`);
`guarded_target` (`threads`); `slo`, `flight_recorder`, `server`,
`process_stats` and `costs` (FLOPs counted by `FlopCounterMode`, or in
closed form for the serving engine's decode step, where the reference
reads XLA's cost analysis). ``federation.py`` is ROADMAP
A10. Quick reads::

    import paddle_tpu_torch.observability as obs
    obs.snapshot()           # every counter/gauge/histogram, one dict
    obs.to_prometheus()      # the same, scrape-ready
    obs.get_sentinel().counts()
"""
from . import costs, tracing, train_introspection  # noqa: F401
from .costs import mfu, peak_flops_per_sec, record_executable_costs
from .flight_recorder import FlightRecorder
from .process_stats import (ProcessSampler, ensure_process_sampler,
                            process_instance, publish_process_stats,
                            read_process_stats, set_process_instance)
from .registry import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, bucket_quantile, get_registry)
from .sentinel import RecompileError, RecompileSentinel, get_sentinel, traced
from .server import ObservabilityServer, start_observability_server
from .slo import SLO, SLOTracker
from .threads import guarded_target
from .tracing import (Span, TraceContext, clock_anchor, collect,
                      current_request_id, events_since, export_chrome_trace,
                      instant, request_scope, span)


def snapshot() -> dict:
    """One registry view covering the training, serving and kernel
    planes (``observability/__init__.py:108-110``)."""
    return get_registry().snapshot()


def to_prometheus() -> str:
    return get_registry().to_prometheus()


def arm_recompile_sentinel():
    """Context manager: a rebuild of a sentinel-tracked step raises."""
    return get_sentinel().armed()


def bench_snapshot() -> dict:
    """Compact end-of-run provenance (``observability/__init__.py:
    121-204``): builds per named step (``xla_traces``, distinct
    signatures where recorded: 1 everywhere = capture-once held), the
    serving engines' pool, prefix-cache and SLO families, and the
    training introspection's readings where they exist. The reference's
    ``kernel_fallbacks`` is always empty here: nothing falls back on a
    card (`kernels`); its ``peak_hbm_bytes`` reads the train step's
    gauge of the same name."""
    reg = get_registry()

    def _flat(name, label_keys):
        return {"/".join(str(labels[k]) for k in label_keys): (
                    int(v) if float(v).is_integer() else v)
                for labels, v in reg.collect(name) if v}

    sent = get_sentinel()
    traces = {}
    for name, n in sent.counts().items():
        sigs = [s for s in sent.signatures(name) if s is not None]
        traces[name] = len(set(sigs)) if sigs else n
    out = {"xla_traces": traces, "kernel_fallbacks": {},
           "peak_hbm_bytes": _flat("train_step_peak_hbm_bytes",
                                   ("executable",))}
    serving = {}
    for name in ("serving_kv_pages_in_use", "serving_kv_page_utilization",
                 "serving_prefix_cached_pages", "serving_prefix_hits_total",
                 "serving_prefix_tokens_saved_total",
                 "serving_prefix_evicted_pages_total",
                 "serving_slo_attained_total"):
        vals = _flat(name, ("engine",))
        if vals:
            serving[name] = vals
    vals = _flat("serving_slo_violated_total", ("engine", "objective"))
    if vals:
        serving["serving_slo_violated_total"] = vals
    if serving:
        out["serving"] = serving
    intro = {}
    stall = {labels.get("loop"): v for labels, v in
             reg.collect("train_data_stall_fraction")}
    if stall:
        intro["data_stall_fraction"] = stall
    worst = None
    for labels, v in reg.collect("train_update_ratio"):
        if v == v and (worst is None or v > worst[1]):
            worst = ({**labels}, v)
    if worst is not None:
        intro["worst_layer_update_ratio"] = {
            "layer": worst[0].get("layer"),
            "executable": worst[0].get("executable"), "ratio": worst[1]}
    if intro:
        out["train_introspection"] = intro
    return out


def reset_for_test():
    """Drop every registry metric, the sentinel's history, the recorded
    step costs and the buffered spans: test isolation only."""
    get_registry().reset()
    get_sentinel().reset()
    tracing.clear()
    costs.reset_for_test()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "DEFAULT_LATENCY_BUCKETS", "bucket_quantile",
    "RecompileError", "RecompileSentinel", "get_sentinel", "traced",
    "guarded_target", "Span", "span", "instant", "request_scope",
    "current_request_id", "collect", "export_chrome_trace", "tracing",
    "TraceContext", "clock_anchor", "events_since", "costs",
    "peak_flops_per_sec", "record_executable_costs", "mfu",
    "train_introspection", "FlightRecorder", "SLO", "SLOTracker",
    "ProcessSampler", "ensure_process_sampler", "publish_process_stats",
    "read_process_stats", "set_process_instance", "process_instance",
    "ObservabilityServer", "start_observability_server", "snapshot",
    "to_prometheus", "arm_recompile_sentinel", "bench_snapshot",
    "reset_for_test"]
