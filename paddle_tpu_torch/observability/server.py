"""Live HTTP telemetry endpoint: /metrics, /healthz, /readyz, /stats,
/trace, /slo, /requests, /train.

Counterpart: ``paddle_tpu/observability/server.py``, copied (it imports
nothing of JAX) without ``/control`` (the cluster's control plane,
ROADMAP A10). A `ThreadingHTTPServer` on a guarded background thread,
on the stdlib only, serving

==========  ============================================  ===========
path        payload                                       consumer
==========  ============================================  ===========
/metrics    ``registry.to_prometheus()`` text exposition  Prometheus
/healthz    200/503 + per-replica JSON (dead, or wedged:  liveness
            a stale mid-step heartbeat) and the process   probes
            self-telemetry block (RSS, uptime, threads)
/readyz     200/503: ready while at least one attached    load
            admission-capable replica is alive            balancers
/stats      ``bench_snapshot()`` + each source's          humans,
            ``stats()`` row                               dashboards
/trace      the chrome-trace export of the span ring      Perfetto
            (``?since=<cursor>`` reads incrementally)
/slo        per-source SLO state: objectives, attained/   SLO
            violated, attainment, goodput/s, burn rates   dashboards
/requests   per-source request timelines: the recent      latency
            ring and the N-worst end-to-end exemplars     debugging
/train      per-attached-train-loop state                 training
==========  ============================================  ===========

Start one alone (``start_observability_server(port=0)``; port 0 picks a
free port), or let ``Engine(observability_port=)`` or
``ResilientTrainLoop(observability_port=)`` own one. It binds
127.0.0.1 unless given another host. Health reads take no lock (the
engine's ``alive`` flag and heartbeat); ``/stats`` calls each engine's
``stats()``. Starting a server also starts the process-wide sampler
(`process_stats.ensure_process_sampler`).
"""
from __future__ import annotations

import http.server
import json
import os
import socket
import threading
import time
import urllib.parse
from dataclasses import asdict, is_dataclass

from . import tracing
from .process_stats import (
    ensure_process_sampler,
    read_process_stats,
    set_process_instance,
)
from .registry import get_registry
from .threads import guarded_target

#: Prometheus text exposition format 0.0.4
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: staleness bound applied to sources that define none of their own
#: (a bare Engine, a Cluster built without hang_threshold_s)
DEFAULT_HANG_THRESHOLD_S = 60.0

_PATHS = ("/metrics", "/healthz", "/readyz", "/stats", "/trace",
          "/slo", "/requests", "/train")


def _source_id(src) -> str:
    """One stable id per attached source (cluster/engine/loop id)."""
    cid = getattr(src, "cluster_id", None)
    if cid is not None:
        return cid
    lid = getattr(src, "loop_id", None)
    if lid is not None and hasattr(src, "train_snapshot"):
        return lid
    return getattr(src, "engine_id", "?")


def _is_train(src) -> bool:
    """Train-loop sources (duck-typed on ``train_snapshot``) feed only
    ``/train`` — they have no replicas, SLOs or request timelines, so
    the serving views skip them instead of mis-probing them."""
    return hasattr(src, "train_snapshot")


def _engine_health(engine, threshold_s, now) -> dict:
    if not engine.alive:
        return {"healthy": False, "state": "dead"}
    hb = engine.heartbeat()
    if hb is not None and threshold_s is not None \
            and now - hb > threshold_s:
        return {"healthy": False, "state": "wedged",
                "busy_s": round(now - hb, 3)}
    return {"healthy": True, "state": "serving"}


class _QuietHTTPServer(http.server.ThreadingHTTPServer):
    """A scraper disconnecting mid-response (probe timeout, Prometheus
    restart) is routine operation, not a stderr traceback: handler
    errors are COUNTED on the registry instead of printed. Real request
    bugs already surface as 500 payloads from the handler's own
    try/except."""

    def handle_error(self, request, client_address):
        get_registry().counter(
            "observability_server_request_errors_total",
            "endpoint requests that failed outside the handler's own "
            "500 path (mostly client disconnects mid-response)").inc()


class ObservabilityServer:
    """One process-wide scrape surface over the metrics registry plus
    any attached `Engine`/`Cluster` sources (duck-typed: a cluster is
    anything with an ``engines`` list)."""

    def __init__(self, port=0, host="127.0.0.1", registry=None,
                 instance=None):
        self._registry = registry or get_registry()
        self._sources: list = []
        self._lock = threading.Lock()
        self._httpd = _QuietHTTPServer(
            (host, int(port)), _make_handler(self))
        self._httpd.daemon_threads = True
        self.host = host
        #: the bound port (auto-picked when constructed with port=0)
        self.port = self._httpd.server_address[1]
        #: self-reported instance identity (r24): rides the ``/trace``
        #: payload next to the clock anchor so a federated merger can
        #: label bundles even before it names its targets
        self.instance = instance or f"{socket.gethostname()}:{os.getpid()}"
        self._explicit_instance = instance is not None
        self._thread = None
        self._stopped = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if self._thread is not None or self._stopped:
            return self
        # the process-wide self-telemetry sampler rides with the first
        # server (one daemon thread per process; idempotent). An
        # explicitly-named server names the process_* gauges too, so a
        # federator sees one identity per target everywhere (r24).
        if self._explicit_instance:
            set_process_instance(self.instance)
        ensure_process_sampler()
        self._thread = threading.Thread(
            target=guarded_target(f"observability-server[:{self.port}]",
                                  self._httpd.serve_forever),
            daemon=True, name="paddle_tpu_torch-observability-server")
        self._thread.start()
        return self

    def stop(self):
        """Idempotent shutdown: stops the accept loop and closes the
        socket; in-flight handler threads are daemons."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def attach(self, source):
        """Register an Engine or Cluster as a health/stats source
        (idempotent, chainable)."""
        with self._lock:
            if not any(s is source for s in self._sources):
                self._sources.append(source)
        return self

    def detach(self, source):
        with self._lock:
            self._sources = [s for s in self._sources if s is not source]
        return self

    def _iter_engines(self):
        """(engine, staleness_threshold_s) pairs across all sources."""
        with self._lock:
            sources = list(self._sources)
        for src in sources:
            if _is_train(src):
                continue
            if hasattr(src, "engines"):
                thr = getattr(src, "hang_threshold_s", None)
                for eng in list(src.engines):
                    yield eng, (thr if thr is not None
                                else DEFAULT_HANG_THRESHOLD_S)
            else:
                yield src, DEFAULT_HANG_THRESHOLD_S

    # -- payload builders (directly testable without HTTP) ---------------
    def render_metrics(self) -> str:
        return self._registry.to_prometheus()

    def health(self):
        """-> (healthy, payload). Lock-free over each replica's
        ``alive`` flag and watchdog heartbeat; the ``serving_replica_
        healthy`` gauge rides along as supporting evidence."""
        now = time.monotonic()
        replicas = {}
        for eng, thr in self._iter_engines():
            replicas[eng.engine_id] = _engine_health(eng, thr, now)
        gauge = self._registry.get("serving_replica_healthy")
        if gauge is not None:
            for labels, v in gauge.collect():
                rep = replicas.get(labels.get("engine"))
                if rep is not None:
                    rep["healthy_gauge"] = v
        healthy = all(r["healthy"] for r in replicas.values())
        return healthy, {"status": "ok" if healthy else "unhealthy",
                         "replicas": replicas,
                         # process self-telemetry rides the liveness
                         # probe: RSS/uptime/threads in every poll
                         "process": read_process_stats()}

    def readiness(self):
        """-> (ready, payload): ready while at least one attached
        admission-capable replica is alive (a source-less server —
        metrics scrape only — is vacuously ready)."""
        admission = []
        with self._lock:
            sources = list(self._sources)
        serving = [s for s in sources if not _is_train(s)]
        for src in serving:
            if hasattr(src, "prefill_engines"):
                admission += [e for e in list(src.prefill_engines)
                              if e.alive]
            elif getattr(src, "role", "both") != "decode" and src.alive:
                admission.append(src)
        # train-loop-only servers are vacuously ready, like source-less
        ready = bool(admission) or not serving
        return ready, {"status": "ready" if ready else "unready",
                       "admission_replicas": [e.engine_id
                                              for e in admission]}

    def stats_payload(self) -> dict:
        from . import bench_snapshot  # late: the package imports us

        sources = []
        with self._lock:
            srcs = list(self._sources)
        for src in srcs:
            if _is_train(src):
                continue  # the training view lives on /train
            row = src.stats()
            sources.append({
                "type": "cluster" if hasattr(src, "engines") else "engine",
                **(asdict(row) if is_dataclass(row) else dict(row))})
        return {"bench": bench_snapshot(), "sources": sources}

    def trace_payload(self, since=None) -> dict:
        """Chrome-trace export of the span ring. ``since`` (the
        ``?since=<cursor>`` query parameter) makes the read INCREMENTAL:
        only events appended after that cursor are shipped, ``cursor``
        is the value to pass next time, and ``missed`` counts events
        that rolled off the ring between the two scrapes (the same
        evictions ``trace_events_dropped_total`` counts globally — a
        federator alerts on its per-target share). The payload also
        carries this process's wall/monotonic `clock` anchor and
        self-reported `instance`, which is everything a merger needs to
        shift the bundle onto a shared timeline."""
        evs, cur, missed = tracing.events_since(since)
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "cursor": cur, "missed": missed,
                "clock": tracing.clock_anchor(),
                "instance": self.instance}

    def slo_payload(self) -> dict:
        """Per-source SLO state (r18): objectives, attained/violated
        totals, attainment, goodput/s, multi-window burn rates — plus
        per-replica sub-rows for clusters (the burn the router steers
        by). A source without a configured SLO reports
        ``{"configured": false}`` so the endpoint always parses."""
        rows = []
        with self._lock:
            srcs = list(self._sources)
        for src in srcs:
            if _is_train(src):
                continue
            tracker = getattr(src, "slo", None)
            row = {"id": _source_id(src),
                   "type": "cluster" if hasattr(src, "engines")
                   else "engine"}
            row.update(tracker.snapshot() if tracker is not None
                       else {"configured": False})
            if hasattr(src, "engines"):
                row["replicas"] = {
                    e.engine_id: (e.slo.snapshot() if e.slo is not None
                                  else {"configured": False})
                    for e in list(src.engines)}
            rows.append(row)
        return {"sources": rows}

    def requests_payload(self) -> dict:
        """Per-source request timelines (r18): the recent terminal
        ring + the N-worst end-to-end exemplars, each a complete phase
        record (`serving.timeline.Timeline.as_dict`)."""
        rows = []
        with self._lock:
            srcs = list(self._sources)
        for src in srcs:
            ring = getattr(src, "timelines", None)
            if ring is None or _is_train(src):
                continue
            rows.append({"id": _source_id(src),
                         "type": "cluster" if hasattr(src, "engines")
                         else "engine", **ring.snapshot()})
        return {"sources": rows}

    def train_payload(self) -> dict:
        """Per-attached-train-loop state (r19): one
        `ResilientTrainLoop.train_snapshot` row per train source —
        position/resume/rollback state, the anomaly history with
        per-layer attribution, the data-stall split, the wrapped
        step's MFU/trace counters, the introspection ring and the
        measured pipeline bubble fraction. A server with no train
        sources serves ``{"sources": []}`` so the endpoint always
        parses."""
        rows = []
        with self._lock:
            srcs = list(self._sources)
        for src in srcs:
            if not _is_train(src):
                continue
            rows.append({"id": _source_id(src), "type": "train_loop",
                         **src.train_snapshot()})
        return {"sources": rows}


def _make_handler(server: ObservabilityServer):
    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):  # scrapes must not spam stderr
            pass

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path
            query = urllib.parse.parse_qs(parsed.query)
            if path != "/" and path.endswith("/"):
                path = path.rstrip("/")
            try:
                if path == "/metrics":
                    code, ctype = 200, PROMETHEUS_CONTENT_TYPE
                    body = server.render_metrics().encode()
                elif path == "/healthz":
                    ok, payload = server.health()
                    code, ctype = (200 if ok else 503), "application/json"
                    body = json.dumps(payload).encode()
                elif path == "/readyz":
                    ok, payload = server.readiness()
                    code, ctype = (200 if ok else 503), "application/json"
                    body = json.dumps(payload).encode()
                elif path == "/stats":
                    code, ctype = 200, "application/json"
                    body = json.dumps(server.stats_payload(),
                                      default=repr).encode()
                elif path == "/trace":
                    since = None
                    raw = query.get("since", [None])[-1]
                    if raw is not None:
                        try:
                            since = int(raw)
                        except ValueError:
                            self._reply(400, "application/json", json.dumps(
                                {"error": f"since={raw!r} is not an "
                                          "integer cursor"}).encode())
                            return
                    code, ctype = 200, "application/json"
                    body = json.dumps(server.trace_payload(since=since),
                                      default=repr).encode()
                elif path == "/slo":
                    code, ctype = 200, "application/json"
                    body = json.dumps(server.slo_payload(),
                                      default=repr).encode()
                elif path == "/requests":
                    code, ctype = 200, "application/json"
                    body = json.dumps(server.requests_payload(),
                                      default=repr).encode()
                elif path == "/train":
                    code, ctype = 200, "application/json"
                    body = json.dumps(server.train_payload(),
                                      default=repr).encode()
                else:
                    code, ctype = 404, "application/json"
                    body = json.dumps({"error": f"unknown path {path!r}",
                                       "paths": list(_PATHS)}).encode()
            except Exception as exc:  # noqa: BLE001 - a scrape failure is
                # a 500 payload, never a silent dropped connection
                code, ctype = 500, "application/json"
                body = json.dumps({"error": repr(exc)}).encode()
            self._reply(code, ctype, body)

        def _reply(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def start_observability_server(port=0, host="127.0.0.1", registry=None,
                               sources=(),
                               instance=None) -> ObservabilityServer:
    """Build and START an `ObservabilityServer`; ``port=0`` auto-picks.
    Engines/clusters in ``sources`` (or attached later) feed the
    health/readiness/stats views; ``instance`` names this process in
    federated views (default ``host:pid``)."""
    srv = ObservabilityServer(port=port, host=host, registry=registry,
                              instance=instance)
    for s in sources:
        srv.attach(s)
    return srv.start()


__all__ = ["ObservabilityServer", "start_observability_server",
           "PROMETHEUS_CONTENT_TYPE", "DEFAULT_HANG_THRESHOLD_S"]
