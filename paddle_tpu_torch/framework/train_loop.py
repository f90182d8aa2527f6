"""The fault-tolerant training plane: `ResilientTrainLoop`.

Counterpart: ``paddle_tpu/framework/train_loop.py``. The contract:

    a training run killed at any step, or poisoned by any single
    injected fault, resumes to the uninterrupted run's loss trajectory
    (bit for bit on the CPU; on a card within the rounding noise of the
    backward's float atomics).

Four pillars, each testable through
`framework.train_faults.TrainFaultInjector`:

1. **Async snapshot checkpointing** — at each interval boundary the
   loop copies params and opt_state to the host
   (`SpmdTrainStep.host_state`, a blocking copy into pinned memory) and
   a `framework.checkpoint.CheckpointManager` commits the files on a
   background thread: the train step does not wait for the disk.
   Memory cost: one host copy of params and slots.
2. **Deterministic resume** — the checkpoint captures the FULL loop
   state: step counter, the seed that keys every step
   (``core.random.fold_in(seed, step)``), the data cursor and the
   skipped-window set, and the GradScaler's scale and skip counters
   (which live inside ``opt_state`` and are saved bit for bit). A fresh
   loop over the same directory restarts mid-epoch with no replayed or
   skipped batches: the data contract is a STEP-INDEXED source
   (``data(i) -> batch`` or ``data.batch_at(i)``), deterministic per
   index. A restore copies into the live tensors, so a step captured as
   a CUDA graph replays on; resuming in-process adds no build.
3. **Anomaly detection + rollback** — a non-finite loss, or a loss
   above ``spike_factor`` x the EWMA after warmup, rolls the loop back
   to the last good checkpoint and skips the poisoned data window;
   a typed `TrainAnomalyError` fires when the rollback budget is
   exhausted (bounded termination, never silent divergence). With the
   step's ``introspect=True`` the detector names the suspect layer from
   the step's per-layer telemetry row.
4. **Preemption handling** — SIGTERM (opt-in ``handle_sigterm=True``)
   or `request_preemption()` commits an emergency snapshot at the next
   step boundary and returns with ``result.preempted=True``.

The loop blocks on the loss each step (one scalar read from the
device): that is the anomaly detector's price. Its wall time splits into
two clocks: waiting on the next batch (``train_data_wait_seconds``,
``train_data_stall_fraction``) and everything else (dispatch, detector
sync, snapshot: ``TrainRunResult.step_seconds``); the two sum to the
iteration's wall time.

Metrics (the reference's names): ``train_checkpoint_write_seconds``,
``train_checkpoints_committed/discarded_total``,
``train_anomaly_total{kind}``, ``train_resumes_total``,
``train_rollbacks_total``, ``train_last_committed_step``.
``flight_recorder=`` (True, or an `observability.FlightRecorder`)
dumps one postmortem (`FlightRecorder.dump_train_death`) when the loop
dies (an injected crash, the anomaly budget spent, a step error) and
re-raises; a run that ends normally writes none. ``observability_port=``
starts an `observability.ObservabilityServer` on 127.0.0.1 with the
loop attached as a ``/train`` source (`train_snapshot`; port 0 picks a
free port); ``loop.observability.stop()`` stops it.
"""
from __future__ import annotations

import itertools
import math
import signal
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..core import random as _random
from ..observability import get_registry
from ..observability import tracing as _tracing
from ..observability import train_introspection as _introspect
from .checkpoint import CheckpointManager
from .train_faults import TrainFaultInjector  # noqa: F401 (re-export)

LOOP_STATE_SCHEMA = "paddle_tpu_torch.train_loop_state/v1"


class TrainAnomalyError(RuntimeError):
    """The loop's rollback budget is exhausted (or it has no checkpoint
    to roll back to): training cannot make progress without silent
    divergence, so it terminates typed."""


#: the train_* metric family, table-driven
_TRAIN_METRICS = (
    ("write_seconds", "histogram", "train_checkpoint_write_seconds",
     "checkpoint commit latency (device-to-host copy excluded: host "
     "snapshot to directory swap on the commit thread)", ("loop",)),
    ("committed", "counter", "train_checkpoints_committed_total",
     "checkpoints atomically committed", ("loop",)),
    ("discarded", "counter", "train_checkpoints_discarded_total",
     "checkpoints discarded: torn/failed commits and integrity-rejected "
     "restore candidates", ("loop",)),
    ("anomaly", "counter", "train_anomaly_total",
     "training anomalies detected, by kind (non_finite | loss_spike)",
     ("loop", "kind")),
    ("resumes", "counter", "train_resumes_total",
     "loop constructions that restored from a committed checkpoint",
     ("loop",)),
    ("rollbacks", "counter", "train_rollbacks_total",
     "anomaly rollbacks to the last good checkpoint", ("loop",)),
    ("last_committed", "gauge", "train_last_committed_step",
     "step index of the newest committed checkpoint", ("loop",)),
)


def register_train_metrics(registry=None) -> dict:
    """Instantiate the ``train_*`` resilience metric family on
    ``registry`` (default: the process registry); returns handle ->
    metric. Idempotent — the registry dedupes by name."""
    r = registry or get_registry()
    out = {}
    for handle, kind, name, help_, labels in _TRAIN_METRICS:
        out[handle] = getattr(r, kind)(name, help_, labelnames=labels)
    return out


@dataclass
class TrainRunResult:
    """What one `ResilientTrainLoop.run` call did.

    ``step_seconds`` is the NON-data half of each iteration (step
    dispatch + detector sync + snapshot dispatch — a synchronous
    commit's stall lands here, an async one's doesn't);
    ``data_wait_seconds`` is the batch-fetch half. The two sum to the
    iteration's wall time."""
    losses_by_step: dict = field(default_factory=dict)
    steps_run: int = 0
    resumed_from: int | None = None   # checkpoint step the LOOP restored
    preempted: bool = False
    rollbacks: int = 0
    anomalies: int = 0
    last_committed_step: int | None = None
    step_seconds: list = field(default_factory=list)
    data_wait_seconds: list = field(default_factory=list)

    @property
    def losses(self) -> list:
        return [self.losses_by_step[s] for s in sorted(self.losses_by_step)]


_loop_uids = itertools.count()


class ResilientTrainLoop:
    """Step-granular, checkpointed, anomaly-guarded wrapper around an
    `SpmdTrainStep`.

    ``data``: a step-indexed batch source — ``data(i)`` or
    ``data.batch_at(i)`` must return the SAME batch for the same index
    in every process (that determinism is what makes mid-epoch resume
    replay- and skip-free). ``params``/``opt_state`` default to
    ``step.init(**init_kwargs)``; construction then restores the newest
    VALID checkpoint in ``directory`` (skipping torn/corrupt ones) into
    them and, when none exists, commits a step-0 snapshot so anomaly
    rollback always has a target.
    """

    def __init__(self, step, data, params=None, opt_state=None, *,
                 directory, seed=0, checkpoint_interval=10, keep=3,
                 async_checkpoint=True, spike_factor=10.0, spike_warmup=5,
                 ewma_alpha=0.1, max_rollbacks=2, skip_window=1,
                 init_kwargs=None, fault_injector=None, flight_recorder=None,
                 handle_sigterm=False, loop_id=None,
                 observability_port=None):
        self.step = step
        self._data = data
        self.loop_id = loop_id or f"train{next(_loop_uids)}"
        self.directory = directory
        self.checkpoint_interval = int(checkpoint_interval)
        self._injector = fault_injector
        self._spike_factor = float(spike_factor)
        self._spike_warmup = int(spike_warmup)
        self._alpha = float(ewma_alpha)
        self._max_rollbacks = int(max_rollbacks)
        self._skip_window = int(skip_window)
        self._m = register_train_metrics()
        self._im = _introspect.register_introspection_metrics()
        # the loop's two wall-time clocks (data wait vs dispatch) and the
        # per-layer grad-norm baseline attribution compares against
        self._data_wait_total = 0.0
        self._dispatch_total = 0.0
        # guards the containers the loop thread mutates and other
        # threads read (skipped set, anomaly history)
        self._state_lock = threading.Lock()
        self._layer_stats = _introspect.LayerGradStats()
        #: recent anomaly/rollback records (step, kind, loss, suspect
        #: layer, action)
        self.anomaly_history: deque = deque(maxlen=32)
        self.last_anomaly: dict | None = None
        self._running = False
        self._preempt = threading.Event()
        # handler installed around run() only (and restored after), so a
        # finished loop never swallows the process's SIGTERM
        self._handle_sigterm = bool(handle_sigterm)

        self._own_flight = flight_recorder is True
        if self._own_flight:
            from ..observability.flight_recorder import FlightRecorder
            flight_recorder = FlightRecorder()
        self._flight = flight_recorder or None

        if params is None:
            params, opt_state = step.init(**(init_kwargs or {}))
        self.params, self.opt_state = params, opt_state

        # loop state (what a checkpoint captures beyond the arrays)
        self._seed = int(seed)
        self._step_idx = 0        # completed optimizer steps
        self._data_cursor = 0     # next data index to consume
        self._skipped: set = set()
        self._ewma = None
        self._ewma_n = 0
        self._rollbacks = 0
        self.resumed_from: int | None = None
        #: host seconds of the last restore (read, checks, copy in)
        self.restore_seconds: float | None = None

        self._manager = None
        if self.checkpoint_interval > 0:
            self._manager = CheckpointManager(
                directory, keep=keep, async_commit=async_checkpoint,
                fault_injector=fault_injector, loop_id=self.loop_id)
            t0 = time.perf_counter()
            restored = self._manager.restore_latest(
                template=self._template())
            if restored is not None:
                ck_step, arrays, ls = restored
                self.params, self.opt_state = step.load_host_state(
                    arrays, self.params, self.opt_state)
                self._load_loop_state(ls)
                self.resumed_from = ck_step
                self.restore_seconds = time.perf_counter() - t0
                self._m["resumes"].inc(loop=self.loop_id)
            else:
                # step-0 snapshot, committed synchronously: rollback and
                # crash-at-step-0 recovery always have a target
                self._snapshot(block=True)

        #: the loop's scrape surface (``observability_port=``): it serves
        #: `train_snapshot` on ``/train``
        self.observability = None
        if observability_port is not None:
            from ..observability.server import start_observability_server
            self.observability = start_observability_server(
                port=observability_port, sources=(self,))

    # -- state plumbing --------------------------------------------------
    def _on_sigterm(self, signum, frame):
        self._preempt.set()

    def request_preemption(self):
        """Preemption notice (what a SIGTERM handler calls): the loop
        commits an emergency snapshot at the next step boundary and
        returns with ``preempted=True``."""
        self._preempt.set()

    def _template(self) -> dict:
        """Flat name -> live tensor (its shape and dtype, no copy) —
        what checkpoint validation matches leaf specs against."""
        return dict(self.step.state_items(self.params, self.opt_state))

    def _loop_state(self) -> dict:
        ls = {"schema": LOOP_STATE_SCHEMA, "loop_id": self.loop_id,
              "step": self._step_idx, "data_cursor": self._data_cursor,
              "seed": self._seed, "skipped": sorted(self._skipped),
              "ewma": self._ewma, "ewma_n": self._ewma_n,
              "rollbacks": self._rollbacks, "wall_time": time.time()}
        if isinstance(self.opt_state, dict) and "scaler" in self.opt_state:
            # the observability view of the GradScaler state (the
            # tensors themselves are checkpointed inside opt_state)
            ms = self.step.metrics_snapshot(self.opt_state)
            ls["loss_scale"] = ms.get("loss_scale")
            ls["found_inf_skips"] = ms.get("found_inf_skips")
        return ls

    def _load_loop_state(self, ls):
        self._step_idx = int(ls["step"])
        self._data_cursor = int(ls["data_cursor"])
        self._seed = int(ls.get("seed", self._seed))
        self._skipped = set(int(i) for i in ls.get("skipped", ()))
        self._ewma = ls.get("ewma")
        self._ewma_n = int(ls.get("ewma_n", 0))
        self._rollbacks = int(ls.get("rollbacks", 0))

    def _snapshot(self, block=False):
        flat = self.step.host_state(self.params, self.opt_state)
        self._manager.save(self._step_idx, flat, self._loop_state(),
                           block=block)

    def _batch_at(self, i):
        getter = getattr(self._data, "batch_at", None)
        return getter(i) if getter is not None else self._data(i)

    def _advance_cursor(self, c):
        c += 1
        while c in self._skipped:
            c += 1
        return c

    @property
    def last_committed_step(self):
        return (self._manager.last_committed_step()
                if self._manager is not None else None)

    def step_key(self, step_idx) -> int:
        """The key step ``step_idx`` runs with (`core.random.fold_in`)."""
        return _random.fold_in(self._seed, step_idx)

    # -- the loop --------------------------------------------------------
    def run(self, num_steps) -> TrainRunResult:
        """Train until ``num_steps`` TOTAL optimizer steps completed
        (absolute — a resumed loop runs only the remainder). Raises the
        fault that killed it (`InjectedCrash`, `TrainAnomalyError`,
        any step error), after the flight recorder's postmortem."""
        res = TrainRunResult(resumed_from=self.resumed_from)
        prev_sigterm = None
        if self._handle_sigterm:
            try:
                prev_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                pass  # not the main thread: request_preemption() still works
        if self._flight is not None:
            self._flight.attach()
        self._running = True
        try:
            self._run(int(num_steps), res)
        except Exception as e:
            if self._flight is not None:
                self._flight.dump_train_death(self, e)
            raise
        finally:
            self._running = False
            res.rollbacks = self._rollbacks
            res.last_committed_step = self.last_committed_step
            if prev_sigterm is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_sigterm)
                except (ValueError, TypeError):
                    pass  # best-effort handler restore; the run is over
            if self._flight is not None and self._own_flight:
                # a recorder this loop built leaves the tracing sinks; a
                # shared one stays attached for its owner
                self._flight.detach()
        return res

    def _run(self, num_steps, res):
        inj = self._injector
        while self._step_idx < num_steps:
            if self._preempt.is_set():
                if self._manager is not None:
                    self._snapshot(block=True)  # the emergency snapshot
                res.preempted = True
                # the notice is sticky until honored, then cleared — a
                # later run() on the same loop trains again
                self._preempt.clear()
                return
            if inj is not None:
                inj.on_step_start(self._step_idx)  # may raise InjectedCrash
                self._maybe_poison_param(inj)
            # the iteration's wall time is exactly data_wait (batch
            # fetch) + step_seconds (dispatch + detector sync + the
            # snapshot dispatch below)
            t_iter = time.perf_counter()
            with _tracing.span("train.data_wait", stage="data_wait",
                               loop=self.loop_id):
                while self._data_cursor in self._skipped:
                    self._data_cursor += 1
                cursor = self._data_cursor
                batch = self._batch_at(cursor)
            t_fetch = time.perf_counter()
            if getattr(self.step, "introspect", False):
                # ring rows carry the LOOP's step index, so a
                # postmortem's telemetry cross-references its anomaly
                # records across resumes and rollbacks
                self.step.introspect_step_hint = self._step_idx
            loss, self.params, self.opt_state = self.step(
                self.params, self.opt_state, batch,
                self.step_key(self._step_idx))
            loss_f = float(loss)  # host sync: the detector's input
            if inj is not None and inj.poison_loss(self._step_idx):
                loss_f = float("nan")
            # the step's folded per-layer telemetry row (None unless
            # the wrapped step runs introspect=True)
            row = (self.step.last_telemetry_row
                   if getattr(self.step, "introspect", False) else None)
            kind = self._classify(loss_f)
            if kind is not None:
                res.anomalies += 1
                self._m["anomaly"].inc(loop=self.loop_id, kind=kind)
                # judge the anomalous row against the HEALTHY history
                # (it is never fed into _layer_stats)
                attribution = _introspect.attribute_anomaly(
                    row, self._layer_stats)
                rec = {"step": self._step_idx, "kind": kind,
                       "loss": loss_f, "wall_time": time.time(),
                       "layer": attribution.get("layer"),
                       "attribution": attribution, "action": "rollback"}
                self.last_anomaly = rec
                with self._state_lock:
                    self.anomaly_history.append(rec)
                self._rollback(kind, loss_f, cursor, attribution)
                self._account_clocks(res, t_iter, t_fetch)
                continue
            if row is not None:
                self._layer_stats.update(row)
            self._ewma = (loss_f if self._ewma is None
                          else self._alpha * loss_f
                          + (1 - self._alpha) * self._ewma)
            self._ewma_n += 1
            res.losses_by_step[self._step_idx] = loss_f
            res.steps_run += 1
            self._step_idx += 1
            self._data_cursor = self._advance_cursor(cursor)
            if (self._manager is not None
                    and self._step_idx % self.checkpoint_interval == 0):
                with _tracing.span("train.snapshot", stage="snapshot",
                                   loop=self.loop_id):
                    self._snapshot()
            self._account_clocks(res, t_iter, t_fetch)
        if self._manager is not None:
            # final state is always committed (async ones are awaited)
            self._manager.wait()
            if self.last_committed_step != self._step_idx:
                self._snapshot(block=True)

    def _account_clocks(self, res, t_iter, t_fetch):
        """Close one iteration's two clocks (see `_run`): data wait +
        dispatch sum to the iteration's wall time by construction."""
        now = time.perf_counter()
        dw, disp = t_fetch - t_iter, now - t_fetch
        res.data_wait_seconds.append(dw)
        res.step_seconds.append(disp)
        self._data_wait_total += dw
        self._dispatch_total += disp
        self._im["data_wait"].observe(dw, loop=self.loop_id)
        self._im["data_stall_fraction"].set(self.data_stall_fraction,
                                            loop=self.loop_id)

    @property
    def data_stall_fraction(self) -> float:
        """Cumulative fraction of loop wall time spent waiting on the
        next batch — >0.3 says the input pipeline, not the step, is
        the thing to optimize."""
        total = self._data_wait_total + self._dispatch_total
        return (self._data_wait_total / total) if total > 0 else 0.0

    def _maybe_poison_param(self, inj):
        """`nan_param_at_step` injection: fill one layer's parameter
        with NaN, in place, before the dispatch (default target: the
        LAST float parameter — deterministic, and downstream-most so
        backprop poisons every layer's grads while only the source
        layer's param-norm telemetry goes non-finite)."""
        default = None
        for n in reversed(list(self.params)):
            if self.params[n].is_floating_point():
                default = n
                break
        name = inj.poison_param(self._step_idx, default=default)
        if name is None:
            return
        if name not in self.params:
            raise ValueError(
                f"nan_param_at_step names unknown parameter {name!r}; "
                f"have {sorted(self.params)}")
        self.params[name].fill_(float("nan"))

    def _classify(self, loss_f):
        if not math.isfinite(loss_f):
            return "non_finite"
        if (self._ewma is not None and self._ewma_n >= self._spike_warmup
                and loss_f > self._spike_factor * abs(self._ewma) + 1e-6):
            return "loss_spike"
        return None

    def _rollback(self, kind, loss_f, cursor, attribution=None):
        """Roll back to the last good checkpoint and skip the poisoned
        data window; typed `TrainAnomalyError` when the budget is out.
        ``attribution`` (from `attribute_anomaly` over the step's
        per-layer telemetry) names the suspect layer in every message
        and in the recorded anomaly history."""
        suspect = ""
        if attribution is not None and attribution.get("layer"):
            suspect = (f" — suspect layer: {attribution['layer']} "
                       f"({attribution['reason']}: "
                       f"{attribution['detail']})")

        def _fatal(msg):
            if self.last_anomaly is not None:
                self.last_anomaly["action"] = "fatal"
            _tracing.instant("train.anomaly", stage="rollback",
                             loop=self.loop_id, kind=kind, fatal=True)
            return TrainAnomalyError(msg + suspect)

        if self._manager is None:
            raise _fatal(
                f"{kind} loss {loss_f} at step {self._step_idx} and "
                "checkpointing is disabled — nothing to roll back to")
        if self._rollbacks >= self._max_rollbacks:
            raise _fatal(
                f"{kind} loss {loss_f} at step {self._step_idx}: rollback "
                f"budget ({self._max_rollbacks}) exhausted")
        t0 = time.perf_counter()
        restored = self._manager.restore_latest(template=self._template())
        if restored is None:
            raise _fatal(
                f"{kind} loss {loss_f} at step {self._step_idx} and no "
                "valid checkpoint to roll back to")
        _tracing.instant("train.rollback", stage="rollback",
                         loop=self.loop_id, kind=kind)
        ck_step, arrays, ls = restored
        prior = self._rollbacks
        self.params, self.opt_state = self.step.load_host_state(
            arrays, self.params, self.opt_state)
        self.restore_seconds = time.perf_counter() - t0
        self._load_loop_state(ls)
        # rollback bookkeeping survives the state rewind (the restored
        # loop_state predates this rollback): the budget is monotone
        # within a process, or a recurring anomaly could loop forever
        self._rollbacks = max(prior, self._rollbacks) + 1
        self._m["rollbacks"].inc(loop=self.loop_id)
        with self._state_lock:
            self._skipped.update(range(cursor, cursor + self._skip_window))

    # -- the /train view -------------------------------------------------
    def train_snapshot(self) -> dict:
        """The loop in one JSON-able dict — the reference's ``/train``
        payload: position and resume/rollback state, the anomaly history
        with per-layer attribution, the data-stall split, the wrapped
        step's metrics view, the introspection ring, and the measured
        pipeline bubble fraction when one has been recorded. Safe to
        call from another thread mid-run: the mutable containers are
        copied under the loop's state lock (skipped set, anomaly
        history) or with bounded retry (the telemetry ring); no device
        sync."""
        with self._state_lock:
            skipped = sorted(self._skipped)
            history = [dict(r) for r in self.anomaly_history]
        out = {
            "schema": "paddle_tpu_torch.train_snapshot/v1",
            "loop_id": self.loop_id,
            "running": self._running,
            "step": self._step_idx,
            "data_cursor": self._data_cursor,
            "skipped_data_indices": skipped,
            "resumed_from": self.resumed_from,
            "rollbacks": self._rollbacks,
            "last_committed_step": self.last_committed_step,
            "ewma_loss": self._ewma,
            "preempt_requested": self._preempt.is_set(),
            "anomaly_history": history,
            "data_stall_fraction": self.data_stall_fraction,
            "data_wait_seconds_total": self._data_wait_total,
            "dispatch_seconds_total": self._dispatch_total,
        }
        ms = getattr(self.step, "metrics_snapshot", None)
        if ms is not None:
            out["train_step"] = ms()
        ring = getattr(self.step, "telemetry_ring", None)
        out["introspection"] = {
            "enabled": bool(getattr(self.step, "introspect", False)),
            "last": getattr(self.step, "last_telemetry_row", None),
            "ring": ring.rows() if ring is not None else [],
        }
        # one stage="all" child per schedule; report the one matching
        # this loop's step when it names one
        bubble = None
        sched = getattr(self.step, "schedule", None)
        for labels, v in get_registry().collect(
                "train_pipeline_bubble_fraction"):
            if labels.get("stage") != "all":
                continue
            if sched is not None and \
                    (labels.get("schedule") or "gpipe_wave") != sched:
                continue
            bubble = v
        out["pipeline_bubble_fraction"] = bubble
        return out


__all__ = ["ResilientTrainLoop", "TrainRunResult", "TrainAnomalyError",
           "register_train_metrics", "LOOP_STATE_SCHEMA"]
