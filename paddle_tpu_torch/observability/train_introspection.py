"""Training introspection: in-step per-layer gradient telemetry, anomaly
attribution, pipeline bubble accounting, data-stall attribution.

Counterpart: ``paddle_tpu/observability/train_introspection.py``. Its
host-side parts are copied (they import nothing of JAX); `grad_telemetry`
is rewritten over torch tensors. The pieces:

- **Per-layer reductions inside the step** (`grad_telemetry`):
  per-layer grad-norm², param-norm², squared update magnitude (for the
  ‖Δw‖/‖w‖ update ratio) and a non-finite element count, plus the
  global grad-norm² — fixed-shape scalars computed where the gradients
  already live. `SpmdTrainStep(introspect=True)` runs them inside its
  one CUDA graph and hands them out as extra static outputs, so the
  step stays one build a batch signature under the armed sentinel, and
  the loss is bit for bit the ``introspect=False`` loss (the reductions
  read the grads, they never feed back into the update).
- **Host fold** (`fold_telemetry` + `TelemetryRing`): the device
  scalars become ``train_layer_grad_norm{layer}`` /
  ``train_update_ratio{layer}`` gauges and a bounded ring of the
  last-K per-step rows — the record a postmortem embeds.
- **Anomaly attribution** (`LayerGradStats` + `attribute_anomaly`):
  given the step's telemetry row, name the first layer whose params or
  grads went non-finite, or whose grad-norm z-score tripped — what
  turns "loss is NaN, rolling back" into "layer gpt.h.7 blew up,
  rolling back".
- **Pipeline bubble accounting** (`pipeline_accounting`): fold measured
  per-(stage, microbatch) durations into a schedule's timeline —
  per-stage busy/idle and the measured
  ``train_pipeline_bubble_fraction``. Pure arithmetic; the port's
  pipeline schedules are ROADMAP A12.

Training trace spans carry a ``stage=`` vocabulary mirroring the
serving timeline's: the ``PHASE_*`` constants below keep the
reference's literal values.
"""
from __future__ import annotations

import math
import re
import time
from collections import deque

from .registry import get_registry

# -- the training span-phase vocabulary -----------------------------------
PHASE_DATA_WAIT = "data_wait"
PHASE_DISPATCH = "dispatch"
PHASE_SNAPSHOT = "snapshot"
PHASE_ROLLBACK = "rollback"
TRAIN_PHASES = (PHASE_DATA_WAIT, PHASE_DISPATCH, PHASE_SNAPSHOT,
                PHASE_ROLLBACK)


# ---------------------------------------------------------------------------
# layer grouping
# ---------------------------------------------------------------------------

_NUMBERED = re.compile(r"^(.*?\.\d+)(\.|$)")


def layer_key(name: str) -> str:
    """Parameter name -> layer key. Names with a numeric component
    (``gpt.h.7.attn.qkv_proj.weight``) group under the prefix through
    the first index (``gpt.h.7`` — one key per transformer block);
    others drop the trailing leaf and keep at most two components
    (``gpt.embeddings.word_embeddings.weight`` -> ``gpt.embeddings``,
    ``fc1.weight`` -> ``fc1``, a bare ``emb`` stays ``emb``)."""
    m = _NUMBERED.match(name)
    if m:
        return m.group(1)
    parts = name.split(".")
    if len(parts) == 1:
        return name
    return ".".join(parts[:-1][:2])


def group_layers(names) -> dict:
    """Ordered layer-key -> [parameter names] over ``names`` (model
    traversal order, so "first layer" in attribution means first in
    definition order)."""
    groups: dict = {}
    for n in names:
        groups.setdefault(layer_key(n), []).append(n)
    return groups


# ---------------------------------------------------------------------------
# in-step reductions (pure; traced into the compiled train step)
# ---------------------------------------------------------------------------

def grad_telemetry(groups: dict, params: dict, grads: dict,
                   new_params: dict) -> dict:
    """The per-layer scalar reductions, computed INSIDE the step (fixed
    shapes — one float32 or int64 scalar per layer and quantity — so a
    captured step's outputs never change shape). Float leaves only; the
    reduction reads params/grads/new_params and feeds nothing back,
    which is what keeps the loss bit for bit the introspect-off loss.
    ``params`` are the values before the update, ``new_params`` after it
    (a step that updates in place passes a copy as ``params``; a float32
    copy costs no cast here).

    The sums of squares are the squares of float32 norms, taken over all
    tensors at once (``torch._foreach_norm``: a few launches, not a few
    per tensor), within a few float32 ulps of the reference's sums; the
    update is the float32 difference of the two params, exact for bf16
    and f16 values.

    Returns ``{"layers": {layer: {"grad_sq", "param_sq", "update_sq",
    "nonfinite"}}, "grad_sq_global"}`` as 0-d tensors — norms and ratios
    are taken on the host at fold time (`fold_telemetry`)."""
    import torch

    def _is_float(v):
        return isinstance(v, torch.Tensor) and v.is_floating_point()

    def sq(tensors):
        norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
        return torch._foreach_mul(norms, norms) if norms else []

    names = [n for ns in groups.values() for n in ns
             if _is_float(grads.get(n))]
    with_p = [n for n in names if _is_float(params.get(n))]
    with_new = [n for n in with_p if new_params.get(n) is not None]
    g_sq = dict(zip(names, sq([grads[n] for n in names])))
    p_sq = dict(zip(with_p, sq([params[n] for n in with_p])))
    u_sq = dict(zip(with_new, sq(torch._foreach_sub(
        [new_params[n].float() for n in with_new],
        [params[n].float() for n in with_new])) if with_new else []))
    anchor = next(iter(grads.values()))
    zero_f = anchor.new_zeros((), dtype=torch.float32)
    zero_i = anchor.new_zeros((), dtype=torch.int64)

    def total(parts, zero):
        return torch.stack(parts).sum() if parts else zero

    out = {"layers": {}}
    glob = zero_f
    for layer, ns in groups.items():
        ns = [n for n in ns if n in g_sq]
        gsq = total([g_sq[n] for n in ns], zero_f)
        out["layers"][layer] = {
            "grad_sq": gsq,
            "param_sq": total([p_sq[n] for n in ns if n in p_sq], zero_f),
            "update_sq": total([u_sq[n] for n in ns if n in u_sq], zero_f),
            "nonfinite": total([(~torch.isfinite(grads[n])).sum()
                                for n in ns], zero_i)}
        glob = glob + gsq
    out["grad_sq_global"] = glob
    return out


# ---------------------------------------------------------------------------
# metric family (table-driven like the train_* family)
# ---------------------------------------------------------------------------

#: the introspection family, with the reference's names and labels
_INTROSPECTION_METRICS = (
    ("layer_grad_norm", "gauge", "train_layer_grad_norm",
     "per-layer gradient L2 norm of the last introspected step",
     ("executable", "layer")),
    ("layer_param_norm", "gauge", "train_layer_param_norm",
     "per-layer parameter L2 norm of the last introspected step",
     ("executable", "layer")),
    ("update_ratio", "gauge", "train_update_ratio",
     "per-layer update ratio ||delta_w|| / ||w|| of the last "
     "introspected step (the learning-rate sanity dial)",
     ("executable", "layer")),
    ("layer_nonfinite", "gauge", "train_layer_nonfinite_grads",
     "per-layer count of non-finite gradient elements in the last "
     "introspected step (0 on a healthy step)",
     ("executable", "layer")),
    ("global_grad_norm", "gauge", "train_global_grad_norm",
     "global gradient L2 norm of the last introspected step",
     ("executable",)),
    ("data_wait", "histogram", "train_data_wait_seconds",
     "per-step wall time spent waiting on the next batch (the data "
     "half of the loop's dispatch-vs-data clock split)", ("loop",)),
    ("data_stall_fraction", "gauge", "train_data_stall_fraction",
     "cumulative fraction of loop wall time spent waiting on data "
     "(data_wait / (data_wait + dispatch))", ("loop",)),
    ("pipeline_stage", "histogram", "train_pipeline_stage_seconds",
     "measured per-unit compute time of one pipeline stage (fwd wave "
     "marks for gpipe_wave, fwd+bwd unit marks for the 1f1b family; "
     "profile_schedule produces them)", ("stage", "schedule")),
    ("pipeline_bubble", "gauge", "train_pipeline_bubble_fraction",
     "measured pipeline bubble fraction (idle / wall per stage over "
     "one schedule pass; stage='all' is the whole-pipeline number)",
     ("stage", "schedule")),
)


def register_introspection_metrics(registry=None) -> dict:
    """Instantiate the ``train_layer_*`` / ``train_pipeline_*`` /
    ``train_data_*`` introspection family on ``registry`` (default:
    the process registry); returns handle -> metric. Idempotent."""
    r = registry or get_registry()
    out = {}
    for handle, kind, name, help_, labels in _INTROSPECTION_METRICS:
        out[handle] = getattr(r, kind)(name, help_, labelnames=labels)
    return out


# ---------------------------------------------------------------------------
# host fold + bounded ring
# ---------------------------------------------------------------------------

def fold_telemetry(host_telem: dict, step: int) -> dict:
    """One device telemetry pytree (already on host) -> one per-step
    row: norms from the squared sums, the ‖Δw‖/‖w‖ update ratio, the
    non-finite counts. ``step`` is the caller's step index (the
    `ResilientTrainLoop` passes its own counter so ring rows
    cross-reference anomaly records across resumes/rollbacks; a bare
    step falls back to its call ordinal). A zero-norm layer reports
    update_ratio 0.0 rather than dividing by zero — the ratio is
    undefined there, and once the params move (the very next step) the
    real ratio appears; a non-finite norm propagates as NaN."""
    layers = {}
    for name, t in host_telem["layers"].items():
        pn = math.sqrt(max(float(t["param_sq"]), 0.0)) \
            if math.isfinite(float(t["param_sq"])) else float(t["param_sq"])
        gn = math.sqrt(max(float(t["grad_sq"]), 0.0)) \
            if math.isfinite(float(t["grad_sq"])) else float(t["grad_sq"])
        un = math.sqrt(max(float(t["update_sq"]), 0.0)) \
            if math.isfinite(float(t["update_sq"])) else float(t["update_sq"])
        if math.isfinite(un) and math.isfinite(pn):
            ratio = (un / pn) if pn > 0.0 else 0.0
        else:
            ratio = float("nan")
        layers[name] = {"grad_norm": gn, "param_norm": pn,
                        "update_ratio": ratio,
                        "nonfinite": int(t["nonfinite"])}
    gsq = float(host_telem["grad_sq_global"])
    return {"step": int(step), "wall_time": time.time(),
            "global_grad_norm": (math.sqrt(max(gsq, 0.0))
                                 if math.isfinite(gsq) else gsq),
            "layers": layers}


class TelemetryRing:
    """Bounded ring of the last-K per-step telemetry rows (what the
    ``/train`` endpoint and the train-death postmortem embed)."""

    def __init__(self, last_k: int = 64):
        self._ring: deque = deque(maxlen=int(last_k))

    def add(self, row: dict):
        self._ring.append(row)

    def rows(self) -> list:
        """Snapshot (oldest first). The ring is read from scrape
        threads while the training thread appends — copy with a
        bounded retry instead of crashing the payload (the
        flight-recorder ring's discipline)."""
        for _ in range(5):
            try:
                return list(self._ring)
            except RuntimeError:  # deque mutated during iteration
                continue
        return []

    def __len__(self):
        return len(self._ring)

    @property
    def last(self) -> dict | None:
        return self._ring[-1] if self._ring else None


# ---------------------------------------------------------------------------
# anomaly attribution
# ---------------------------------------------------------------------------

class LayerGradStats:
    """Per-layer EWMA mean/variance of grad norms — the baseline a
    z-score attribution compares a suspect step against. Feed it only
    steps the anomaly detector passed (an anomalous row must be judged
    against the healthy history, not absorbed into it)."""

    def __init__(self, alpha: float = 0.2, warmup: int = 3):
        self._alpha = float(alpha)
        self._warmup = int(warmup)
        self._mean: dict = {}
        self._var: dict = {}
        self._n: dict = {}

    def update(self, row: dict):
        a = self._alpha
        for layer, t in row["layers"].items():
            v = t["grad_norm"]
            if not math.isfinite(v):
                continue
            if layer not in self._mean:
                self._mean[layer], self._var[layer], self._n[layer] = \
                    v, 0.0, 1
                continue
            d = v - self._mean[layer]
            self._mean[layer] += a * d
            self._var[layer] = (1 - a) * (self._var[layer] + a * d * d)
            self._n[layer] += 1

    def z(self, layer: str, value: float) -> float | None:
        """z-score of ``value`` against the layer's history; None
        inside warmup or for an untracked layer."""
        if self._n.get(layer, 0) < self._warmup:
            return None
        sd = math.sqrt(self._var[layer]) + 1e-12
        return (value - self._mean[layer]) / sd


def attribute_anomaly(row: dict | None, stats: LayerGradStats | None = None,
                      z_threshold: float = 4.0) -> dict:
    """Name the suspect layer for an anomalous step, sharpest signal
    first: (1) the first layer whose PARAMETER norm is non-finite (the
    blown-up weights themselves — a NaN anywhere downstream poisons
    every layer's grads, but only the source layer's params); (2) the
    first layer whose grads carry non-finite elements or whose
    grad-norm overflowed; (3) the layer with the largest grad-norm
    z-score above ``z_threshold``. Returns ``{"layer", "reason",
    "detail"}`` with ``layer=None`` when the row shows no per-layer
    signal (e.g. a host-side loss poison)."""
    if row is None:
        return {"layer": None, "reason": "no_telemetry",
                "detail": "step ran without introspect=True"}
    for layer, t in row["layers"].items():
        if not math.isfinite(t["param_norm"]):
            return {"layer": layer, "reason": "param_nonfinite",
                    "detail": f"param_norm={t['param_norm']}"}
    for layer, t in row["layers"].items():
        if t["nonfinite"] > 0 or not math.isfinite(t["grad_norm"]):
            return {"layer": layer, "reason": "grad_nonfinite",
                    "detail": (f"nonfinite_elements={t['nonfinite']} "
                               f"grad_norm={t['grad_norm']}")}
    best, best_z = None, 0.0
    if stats is not None:
        for layer, t in row["layers"].items():
            z = stats.z(layer, t["grad_norm"])
            if z is not None and z > best_z:
                best, best_z = layer, z
    if best is not None and best_z >= z_threshold:
        return {"layer": best, "reason": "grad_norm_zscore",
                "detail": f"z={best_z:.2f}"}
    return {"layer": None, "reason": "no_layer_signal",
            "detail": "all layers finite and inside the z-score band"}


# ---------------------------------------------------------------------------
# pipeline schedule index tables (shared by the compiled schedules, the
# host-stepped profiler and the accounting below)
# ---------------------------------------------------------------------------

def fwd_unit_index(t, d, pp, n_virtual, n_micro):
    """Device ``d``'s forward unit at tick ``t`` under the continuous
    1F1B / interleaved-1F1B schedule: returns ``(valid, chunk, micro)``.

    The schedule streams microbatch groups of ``pp`` through the ``V``
    chunks each device owns without draining between groups: with
    ``q = t - d`` (device d enters the stream d ticks late), chunk
    ``k = (q mod V*pp) // pp`` processes microbatch
    ``m = (q // (V*pp)) * pp + (q mod pp)``. Pure integer arithmetic —
    the same expressions run on Python ints (accounting, tests) and on
    device scalars inside a compiled schedule's tick."""
    V, M = n_virtual, n_micro
    VP = V * pp
    q = t - d
    k = (q % VP) // pp
    m = (q // VP) * pp + (q % pp)
    valid = (q >= 0) & (q < M * V)
    return valid, k, m


def bwd_unit_index(t, d, pp, n_virtual, n_micro):
    """Device ``d``'s backward unit at tick ``t``: ``(valid, chunk,
    micro)``. Backward of chunk ``v = k*pp + d`` for microbatch ``m``
    runs ``2*(V*pp - 1 - v)`` ticks after its forward (the cotangent
    rings back one virtual stage per tick, the last chunk's backward
    shares its forward's tick), which inverts to at most ONE backward
    unit per device per tick."""
    V, M = n_virtual, n_micro
    VP = V * pp
    z = t + d - 2 * (VP - 1)
    mm = z % pp
    c = (z - mm) // pp
    k = (-c) % V
    j = (c + k) // V
    m = j * pp + mm
    valid = (j >= 0) & (m < M)
    return valid, k, m


def schedule_ticks(schedule: str, pp: int, n_virtual: int,
                   n_micro: int) -> int:
    """Total clock ticks of one schedule pass."""
    if schedule == "gpipe_wave":
        if n_virtual == 1:
            return n_micro + pp - 1
        # group scan: M//pp groups, each V*pp + pp - 1 ticks
        return (n_micro // pp) * (n_virtual * pp + pp - 1)
    return n_virtual * n_micro + n_virtual * pp + pp - 2


def pipeline_accounting(fwd_unit_seconds, bwd_unit_seconds=None, *,
                        schedule: str = "gpipe_wave",
                        n_virtual: int = 1) -> dict:
    """Fold measured per-unit durations into ``schedule``'s timeline
    and return the bubble accounting (schedule-neutral successor of
    ``gpipe_wave_accounting``; that name stays as an alias).

    ``fwd_unit_seconds``: list of rows of M floats — row ``v`` is
    virtual stage ``v = k*pp + d`` (for ``gpipe_wave`` V=1 the rows ARE
    the pp stages, preserving that alias's call shape); ``[v][m]`` is the
    measured forward compute of that stage on microbatch ``m``.
    ``bwd_unit_seconds``: same shape for the backward units — required
    for the 1f1b family (each tick pairs one forward and one backward
    unit per device), refused for the forward-only gpipe_wave fold.

    Tick model: the lockstep semantics of the compiled
    schedules — every device waits on the ppermute ring each tick, so
    a tick lasts as long as the slowest device's work; a device's work
    in a tick is the SUM of its active units (the 1f1b family pairs a
    forward and a backward unit in one tick). Per-stage stats aggregate
    over the chunks a device owns.

    Returns ``{"schedule", "pp", "n_virtual", "n_micro",
    "wall_seconds", "per_stage": {stage_idx: {"busy_seconds",
    "idle_seconds", "bubble_fraction"}}, "bubble_fraction"}`` — the
    top-level fraction is total idle / (P x wall), equal to
    (P-1)/(M+P-1) for gpipe_wave/1f1b and (P-1)/(M*V+P-1) for
    interleaved_1f1b when every unit costs the same."""
    rows = len(fwd_unit_seconds)
    if rows == 0:
        raise ValueError("no stages to account")
    M = len(fwd_unit_seconds[0])
    V = int(n_virtual)
    for name, arr in (("fwd_unit_seconds", fwd_unit_seconds),
                      ("bwd_unit_seconds", bwd_unit_seconds or [])):
        if any(len(row) != M for row in arr):
            raise ValueError(f"ragged {name} — every stage needs one "
                             "duration per microbatch")

    if schedule == "gpipe_wave":
        if V != 1:
            raise ValueError(
                "gpipe_wave accounting folds the V=1 forward wave only "
                "(measure interleaving via schedule='interleaved_1f1b')")
        if bwd_unit_seconds is not None:
            raise ValueError(
                "gpipe_wave accounting is forward-wave only — pass "
                "bwd_unit_seconds with schedule='1f1b' or "
                "'interleaved_1f1b'")
        P = rows
        wall = 0.0
        for t in range(M + P - 1):
            active = [fwd_unit_seconds[s][t - s]
                      for s in range(P) if 0 <= t - s < M]
            wall += max(active)
        per_stage = {}
        total_idle = 0.0
        for s in range(P):
            busy = float(sum(fwd_unit_seconds[s]))
            idle = max(wall - busy, 0.0)
            total_idle += idle
            per_stage[s] = {
                "busy_seconds": busy, "idle_seconds": idle,
                "bubble_fraction": (idle / wall) if wall else 0.0}
        return {"schedule": schedule, "pp": P, "n_virtual": 1,
                "n_micro": M, "wall_seconds": wall,
                "per_stage": per_stage,
                "bubble_fraction": (total_idle / (P * wall))
                if wall else 0.0}

    if schedule not in ("1f1b", "interleaved_1f1b"):
        raise ValueError(
            f"unknown schedule {schedule!r}; accounting covers "
            "gpipe_wave (forward wave), 1f1b and interleaved_1f1b "
            "(paired fwd/bwd ticks)")
    if bwd_unit_seconds is None:
        raise ValueError(
            f"{schedule} accounting pairs forward and backward units "
            "per tick — bwd_unit_seconds is required")
    if rows % V:
        raise ValueError(
            f"{rows} virtual-stage rows not divisible by n_virtual={V}")
    P = rows // V
    T = schedule_ticks(schedule, P, V, M)
    busy = [0.0] * P
    wall = 0.0
    for t in range(T):
        tick = 0.0
        for d in range(P):
            work = 0.0
            ok_f, k_f, m_f = fwd_unit_index(t, d, P, V, M)
            if ok_f:
                work += fwd_unit_seconds[k_f * P + d][m_f]
            ok_b, k_b, m_b = bwd_unit_index(t, d, P, V, M)
            if ok_b:
                work += bwd_unit_seconds[k_b * P + d][m_b]
            busy[d] += work
            tick = max(tick, work)
        wall += tick
    per_stage = {}
    total_idle = 0.0
    for d in range(P):
        idle = max(wall - busy[d], 0.0)
        total_idle += idle
        per_stage[d] = {"busy_seconds": busy[d], "idle_seconds": idle,
                        "bubble_fraction": (idle / wall) if wall else 0.0}
    return {"schedule": schedule, "pp": P, "n_virtual": V, "n_micro": M,
            "wall_seconds": wall, "per_stage": per_stage,
            "bubble_fraction": (total_idle / (P * wall)) if wall else 0.0}


def gpipe_wave_accounting(stage_micro_seconds) -> dict:
    """Alias: the V=1 GPipe forward-wave fold (see
    `pipeline_accounting`, which this delegates to)."""
    return pipeline_accounting(stage_micro_seconds, schedule="gpipe_wave")


def record_pipeline_bubble(report: dict, stage_unit_seconds,
                           registry=None) -> None:
    """Publish one schedule pass's accounting: every per-stage unit
    mark lands on ``train_pipeline_stage_seconds{stage,schedule}``,
    the per-stage and whole-pipeline bubble fractions on
    ``train_pipeline_bubble_fraction{stage,schedule}`` (``stage="all"``
    is the aggregate number).
    ``stage_unit_seconds``: one list of unit durations per stage
    (device) — the forward wave's [P][M] marks for gpipe_wave, each
    device's fwd+bwd unit marks for the 1f1b family. The schedule
    label comes from ``report["schedule"]``."""
    m = register_introspection_metrics(registry)
    sched = report.get("schedule", "gpipe_wave")
    for s, row in enumerate(stage_unit_seconds):
        for dt in row:
            m["pipeline_stage"].observe(dt, stage=f"stage{s}",
                                        schedule=sched)
    for s, acct in report["per_stage"].items():
        m["pipeline_bubble"].set(acct["bubble_fraction"],
                                 stage=f"stage{s}", schedule=sched)
    m["pipeline_bubble"].set(report["bubble_fraction"], stage="all",
                             schedule=sched)


__all__ = [
    "layer_key", "group_layers", "grad_telemetry",
    "register_introspection_metrics", "fold_telemetry", "TelemetryRing",
    "LayerGradStats", "attribute_anomaly",
    "fwd_unit_index", "bwd_unit_index", "schedule_ticks",
    "pipeline_accounting", "gpipe_wave_accounting",
    "record_pipeline_bubble",
    "TRAIN_PHASES", "PHASE_DATA_WAIT", "PHASE_DISPATCH",
    "PHASE_SNAPSHOT", "PHASE_ROLLBACK",
]
