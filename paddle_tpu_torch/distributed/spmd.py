"""The train step on one device, one CUDA graph per batch signature.

Counterpart: ``paddle_tpu/distributed/spmd.py`` ``SpmdTrainStep`` (:303)
at data-parallel degree 1, ``make_scaler_step`` / ``scaler_state``
(:183-300) and ``gpt_loss_fn`` (:878). The reference jits forward,
backward and update into one executable per batch signature and reports
each trace to its recompile sentinel under ``spmd.step[sN]`` (:388,
:577). Here the same step runs as one CUDA graph on a card:

- ``init(dtype, slot_dtype)`` hands back the model's own parameter
  tensors (cast copies only where ``dtype`` differs) and the optimizer
  state (with a scaler, its device state under ``"scaler"``);
- ``step(params, opt_state, batch, key) -> (loss, params, opt_state)``:
  the loss through ``torch.func.functional_call`` with the dict's
  tensors, its gradient by ``torch.autograd`` (a parameter the loss does
  not read gets a zero gradient), the clip and the update (and with a
  scaler the found-inf gate and the scale's bookkeeping). torch has no
  donation: params and opt_state are updated IN PLACE and returned.
- The first call at a batch signature (the shapes and dtypes of the
  batch's entries, ``_dispatch_sig`` :583-593) builds a
  `jit.CapturedStep`: its warm-up is that call's step, then it captures
  the step; every later call copies the batch into the static inputs
  (one device copy an entry), stages the learning rate and replays.
  Each build is reported to the port's sentinel under `exec_name`; a
  call whose params or opt_state hold other tensors than the ones
  captured (a new ``init``, a state restored into new tensors) builds
  anew, reported too, and never replays on stale addresses. A capture
  that fails raises; nothing on a card runs the step eagerly but
  `run_eager`, the check's eager twin. On the CPU the same body runs
  eagerly on the same buffers.
- ``key`` decides every random draw of the step: one generator belongs
  to the step object, is registered with its graphs and is seeded from
  ``key`` before each call, so a replay draws what the eager step with
  that key draws (`core.random`).
- The learning rate is ``optimizer.get_lr()`` read on every call and
  staged into a device scalar, so a scheduler moves a captured step.
  (The reference's jitted step reads it once, at trace time: ROADMAP
  C.3.)
- The loss returned is a copy; the next replay does not overwrite it.
  A loss function may return ``(loss, aux)``, ``aux`` a dict of tensors:
  the step keeps their copies from its last call in `last_aux`.
- Memory: the graph's pool keeps the step's activations between calls,
  about what the eager step allocates above the weights, moments and
  batch. On an H100 (``PERF.md`` §5), bf16: 18.4 GiB held at gpt3-1.3b's
  b8 x s1024 (the eager step peaks 17.4 GiB above them; the replays'
  whole peak 1.04 x the eager step's), 5.6 GiB at bert-large's b8 x
  s512 (1.12 x), 9.4 GiB at 18 layers of Gemma-2B's widths, b4 x s1024
  (1.03 x).
- ``amp="bfloat16"`` is the reference's O2 cast (:488-499): float32
  masters, the forward in bfloat16, float32 gradients.

`metrics_snapshot` (:801-850) gives the executable's name, its builds
(``xla_traces``), steps, tokens and ``step_seconds_sum`` (host time from
call to return), and with ``opt_state`` the scaler's ``found_inf_skips``
and ``loss_scale`` (one small read from the device); ``memory``,
``cost`` and ``mfu`` are None (XLA's analyses; ROADMAP A9).

``introspect=True`` (:326-387, :687-735): the per-layer reductions of
`observability.train_introspection.grad_telemetry` (grad-norm²,
param-norm², update magnitude², non-finite count a layer, and the global
grad-norm²) run inside the step's one graph, on the unscaled grads, as
extra static outputs; a float32 copy of the params taken before the
in-place update gives the update's magnitude (that copy lives in the
graph's pool). Each call folds them on the host
(one small read from the device) into the ``train_layer_*`` gauges,
`last_telemetry_row` and a ring of the last ``introspect_last_k`` rows
(`telemetry_ring`). The reductions only read: the loss is bit for bit
the ``introspect=False`` loss, and the step is still one build a batch
signature.

`host_state` / `load_host_state` (:742-798) move the whole training
state (``param/<name>`` and ``opt/<path>`` leaves) to the host and back
for `framework.CheckpointManager`: the snapshot is a blocking copy into
pinned host memory (the next replay rewrites the params in place), the
restore copies INTO the live tensors, so the captured graph's addresses
hold and a resume or rollback replays without a new build.

What this slice leaves out raises `NotImplementedError` naming its
ROADMAP item: a device mesh and recompute (A12).
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch
from torch.func import functional_call

from ..core import random as _random
from ..device import resolve_dtype
from ..jit.capture import CapturedStep, graph_pool
from ..nn.functional import cross_entropy
from ..observability import get_registry, get_sentinel
from ..observability import tracing as _tracing
from ..observability import train_introspection as _introspect

_uids = itertools.count()


def scaler_state(scaler, device) -> dict:
    """The scaler's state as device tensors: the float32 ``scale`` and
    the int32 ``good``, ``bad`` and ``skipped`` counts."""
    dev = torch.device(device)
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return {"scale": torch.tensor(scaler.get_loss_scaling(),
                                  dtype=torch.float32, device=dev),
            "good": zero(), "bad": zero(), "skipped": zero()}


def make_scaler_step(forward_backward, opt, scaler, telemetry=None):
    """The train step with dynamic loss scaling (``GradScaler``'s
    semantics, :183-300): the loss scaled, the grads unscaled in float32,
    a non-finite grad anywhere skips the whole update (params, slots and
    the step count stay) through the optimizer's ``found_inf``, and the
    scale shrinks or grows. Every decision is a device ``torch.where``;
    nothing is read on the host. ``forward_backward(params, batch,
    scale)`` returns ``(scaled loss, grads, aux)``. ``telemetry(params,
    grads, update)``: the in-step reductions around the update
    (`SpmdTrainStep._telemetry`), given the unscaled float32 grads, as
    the reference gives them. Returns ``step(params, opt_state, batch,
    lr) -> (loss, aux, telemetry or None)``, updating in place."""
    incr_n = int(scaler._incr_every_n_steps)
    decr_n = int(scaler._decr_every_n_nan_or_inf)
    incr_r = float(scaler._incr_ratio)
    decr_r = float(scaler._decr_ratio)

    def step(params, opt_state, batch, lr):
        sc = opt_state["scaler"]
        scale = sc["scale"]
        loss_s, grads, aux = forward_backward(params, batch, scale)
        loss = loss_s / scale
        grads = {k: g.float() / scale for k, g in grads.items()}
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        found = (~finite).to(torch.int32)

        def update():
            opt.apply_gradients(params, grads, {"step": opt_state["step"],
                                                "slots": opt_state["slots"]},
                                lr=lr, found_inf=found)

        telem = None
        if telemetry is None:
            update()
        else:
            telem = telemetry(params, grads, update)
        zero = torch.zeros_like(sc["good"])
        good = torch.where(finite, sc["good"] + 1, zero)
        bad = torch.where(finite, zero, sc["bad"] + 1)
        dec = bad >= decr_n
        inc = good >= incr_n
        sc["scale"].copy_(torch.where(
            dec, torch.clamp(scale * decr_r, min=1.0),
            torch.where(inc, scale * incr_r, scale)))
        sc["good"].copy_(torch.where(inc, zero, good))
        sc["bad"].copy_(torch.where(dec, zero, bad))
        sc["skipped"].add_(found)
        return loss, aux, telem

    return step


def _leaves(tree) -> list:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _paths(tree, prefix="") -> list:
    """``(path, tensor)`` of a nested dict's tensors in sorted key order,
    the path its keys joined by ``/`` (the reference's ``_path_str`` of
    a flattened pytree, :738-740)."""
    if isinstance(tree, dict):
        return [pt for k in sorted(tree)
                for pt in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)] if isinstance(tree, torch.Tensor) else []


class SpmdTrainStep:
    def __init__(self, model, loss_fn, optimizer, mesh=None, amp=None,
                 recompute=False, scaler=None, introspect=False,
                 introspect_last_k=64):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (data/tensor parallel training) is a later "
                "slice (ROADMAP A12); this step runs on the model's device")
        if recompute:
            raise NotImplementedError(
                "recompute (activation checkpointing) is a later slice "
                "(ROADMAP A12)")
        self.model = model
        self.optimizer = optimizer
        self.scaler = scaler
        self._loss_fn = loss_fn
        amp = {"bf16": "bfloat16"}.get(amp, amp)
        self.amp = None if amp is None else resolve_dtype(amp)
        self._names = [n for n, _ in model.named_parameters()]
        #: the step's name on the recompile sentinel
        self.exec_name = f"spmd.step[s{next(_uids)}]"
        #: batch signature -> (its CapturedStep, the addresses it binds)
        self._steps: dict = {}
        self._pool = None
        self._gen = None
        self._aux_keys: list = []
        #: copies of the loss function's aux tensors from the last call
        self.last_aux = None
        self._step_seconds = 0.0
        #: in-step per-layer telemetry (module docstring)
        self.introspect = bool(introspect)
        self._layer_groups = (_introspect.group_layers(self._names)
                              if self.introspect else None)
        self.telemetry_ring = (_introspect.TelemetryRing(introspect_last_k)
                               if self.introspect else None)
        #: the newest folded per-step row (None until the first call)
        self.last_telemetry_row = None
        self._introspect_metrics = (
            _introspect.register_introspection_metrics()
            if self.introspect else None)
        self._introspect_calls = 0
        #: the step index the next row carries, when a wrapping loop
        #: (`ResilientTrainLoop`) sets it; else the call's ordinal
        self.introspect_step_hint = None
        r = get_registry()
        self._c_steps = r.counter("train_steps_total", "train step calls",
                                  labelnames=("executable",))
        self._c_tokens = r.counter("train_tokens_total", "tokens processed",
                                   labelnames=("executable",))

    def init(self, dtype=None, slot_dtype=None):
        """``(params, opt_state)``: the model's own parameter tensors
        (detached, sharing their storage, so the in-place update trains
        the model itself and no second copy stays resident; a float
        parameter is cast to a new tensor only where ``dtype`` differs
        from its own) and the optimizer state with slots stored in
        ``slot_dtype`` (and the scaler's state, with a scaler)."""
        dt = None if dtype is None else resolve_dtype(dtype)
        params = {}
        for n, p in self.model.named_parameters():
            v = p.detach()
            params[n] = (v.to(dt) if dt is not None and v.is_floating_point()
                         else v)
        sd = None if slot_dtype is None else resolve_dtype(slot_dtype)
        opt_state = self.optimizer.init_state(params, slot_dtype=sd)
        if self.scaler is not None:
            opt_state["scaler"] = scaler_state(
                self.scaler, next(iter(params.values())).device)
        return params, opt_state

    # -- the step's body ---------------------------------------------------
    def _forward_backward(self, params, batch, scale=None):
        """``(loss, grads, aux)`` of one batch under the current random
        scope: the float32 loss (times ``scale`` when given), a name ->
        gradient dict in the parameters' dtypes, and the loss function's
        aux dict (or None)."""
        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self._names}
        if self.amp is not None:
            state = {n: (v.to(self.amp) if v.is_floating_point() else v)
                     for n, v in leaves.items()}
        else:
            state = leaves
        out = self._loss_fn(self.model, state, batch)
        loss, aux = out if isinstance(out, tuple) else (out, None)
        loss = loss.float()
        if scale is not None:
            loss = loss * scale
        # a parameter the loss never reads (a post-LN fused layer's
        # pre_ln_scale, ffn._ln1_*) gets a zero gradient, as jax.grad
        # gives it in the reference: AdamW's decoupled decay still moves it
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), dict(zip(self._names, grads)), aux

    def loss_and_grads(self, params, batch, key):
        """The loss (float32 scalar) and a name -> gradient dict (each in
        its parameter's dtype) of one batch, eagerly, with a generator
        seeded from ``key``."""
        dev = next(iter(params.values())).device
        with _random.rng_guard(_random.step_generator(key, dev)):
            loss, grads, _ = self._forward_backward(params, batch)
        return loss, grads

    def _telemetry(self, params, grads, update):
        """Run ``update()`` (in place) between a float32 copy of the params
        and the per-layer reductions; returns them packed as two tensors:
        float64 ``[4, layers]`` (grad², param², update², non-finite
        count; exact for float32 sums and counts below 2^53) and the
        float32 global grad²."""
        before = {n: p.to(torch.float32, copy=True)
                  for n, p in params.items()
                  if p.is_floating_point() and n in grads}
        update()
        t = _introspect.grad_telemetry(self._layer_groups, before, grads,
                                       params)
        rows = [torch.stack([t["layers"][layer][q].double()
                             for layer in self._layer_groups])
                for q in ("grad_sq", "param_sq", "update_sq", "nonfinite")]
        return torch.stack(rows), t["grad_sq_global"]

    def _body(self, params, opt_state, consts):
        """The step over the static buffers: ``lr`` (float32 bits in an
        int32 buffer) and the batch's tensors; returns the loss, the aux
        tensors in `_aux_keys` order and, with introspection, the packed
        telemetry (`_telemetry`)."""
        telemetry = self._telemetry if self.introspect else None
        scaled = (None if self.scaler is None else
                  make_scaler_step(self._forward_backward, self.optimizer,
                                   self.scaler, telemetry))

        def body(lr, **tensors):
            lr = lr.view(torch.float32).reshape(())
            batch = {**consts, **tensors}
            telem = None
            with torch.enable_grad(), _random.rng_guard(self._gen):
                if scaled is not None:
                    loss, aux, telem = scaled(params, opt_state, batch, lr)
                else:
                    loss, grads, aux = self._forward_backward(params, batch)

                    def update():
                        self.optimizer.apply_gradients(params, grads,
                                                       opt_state, lr=lr)

                    if telemetry is None:
                        update()
                    else:
                        telem = telemetry(params, grads, update)
            aux = aux or {}
            self._aux_keys = sorted(aux)
            return (loss, *(aux[k].detach() for k in self._aux_keys),
                    *(telem or ()))

        return body

    # -- dispatch ----------------------------------------------------------
    @staticmethod
    def _dispatch_sig(batch) -> tuple:
        """The batch's signature: each entry's shape and dtype (or, for a
        non-tensor entry, its value), in key order."""
        if not isinstance(batch, dict):
            raise TypeError("the batch is a dict of tensors")
        return tuple((k, tuple(v.shape), v.dtype)
                     if isinstance(v, torch.Tensor) else (k, repr(v))
                     for k, v in sorted(batch.items()))

    def _build(self, params, opt_state, batch, note):
        dev = next(iter(params.values())).device
        if self._gen is None:
            self._gen = torch.Generator(device=dev)
            self._pool = graph_pool(dev)
        tensors = {k: v for k, v in batch.items()
                   if isinstance(v, torch.Tensor)}
        consts = {k: v for k, v in batch.items() if k not in tensors}
        name = self.exec_name
        fixed = _leaves(params) + _leaves(opt_state)
        step = CapturedStep(
            name, self._body(params, opt_state, consts), dev, pool=self._pool,
            on_trace=lambda: get_sentinel().note_trace(name, note),
            staged={"lr": (1,)},
            inputs={k: (tuple(v.shape), v.dtype) for k, v in tensors.items()},
            fixed=fixed, generators=[self._gen] if dev.type == "cuda" else (),
            warm_is_call=True)
        return step

    def _operands(self, batch):
        lr = np.array([self.optimizer.get_lr()], np.float32).view(np.int32)
        return {"lr": lr, **{k: v for k, v in batch.items()
                             if isinstance(v, torch.Tensor)}}

    def __call__(self, params, opt_state, batch, key):
        t0 = time.perf_counter()
        sig = self._dispatch_sig(batch)
        bound = tuple((t.data_ptr(), t.dtype)
                      for t in _leaves(params) + _leaves(opt_state))
        entry = self._steps.get(sig)
        if entry is None or entry[1] != bound:
            note = repr(sig) if entry is None else (
                f"{sig!r}; params and opt_state at new addresses "
                f"({get_sentinel().trace_count(self.exec_name)})")
            entry = self._steps[sig] = (
                self._build(params, opt_state, batch, note), bound)
        self._seed(key)
        with _tracing.span("train.step", stage="dispatch",
                           executable=self.exec_name):
            loss, *rest = entry[0](**self._operands(batch))
        self._outputs(rest)
        self._step_seconds += time.perf_counter() - t0
        self._c_steps.inc(executable=self.exec_name)
        tokens = self._tokens(batch)
        if tokens:
            self._c_tokens.inc(tokens, executable=self.exec_name)
        return loss, params, opt_state

    def run_eager(self, params, opt_state, batch, key):
        """The step once, eagerly, on the buffers of the step built for
        this batch signature (after copying the batch in): what a replay
        computes, for a check. Nothing on a main path calls it."""
        step = self._steps[self._dispatch_sig(batch)][0]
        self._seed(key)
        loss, *rest = step.run_eager(**self._operands(batch))
        self._outputs(rest)
        return loss, params, opt_state

    def _outputs(self, rest):
        """Keep a call's aux copies and fold its telemetry."""
        n = len(self._aux_keys)
        self.last_aux = dict(zip(self._aux_keys, rest[:n]))
        if self.introspect:
            self._fold_telemetry(*rest[n:])

    def _fold_telemetry(self, packed, global_sq):
        """One small read of the in-step reductions -> the gauges, the
        bounded ring and `last_telemetry_row` (:710-735)."""
        idx = (self.introspect_step_hint
               if self.introspect_step_hint is not None
               else self._introspect_calls)
        rows = packed.cpu().tolist()
        host = {"layers": {
            layer: {"grad_sq": rows[0][i], "param_sq": rows[1][i],
                    "update_sq": rows[2][i], "nonfinite": rows[3][i]}
            for i, layer in enumerate(self._layer_groups)},
            "grad_sq_global": float(global_sq)}
        row = _introspect.fold_telemetry(host, idx)
        self._introspect_calls += 1
        m = self._introspect_metrics
        name = self.exec_name
        for layer, t in row["layers"].items():
            m["layer_grad_norm"].set(t["grad_norm"], executable=name,
                                     layer=layer)
            m["layer_param_norm"].set(t["param_norm"], executable=name,
                                      layer=layer)
            m["update_ratio"].set(t["update_ratio"], executable=name,
                                  layer=layer)
            m["layer_nonfinite"].set(t["nonfinite"], executable=name,
                                     layer=layer)
        m["global_grad_norm"].set(row["global_grad_norm"], executable=name)
        self.telemetry_ring.add(row)
        self.last_telemetry_row = row
        return row

    # -- the training state to the host and back ---------------------------
    @staticmethod
    def state_items(params, opt_state) -> list:
        """``(key, tensor)`` of the whole training state: ``param/<name>``
        in the params' order, then ``opt/<path>`` (``step``,
        ``slots/<name>/<slot>``, ``scaler/<field>``) in sorted key
        order."""
        return ([(f"param/{n}", v) for n, v in params.items()]
                + [(f"opt/{p}", v) for p, v in _paths(opt_state)])

    def host_state(self, params, opt_state) -> dict:
        """The training state as one name -> host tensor dict (keys of
        `state_items`): the snapshot a `framework.CheckpointManager`
        commits in the background. On a card each leaf is copied into
        pinned host memory and the call waits for the copies: the next
        replay rewrites params and slots in place, so the snapshot must
        be whole before it runs. On the CPU, clones."""
        out = {}
        cuda = False
        for k, v in self.state_items(params, opt_state):
            if v.is_cuda:
                cuda = True
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
            else:
                h = v.detach().clone()
            out[k] = h
        if cuda:
            torch.cuda.current_stream().synchronize()
        return out

    def load_host_state(self, flat, params, opt_state):
        """Inverse of `host_state`: copy a restored flat dict (host
        tensors or numpy arrays) INTO the live ``params`` and
        ``opt_state`` tensors, which keeps the addresses the captured
        graphs bind, and return them. A missing leaf, or one of another
        shape or dtype, raises `framework.checkpoint.
        CheckpointCorruptError`: a restore matches the step's layout
        exactly or fails typed, never trains on garbage."""
        from ..framework.checkpoint import CheckpointCorruptError

        items = self.state_items(params, opt_state)
        for key, live in items:
            if key not in flat:
                raise CheckpointCorruptError(
                    f"checkpoint missing leaf {key!r}")
            a = flat[key]
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            if tuple(a.shape) != tuple(live.shape):
                raise CheckpointCorruptError(
                    f"restored leaf {key!r} shape {tuple(a.shape)} != live "
                    f"{tuple(live.shape)}")
            if a.dtype != live.dtype:
                raise CheckpointCorruptError(
                    f"restored leaf {key!r} dtype {a.dtype} != live "
                    f"{live.dtype}")
        with torch.no_grad():
            for key, live in items:
                a = flat[key]
                if not isinstance(a, torch.Tensor):
                    a = torch.from_numpy(np.ascontiguousarray(a))
                live.copy_(a)
        return params, opt_state

    def _seed(self, key):
        self._gen.manual_seed(int(key) & 0x7FFF_FFFF_FFFF_FFFF)

    def captured(self, batch) -> CapturedStep:
        """The `CapturedStep` built for ``batch``'s signature."""
        return self._steps[self._dispatch_sig(batch)][0]

    @staticmethod
    def _tokens(batch) -> int:
        """Tokens a call: batch x sequence of ``input_ids`` or, without
        it, of the first entry of rank 2 or more in key order (the
        reference takes that one always, :406-414, which counts a BERT
        batch by its [B, 1, 1, S] mask)."""
        ids = batch.get("input_ids")
        leaves = [ids] if isinstance(ids, torch.Tensor) else [
            v for _, v in sorted(batch.items())
            if isinstance(v, torch.Tensor)]
        for v in leaves:
            if v.dim() >= 2:
                return int(v.shape[0]) * int(v.shape[1])
        return 0

    def metrics_snapshot(self, opt_state=None) -> dict:
        """The training plane in one dict (module docstring). With the
        live ``opt_state``, also the scaler's monotone found-inf skip
        count and current scale (one small read from the device)."""
        name = self.exec_name
        out = {"executable": name,
               "xla_traces": get_sentinel().trace_count(name),
               "steps": int(self._c_steps.value(executable=name)),
               "tokens": int(self._c_tokens.value(executable=name)),
               "step_seconds_sum": self._step_seconds,
               "memory": None, "cost": None, "mfu": None}
        if self.introspect:
            out["introspection"] = {
                "enabled": True,
                "last": self.last_telemetry_row,
                "ring_len": len(self.telemetry_ring),
            }
        if opt_state is not None and "scaler" in opt_state:
            sc = opt_state["scaler"]
            out["found_inf_skips"] = int(sc["skipped"])
            out["loss_scale"] = float(sc["scale"])
        return out


def gpt_loss_fn(model, state, batch):
    """Next-token LM loss of the GPT family: mean cross-entropy of the
    logits of ``batch["input_ids"]`` against ``batch["labels"]``."""
    logits = functional_call(model, state, (batch["input_ids"],))
    if isinstance(logits, tuple):
        logits = logits[0]
    return cross_entropy(logits, batch["labels"], reduction="mean")


__all__ = ["SpmdTrainStep", "gpt_loss_fn", "make_scaler_step",
           "scaler_state"]
