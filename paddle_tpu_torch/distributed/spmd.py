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

What this slice leaves out raises `NotImplementedError` naming its
ROADMAP item: a device mesh and recompute (A12), in-step introspection
(A11).
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

_uids = itertools.count()


def scaler_state(scaler, device) -> dict:
    """The scaler's state as device tensors: the float32 ``scale`` and
    the int32 ``good``, ``bad`` and ``skipped`` counts."""
    dev = torch.device(device)
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return {"scale": torch.tensor(scaler.get_loss_scaling(),
                                  dtype=torch.float32, device=dev),
            "good": zero(), "bad": zero(), "skipped": zero()}


def make_scaler_step(forward_backward, opt, scaler):
    """The train step with dynamic loss scaling (``GradScaler``'s
    semantics, :183-300): the loss scaled, the grads unscaled in float32,
    a non-finite grad anywhere skips the whole update (params, slots and
    the step count stay) through the optimizer's ``found_inf``, and the
    scale shrinks or grows. Every decision is a device ``torch.where``;
    nothing is read on the host. ``forward_backward(params, batch,
    scale)`` returns ``(scaled loss, grads, aux)``. Returns ``step(params,
    opt_state, batch, lr) -> (loss, aux)``, updating in place."""
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
        opt.apply_gradients(params, grads, {"step": opt_state["step"],
                                            "slots": opt_state["slots"]},
                            lr=lr, found_inf=found)
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
        return loss, aux

    return step


def _leaves(tree) -> list:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


class SpmdTrainStep:
    def __init__(self, model, loss_fn, optimizer, mesh=None, amp=None,
                 recompute=False, scaler=None, introspect=False):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (data/tensor parallel training) is a later "
                "slice (ROADMAP A12); this step runs on the model's device")
        if recompute:
            raise NotImplementedError(
                "recompute (activation checkpointing) is a later slice "
                "(ROADMAP A12)")
        if introspect:
            raise NotImplementedError(
                "in-step introspection is a later slice (ROADMAP A11)")
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

    def _body(self, params, opt_state, consts):
        """The step over the static buffers: ``lr`` (float32 bits in an
        int32 buffer) and the batch's tensors; returns the loss and the
        aux tensors in `_aux_keys` order."""
        scaled = (None if self.scaler is None else
                  make_scaler_step(self._forward_backward, self.optimizer,
                                   self.scaler))

        def body(lr, **tensors):
            lr = lr.view(torch.float32).reshape(())
            batch = {**consts, **tensors}
            with torch.enable_grad(), _random.rng_guard(self._gen):
                if scaled is not None:
                    loss, aux = scaled(params, opt_state, batch, lr)
                else:
                    loss, grads, aux = self._forward_backward(params, batch)
                    self.optimizer.apply_gradients(params, grads, opt_state,
                                                   lr=lr)
            aux = aux or {}
            self._aux_keys = sorted(aux)
            return (loss, *(aux[k].detach() for k in self._aux_keys))

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
        loss, *aux = entry[0](**self._operands(batch))
        self.last_aux = dict(zip(self._aux_keys, aux))
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
        loss, *aux = step.run_eager(**self._operands(batch))
        self.last_aux = dict(zip(self._aux_keys, aux))
        return loss, params, opt_state

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
