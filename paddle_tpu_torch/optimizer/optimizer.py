"""Optimizer base: the eager ``step()`` and the functional form.

Counterpart: ``paddle_tpu/optimizer/optimizer.py``. One per-parameter
rule ``_update_rule(p, g, slots, lr, meta) -> (new_p, new_slots)`` serves
both forms, float32 math whatever the storage dtype (slots stored in
bf16 are cast up before the rule and the results cast back):

- the eager ``step()`` (:135-173) over ``parameters=`` (torch
  parameters, ``(name, param)`` pairs, or groups ``{"params": [...]}``
  flattened as in :34-40) reads ``p.grad``, clips the ``(param, grad)``
  pairs, and updates each parameter and its slots in place; with
  ``multi_precision`` a bf16 parameter keeps a float32 master that the
  rule updates (:102-103, :157-163); `clear_grad`, `minimize`,
  `state_dict` / `set_state_dict` with the reference's keys
  (``{name}.{slot}``, ``{name}.master``, ``@step``, ``@lr``; :255-293);
- ``init_state`` / ``apply_gradients(params, grads, state, lr=None)``
  (:200-252) over name -> tensor dicts, for the compiled train step: the
  grads are cast to their parameter's dtype (:240) and clipped by
  ``apply_functional``. torch has no buffer donation, so params and
  slots are updated IN PLACE and the same dicts returned: one copy of
  the training state stays live.

``learning_rate`` is a float or an `lr.LRScheduler` (`get_lr` /
`set_lr`, :77-88). Every scalar the update reads lives on the device: the
learning rate (a float32 scalar, or the tensor given as ``lr=``), the
step count ``state["step"]`` (int32, advanced on the device; :205) and,
from a loss scaler, ``found_inf`` (int32: nonzero skips the update and
leaves the step count). So an update costs no host synchronisation and
`distributed.SpmdTrainStep` captures it inside its CUDA graph. Adam and
AdamW run one Hopper kernel over all their tensors on a card
(`kernels.multi_tensor_adam`); the other optimizers run their rules as
torch ops.

``slot_placement="host"`` (ZeRO-Offload slots) raises naming ROADMAP
A11, ``minimize`` under a static program (``startup_program=``) A14.
"""
from __future__ import annotations

import numbers
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from .lr import LRScheduler


class _Item(NamedTuple):
    """One parameter's update: its param, grad and slots, the float32
    master it updates instead of ``p`` (or None) and its weight decay."""
    p: torch.Tensor
    g: torch.Tensor
    slots: dict
    master: Optional[torch.Tensor]
    wd: float


def _store(dst, new, skip):
    """``dst`` := ``new`` in ``dst``'s dtype, unless ``skip``."""
    new = new.to(dst.dtype)
    if skip is not None:
        new = torch.where(skip, dst, new)
    dst.copy_(new)


class Optimizer:
    _slot_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, slot_placement="device"):
        if slot_placement == "host":
            raise NotImplementedError(
                "host-offloaded optimizer slots (slot_placement='host') are "
                "a later slice (ROADMAP A11)")
        if slot_placement != "device":
            raise ValueError(f"slot_placement must be 'device' or 'host', "
                             f"got {slot_placement!r}")
        self._names: dict = {}
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                parameters = [p for g in parameters for p in g["params"]]
            flat = []
            for p in parameters:
                if isinstance(p, tuple):
                    self._names[id(p[1])] = p[0]
                    p = p[1]
                flat.append(p)
            parameters = flat
        self._parameter_list = parameters
        self._index = {id(p): i for i, p in enumerate(parameters or ())}
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, numbers.Real):
            self._weight_decay = float(weight_decay)
        elif weight_decay is None:
            self._weight_decay = 0.0
        else:                      # an L2Decay-like object
            self._weight_decay = float(getattr(weight_decay, "_coeff", 0.0))
        # the eager step's state, by id of the parameter
        self._accumulators: dict = {}
        self._master_weights: dict = {}
        self._step_count = 0
        self._eager_step: Optional[torch.Tensor] = None
        self._lr_bufs: dict = {}

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.get_lr()
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr not allowed with an LRScheduler; "
                               "call scheduler.step() instead")
        self._learning_rate = value

    def _lr_tensor(self, lr, device) -> torch.Tensor:
        """The update's learning rate as a float32 device scalar: ``lr``
        itself when it is one, else ``get_lr()`` (or ``lr``) written into
        this optimizer's buffer for ``device`` (a fill, no copy from the
        host)."""
        if isinstance(lr, torch.Tensor):
            return lr
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a captured update takes its lr as a device "
                               "tensor (apply_gradients(lr=...)): a number "
                               "would be fixed in the graph")
        value = float(self.get_lr() if lr is None else lr)
        buf = self._lr_bufs.get(device)
        if buf is None:
            buf = self._lr_bufs[device] = torch.zeros(
                (), dtype=torch.float32, device=device)
        return buf.fill_(value)

    # -- the update ----------------------------------------------------------
    def _init_slots(self, value, dtype=None):
        """Zero slots like ``value``, stored in ``dtype`` (default
        float32)."""
        return {n: torch.zeros_like(value, dtype=dtype or torch.float32)
                for n in self._slot_names}

    def _update_rule(self, p, g, slots, lr, meta):
        raise NotImplementedError

    def _update(self, items, lr, step, found_inf, clip_scale=None):
        """Apply ``_update_rule`` to every `_Item` in place; ``step`` is
        the count before this update. ``clip_scale`` is None here (only
        Adam's kernel takes one)."""
        t = (step + 1).float()
        skip = None if found_inf is None else found_inf != 0
        for it in items:
            p_in = it.p if it.master is None else it.master
            g = it.g if it.g.dtype == p_in.dtype else it.g.to(p_in.dtype)
            slots_in = {n: (s.float() if s.dtype in (torch.bfloat16,
                                                     torch.float16) else s)
                        for n, s in it.slots.items()}
            new_p, new_slots = self._update_rule(
                p_in, g, slots_in, lr, {"weight_decay": it.wd, "step": t})
            if it.master is not None:
                _store(it.master, new_p, skip)
            _store(it.p, new_p, skip)
            for n, v in new_slots.items():
                if v is not it.slots[n]:
                    _store(it.slots[n], v, skip)

    def _fused_clip(self, grads):
        """The clip scale this optimizer's kernel applies as it reads the
        grads, or None when the clip runs on its own (the default)."""
        return None

    # -- eager step --------------------------------------------------------
    def _key(self, p):
        """The parameter's name in `state_dict` (and for
        ``apply_decay_param_fun``): the name it was given with, its
        ``name``, else ``param_{index}``."""
        return self._names.get(id(p)) or getattr(p, "name", None) \
            or f"param_{self._index[id(p)]}"

    def _ensure_slots(self, p):
        pid = id(p)
        if pid not in self._accumulators:
            self._accumulators[pid] = self._init_slots(p.detach())
            if self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16):
                self._master_weights[pid] = p.detach().float()
        return self._accumulators[pid]

    def _effective_wd(self, p):
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            return float(getattr(reg, "_coeff", self._weight_decay))
        return self._weight_decay

    def _eager_step_tensor(self, device) -> torch.Tensor:
        """The eager step count on ``device`` (int32, the count before
        this step), made from the host count when first needed."""
        if self._eager_step is None or self._eager_step.device != device:
            self._eager_step = torch.tensor(self._step_count - 1,
                                            dtype=torch.int32, device=device)
        return self._eager_step

    @torch.no_grad()
    def step(self):
        params = self._parameter_list
        if params is None:
            raise ValueError("optimizer created without parameters; "
                             "pass parameters=model.parameters()")
        self._step_count += 1
        pairs = [(p, p.grad) for p in params
                 if p.grad is not None and p.requires_grad]
        if not pairs:
            self._eager_step = None
            return
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        dev = pairs[0][0].device
        step = self._eager_step_tensor(dev)
        items = [_Item(p, g, self._ensure_slots(p),
                       self._master_weights.get(id(p)), self._effective_wd(p))
                 for p, g in pairs]
        self._update(items, self._lr_tensor(None, dev), step, None)
        step.add_(1)

    def clear_grad(self, set_to_zero=False):
        if self._parameter_list is not None:
            for p in self._parameter_list:
                if set_to_zero and p.grad is not None:
                    p.grad.zero_()
                else:
                    p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        if startup_program is not None:
            raise NotImplementedError(
                "minimize under a static program is a later slice (ROADMAP "
                "A14); the port runs eagerly")
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # -- functional API (the train step) -----------------------------------
    def init_state(self, params: dict, slot_dtype=None) -> dict:
        """``{"step": int32 0, "slots": {name: {slot: zeros}}}`` on the
        params' device, float slots allocated directly in ``slot_dtype``
        (default float32)."""
        dev = next(iter(params.values())).device if params else "cpu"
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "slots": {k: self._init_slots(v, dtype=slot_dtype)
                          for k, v in params.items()}}

    @torch.no_grad()
    def apply_gradients(self, params: dict, grads: dict, state: dict,
                        lr=None, found_inf=None):
        """One update of every parameter with a gradient, in place; the
        step count advances on the device. ``lr``: a number or a float32
        device scalar (default `get_lr()`). ``found_inf``: an int32 device
        scalar; nonzero leaves params, slots and the step count as they
        were (the loss scaler's skip). Returns ``(params, state)``, the
        same dicts."""
        step = state["step"]
        grads = {k: g for k, g in grads.items()
                 if g is not None and k in params}
        clip_scale = None
        if self._grad_clip is not None:
            clip_scale = self._fused_clip(grads)
            if clip_scale is None:
                grads = self._grad_clip.apply_functional(grads)
        items = [_Item(params[k], grads[k], state["slots"][k], None,
                       self._weight_decay)
                 for k in params if k in grads]
        self._update(items, self._lr_tensor(lr, step.device), step,
                     found_inf, clip_scale)
        step.add_(1 if found_inf is None else 1 - found_inf)
        return params, state

    # -- checkpoint ----------------------------------------------------------
    def state_dict(self):
        sd = OrderedDict()
        for p in self._parameter_list or ():
            slots = self._accumulators.get(id(p))
            if slots is None:
                continue
            key = self._key(p)
            for sname, sval in slots.items():
                sd[f"{key}.{sname}"] = sval
            if id(p) in self._master_weights:
                sd[f"{key}.master"] = self._master_weights[id(p)]
        sd["@step"] = torch.tensor(self._step_count)
        if isinstance(self._learning_rate, LRScheduler):
            sd["@lr"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, sd):
        if "@step" in sd:
            self._step_count = int(sd["@step"])
            self._eager_step = None
        if "@lr" in sd and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(dict(sd["@lr"]))
        for p in self._parameter_list or ():
            key = self._key(p)
            slots = self._accumulators.get(id(p), {})
            for sname in self._slot_names:
                v = sd.get(f"{key}.{sname}")
                if v is not None:
                    slots[sname] = _restored(slots.get(sname), v, p.device)
            if slots:
                self._accumulators[id(p)] = slots
            v = sd.get(f"{key}.master")
            if v is not None:
                self._master_weights[id(p)] = _restored(
                    self._master_weights.get(id(p)), v, p.device)


def _restored(live, value, device):
    """``value`` as a tensor on ``device``: copied into ``live`` when that
    has its shape and dtype (so its address holds), else a new one."""
    value = torch.as_tensor(value)
    if live is not None and live.shape == value.shape \
            and live.dtype == value.dtype:
        return live.copy_(value)
    return value.to(device).clone()


__all__ = ["Optimizer"]
