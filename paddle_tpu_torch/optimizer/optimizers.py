"""The optimizers: SGD, Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta,
RMSProp, Lamb.

Counterpart: ``paddle_tpu/optimizer/optimizers.py``, with its float32
update math and its weight-decay semantics: the plain optimizers fold
``weight_decay`` into the gradient as L2 (``_l2``, :20-21, in the
gradient's dtype); AdamW and Lamb decay decoupled. A Python scalar
beside a tensor of lower precision is taken in that tensor's dtype, as
JAX's weak typing does (`kernels.multi_tensor_adam.weak`).

Adam and AdamW update every tensor in one launch of the Hopper kernel a
dtype group (`kernels.multi_tensor_adam`; its plain version on the CPU),
which also applies a global-norm clip's scale as it reads each grad. The
others run their rules as torch ops, each parameter in turn.
"""
from __future__ import annotations

import torch

from ..kernels.multi_tensor_adam import AdamEntry, AdamTables, \
    multi_tensor_adam, weak
from ..nn.clip import ClipGradByGlobalNorm
from .optimizer import Optimizer


def _l2(g, p, wd):
    return g + weak(wd, g) * p.to(g.dtype) if wd else g


class SGD(Optimizer):
    def _update_rule(self, p, g, slots, lr, meta):
        g = _l2(g, p, meta["weight_decay"])
        return p - weak(lr, p) * g.to(p.dtype), slots


class Momentum(Optimizer):
    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update_rule(self, p, g, slots, lr, meta):
        g32 = _l2(g.float(), p, meta["weight_decay"])
        v = self._momentum * slots["velocity"] + g32
        upd = g32 + self._momentum * v if self._nesterov else v
        return p - weak(lr, p) * upd.to(p.dtype), {"velocity": v}


class Adam(Optimizer):
    _slot_names = ("moment1", "moment2")
    _adamw = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, slot_placement="device"):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name, slot_placement=slot_placement)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._tables = AdamTables()

    def _fused_clip(self, grads):
        if isinstance(self._grad_clip, ClipGradByGlobalNorm) and grads:
            return self._grad_clip.scale(grads)
        return None

    def _update(self, items, lr, step, found_inf, clip_scale=None):
        multi_tensor_adam(
            [AdamEntry(it.p, it.g, it.slots["moment1"], it.slots["moment2"],
                       it.master, it.wd, it.lr_scale) for it in items],
            lr, step, beta1=self._beta1, beta2=self._beta2,
            epsilon=self._epsilon, adamw=self._adamw, found_inf=found_inf,
            clip_scale=clip_scale, tables=self._tables)


class AdamW(Adam):
    """Decoupled weight decay; ``apply_decay_param_fun(name)`` picks the
    parameters the eager ``step()`` decays (:103-113)."""
    _adamw = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 slot_placement="device"):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, slot_placement=slot_placement)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _effective_wd(self, p):
        fn = self._apply_decay_param_fun
        if fn is not None and not fn(self._key(p)):
            return 0.0
        return super()._effective_wd(p)


class Adamax(Optimizer):
    _slot_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_rule(self, p, g, slots, lr, meta):
        g32 = _l2(g.float(), p, meta["weight_decay"])
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * slots["inf_norm"], g32.abs())
        upd = m / ((1 - torch.pow(self._beta1, meta["step"]))
                   * (u + self._epsilon))
        return p.float() - lr * upd, {"moment": m, "inf_norm": u}


class Adagrad(Optimizer):
    _slot_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _init_slots(self, value, dtype=None):
        return {"moment": torch.full(value.shape, self._initial,
                                     dtype=dtype or torch.float32,
                                     device=value.device)}

    def _update_rule(self, p, g, slots, lr, meta):
        g32 = _l2(g.float(), p, meta["weight_decay"])
        mom = slots["moment"] + g32.square()
        upd = g32 / (torch.sqrt(mom) + self._epsilon)
        return p.float() - lr * upd, {"moment": mom}


class Adadelta(Optimizer):
    _slot_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon, self._rho = epsilon, rho

    def _update_rule(self, p, g, slots, lr, meta):
        g32 = _l2(g.float(), p, meta["weight_decay"])
        asg = (self._rho * slots["avg_squared_grad"]
               + (1 - self._rho) * g32.square())
        upd = (g32 * torch.sqrt(slots["avg_squared_update"] + self._epsilon)
               / torch.sqrt(asg + self._epsilon))
        asu = (self._rho * slots["avg_squared_update"]
               + (1 - self._rho) * upd.square())
        return p.float() - lr * upd, {"avg_squared_grad": asg,
                                      "avg_squared_update": asu}


class RMSProp(Optimizer):
    _slot_names = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update_rule(self, p, g, slots, lr, meta):
        g32 = _l2(g.float(), p, meta["weight_decay"])
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * g32.square()
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * g32
            denom = torch.sqrt(ms - mg.square() + self._epsilon)
        else:
            mg = slots["mean_grad"]
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * slots["momentum"] + lr * g32 / denom
        return p.float() - mom, {"mean_square": ms, "mean_grad": mg,
                                 "momentum": mom}


class Lamb(Optimizer):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_rule(self, p, g, slots, lr, meta):
        g32 = g.float()
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g32.square()
        t = meta["step"]
        m_hat = m / (1 - torch.pow(self._beta1, t))
        v_hat = v / (1 - torch.pow(self._beta2, t))
        p32 = p.float()
        r = m_hat / (torch.sqrt(v_hat) + self._epsilon) \
            + meta["weight_decay"] * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p32 - lr * trust * r, {"moment1": m, "moment2": v}


__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb"]
