"""`MoELayer`: gate, dense dispatch, experts, combine, on one card.

Counterpart: ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``.
The experts are either one `ExpertFFN` (every expert in one batched
product pair, `distributed.moe.stacked_expert_ffn`) or a list of modules,
the reference's form, each given its ``[g, c, m]`` slots. Spreading the
experts over a group of ranks (``moe_group``, ``mp_group``) is a later
slice (ROADMAP A12) and raises; the reference's layer takes the groups
and computes every expert locally all the same.
"""
from __future__ import annotations

import torch

from .....distributed import moe as moe_core
from .....nn import functional as F
from .....nn.container import LayerList
from .....nn.layer import Layer
from .gate import GShardGate, NaiveGate, SwitchGate

#: the experts' activations: ``jax.nn.gelu`` (tanh by default) and relu
_ACTIVATIONS = {"gelu": moe_core.gelu_tanh, "relu": F.relu}


class ExpertFFN(Layer):
    """``num_expert`` FFNs stacked: w1 ``[E, d_model, d_hidden]``, b1
    ``[E, d_hidden]``, w2 ``[E, d_hidden, d_model]``, b2 ``[E,
    d_model]`` (XavierUniform weights with the reference's 3-D fans,
    zero biases); ``forward(dispatched [E, g, c, m]) -> [E, g, c, m]``."""

    _init_normal = ("w1", "w2")

    def __init__(self, num_expert, d_model, d_hidden, activation="gelu", *,
                 device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.num_expert = num_expert
        self.activation = activation
        self.w1 = self.create_parameter([num_expert, d_model, d_hidden])
        self.b1 = self.create_parameter([num_expert, d_hidden], is_bias=True)
        self.w2 = self.create_parameter([num_expert, d_hidden, d_model])
        self.b2 = self.create_parameter([num_expert, d_model], is_bias=True)

    def forward(self, dispatched):
        return moe_core.stacked_expert_ffn(dispatched, self.w1, self.b1,
                                           self.w2, self.b2,
                                           _ACTIVATIONS[self.activation])


class MoELayer(Layer):
    """``forward(x [B, S, M] or [S, M]) -> same shape``; the load-balancing
    loss of the call is ``gate.loss``. ``gate``: a gate module, a dict
    (``{"type": "naive" | "gshard" | "switch", "top_k": k}``) or None (a
    `NaiveGate` of ``top_k``). ``experts``: an `ExpertFFN`, a list of
    modules, or None (an `ExpertFFN` of ``num_expert`` x ``d_hidden``).
    ``device``/``dtype``: of the gate and experts the layer builds."""

    def __init__(self, d_model, experts=None, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, top_k=2,
                 num_expert=None, d_hidden=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        if moe_group is not None or mp_group is not None:
            raise NotImplementedError(
                "MoELayer(moe_group=, mp_group=): experts spread over a "
                "group of ranks are a later slice (ROADMAP A12)")
        kw = dict(device=device, dtype=dtype)
        self.d_model = d_model
        if gate is None:
            n = (experts.num_expert if isinstance(experts, ExpertFFN)
                 else len(experts) if experts is not None else num_expert)
            gate = NaiveGate(d_model, n, topk=top_k, **kw)
        elif isinstance(gate, dict):
            cls = {"naive": NaiveGate, "gshard": GShardGate,
                   "switch": SwitchGate}[gate.get("type", "naive")]
            gate = cls(d_model, num_expert or len(experts),
                       topk=gate.get("top_k", top_k), **kw)
        self.gate = gate
        if experts is None:
            if not (num_expert and d_hidden):
                raise ValueError("MoELayer without experts needs num_expert "
                                 "and d_hidden")
            experts = ExpertFFN(num_expert, d_model, d_hidden, **kw)
        if isinstance(experts, (list, tuple)):
            experts = LayerList(experts)
        self.experts = experts

    @property
    def num_expert(self):
        if isinstance(self.experts, ExpertFFN):
            return self.experts.num_expert
        return len(self.experts)

    def forward(self, x):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        combine, dispatch, _ = self.gate.gating(x)
        dispatched = moe_core.moe_dispatch(x, dispatch)      # [E, g, c, m]
        if isinstance(self.experts, ExpertFFN):
            expert_out = self.experts(dispatched)
        else:
            expert_out = torch.stack([expert(dispatched[i]) for i, expert
                                      in enumerate(self.experts)])
        y = moe_core.moe_combine(expert_out, combine)
        return y[0] if squeeze else y


__all__ = ["ExpertFFN", "MoELayer"]
