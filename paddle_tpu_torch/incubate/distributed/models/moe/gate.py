"""MoE gates: a linear projection of the tokens to expert logits, then
`distributed.moe.top_k_gating`'s dense combine and dispatch tensors.

Counterpart: ``paddle_tpu/incubate/distributed/models/moe/gate.py``. The
gate's weight is ``[d_model, num_expert * world_size]``, drawn
XavierUniform when the gate is built (`nn.init_weights` draws it again
from a seed); the logits are formed in float32
whatever the tokens' dtype. ``gating`` keeps the load-balancing loss of
its last call in ``loss``.
"""
from __future__ import annotations

import torch

from .....distributed import moe as moe_core
from .....nn.layer import Layer


class NaiveGate(Layer):
    """Linear gate, top-k (``topk``), capacity ``capacity_factor``."""

    top_k = 2
    _init_normal = ("weight",)

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity_factor=1.25, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.d_model = d_model
        self.num_expert = num_expert * world_size
        self.top_k = topk
        self.capacity_factor = capacity_factor
        self.weight = self.create_parameter([d_model, self.num_expert])
        self.loss = None

    def gating(self, x):
        """x ``[g, s, m]`` -> ``(combine, dispatch, aux_loss)``."""
        logits = torch.einsum("gsm,me->gse", x.float(), self.weight.float())
        combine, dispatch, aux = moe_core.top_k_gating(
            logits, k=self.top_k, capacity_factor=self.capacity_factor)
        self.loss = aux
        return combine, dispatch, aux

    def forward(self, x):
        return self.gating(x)


class GShardGate(NaiveGate):
    """Top-2 gate with the load-balancing loss (GShard §2.4); the
    capacity factor is ``capacity[0]``. ``random_routing`` and ``group``
    are taken and unused, as in the reference."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None, *,
                 device=None, dtype=None):
        cap = capacity[0] if isinstance(capacity, (tuple, list)) else capacity
        super().__init__(d_model, num_expert, world_size, topk=topk,
                         capacity_factor=cap, device=device, dtype=dtype)


class SwitchGate(NaiveGate):
    """Top-1 gate (Switch Transformer §2.2); ``topk`` is ignored, as in
    the reference."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 capacity=(1.2, 2.4), group=None, *, device=None,
                 dtype=None):
        cap = capacity[0] if isinstance(capacity, (tuple, list)) else capacity
        super().__init__(d_model, num_expert, world_size, topk=1,
                         capacity_factor=cap, device=device, dtype=dtype)


__all__ = ["NaiveGate", "GShardGate", "SwitchGate"]
