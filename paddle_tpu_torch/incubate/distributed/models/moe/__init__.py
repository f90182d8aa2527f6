"""The MoE layer and its gates on one card.

Counterpart: ``paddle_tpu/incubate/distributed/models/moe/``."""
from .gate import GShardGate, NaiveGate, SwitchGate
from .moe_layer import ExpertFFN, MoELayer

__all__ = ["MoELayer", "ExpertFFN", "NaiveGate", "GShardGate", "SwitchGate"]
