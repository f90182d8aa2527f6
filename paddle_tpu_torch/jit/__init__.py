"""Capture discipline: one CUDA graph per shape bucket (`capture`), the
port's counterpart of the reference's ``jax.jit`` of each serving step
and of its compiled generation loop."""
from .capture import CapturedStep, graph_pool

__all__ = ["CapturedStep", "graph_pool"]
