"""Optimizers of the port, functional form (`optimizer`, `optimizers`)."""
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW"]
