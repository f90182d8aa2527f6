"""Optimizers of the port: the base with its eager ``step()`` and its
functional form (`optimizer`), the nine optimizers (`optimizers`) and
the LR schedulers (`lr`)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import (
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum, RMSProp,
)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb"]
