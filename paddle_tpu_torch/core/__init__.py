"""Core pieces of the port: random state (`random`) and `Parameter`."""
from . import random
from .parameter import Parameter

__all__ = ["random", "Parameter"]
