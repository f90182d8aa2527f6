"""Core pieces of the port (random state, `random`)."""
from . import random

__all__ = ["random"]
