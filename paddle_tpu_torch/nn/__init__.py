"""Neural-network functions of the port (see `functional`)."""
from . import functional

__all__ = ["functional"]
