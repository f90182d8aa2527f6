"""Neural-network pieces of the port: `functional`, `Dropout`, global-norm
clipping (`clip`)."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer import Dropout

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout"]
