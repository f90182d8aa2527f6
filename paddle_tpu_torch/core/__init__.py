"""Core pieces of the port: dtypes (`dtype`), places (`place`), the
Tensor surface (`tensor`, installed on ``torch.Tensor`` at import),
autograd (`autograd`), the dispatch's AMP hook (`dispatch`), random
state (`random`) and `Parameter`."""
from . import autograd, dispatch, dtype, place, random
from .parameter import Parameter
from .tensor import Tensor

__all__ = ["autograd", "dispatch", "dtype", "place", "random", "Parameter",
           "Tensor"]
