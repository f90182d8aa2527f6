"""Mixed precision of the port: `auto_cast` (O1 and O2 through
`decorate`, on `core.dispatch`'s hook) and dynamic loss scaling
(`grad_scaler`)."""
from .auto_cast import amp_guard, auto_cast, black_list, decorate, white_list
from .grad_scaler import GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "white_list", "black_list",
           "GradScaler"]
