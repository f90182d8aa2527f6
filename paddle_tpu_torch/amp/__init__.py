"""Mixed precision of the port: dynamic loss scaling (`grad_scaler`).
``auto_cast`` (O1) waits for A3's dispatch hook (ROADMAP A6)."""
from .grad_scaler import GradScaler

__all__ = ["GradScaler"]
