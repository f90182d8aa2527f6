"""Test helpers of the port: the OpTest harness (`optest`)."""
from .optest import OpTest, numeric_grad

__all__ = ["OpTest", "numeric_grad"]
