"""Training steps of the port: `SpmdTrainStep` on one device and
`gpt_loss_fn` (`spmd`)."""
from .spmd import SpmdTrainStep, gpt_loss_fn

__all__ = ["SpmdTrainStep", "gpt_loss_fn"]
