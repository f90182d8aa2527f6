"""Framework utilities: save/load (`io`) and the fault-tolerant training
plane (checkpoint manager, resilient loop, training fault injector).

Counterpart: ``paddle_tpu/framework/``. ``ParamAttr`` waits for the
port's ``nn.Layer`` (ROADMAP A5), the default-dtype functions for its
dtype table (A2) and the RNG-state functions for ``core/random.py``'s
rest (A3).
"""
from .checkpoint import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointError,
    CheckpointManager,
    TrainEpochRange,
    load_sharded,
    save_sharded,
)
from .io import load, save  # noqa: F401
from .train_faults import InjectedCrash, TrainFaultInjector  # noqa: F401
from .train_loop import (  # noqa: F401
    ResilientTrainLoop,
    TrainAnomalyError,
    TrainRunResult,
    register_train_metrics,
)

__all__ = ["CheckpointCorruptError", "CheckpointError", "CheckpointManager",
           "TrainEpochRange", "load_sharded", "save_sharded", "load", "save",
           "InjectedCrash", "TrainFaultInjector", "ResilientTrainLoop",
           "TrainAnomalyError", "TrainRunResult", "register_train_metrics"]
