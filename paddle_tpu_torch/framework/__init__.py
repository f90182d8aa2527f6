"""Framework utilities: save/load (`io`) and the fault-tolerant training
plane (checkpoint manager, resilient loop, training fault injector).

Counterpart: ``paddle_tpu/framework/``, with ``ParamAttr`` and
``create_parameter`` (`param_attr`). The default-dtype functions wait
for the port's dtype table (ROADMAP A2) and the RNG-state functions for
``core/random.py``'s rest (A3).
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
from .param_attr import ParamAttr, create_parameter  # noqa: F401
from .train_faults import InjectedCrash, TrainFaultInjector  # noqa: F401
from .train_loop import (  # noqa: F401
    ResilientTrainLoop,
    TrainAnomalyError,
    TrainRunResult,
    register_train_metrics,
)

__all__ = ["CheckpointCorruptError", "CheckpointError", "CheckpointManager",
           "TrainEpochRange", "load_sharded", "save_sharded", "load", "save",
           "ParamAttr", "create_parameter",
           "InjectedCrash", "TrainFaultInjector", "ResilientTrainLoop",
           "TrainAnomalyError", "TrainRunResult", "register_train_metrics"]
