from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .fault_tolerance import HeartbeatMonitor, StragglerPolicy, plan_elastic_remesh
from .losses import cross_entropy, total_loss
from .train_step import TrainConfig, init_train_state, make_train_step

__all__ = [
    "AsyncCheckpointer",
    "HeartbeatMonitor",
    "StragglerPolicy",
    "TrainConfig",
    "cross_entropy",
    "init_train_state",
    "latest_step",
    "make_train_step",
    "plan_elastic_remesh",
    "restore",
    "save",
    "total_loss",
]
