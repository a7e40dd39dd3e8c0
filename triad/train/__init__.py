from triad.train.optim import (
    GROUPS,
    BankState,
    OptimizerBank,
    ParamPartition,
    clip_grads,
    gate_grads,
    group_gates,
    group_schedules,
    label_for_path,
)
from triad.train.step import StepFactory, TrainState, init_train_state

__all__ = [
    "GROUPS",
    "BankState",
    "OptimizerBank",
    "ParamPartition",
    "StepFactory",
    "TrainState",
    "clip_grads",
    "gate_grads",
    "group_gates",
    "group_schedules",
    "init_train_state",
    "label_for_path",
]
