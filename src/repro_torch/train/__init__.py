from repro_torch.train.loop import FailureInjector, InjectedFailure, LoopReport, run_training
from repro_torch.train.step import TrainConfig, TrainState, init_train_state, train_step

__all__ = [
    "FailureInjector",
    "InjectedFailure",
    "LoopReport",
    "run_training",
    "TrainConfig",
    "TrainState",
    "init_train_state",
    "train_step",
]
