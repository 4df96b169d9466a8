"""Training step and loop (counterpart of ``repro/train``)."""
from .step import TrainStepConfig, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "TrainStepConfig", "make_train_step"]
