"""repro_torch.training — the training step and loop of the port."""
from repro_torch.training.tasks import Task, classifier_task, lm_task
from repro_torch.training.train_state import TrainState
from repro_torch.training.trainer import FitOptions, fit, make_train_step

__all__ = ["FitOptions", "Task", "TrainState", "classifier_task", "fit",
           "lm_task", "make_train_step"]
