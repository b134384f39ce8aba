"""repro_torch.training — the training step and loop of the port."""
from repro_torch.training.controller import (AdaptiveBatchController,
                                             ControllerConfig,
                                             decide_global_batch,
                                             decide_targets,
                                             snap_accum_steps,
                                             snap_targets)
from repro_torch.training.tasks import (Task, classifier_task, lm_task,
                                        ssl_task)
from repro_torch.training.train_state import TrainState
from repro_torch.training.trainer import (FitOptions, MetricRing, fit,
                                          make_classifier_step,
                                          make_ssl_step, make_train_step)

__all__ = ["AdaptiveBatchController", "ControllerConfig", "FitOptions",
           "MetricRing", "Task", "TrainState", "classifier_task", "decide_global_batch",
           "decide_targets", "fit", "lm_task", "make_classifier_step",
           "make_ssl_step", "make_train_step", "snap_accum_steps",
           "snap_targets", "ssl_task"]
