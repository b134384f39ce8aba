"""repro_torch.checkpoint — tree checkpoints in the JAX package's
format (``arrays.npz`` + ``meta.json``), so either package restores the
other's."""
from repro_torch.checkpoint.checkpoint import (gathered_train_state,
                                               latest_step, restore,
                                               restore_train_state, save,
                                               save_train_state,
                                               saved_shardings,
                                               train_state_tree)

__all__ = ["gathered_train_state", "latest_step", "restore",
           "restore_train_state", "save", "save_train_state",
           "saved_shardings", "train_state_tree"]
