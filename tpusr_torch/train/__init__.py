"""The training path: the supervised SR and classifier trainers, the
ESRGAN adversarial trainer, their callbacks, checkpoints and metrics log."""

from tpusr_torch.train.callbacks import (EarlyStopping, EpochMemoryTracker,
                                         EpochTimeTracker, ReduceLROnPlateau)
from tpusr_torch.train.checkpoint import (load_metadata, restore_checkpoint,
                                          save_checkpoint,
                                          save_checkpoint_async)
from tpusr_torch.train.gan import ESRGANTrainer, GANFitResult, GANState
from tpusr_torch.train.trainer import (ClassifierTrainer, FitResult,
                                       SupervisedSRTrainer, TrainState)

__all__ = ["ClassifierTrainer", "ESRGANTrainer", "EarlyStopping",
           "EpochMemoryTracker", "EpochTimeTracker", "FitResult",
           "GANFitResult", "GANState", "ReduceLROnPlateau",
           "SupervisedSRTrainer", "TrainState", "load_metadata",
           "restore_checkpoint", "save_checkpoint", "save_checkpoint_async"]
