"""Training: AdamW, grad-accum step, checkpointing, trainer loop, after
``repro/train``."""
from .checkpoint import CheckpointManager
from .optim import AdamWConfig, adamw_init, adamw_update, cosine_lr
from .step import TrainConfig, init_state, make_train_step
from .trainer import RunConfig, Trainer

__all__ = ["AdamWConfig", "CheckpointManager", "RunConfig", "TrainConfig",
           "Trainer", "adamw_init", "adamw_update", "cosine_lr",
           "init_state", "make_train_step"]
