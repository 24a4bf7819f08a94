from .checkpoint import CheckpointManager
from .contrastive import contrastive_loss_fn, init_contrastive, make_contrastive_train_step
from .converter import converter_loss_fn, init_converter, make_converter_train_step
from .fused import (
    FusedContrastivePipeline,
    FusedConverterPipeline,
    augment_contrastive_views,
    augment_triplets,
    crop_views,
)
from .state import TrainState, current_lr, make_lr_schedule, make_optimizer

__all__ = [
    "CheckpointManager",
    "TrainState",
    "current_lr",
    "make_lr_schedule",
    "make_optimizer",
    "init_contrastive",
    "contrastive_loss_fn",
    "make_contrastive_train_step",
    "init_converter",
    "converter_loss_fn",
    "make_converter_train_step",
    "FusedContrastivePipeline",
    "FusedConverterPipeline",
    "augment_contrastive_views",
    "augment_triplets",
    "crop_views",
]
