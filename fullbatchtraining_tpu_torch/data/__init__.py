"""Data of the port: host arrays and image trees, the baked store,
device-side augmentation, epoch layout and the streaming plan."""

from .augmentations import crop_flip, draw_crop_flip, make_augment_fn, make_eval_transform, normalize
from .baked import BakedDataset, bake_dataset
from .datasets import ArrayDataset, construct_datasets
from .pipeline import (DataBundle, construct_databundle, epoch_layout, epoch_order, layout_epoch,
                       rank_rows, stream_plan)

__all__ = ["ArrayDataset", "BakedDataset", "DataBundle", "bake_dataset", "construct_datasets",
           "construct_databundle", "crop_flip", "draw_crop_flip", "epoch_layout", "epoch_order",
           "layout_epoch", "make_augment_fn", "make_eval_transform", "normalize",
           "rank_rows", "stream_plan"]
