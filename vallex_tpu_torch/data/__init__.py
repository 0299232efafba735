"""Training data pipeline: HDF5 dataset, bucketing sampler, collation."""

from .dataset import (
    AudioDataset,
    DynamicBatchSampler,
    collate,
    collate_packed,
    create_dataloader,
)

__all__ = [
    "AudioDataset",
    "DynamicBatchSampler",
    "collate",
    "collate_packed",
    "create_dataloader",
]
