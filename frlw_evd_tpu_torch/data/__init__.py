"""Datasets and the host-side input pipeline (counterpart of
frlw_evd_tpu/data): the reference-format uint8 blob datasets, their
augmentation, the batching loader with pinned batches for the card, the
streaming window fetcher and the synthetic GEN1-style tree."""

from .augment import augment_sample, xyxy2cxcywh
from .dataset import (GEN1_CLASSES, GEN4_CLASSES, PropheseeDataset,
                      PropheseeTafDataset, dataset_geometry)
from .loader import Loader, collate_batch

__all__ = ["GEN1_CLASSES", "GEN4_CLASSES", "Loader", "PropheseeDataset",
           "PropheseeTafDataset", "augment_sample", "collate_batch",
           "dataset_geometry", "xyxy2cxcywh"]
