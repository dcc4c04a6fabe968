"""Training data (counterpart of ``segma_tpu/data``): the on-disk dataset,
its interval index and the host-path random-crop loader."""

from segma_tpu_torch.data.file_dataset import (
    DatasetNotLoadedError,
    DatasetSubset,
    SegmaFileDataset,
    URISubsetLeakageError,
)
from segma_tpu_torch.data.intervals import IntervalIndex
from segma_tpu_torch.data.loaders import (
    AudioSegmentationSampler,
    PrefetchingLoader,
    SegmentationDataLoader,
    generate_frames,
    windows_to_targets,
)

__all__ = [
    "AudioSegmentationSampler",
    "DatasetNotLoadedError",
    "DatasetSubset",
    "IntervalIndex",
    "PrefetchingLoader",
    "SegmaFileDataset",
    "SegmentationDataLoader",
    "URISubsetLeakageError",
    "generate_frames",
    "windows_to_targets",
]
