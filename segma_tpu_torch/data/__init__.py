"""Training data (counterpart of ``segma_tpu/data``): the on-disk dataset,
its interval index, the random-crop loader and the device audio cache."""

from segma_tpu_torch.data.device_cache import DeviceAudioCache
from segma_tpu_torch.data.file_dataset import (
    DatasetNotLoadedError,
    DatasetSubset,
    SegmaFileDataset,
    URISubsetLeakageError,
)
from segma_tpu_torch.data.intervals import IntervalIndex
from segma_tpu_torch.data.loaders import (
    AudioSegmentationSampler,
    BatchContractError,
    DataLoaderError,
    PrefetchingLoader,
    SegmentationDataLoader,
    generate_frames,
    windows_to_targets,
)

__all__ = [
    "AudioSegmentationSampler",
    "BatchContractError",
    "DataLoaderError",
    "DatasetNotLoadedError",
    "DatasetSubset",
    "DeviceAudioCache",
    "IntervalIndex",
    "PrefetchingLoader",
    "SegmaFileDataset",
    "SegmentationDataLoader",
    "URISubsetLeakageError",
    "generate_frames",
    "windows_to_targets",
]
