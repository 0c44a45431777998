"""Data helpers: the dataset loaders, the degradation model, and the
training path's augmentation and batch prefetching."""

from tpusr_torch.data.degrade import DegradeConfig, degrade_image
from tpusr_torch.data.loading import (add_padding, get_all_image_paths,
                                      load_dataset_as_patches,
                                      load_defects_dataset_as_patches,
                                      load_predictions_dataset)

__all__ = ["DegradeConfig", "add_padding", "degrade_image",
           "get_all_image_paths", "load_dataset_as_patches",
           "load_defects_dataset_as_patches", "load_predictions_dataset"]
