"""Data helpers of the training path: augmentation and batch prefetching."""
