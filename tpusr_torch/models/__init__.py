"""EDSR, the VGG16 classifier and its int8 paths."""

from tpusr_torch.models.edsr import EDSR
from tpusr_torch.models.vgg import VGG16Classifier

__all__ = ["EDSR", "VGG16Classifier"]
