"""EDSR, SRCNN, the VGG16 classifier and its int8 paths."""

from tpusr_torch.models.edsr import EDSR
from tpusr_torch.models.srcnn import SRCNN
from tpusr_torch.models.vgg import VGG16Classifier

__all__ = ["EDSR", "SRCNN", "VGG16Classifier"]
