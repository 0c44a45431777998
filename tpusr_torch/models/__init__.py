"""EDSR, SRCNN, ESRGAN, the VGG16 classifier and its int8 paths, the VGG19
perceptual extractor."""

from tpusr_torch.models.edsr import EDSR
from tpusr_torch.models.esrgan import ESRGANDiscriminator, ESRGANGenerator
from tpusr_torch.models.srcnn import SRCNN
from tpusr_torch.models.vgg import (VGG16Classifier, VGG19Features,
                                   preprocess_caffe)

__all__ = ["EDSR", "ESRGANDiscriminator", "ESRGANGenerator", "SRCNN",
           "VGG16Classifier", "VGG19Features", "preprocess_caffe"]
