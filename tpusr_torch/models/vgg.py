"""VGG16 defect classifier (port of ``tpusr/models/vgg.py::VGG16Classifier``):
VGG16 conv base -> global average pool -> Dropout -> Dense 256 relu ->
Dropout -> Dense softmax; dropout only with ``train=True``.

It serves the ``per_patch_f32`` mode and the f32 calibration forward of the
int8 path, and ``ClassifierTrainer`` trains it. It is not a Pallas path in the JAX package, so it runs PyTorch's
own ``nn.Conv2d``/``nn.Linear`` (TF32 off). Its weights are in PyTorch's
layouts (OIHW, Linear (out, in)); ``tpusr_torch.bridge`` converts a flax tree
once. The public forward takes NHWC patches, as the JAX model does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.bridge import dense_to_linear, hwio_to_oihw
from tpusr_torch.device import resolve_device
from tpusr_torch.models.init import default_generator, variance_scaling

# (block, convs-in-block, filters)
VGG16_CFG = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))


def conv_names() -> list[str]:
    return [f"block{b}_conv{c}" for b, n, _f in VGG16_CFG
            for c in range(1, n + 1)]


class VGG16Classifier(nn.Module):
    """``widths`` overrides the five block widths (tests use narrow ones);
    the layer names and the block structure stay VGG16's."""

    def __init__(self, num_classes: int = 2, dense_units: int = 256,
                 widths: tuple[int, ...] | None = None, device=None,
                 generator: torch.Generator | None = None,
                 dropout_rate: float = 0.2):
        super().__init__()
        dev = resolve_device(device)
        g = default_generator(generator)
        widths = tuple(widths or (f for _b, _n, f in VGG16_CFG))
        self.dropout_rate = dropout_rate
        self.init_args = dict(num_classes=num_classes, dense_units=dense_units,
                              widths=widths, dropout_rate=dropout_rate)
        self.blocks = tuple((b, n, wd) for (b, n, _f), wd in zip(VGG16_CFG, widths))
        self.vgg16 = nn.ModuleDict()
        cin = 3
        for b, n, wd in self.blocks:
            for c in range(1, n + 1):
                conv = nn.Conv2d(cin, wd, 3, padding=1)
                # flax lecun_normal: variance 1 / fan_in, stored HWIO there
                conv.weight.data = hwio_to_oihw(variance_scaling(
                    (3, 3, cin, wd), 9 * cin, 1.0, g)).contiguous()
                conv.bias.data.zero_()
                self.vgg16[f"block{b}_conv{c}"] = conv
                cin = wd
        self.fc1 = nn.Linear(cin, dense_units)
        self.predictions = nn.Linear(dense_units, num_classes)
        for lin in (self.fc1, self.predictions):
            lin.weight.data = dense_to_linear(variance_scaling(
                (lin.in_features, lin.out_features), lin.in_features, 1.0,
                g)).contiguous()
            lin.bias.data.zero_()
        self.requires_grad_(False)
        self.to(dev)

    def _dropout(self, x: torch.Tensor, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
        """flax ``Dropout``: keep where a uniform draw from ``generator`` is
        below 1 - rate, scaled by 1 / (1 - rate). ``F.dropout`` takes no
        generator."""
        if not train or self.dropout_rate <= 0:
            return x
        if generator is None:
            raise ValueError("VGG16Classifier: train=True needs a generator "
                             "for the dropout masks")
        keep_prob = 1.0 - self.dropout_rate
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(N, H, W, 3) [0, 1] patches -> (N, classes) softmax probs; with
        ``train``, dropout masks drawn from ``generator``."""
        x = x.permute(0, 3, 1, 2)
        for b, n, _wd in self.blocks:
            for c in range(1, n + 1):
                x = F.relu(self.vgg16[f"block{b}_conv{c}"](x))
            x = F.max_pool2d(x, 2, 2)
        x = x.mean(dim=(2, 3))                       # GlobalAveragePooling2D
        x = self._dropout(x, train, generator)
        x = F.relu(self.fc1(x))
        x = self._dropout(x, train, generator)
        return torch.softmax(self.predictions(x), dim=-1)
