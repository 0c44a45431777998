"""LPIPS (alex), the reference EDA's perceptual metric (port of
``tpusr/metrics/lpips.py``).

AlexNet-OWT's five ReLU feature taps (a 3/2 max-pool after conv1 and
conv2), each unit-normalised over its channels, their squared differences
weighted by the learned per-channel ``lin`` heads, averaged over space and
summed over the taps. Weights come from an offline-provisioned ``.npz``
(``python -m tpusr_torch.tools.lpips_weights``); the bundle's HWIO kernels
become ``nn.Conv2d``'s OIHW in ``bridge.py``. The convolutions are
``F.conv2d`` with TF32 off (the JAX package leaves them to ``lax.conv``).

Inputs to ``lpips_alex`` are NHWC RGB in [-1, 1], as in the JAX package;
``LPIPSAlex`` itself runs on NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.device import resolve_device

# channel normalisation before the feature net (lpips ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet-OWT .features conv geometry: (kernel, stride, padding, out_ch)
ALEX_CONVS = ((11, 4, 2, 64), (5, 1, 2, 192), (3, 1, 1, 384),
              (3, 1, 1, 256), (3, 1, 1, 256))
# max-pool (3, stride 2) follows the conv1 and conv2 taps
_POOL_AFTER = (True, True, False, False, False)


class LPIPSAlex(nn.Module):
    """AlexNet-OWT features and the LPIPS heads, on NCHW; ``forward(x0,
    x1)`` of two (N, 3, H, W) [-1, 1] RGB batches gives the (N,)
    distances."""

    def __init__(self, device=None):
        super().__init__()
        cin = 3
        for i, (k, s, p, cout) in enumerate(ALEX_CONVS, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(cin, cout, k, s, p))
            self.register_buffer(f"lin{i}", torch.zeros(cout))
            cin = cout
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The five ReLU taps of AlexNet-OWT ``.features``."""
        feats = []
        for i, pool in enumerate(_POOL_AFTER, start=1):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if pool:
                x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        f0s = self.features((x0 - self.shift) / self.scale)
        f1s = self.features((x1 - self.shift) / self.scale)
        total = 0.0
        for i, (f0, f1) in enumerate(zip(f0s, f1s), start=1):
            d = (_unit_normalize(f0) - _unit_normalize(f1)) ** 2
            lin = getattr(self, f"lin{i}").view(1, -1, 1, 1)
            total = total + (d * lin).sum(dim=1).mean(dim=(1, 2))
        return total


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Divide by the channel norm plus ``eps`` (NCHW: channels on dim 1)."""
    return f / (torch.sqrt((f * f).sum(dim=1, keepdim=True)) + eps)


def load_lpips_npz(path: str, device=None) -> LPIPSAlex:
    """A provisioned LPIPS-alex ``.npz`` bundle as an ``LPIPSAlex`` on
    ``device`` (CUDA unless the caller passes ``device="cpu"``)."""
    from tpusr_torch.bridge import lpips_alex_from_arrays

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return lpips_alex_from_arrays(flat, device=device)


def lpips_alex(net: LPIPSAlex, img0: torch.Tensor,
               img1: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per pair: (N, H, W, 3) [-1, 1] RGB x2 -> (N,)."""
    return net(img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2))


def lpips_alex_from_uint8_rgb(net: LPIPSAlex, a, b) -> float:
    """Two HWC uint8 RGB images (numpy or tensors) -> scalar LPIPS, the
    EDA's per-pair use; computed on ``net``'s device."""
    dev = net.conv1.weight.device

    def prep(img):
        x = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img)
                            else img).to(dev, torch.float32)
        return x[None] / 127.5 - 1.0

    with torch.no_grad():
        return float(lpips_alex(net, prep(a), prep(b))[0])
