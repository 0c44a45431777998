"""SRCNN (port of ``tpusr/models/srcnn.py``): Conv 96x(9,9) relu -> Conv
32x(1,1) relu -> Conv channels x(5,5) linear, all SAME, on a pre-upscaled LR
image in [0, 1].

The JAX package runs these convs through XLA, not a Pallas kernel, so the
port runs ``F.conv2d`` (TF32 off). Weights are in PyTorch's layout (OIHW);
``tpusr_torch.bridge.srcnn_from_flax`` converts a flax tree. The forward
takes and returns NHWC, as the JAX model does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.bridge import hwio_to_oihw
from tpusr_torch.models.init import DrawnConv2d, dense_params, param_rng


class SRCNN(nn.Module):
    def __init__(self, channels: int = 3, f1: int = 96, f2: int = 32,
                 device=None, key=None):
        """Weights are flax's ``init`` from ``key`` (a PRNG key, or an int
        seed for ``PRNGKey(seed)``; by default ``PRNGKey(42)``, the JAX
        trainer's), made on ``device`` (CUDA unless ``device="cpu"``); no
        torch initialiser runs."""
        super().__init__()
        r = param_rng(key, device)
        self.init_args = dict(channels=channels, f1=f1, f2=f2)
        for name, cin, cout, k in (("conv1", channels, f1, 9),
                                   ("conv2", f1, f2, 1),
                                   ("conv3", f2, channels, 5)):
            conv = DrawnConv2d(cin, cout, k, padding=k // 2,
                               device=r.device)
            # flax nn.Conv's default lecun_normal: variance 1 / fan_in
            kernel, bias = dense_params(r.child(name), (k, k, cin, cout),
                                        r.device)
            conv.weight.data = hwio_to_oihw(kernel).contiguous()
            conv.bias.data = bias
            self.add_module(name, conv)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) -> (N, H, W, C)."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        return self.conv3(x).permute(0, 2, 3, 1)
